"""Finds a cell's parts by the names in BENCHMARK.json.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's ``file`` is given in BENCHMARK.json, the mix is
``traffic/<traffic>.json`` and each per-layer metric is
``metrics/<name>.py`` (a module with ``read(window) -> float | None``).
Adding a configuration, a mix or a metric is adding files and entries:
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list            # metric entries of BENCHMARK.json
    per_layer: list


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / 'BENCHMARK.json') as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    work = {w['name']: w for w in bench['workloads']}
    if name not in work:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    w = work[name]
    cfg_entry = {c['name']: c for c in bench['configs']}[w['config']]
    with open(root / cfg_entry['file']) as fh:
        config = json.load(fh)
    with open(root / HERE.name / 'traffic' / f"{w['traffic']}.json") as fh:
        mix = json.load(fh)
    return Cell(name=name, chips=w['chips'], config=config, mix=mix,
                end_to_end=[m for m in bench['end_to_end']
                            if _applies(m, name)],
                per_layer=[m for m in bench['per_layer']
                           if _applies(m, name)])


def reader(metric: str, root: pathlib.Path = ROOT):
    """The per-layer metric's reader: metrics/<metric>.py's read."""
    path = root / HERE.name / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        f'hfdlbench_metric_{metric.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
