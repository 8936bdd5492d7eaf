"""The traffic generator: the deployments' channels against the system
table, occupancy by mix, and what the seed decides."""

import json
import pathlib
import re

import numpy as np
import pytest

from hfdlbench import spec, traffic, tx

ROOT = pathlib.Path(__file__).resolve().parents[2]
TINY = dict(channels=[[8885, [15]], [8886, [14]], [8936, [2, 9]],
                      [8939, [10]]],
            sample_rate=216_000, centerfreq=8_915_000, sample_format='CS16')
SEED = 2**31 + 12345


def mix(name, **over):
    m = json.loads((spec.HERE / 'traffic' / f'{name}.json').read_text())
    m.update(over)
    return m


def config(name):
    return json.loads((spec.HERE / 'configs' / f'{name}.json').read_text())


def systable() -> dict:
    """kHz -> sorted ground station ids, from the repo's system table."""
    out: dict = {}
    text = (ROOT / 'etc' / 'systable.conf').read_text()
    for block in re.findall(r'\{(.*?)\}', text, re.S):
        sid = int(re.search(r'id = (\d+)', block).group(1))
        freqs = re.search(r'frequencies = \(([^)]*)\)', block).group(1)
        for f in freqs.split(','):
            out.setdefault(int(float(f)), []).append(sid)
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize('name', ['hfdl3456k_3band_cs16',
                                  'hfdl2160k_2band_cs16'])
def test_channels_are_every_system_table_frequency_the_capture_holds(name):
    cfg = config(name)
    table = systable()
    half = cfg['sample_rate'] / 2
    inside = {f: ids for f, ids in table.items()
              if abs(f * 1000 - cfg['centerfreq']) < half - 20_000}
    assert {f: ids for f, ids in cfg['channels']} == inside
    assert [f for f, _ in cfg['channels']] == sorted(inside)


@pytest.mark.parametrize('name,mix_name,frames', [
    ('hfdl3456k_3band_cs16', 'squitters', 41),
    ('hfdl2160k_2band_cs16', 'squitters', 30),
    ('hfdl3456k_3band_cs16', 'slots_full', 66),
    ('hfdl3456k_3band_cs16', 'slots_spaced', 34),
    ('hfdl2160k_2band_cs16', 'slots_spaced', 22)])
def test_occupancy_of_each_mix(name, mix_name, frames):
    cfg, m = config(name), mix(mix_name)
    occ = traffic.occupancy(cfg, m)
    assert len(occ) == frames and len(set(occ)) == frames
    hz = traffic.channel_freqs(cfg)
    if m['frames'] == 'squitter':
        assert frames == sum(len(ids) for _, ids in cfg['channels'])
        assert m['slots'] == 13
        return
    apart = m.get('quiet_within_hz', 0)
    near = {i for i, f in enumerate(hz)
            if any(0 < abs(f - g) < apart for g in hz)}
    on = {i for _, i in occ}
    assert on == set(range(len(hz))) - near
    # every slot of every emitting channel, but 8885 and 8886 kHz in turn
    pair = {hz.index(8_885_000), hz.index(8_886_000)} - near
    assert frames == len(on) * m['slots'] - (len(pair) == 2) * m['slots']
    for s in range(m['slots']):
        busy = sorted(hz[i] for t, i in occ if t == s)
        assert min(np.diff(busy)) >= max(apart, m['turns_within_hz'])


def test_seed_decides_contents_not_work():
    m = mix('slots_full')
    a = traffic.build(TINY, m, seed=SEED)
    b = traffic.build(TINY, m, seed=SEED)
    c = traffic.build(TINY, m, seed=7)
    assert a.raw == b.raw and a.emissions == b.emissions
    assert a.raw != c.raw
    key = [(e.channel, e.slot, e.mode, len(e.pdu)) for e in a.emissions]
    assert key == [(e.channel, e.slot, e.mode, len(e.pdu))
                   for e in c.emissions]
    assert sorted(e.snr_db for e in a.emissions) == sorted(
        e.snr_db for e in c.emissions)
    assert sorted(e.delay_s for e in a.emissions) == sorted(
        e.delay_s for e in c.emissions)
    assert [e.snr_db for e in a.emissions] != [e.snr_db for e in c.emissions]
    assert any(x.pdu != y.pdu for x, y in zip(a.emissions, c.emissions))
    assert [e.mode for e in a.emissions] == [
        tx.SINGLE_SLOT_MODES[k % 4] for k in range(len(a.emissions))]
    assert traffic.build(TINY, m, seed=SEED, samples=False).emissions \
        == a.emissions


def test_loop_and_frames_ending_in():
    cap = traffic.build(TINY, mix('slots_full'), seed=1, samples=False)
    n = cap.loop_len
    assert n == 2 * tx.SLOT_SYMBOLS * 3 * 40
    assert len(cap.emissions) == 6      # 8885 and 8886 in turn
    keys = sorted(traffic.frames_ending_in(cap, 0, 3 * n))
    assert keys == sorted((e.channel, k * 2 + e.slot)
                          for e in cap.emissions for k in range(3))
    e = cap.emissions[0]
    end = cap.end_sample(e)
    assert traffic.frames_ending_in(cap, end + 1, end + 2) == []
    assert (e.channel, 2 + e.slot) in traffic.frames_ending_in(
        cap, n + end, n + end + 1)
