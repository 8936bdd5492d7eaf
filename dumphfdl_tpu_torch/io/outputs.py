# Copy of dumphfdl_tpu/io/outputs.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Output layer: registry, per-output queues/threads, drivers.

Reference: reference src/output-common.{c,h} and the per-driver
files.  Semantics preserved:

* ``--output what:format:type:k=v,...`` spec (main.c:838-960);
* formatter instances dedup'd per (format, intype) (output-common.c:76-87);
* one worker thread + bounded queue per output; high-water mark 1000
  (0 = unlimited; disabled for file input so offline decodes are
  lossless) (output-common.h:17-19, main.c:452);
* failed produce -> message requeued at the front + 2 s pause
  (output-common.c:233-241); failed init -> output deactivated and its
  queue drained (output-common.c:254-260);
* ordered shutdown via a sentinel flowing through every queue
  (output-common.c:285-297).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import socket
import sys
import threading
import time as time_mod
from typing import Any

OUTPUT_QUEUE_HWM_DEFAULT = 1000
OUTPUT_QUEUE_HWM_NONE = 0

_SHUTDOWN = object()


def parse_kvargs(text: str) -> dict[str, str]:
    """`key1=val1,key2=val2` parser (kvargs.c:36-78)."""
    out: dict[str, str] = {}
    if not text:
        return out
    for part in text.split(','):
        if not part:
            continue
        if '=' not in part:
            raise ValueError(f'kvargs: missing value in {part!r}')
        k, v = part.split('=', 1)
        out[k.strip()] = v.strip()
    return out


@dataclasses.dataclass
class OutputSpec:
    """Parsed --output specifier."""
    what: str          # 'decoded' (or 'raw' in future)
    fmt: str           # text | json | basestation
    driver: str        # file | tcp | udp | zmq | kafka
    params: dict[str, str]

    @classmethod
    def parse(cls, text: str) -> 'OutputSpec':
        parts = text.split(':', 3)
        if len(parts) < 3:
            raise ValueError(
                f'invalid output spec {text!r}: want what:format:type[:params]')
        what, fmt, driver = parts[0], parts[1], parts[2]
        params = parse_kvargs(parts[3]) if len(parts) > 3 else {}
        return cls(what=what.lower(), fmt=fmt.lower(),
                   driver=driver.lower(), params=params)


class OutputDriver:
    """Base driver: init() once in the worker; produce() per message."""
    name = 'base'

    def __init__(self, params: dict[str, str]):
        self.params = params

    def init(self) -> None:
        pass

    def produce(self, payload: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FileOutput(OutputDriver):
    """Append-mode file with optional hourly/daily rotation
    (output-file.c:68-156); '-' writes to stdout."""
    name = 'file'

    def __init__(self, params):
        super().__init__(params)
        self.path = params.get('path', '-')
        rotate = params.get('rotate', 'none').lower()
        if rotate not in ('none', 'hourly', 'daily'):
            raise ValueError(f'file: invalid rotate={rotate}')
        self.rotate = rotate
        self._fh = None
        self._cur_suffix = None

    def _suffix(self) -> str:
        tm = time_mod.gmtime()
        if self.rotate == 'daily':
            return time_mod.strftime('_%Y%m%d', tm)
        if self.rotate == 'hourly':
            return time_mod.strftime('_%Y%m%d_%H', tm)
        return ''

    def _open(self) -> None:
        if self.path == '-':
            self._fh = sys.stdout.buffer
            return
        suffix = self._suffix()
        path = self.path
        if suffix:
            root, ext = os.path.splitext(path)
            path = root + suffix + ext
        self._fh = open(path, 'ab')
        self._cur_suffix = suffix

    def init(self) -> None:
        self._open()

    def produce(self, payload: bytes) -> None:
        if self.rotate != 'none' and self._suffix() != self._cur_suffix:
            if self._fh is not sys.stdout.buffer:
                self._fh.close()
            self._open()
        self._fh.write(payload)
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None and self._fh is not sys.stdout.buffer:
            self._fh.close()


class TcpOutput(OutputDriver):
    """TCP client with auto-reconnect >=10 s apart, 5 s send timeout;
    drops while disconnected (output-tcp.c:16-19,63-167)."""
    name = 'tcp'
    RECONNECT_INTERVAL = 10.0
    SEND_TIMEOUT = 5.0

    def __init__(self, params):
        super().__init__(params)
        try:
            self.address = params['address']
            self.port = int(params['port'])
        except KeyError as e:
            raise ValueError(f'tcp: missing required param {e}') from None
        self._sock = None
        self._last_attempt = 0.0

    def _connect(self) -> None:
        now = time_mod.monotonic()
        if now - self._last_attempt < self.RECONNECT_INTERVAL:
            return
        self._last_attempt = now
        try:
            s = socket.create_connection((self.address, self.port),
                                         timeout=self.SEND_TIMEOUT)
            s.settimeout(self.SEND_TIMEOUT)
            self._sock = s
        except OSError:
            self._sock = None

    def init(self) -> None:
        self._last_attempt = -1e9
        self._connect()

    def produce(self, payload: bytes) -> None:
        if self._sock is None:
            self._connect()
            if self._sock is None:
                return             # drop silently while disconnected
        try:
            self._sock.sendall(payload)
        except OSError:
            try:
                self._sock.close()
            finally:
                self._sock = None
            raise                  # -> requeue at front + delay

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()


class UdpOutput(OutputDriver):
    """Fire-and-forget datagrams (output-udp.c)."""
    name = 'udp'

    def __init__(self, params):
        super().__init__(params)
        try:
            self.address = params['address']
            self.port = int(params['port'])
        except KeyError as e:
            raise ValueError(f'udp: missing required param {e}') from None
        self._sock = None
        self._dest = None

    def init(self) -> None:
        infos = socket.getaddrinfo(self.address, self.port,
                                   type=socket.SOCK_DGRAM)
        family, _, _, _, addr = infos[0]
        self._sock = socket.socket(family, socket.SOCK_DGRAM)
        self._dest = addr

    def produce(self, payload: bytes) -> None:
        try:
            self._sock.sendto(payload, self._dest)
        except OSError:
            pass

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()


class ZmqOutput(OutputDriver):
    """ZeroMQ PUB socket, server(bind)/client(connect) modes
    (output-zmq.c:64-94).  Requires pyzmq."""
    name = 'zmq'

    def __init__(self, params):
        super().__init__(params)
        self.mode = params.get('mode', 'server')
        if self.mode not in ('server', 'client'):
            raise ValueError(f'zmq: invalid mode={self.mode}')
        try:
            self.endpoint = params['endpoint']
        except KeyError:
            raise ValueError('zmq: missing required param endpoint') from None
        self.hwm = int(params.get('hwm', OUTPUT_QUEUE_HWM_DEFAULT))
        self._sock = None
        self._ctx = None

    def init(self) -> None:
        try:
            import zmq
        except ImportError:
            raise RuntimeError('zmq output requires pyzmq (not installed)')
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.PUB)
        self._sock.set(zmq.SNDHWM, self.hwm)
        if self.mode == 'server':
            self._sock.bind(self.endpoint)
        else:
            self._sock.connect(self.endpoint)

    def produce(self, payload: bytes) -> None:
        self._sock.send(payload)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close(0)


class KafkaOutput(OutputDriver):
    """Kafka producer (output-rdkafka.c:27-247).  Requires confluent-kafka."""
    name = 'kafka'

    def __init__(self, params):
        super().__init__(params)
        try:
            self.brokers = params['brokers']
            self.topic = params['topic']
        except KeyError as e:
            raise ValueError(f'kafka: missing required param {e}') from None
        self._producer = None

    def init(self) -> None:
        try:
            from confluent_kafka import Producer
        except ImportError:
            raise RuntimeError(
                'kafka output requires confluent-kafka (not installed)')
        conf = {'bootstrap.servers': self.brokers,
                'acks': self.params.get('acks', '1')}
        for key in ('security.protocol', 'sasl.mechanism', 'sasl.username',
                    'sasl.password', 'ssl.ca.location'):
            pkey = key.replace('.', '_')
            if pkey in self.params:
                conf[key] = self.params[pkey]
        self._producer = Producer(conf)

    def produce(self, payload: bytes) -> None:
        self._producer.produce(self.topic, payload)
        self._producer.poll(0)

    def close(self) -> None:
        if self._producer is not None:
            self._producer.flush(5)


DRIVERS = {
    'file': FileOutput,
    'tcp': TcpOutput,
    'udp': UdpOutput,
    'zmq': ZmqOutput,
    'kafka': KafkaOutput,
}


class OutputInstance:
    """One output: worker thread + bounded deque with HWM semantics."""

    RETRY_DELAY = 2.0       # output-common.c:240

    def __init__(self, driver: OutputDriver, fmt: str,
                 hwm: int = OUTPUT_QUEUE_HWM_DEFAULT):
        self.driver = driver
        self.fmt = fmt
        self.hwm = hwm
        self._deque: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self.active = True
        self.dropped = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f'output-{driver.name}')
        self._thread.start()

    def push(self, payload: bytes) -> None:
        with self._cv:
            if not self.active:
                return
            if self.hwm and len(self._deque) >= self.hwm:
                self.dropped += 1
                return             # HWM throttle (output-common.c:269-283)
            self._deque.append(payload)
            self._cv.notify()

    def shutdown(self) -> None:
        with self._cv:
            self._deque.append(_SHUTDOWN)
            self._cv.notify()

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)

    def _run(self) -> None:
        try:
            self.driver.init()
        except Exception as e:
            print(f'output {self.driver.name}: init failed: {e}',
                  file=sys.stderr)
            with self._cv:
                self.active = False
                self._deque.clear()
            # keep draining so producers never block (output-common.c:254-260)
        while True:
            with self._cv:
                while not self._deque:
                    self._cv.wait()
                item = self._deque.popleft()
            if item is _SHUTDOWN:
                break
            if not self.active:
                continue
            try:
                self.driver.produce(item)
            except Exception:
                with self._cv:
                    self._deque.appendleft(item)   # requeue at the front
                time_mod.sleep(self.RETRY_DELAY)
        self.driver.close()


class OutputManager:
    """Formatter dedup + fan-out to output instances (pdu.c:116-153)."""

    def __init__(self, ctx, hwm: int = OUTPUT_QUEUE_HWM_DEFAULT):
        from . import formatters as fmtrs
        self.ctx = ctx
        self.hwm = hwm
        self._fmtrs: dict[str, Any] = {}
        self._outputs: list[tuple[Any, OutputInstance]] = []
        self._fmtr_factory = fmtrs.create

    def add_output(self, spec: OutputSpec | str) -> OutputInstance:
        if isinstance(spec, str):
            spec = OutputSpec.parse(spec)
        if spec.what != 'decoded':
            raise ValueError(f'unsupported output class {spec.what!r}')
        fmtr = self._fmtrs.get(spec.fmt)
        if fmtr is None:
            fmtr = self._fmtr_factory(spec.fmt, self.ctx)
            self._fmtrs[spec.fmt] = fmtr
        try:
            driver_cls = DRIVERS[spec.driver]
        except KeyError:
            raise ValueError(f'unknown output driver {spec.driver!r}') from None
        inst = OutputInstance(driver_cls(spec.params), spec.fmt, self.hwm)
        self._outputs.append((fmtr, inst))
        return inst

    def dispatch(self, metadata, trees) -> None:
        """Format each tree once per distinct formatter; fan out."""
        cache: dict[tuple[int, int], Any] = {}
        for tree in trees:
            for fmtr, inst in self._outputs:
                key = (id(fmtr), id(tree))
                if key not in cache:
                    cache[key] = fmtr.format(metadata, tree)
                payload = cache[key]
                if payload is not None:
                    inst.push(payload.encode('utf-8'))

    def shutdown(self) -> None:
        for _, inst in self._outputs:
            inst.shutdown()
        for _, inst in self._outputs:
            inst.join(10)
