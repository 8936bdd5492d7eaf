"""The closed loop's source: a process of its own, as the reader of an SDR
piped into the command line is.

    python3 -m hfdlbench.source <fifo>

reads the cell's configuration, mix and seed as one JSON line on standard
input, synthesizes the capture (traffic.build), prints ``ready <seconds of
synthesis>``, then writes whole loops of it into the named pipe <fifo>
until its standard input closes, and ends after the loop in progress,
printing ``loops <loops written>``.  It holds the pipe open for reading
too, so that it never waits for a reader and no write finds none.
"""

from __future__ import annotations

import fcntl
import json
import os
import select
import sys

from hfdlbench import traffic

F_SETPIPE_SZ = 1031
PIPE_WRITE = 1 << 20            # bytes per write


def closed(fd: int) -> bool:
    """Whether the file `fd` reads has ended (its writer closed it)."""
    return bool(select.select([fd], [], [], 0)[0]) and not os.read(fd, 1)


def main(argv=None) -> int:
    fifo = (argv or sys.argv[1:])[0]
    job = json.loads(sys.stdin.buffer.readline())
    cap = traffic.build(job['config'], job['mix'], job['seed'])
    raw = memoryview(cap.raw)
    print(f'ready {cap.synth_s}', flush=True)
    fd = os.open(fifo, os.O_RDWR)
    try:
        fcntl.fcntl(fd, F_SETPIPE_SZ, PIPE_WRITE)
    except OSError:
        pass
    loops = 0
    stdin = sys.stdin.fileno()
    while not closed(stdin):
        for a in range(0, len(raw), PIPE_WRITE):
            part = raw[a:a + PIPE_WRITE]
            while part:
                part = part[os.write(fd, part):]
        loops += 1
    os.close(fd)
    print(f'loops {loops}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
