"""A time limit of a test's own for the PyTorch port's slow CPU tests:

    with time_limit(300):
        ...

raises TimeoutError in the test's thread once the seconds are over (by
SIGALRM, so in the main thread of the process running the test)."""

import contextlib
import signal


@contextlib.contextmanager
def time_limit(seconds: float):
    def expire(signum, frame):
        raise TimeoutError(f'the test ran past its limit of {seconds} s')

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
