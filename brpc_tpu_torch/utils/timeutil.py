"""Time helpers (≙ butil/time.h: cpuwide_time_us, gettimeofday_us, Timer)."""

from __future__ import annotations

import time


def monotonic_ns() -> int:
    return time.monotonic_ns()


def monotonic_us() -> int:
    return time.monotonic_ns() // 1000


def realtime_us() -> int:
    return time.time_ns() // 1000


class Timer:
    """Start/stop stopwatch (≙ butil::Timer, time.h)."""

    __slots__ = ("_start", "_stop")

    def __init__(self, start: bool = False):
        self._start = 0
        self._stop = 0
        if start:
            self.start()

    def start(self) -> None:
        self._start = time.monotonic_ns()
        self._stop = self._start

    def stop(self) -> None:
        self._stop = time.monotonic_ns()

    def n_elapsed(self) -> int:
        return self._stop - self._start

    def u_elapsed(self) -> int:
        return self.n_elapsed() // 1000

    def m_elapsed(self) -> int:
        return self.n_elapsed() // 1_000_000
