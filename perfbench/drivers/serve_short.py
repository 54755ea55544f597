"""The serving driver for a closed loop whose streams end before its
clients can all be running: ``serve``'s run, with set-up ended once the
engine has let in as many streams as there are clients (``admitted``),
not once that many are running at once.

The engine admits one stream a loop, and a stream runs for about its
output length in loops, so with outputs shorter than the clients are
many (docqa: 16-64 tokens for 48 clients) the running batch settles near
the mean output length and never holds every client; ``serve``'s ramp
would wait for that until its timeout.  Everything else is ``serve``'s.
"""

from __future__ import annotations

import time
from typing import Dict

from perfbench.drivers import serve
from perfbench.profiling import Patches


def _wait_admitted(engine, n_full: int) -> None:
    deadline = time.monotonic() + serve.RAMP_TIMEOUT_S
    while engine.stats()["admitted"] < n_full:
        if time.monotonic() > deadline:
            raise RuntimeError(f"{n_full} streams were not let in within "
                               f"{serve.RAMP_TIMEOUT_S} s: {engine.stats()}")
        time.sleep(serve.POLL_S)


def run(ctx) -> Dict:
    patches = Patches()
    patches.set(serve, "_wait_full", _wait_admitted)
    try:
        return serve.run(ctx)
    finally:
        patches.undo()
