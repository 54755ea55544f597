"""The benchmark's own instrumentation: host-clock spans around calls into
the program's layers, and what one torch.profiler slice shows.

Spans wrap attributes of the program's objects and modules for the
length of a run (``Patches`` puts every one back); the program's code is
not changed.  The slice records the device's operations alone: recording
the host's operations too costs each one microseconds, which slowed the
host's issue below the card's pace and read as idle time on the card
(PERF.md).  A gap in the device's work is named after the benchmark's
innermost span open at its middle, placed on the profiler's clock by one
anchor: the runtime's record of the synchronize the slice opens with.
"""

from __future__ import annotations

import bisect
import heapq
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.roofline import idle_gaps, union_seconds

TOP = 10          # entries of each breakdown list
NAME_CHARS = 96   # a breakdown name's length
ANCHOR = "cudaDeviceSynchronize"


class Patches:
    """Attributes replaced for a run and put back by :meth:`undo`."""

    def __init__(self):
        self._undo = []

    def set(self, obj, attr: str, value) -> None:
        own = attr in vars(obj)
        self._undo.append((obj, attr, own, vars(obj).get(attr)))
        setattr(obj, attr, value)

    def undo(self) -> None:
        while self._undo:
            obj, attr, own, old = self._undo.pop()
            if own:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)


class Spans:
    """{name: [(start, end)]} on the monotonic clock."""

    def __init__(self):
        self.by_name: Dict[str, List[Tuple[float, float]]] = \
            defaultdict(list)

    def timed(self, name: str, fn):
        out = self.by_name[name]

        def wrapper(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                out.append((t0, time.monotonic()))
        return wrapper

    def within(self, t0: float, t1: float) -> Dict[str, List[float]]:
        """{name: [seconds]} of the spans that began in [t0, t1]."""
        return {n: [b - a for a, b in v if t0 <= a <= t1]
                for n, v in self.by_name.items()}

    def named(self) -> List[Tuple[float, float, str]]:
        """Every span as (start, end, name), in seconds."""
        return [(a, b, n) for n, v in self.by_name.items() for a, b in v]


class Slice:
    """One profiler slice of the device's operations on a CUDA device (on
    another device it records nothing).  It opens with a synchronize, so
    that the slice holds only work issued inside it, and ``anchor`` is
    the host clock's reading just before that synchronize."""

    def __init__(self, dev):
        self.dev, self.prof, self.anchor, self.closed = dev, None, None, None

    def __enter__(self):
        import torch
        if self.dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.anchor = time.monotonic()
            torch.cuda.synchronize(self.dev)
        return self

    def __exit__(self, *exc):
        import torch
        if self.prof is not None:
            torch.cuda.synchronize(self.dev)
            self.closed = time.monotonic()
            self.prof.__exit__(*exc)
        return False


def warm_up(dev) -> None:
    """The profiler's own start-up (CUPTI) before any window."""
    import torch
    with Slice(dev):
        torch.zeros(1, device=dev).add_(1)


def summarize(sl: Slice, spans: List[Tuple[float, float, str]] = ()
              ) -> Optional[Dict]:
    """A slice's device intervals, busy and window seconds, and the
    breakdown (device operations by time, idle gaps by the host work
    around them); None where it recorded no device operation.  `spans`
    are the benchmark's (start, end, name) in host seconds."""
    if sl.prof is None:
        return None
    from torch.autograd import DeviceType
    dev, host, anchor = [], [], None
    for e in sl.prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, a, b))
        else:               # the runtime's calls, on the profiler's clock
            host.append((a, b))
            if e.name == ANCHOR and (anchor is None or a < anchor):
                anchor = a
    if not dev:
        return None
    everything = [(a, b) for _, a, b in dev] + host
    lo = min(a for a, _ in everything)
    hi = max(b for _, b in everything)
    dev.sort(key=lambda d: d[1])
    intervals = [(a, b) for _, a, b in dev]
    by_op: Dict[str, float] = defaultdict(float)
    for name, a, b in dev:
        by_op[name[:NAME_CHARS]] += (b - a) / 1e6
    placed = [] if anchor is None else [
        ((a - sl.anchor) * 1e6 + anchor, (b - sl.anchor) * 1e6 + anchor, n)
        for a, b, n in spans]
    by_gap: Dict[str, float] = defaultdict(float)
    for name, seconds in name_gaps(placed, dev, idle_gaps(intervals, lo,
                                                          hi)):
        by_gap[name] += seconds
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                                key=lambda kv: -kv[1])[:TOP]]
    return {"intervals": dev, "busy_s": union_seconds(intervals),
            "window_s": (hi - lo) / 1e6, "anchored": anchor is not None,
            "breakdown": {"device_ops": top(by_op),
                          "idle_gaps": top(by_gap)}}


def name_gaps(spans, dev, gaps):
    """[(name, seconds)] of each gap (profiler microseconds, in order):
    "outer > inner" after the two innermost spans open at its middle, or
    the one, else "before <the device operation that ends it>".  `dev`
    is [(name, start, end)] sorted by start.  One sweep: the spans opened
    so far in a heap by their start, those that closed before the gap
    dropped off the top."""
    spans = sorted(spans)
    starts = [a for _, a, _ in dev]
    heap, i, out = [], 0, []
    for a, b in gaps:
        t = (a + b) / 2
        while i < len(spans) and spans[i][0] <= t:
            heapq.heappush(heap, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        if heap:
            inner = heapq.heappop(heap)
            while heap and heap[0][1] < t:
                heapq.heappop(heap)
            name = f"{heap[0][2]} > {inner[2]}" if heap else inner[2]
            heapq.heappush(heap, inner)
        else:
            j = bisect.bisect_left(starts, b)
            name = (f"before {dev[j][0]}" if j < len(dev)
                    else "after the last operation")
        out.append((name[:NAME_CHARS], (b - a) / 1e6))
    return out
