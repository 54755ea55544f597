"""Shared arithmetic of the metric readers."""

import math


def p95(xs):
    """The 95th percentile by nearest rank, or None without samples."""
    xs = sorted(xs)
    if not xs:
        return None
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def completed_in_window(rec):
    """Requests that ended with their stream closed cleanly, their last
    token inside the window."""
    t0, t1 = rec["t0"], rec["t1"]
    return [r for r in rec.get("requests", ())
            if r["end"] == "eof" and r["stamps"]
            and t0 <= r["stamps"][-1] <= t1]
