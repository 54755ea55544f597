"""itl_p95_ms.serve: the 95th percentile of every gap between two
consecutive tokens of one stream, both inside the window, in ms."""

from perfbench.stats import p95


def read(rec):
    if "requests" not in rec:
        return None
    t0, t1 = rec["t0"], rec["t1"]
    gaps = [b - a for r in rec["requests"]
            for a, b in zip(r["stamps"], r["stamps"][1:])
            if t0 <= a and b <= t1]
    v = p95(gaps)
    return None if v is None else v * 1e3
