"""serve_tokens_per_s: output tokens that every client received inside
the window (client stamps), over the window's seconds."""


def read(rec):
    if "requests" not in rec:
        return None
    t0, t1 = rec["t0"], rec["t1"]
    n = sum(1 for r in rec["requests"] for t in r["stamps"] if t0 <= t <= t1)
    return n / (t1 - t0)
