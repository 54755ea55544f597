"""causal_fwd_roofline.serve: the least time of each prefill's causal
forward in the profiler slice (``roofline.attention_bounds(...)["fwd"]``
at its B, S, H, hd), over the forward kernel's device time there, in %.
Where the profiler dropped some records the bound is scaled to those
kept."""

from perfbench import roofline

KERNEL = "causal_fwd"


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    calls = prof["calls"]["causal_fwd"]
    times = [b - a for name, a, b in prof["intervals"] if KERNEL in name]
    if not calls or not times:
        return None
    rate = {e: r for e, r in roofline.PRODUCTS.values()}
    bound_ms = sum(roofline.attention_bounds(B, S, H, hd, elt,
                                             rate[elt])["fwd"][0]
                   for (B, S, H, hd), elt in calls)
    bound_ms *= len(times) / len(calls)
    return 100.0 * bound_ms / (sum(times) / 1e3)
