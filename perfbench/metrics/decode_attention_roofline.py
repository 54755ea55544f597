"""decode_attention_roofline: the least time of every decode-attention
launch in the profiler slice (``roofline.decode_attention_bound`` at
the call's N, H, hd and p), over the kernel's device time there, in %.
Where the profiler dropped some of the kernel's records, the calls'
bound is scaled to the records kept."""

from perfbench import roofline

KERNEL = "decode_attention_kernel"


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    calls = prof["calls"]["decode_attention"]
    times = [b - a for name, a, b in prof["intervals"] if KERNEL in name]
    if not calls or not times:
        return None
    bound_ms = sum(roofline.decode_attention_bound(N, H, hd, p, elt)[0]
                   for (N, H, hd), elt, p in calls)
    bound_ms *= len(times) / len(calls)
    return 100.0 * bound_ms / (sum(times) / 1e3)
