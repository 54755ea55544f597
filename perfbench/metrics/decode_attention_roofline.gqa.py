"""decode_attention_roofline.gqa: the least time of every grouped-query
decode-attention launch in the profiler slice
(``roofline_moe_serve.decode_attention_gqa_bound`` at the call's N, H, hd
and p, the cache's bytes counted at the configuration's KV heads), over
the kernel's device time there, in %.  Where the profiler dropped some
of the kernel's records, the calls' bound is scaled to the records
kept; None without a slice, a recorded call or a configuration with KV
heads."""

from perfbench import roofline_moe_serve

KERNEL = "decode_attention_kernel"


def read(rec):
    prof, kv = rec.get("profile"), rec.get("model", {}).get("n_kv_heads")
    if not prof or not kv:
        return None
    calls = prof.get("calls", {}).get("decode_attention")
    times = [b - a for name, a, b in prof["intervals"] if KERNEL in name]
    if not calls or not times:
        return None
    bound_ms = sum(roofline_moe_serve.decode_attention_gqa_bound(
        N, H, kv, hd, p, elt)[0] for (N, H, hd), elt, p in calls)
    bound_ms *= len(times) / len(calls)
    return 100.0 * bound_ms / (sum(times) / 1e3)
