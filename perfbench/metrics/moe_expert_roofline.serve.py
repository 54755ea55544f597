"""moe_expert_roofline.serve: the least time of the held experts' grouped
products in the profiler slice (``roofline_moe_serve``: three products a
MoE layer for each step and prefill, each at the rows the counters saw
in that call), over the device time of the grouped-product kernels
there, in %.  Where the profiler dropped some of the kernels' records,
the calls' bound is scaled to the records kept.  None without a slice,
the per-call counters or a matching kernel."""

from perfbench import roofline_moe_serve

KERNEL = "GroupProblemShape"     # CUTLASS's grouped GEMM, torch._grouped_mm


def read(rec):
    prof, calls = rec.get("profile"), rec.get("moe", {}).get("slice_calls")
    if not prof or not calls:
        return None
    times = [b - a for name, a, b in prof["intervals"] if KERNEL in name]
    launches = sum(roofline_moe_serve.PRODUCTS_PER_LAYER * len(c)
                   for c in calls)
    if not times or not launches:
        return None
    bound = roofline_moe_serve.expert_launches_bound_s(rec["model"], calls)
    bound *= min(1.0, len(times) / launches)
    return 100.0 * bound / (sum(times) / 1e6)
