"""moe_expert_roofline.train: the least time of the held experts'
grouped products in the profiler slice (``roofline_moe``: 3 products
forward and 6 backward a MoE layer and step, at the rows the counters
saw in the slice), over the device time of the grouped-product kernels
there, in %; None without a slice, the counters or a matching kernel."""

from perfbench import roofline_moe

KERNEL = "GroupProblemShape"     # CUTLASS's grouped GEMM, torch._grouped_mm


def read(rec):
    prof, moe = rec.get("profile"), rec.get("moe", {})
    sl = moe.get("slice")
    if not prof or not sl or not sl["assignments"]:
        return None
    dev_s = sum(b - a for name, a, b in prof["intervals"]
                if KERNEL in name) / 1e6
    if not dev_s:
        return None
    bound = roofline_moe.expert_products_bound_s(
        rec["model"], sl["assignments"], rec["trace_steps"])
    return 100.0 * bound / dev_s
