"""causal_attention_roofline.train: the least time of each causal
forward, dq and dk/dv launch in the profiler slice
(``roofline.attention_bounds`` at the step's B, S, H, hd and
product dtype), over the
three kernels' device time there, in %."""

from perfbench import roofline

KINDS = {"causal_fwd": "fwd", "causal_dq": "bwd_dq",
         "causal_dkdv": "bwd_dkdv"}


def read(rec):
    prof = rec.get("profile")
    if not prof or "steps" not in rec:
        return None
    m = rec["model"]
    H = m["n_heads"]
    elt, rate = roofline.PRODUCTS[m["dtype"]]
    bounds = roofline.attention_bounds(rec["batch"], rec["seq"] - 1, H,
                                       m["d_model"] // H, elt, rate)
    bound_ms = dev_us = 0.0
    for name, a, b in prof["intervals"]:
        for key, kind in KINDS.items():
            if key in name:
                bound_ms += bounds[kind][0]
                dev_us += b - a
    if not dev_us:
        return None
    return 100.0 * bound_ms / (dev_us / 1e3)
