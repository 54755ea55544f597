"""train_mfu.moe: model FLOPs of the optimizer steps taken in the window
(``roofline_moe.train_step_flops``: 6 x the non-expert weights a token,
6 x one expert's weights for each assignment the held experts' counters
saw in the window, causal attention and the convolutions forward and
backward), over the window, over the H100's dense bf16 peak, in %; None
without the counters."""

from perfbench import roofline_moe


def read(rec):
    win = rec.get("moe", {}).get("window")
    if not win or not win["assignments"] or "steps" not in rec:
        return None
    held = sum(sum(c) for c in win["assignments"])
    flops = rec["steps"] * roofline_moe.train_step_flops(
        rec["model"], rec["batch"], rec["seq"] - 1, held / rec["steps"])
    return 100.0 * flops / rec["window_s"] / roofline_moe.BF16_FLOPS
