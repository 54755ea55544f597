"""train_mfu: model FLOPs of the optimizer steps taken in the window
(``roofline.train_step_flops``: 6 x block weights and 6 x the tied
head per token, causal attention forward and backward), over the
window, over the H100's dense bf16 peak, in %."""

from perfbench import roofline


def read(rec):
    if "steps" not in rec:
        return None
    flops = rec["steps"] * roofline.train_step_flops(
        rec["model"], rec["batch"], rec["seq"] - 1)
    return 100.0 * flops / rec["window_s"] / roofline.BF16_FLOPS
