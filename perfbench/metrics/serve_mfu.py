"""serve_mfu: model FLOPs of every prompt token prefilled and every token
decoded in the window (the configuration's blocks, tied logits and
attention over each position's context), over the window, over the
H100's dense bf16 peak, in %."""

from perfbench import roofline


def read(rec):
    if "decode_batches" not in rec or not rec["decode_batches"]:
        return None
    m = rec["model"]
    flops = sum(roofline.prefill_flops(m, plen) for _, plen in rec["admits"])
    per_token = roofline.decode_token_flops(m, 0)
    attn = 4 * m["n_layers"] * m["d_model"]
    flops += sum(n * per_token + attn * ctx
                 for _, n, ctx in rec["decode_batches"])
    return 100.0 * flops / rec["window_s"] / roofline.BF16_FLOPS
