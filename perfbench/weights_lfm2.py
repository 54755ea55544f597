"""Weights of an lfm2 configuration from the seed, made on the device in
a few large calls, as ``weights.py`` makes GPT-2's.

One ``torch.randn`` fills every product weight and the embedding; each
leaf is a view of that buffer scaled by 1 / sqrt(fan_in) (the port's
``transformer.init`` distribution); the norms are ones; each MoE
layer's ``expert_bias`` (a buffer the step does not train) is a second
draw, normal x 0.05.  The names and layouts are the port's parameter
tree for the family (``layers.<i>.<leaf>``, one leaf a layer), so the
same dict loads into the program's model and feeds the plain reference,
which makes its own copy from the seed again.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench import traffic

BIAS_STD = 0.05


def is_moe(m: Dict, i: int) -> bool:
    return m["n_experts"] > 0 and i >= m["n_dense_layers"]


def layout(m: Dict) -> List[Tuple[str, tuple, int]]:
    """[(name, shape, fan_in)] of the drawn leaves, in draw order."""
    V, D, H, KV, F = (m["vocab"], m["d_model"], m["n_heads"],
                      m["n_kv_heads"], m["d_ff"])
    hd, W = D // H, m["conv_width"]
    E, Eh, Fe = m["n_experts"], m["experts_held"], m["d_expert"]
    out = [("embed", (V, D), D)]
    for i, kind in enumerate(m["layer_kinds"]):
        p = f"layers.{i}."
        if kind == "conv":
            out += [(p + "in_proj", (D, 3 * D), D), (p + "conv", (D, 1, W), W),
                    (p + "out_proj", (D, D), D)]
        else:
            out += [(p + "wq", (D, H * hd), D), (p + "wk", (D, KV * hd), D),
                    (p + "wv", (D, KV * hd), D),
                    (p + "wo", (H * hd, D), H * hd)]
        if is_moe(m, i):
            out += [(p + "router", (D, E), D), (p + "we1", (Eh, D, Fe), D),
                    (p + "we3", (Eh, D, Fe), D), (p + "we2", (Eh, Fe, D), Fe)]
        else:
            out += [(p + "w1", (D, F), D), (p + "w3", (D, F), D),
                    (p + "w2", (F, D), F)]
    return out


def norms(m: Dict) -> List[Tuple[str, int]]:
    """[(name, width)] of the RMSNorm gains."""
    D, hd = m["d_model"], m["d_model"] // m["n_heads"]
    out = [("norm_f", D)]
    for i, kind in enumerate(m["layer_kinds"]):
        p = f"layers.{i}."
        out += [(p + "mix_norm", D), (p + "ffn_norm", D)]
        if kind == "attn":
            out += [(p + "q_norm", hd), (p + "k_norm", hd)]
    return out


def make_weights(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} of the model `m` (a config file's "model"
    group) from `seed`, on `device`: parameters and the
    ``layers.<i>.expert_bias`` buffers."""
    g = torch.Generator(device=device)
    g.manual_seed(traffic.stream_seed(seed, 0))
    shapes = layout(m)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in shapes),
                       generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, fan_in in shapes:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(1.0 / math.sqrt(fan_in))
        at += n
    for name, width in norms(m):
        out[name] = torch.ones(width, device=device)
    moe = [i for i in range(m["n_layers"]) if is_moe(m, i)]
    bias = torch.randn(len(moe), m["n_experts"], generator=g, device=device,
                       dtype=torch.float32).mul_(BIAS_STD)
    for j, i in enumerate(moe):
        out[f"layers.{i}.expert_bias"] = bias[j]
    return out
