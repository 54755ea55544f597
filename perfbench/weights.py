"""Weights from the seed, made on the device in a few large calls.

One ``torch.randn`` on a generator of the run's device fills every
product weight and both embeddings at once; each leaf is a view of that
buffer scaled by 1 / sqrt(fan_in) (the distribution of the port's
``transformer.init``); the layer norms are ones and zeros.  The names
and layouts are the port's parameter tree, so the same dict loads into
the program's model and feeds the plain reference, which makes its own
copy from the seed again rather than taking the program's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench import traffic


def layout(m: Dict) -> List[Tuple[str, tuple, int]]:
    """[(name, shape, fan_in)] of the drawn leaves, in draw order."""
    V, D, H, L, F, S = (m["vocab"], m["d_model"], m["n_heads"],
                        m["n_layers"], m["d_ff"], m["max_seq"])
    hd = D // H
    return [("embed", (V, D), D), ("pos", (S, D), D),
            ("blocks.wq", (L, D, H, hd), D), ("blocks.wk", (L, D, H, hd), D),
            ("blocks.wv", (L, D, H, hd), D), ("blocks.wo", (L, H, hd, D), D),
            ("blocks.w1", (L, D, F), D), ("blocks.w2", (L, F, D), F)]


def make_weights(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{parameter name: f32 tensor} of the model `m` (a config file's
    "model" group) from `seed`, on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(traffic.stream_seed(seed, 0))
    shapes = layout(m)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=g, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, fan_in in shapes:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(1.0 / math.sqrt(fan_in))
        at += n
    D, L = m["d_model"], m["n_layers"]
    ones = torch.ones((2 * L + 1) * D, device=device)
    zeros = torch.zeros((2 * L + 1) * D, device=device)
    out["ln_f.g"], out["ln_f.b"] = ones[:D], zeros[:D]
    out["blocks.ln1_g"] = ones[D:D + L * D].view(L, D)
    out["blocks.ln2_g"] = ones[D + L * D:].view(L, D)
    out["blocks.ln1_b"] = zeros[D:D + L * D].view(L, D)
    out["blocks.ln2_b"] = zeros[D + L * D:].view(L, D)
    return out


def token_generator(seed: int, device) -> torch.Generator:
    """The generator of a training run's token batches."""
    g = torch.Generator(device=device)
    g.manual_seed(traffic.stream_seed(seed, 1))
    return g
