"""The yardstick's arithmetic of the lfm2 family (routed MoE): model
FLOPs of a training step and the least time of the held experts'
grouped products.  Peaks are ``roofline``'s.

A product of an [m, k] by a [k, n] matrix is 2 m k n FLOPs; training
is 3x the forward (6 x weights a token).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from perfbench.roofline import BF16_FLOPS, HBM_BYTES_PER_S, PRODUCTS

# the grouped products of one MoE layer in one step: x w1, x w3, a w2
# forward; the input gradients through w2, w1 and w3 and the three weight
# gradients backward
FWD_PRODUCTS, BWD_PRODUCTS = 3, 6


def _is_moe(m: Dict, i: int) -> bool:
    return m["n_experts"] > 0 and i >= m["n_dense_layers"]


def dense_weights(m: Dict) -> int:
    """Weights a product multiplies once a token outside the experts:
    the conv mixers' in/out projections, attention's q, k, v and o, the
    dense FFNs, the routers and the tied head."""
    D, H, KV, V = m["d_model"], m["n_heads"], m["n_kv_heads"], m["vocab"]
    hd = D // H
    total = D * V
    for i, kind in enumerate(m["layer_kinds"]):
        total += 4 * D * D if kind == "conv" else \
            2 * D * H * hd + 2 * D * KV * hd
        total += D * m["n_experts"] if _is_moe(m, i) else 3 * D * m["d_ff"]
    return total


def expert_weights(m: Dict) -> int:
    """One expert's weights (w1, w3, w2)."""
    return 3 * m["d_model"] * m["d_expert"]


def attention_fwd_flops(m: Dict, B: int, S: int) -> int:
    """q.k and p.v of the causal pairs t <= s over the attention
    layers."""
    n_attn = sum(k == "attn" for k in m["layer_kinds"])
    return n_attn * 4 * m["d_model"] * B * S * (S + 1) // 2


def conv_fwd_flops(m: Dict, B: int, S: int) -> int:
    """The depthwise convolutions' multiply-adds."""
    n_conv = sum(k == "conv" for k in m["layer_kinds"])
    return n_conv * 2 * m["conv_width"] * m["d_model"] * B * S


def train_step_flops(m: Dict, B: int, S: int, held_assignments: int) -> int:
    """One optimizer step on B sequences of S positions whose tokens made
    `held_assignments` assignments to the held experts, over every MoE
    layer: forward and backward of every product."""
    return (6 * dense_weights(m) * B * S
            + 6 * expert_weights(m) * held_assignments
            + 3 * (attention_fwd_flops(m, B, S) + conv_fwd_flops(m, B, S)))


def expert_product_bound_s(m: Dict, rows: int) -> float:
    """Least seconds of one grouped product of a held-expert layer over
    `rows` assignments: 2 x rows x D x F FLOPs at the product dtype's
    rate, or each weight (all held experts) and each activation row read
    once and each output written once, at HBM's rate, whichever is
    longer."""
    D, Fe, held = m["d_model"], m["d_expert"], m["experts_held"]
    elt, rate = PRODUCTS[m["dtype"]]
    flops = 2 * rows * D * Fe
    nbytes = elt * (held * D * Fe + rows * (D + Fe))
    return max(flops / rate, nbytes / HBM_BYTES_PER_S)


def expert_products_bound_s(m: Dict, per_layer: Sequence[Sequence[int]],
                            steps: int) -> float:
    """Least seconds of every held-expert grouped product of `steps`
    training steps whose MoE layers counted `per_layer` [layer][expert]
    assignments in all (each step taken at the layer's mean)."""
    return sum((FWD_PRODUCTS + BWD_PRODUCTS) * steps
               * expert_product_bound_s(m, round(sum(c) / steps))
               for c in per_layer)


def load_max(per_layer: List[List[int]]) -> float:
    """The most-loaded held expert's assignments over the held experts'
    mean, at the worst layer."""
    return max(max(c) * len(c) / sum(c) for c in per_layer if sum(c))

