"""The yardstick's arithmetic of serving the lfm2 family: the least time
of the held experts' grouped products at decode and prefill shapes, and
of the grouped-query decode-attention kernel.  Peaks are ``roofline``'s.

A grouped product multiplies each held expert's rows by that expert's
weight matrix; an expert with no row is not read.  At a decode step's
shapes (about 16 rows an expert at 128 slots) the weights' bytes bound
it; at a prefill's, the FLOPs.
"""

from __future__ import annotations

from typing import Dict, Sequence

from perfbench.roofline import BF16_FLOPS, HBM_BYTES_PER_S, PRODUCTS

# the grouped products of one MoE layer in one forward: x w1, x w3, a w2
PRODUCTS_PER_LAYER = 3


def expert_product_flops(m: Dict, counts: Sequence[int]) -> int:
    """FLOPs of one grouped product of a layer whose held experts got
    `counts` rows: 2 x rows x d_model x d_expert."""
    return 2 * sum(counts) * m["d_model"] * m["d_expert"]


def expert_product_bytes(m: Dict, counts: Sequence[int]) -> int:
    """Bytes of one grouped product: the weight matrix of every expert
    with at least one row read once, each row in read once and each row
    out written once (d_model + d_expert values a row, either way
    round)."""
    D, Fe = m["d_model"], m["d_expert"]
    elt, _ = PRODUCTS[m["dtype"]]
    return elt * (sum(1 for c in counts if c) * D * Fe
                  + sum(counts) * (D + Fe))


def expert_product_bound_s(m: Dict, counts: Sequence[int]) -> float:
    """Least seconds of one grouped product: FLOPs at the product dtype's
    dense rate or bytes at HBM's, whichever is longer."""
    _, rate = PRODUCTS[m["dtype"]]
    return max(expert_product_flops(m, counts) / rate,
               expert_product_bytes(m, counts) / HBM_BYTES_PER_S)


def expert_launches_bound_s(m: Dict,
                            calls: Sequence[Sequence[Sequence[int]]]
                            ) -> float:
    """Least seconds of every grouped product of `calls` (steps and
    prefills), each given as its MoE layers' [layer][expert] rows: three
    products a layer and call, each bounded alone."""
    return sum(PRODUCTS_PER_LAYER * expert_product_bound_s(m, counts)
               for call in calls for counts in call)


def decode_attention_gqa_bound(N, H, KV, hd, p, elt):
    """(least ms, what bounds it) of one decode-attention launch of N
    slots, H query heads over KV heads of hd, each slot attending over
    0..p[n]: each input read once (q; k_new and v_new at the KV heads;
    the valid K/V window at the KV heads; p), each output written once
    (o; the two appended rows at the KV heads); q.k and w.v at the bf16
    rate for every query head."""
    window = sum(int(x) + 1 for x in p)
    nbytes = (N * H * hd * elt + 2 * N * KV * hd * elt
              + 2 * window * KV * hd * elt + 4 * N
              + N * H * hd * elt + 2 * N * KV * hd * elt)
    flops = 4 * window * H * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")
