"""The yardstick's arithmetic: published peaks, the least time a kernel
could take, model FLOPs, and what a torch.profiler slice shows of the
device.

The peaks and the two bound functions are frozen copies of
``chip_smoke.py`` (its peak constants beside ``HBM_BYTES_PER_S``,
``decode_attention_bound`` and ``attention_bounds``), and
``union_seconds`` the interval arithmetic of its ``device_profile``:
copied, not imported, so that a change to the
program cannot move the yardstick.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12     # device memory
BF16_FLOPS = 989e12           # bf16 on the tensor cores
F32_FLOPS = 67e12             # f32 outside the tensor cores
# a product dtype's bytes an element and the rate its kernels run at
PRODUCTS = {"bfloat16": (2, BF16_FLOPS), "float32": (4, F32_FLOPS)}


def decode_attention_bound(N, H, hd, p, elt):
    """(least ms, what bounds it) of one decode-attention launch: each
    input read once (q, k_new, v_new, the valid K/V window of this call's
    p, p itself), each output written once (o, the two appended rows);
    the products at the bf16 rate."""
    window = sum(int(x) + 1 for x in p)
    nbytes = (3 * N * H * hd * elt + 2 * window * H * hd * elt + 4 * N
              + 3 * N * H * hd * elt)
    flops = 4 * window * H * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bounds(B, S, H, hd, elt, flops=BF16_FLOPS):
    """{kernel: (least ms, what bounds it)} of the causal-attention
    kernels at [B, S, H, hd]: each input read once and each output
    written once (n: one [B, S, H, hd] tensor, rows: one [B, H, S] f32
    row statistic), the products of the causal half (pairs t <= s) at
    the rate `flops`.  fwd: q, k, v -> o, lse with q.k and w.v; bwd_dq:
    q, k, v, dO, lse -> dq, D with q.k, dO.v and dS.k; bwd_dkdv: q, k,
    v, dO, lse, D -> dk, dv with q.k, dO.v, p.dO and dS.q."""
    n, rows = B * S * H * hd * elt, B * H * S * 4
    mac = 2 * hd * B * H * S * (S + 1) // 2     # flops of one product

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")
    return {"fwd": bound(4 * n + rows, 2 * mac),
            "bwd_dq": bound(5 * n + 2 * rows, 3 * mac),
            "bwd_dkdv": bound(6 * n + 2 * rows, 4 * mac)}


# -- model FLOPs --------------------------------------------------------------
# A GPT-2 block without biases: q, k, v, o (4 D^2) and the MLP (2 D F)
# weights; a product of an [m, k] by a [k, n] matrix is 2 m k n FLOPs.


def block_params(m: Dict) -> int:
    """Weights of the blocks (non-embedding parameters that a product
    multiplies; the layer norms' gains and shifts add no product)."""
    D, F = m["d_model"], m["d_ff"]
    return m["n_layers"] * (4 * D * D + 2 * D * F)


def decode_token_flops(m: Dict, context: int) -> int:
    """One token decoded with `context` positions attended (itself
    included): the blocks, the tied logits, q.k and p.v over the
    context."""
    D, V, L = m["d_model"], m["vocab"], m["n_layers"]
    return 2 * block_params(m) + 2 * D * V + L * 4 * context * D


def prefill_flops(m: Dict, S: int) -> int:
    """One prompt of S tokens: the blocks for each token, causal q.k and
    p.v over the pairs t <= s, and the logits of the last position (the
    only ones a prefill computes)."""
    D, V, L = m["d_model"], m["vocab"], m["n_layers"]
    return (2 * block_params(m) * S + L * 4 * D * S * (S + 1) // 2
            + 2 * D * V)


def train_step_flops(m: Dict, B: int, S: int) -> int:
    """One optimizer step on B sequences of S input positions: forward
    and backward (3x forward) of the blocks and the tied head over every
    position, and of causal attention over the pairs t <= s."""
    D, V, L = m["d_model"], m["vocab"], m["n_layers"]
    T = B * S
    attn_fwd = L * 4 * D * B * S * (S + 1) // 2
    return 6 * block_params(m) * T + 6 * D * V * T + 3 * attn_fwd


# -- what a profiler slice shows of the device ---------------------------------


def union_seconds(spans: Iterable[Tuple[float, float]]) -> float:
    """Seconds covered by the union of [start, end] intervals in us."""
    busy, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return busy / 1e6


def idle_gaps(spans: Sequence[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] (us) that no device interval covers."""
    gaps, reach = [], lo
    for a, b in sorted(spans):
        if a > reach:
            gaps.append((reach, min(a, hi)))
        reach = max(reach, b)
        if reach >= hi:
            break
    if reach < hi:
        gaps.append((reach, hi))
    return [(a, b) for a, b in gaps if b > a]
