"""Ring and Ulysses attention over a mesh axis (port of
brpc_tpu/parallel/ring_attention.py).

Each rank holds its shard of q, k, v [B/dp, S/n, H/tp, hd] (n the size of
the sequence axis) and gets its shard of the output back, as the
reference's ``shard_map`` body does:

  ring_attention     K/V circulate over the axis (``collectives.
                     ring_permute``); each rank folds every held block
                     into an online-softmax state (m, l, o) in f32, in
                     the reference's order: its own block first, then
                     the one from rank i-1, and so on.  A wholly future
                     block is skipped (causal).
  ulysses_attention  one all-to-all swaps sequence sharding for head
                     sharding, attention runs over the whole sequence for
                     H/(tp n) heads (one fold at offsets 0/0), and a
                     second all-to-all swaps back; needs n | H/tp.

The fold is ``ops.ring_fold``: the hand-written kernels for CUDA tensors,
the plain version for CPU tensors.  :class:`RingAttention` carries the
backward explicitly, since torch's collectives carry no autograd: the
ring runs again, dq stays local, and the dk/dv accumulators (f32) travel
with their K/V blocks and are back at their owner after n hops.  The
forward saves q, k, v, the normalised f32 output and the row
log-sum-exp; nothing differentiates through the permutes.

Ulysses' local attention is the reference's ``_dense_local`` (:125-133):
f32 weights times ``scale``, as the fold's; the fold computes
(sum_j p_j v_j) / l where ``_dense_local`` computes sum_j (p_j / l) v_j,
which differs by f32 rounding only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from brpc_tpu_torch.ops.ring_fold import (NEG, ring_fold_backward_dkdv,
                                          ring_fold_backward_dq,
                                          ring_fold_forward)
from brpc_tpu_torch.parallel import collectives, sharding


def _ring(mesh, axis):
    """(n, this rank's index) on the axis; (1, 0) without one."""
    if mesh is None or axis not in mesh.shape:
        return 1, 0
    return mesh.shape[axis], sharding.axis_index(mesh, axis)


def _accumulator(t):
    """f32 zeros [B, H, C, hd] for a [B, C, H, hd] tensor."""
    B, C, H, hd = t.shape
    return torch.zeros((B, H, C, hd), dtype=torch.float32, device=t.device)


def _out(acc, dtype):
    """[B, H, C, hd] f32 -> [B, C, H, hd] in the working type."""
    return acc.transpose(1, 2).to(dtype, memory_format=torch.contiguous_format,
                                  copy=True)


class RingAttention(torch.autograd.Function):
    """Ring attention of this rank's q over every rank's k, v along
    `axis` of `mesh` (mesh None: one block, the local attention)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        n, idx = _ring(mesh, axis)
        B, C, H, _ = q.shape
        m = torch.full((B, H, C), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, C), dtype=torch.float32, device=q.device)
        o = _accumulator(q)
        kb, vb = k, v
        for step in range(n):
            src = (idx - step) % n
            ring_fold_forward(q, kb, vb, m, l, o, idx * C, src * C, causal,
                              scale)
            if step < n - 1:
                kb = collectives.ring_permute(mesh, axis, kb)
                vb = collectives.ring_permute(mesh, axis, vb)
        o /= torch.clamp(l, min=1e-30)[..., None]
        ctx.save_for_backward(q, k, v, o, m + torch.log(l))
        ctx.ring = (mesh, axis, causal, scale)
        return _out(o, q.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis, causal, scale = ctx.ring
        n, idx = _ring(mesh, axis)
        C = q.shape[1]
        if do.stride(-1) != 1:
            do = do.contiguous()
        # D = sum_k dO . o, the softmax backward's row sums [B, H, C]
        delta = (do.float().transpose(1, 2) * o).sum(-1).contiguous()
        dq = _accumulator(q)
        dk, dv = _accumulator(k), _accumulator(v)
        kb, vb = k, v
        for step in range(n):
            src = (idx - step) % n
            ring_fold_backward_dq(q, kb, vb, do, lse, delta, dq, idx * C,
                                  src * C, causal, scale)
            ring_fold_backward_dkdv(q, kb, vb, do, lse, delta, dk, dv,
                                    idx * C, src * C, causal, scale)
            if step < n - 1:
                kb = collectives.ring_permute(mesh, axis, kb)
                vb = collectives.ring_permute(mesh, axis, vb)
            if n > 1:   # the accumulators go on with their block
                dk = collectives.ring_permute(mesh, axis, dk)
                dv = collectives.ring_permute(mesh, axis, dv)
        return (_out(dq, q.dtype), _out(dk, k.dtype), _out(dv, v.dtype),
                None, None, None, None)


def _scale(q, scale: Optional[float]) -> float:
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else scale


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True,
                   scale: Optional[float] = None):
    """Blockwise ring attention over mesh axis `axis`: this rank's shards
    q, k, v [B/dp, S/n, H/tp, hd] -> its shard of the output, same shape
    and dtype."""
    return RingAttention.apply(q, k, v, mesh, axis, causal,
                               _scale(q, scale))


def ulysses_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True,
                      scale: Optional[float] = None):
    """All-to-all sequence parallelism (Ulysses style) on this rank's
    shards [B/dp, S/n, H/tp, hd]: requires n | H/tp."""
    n = mesh.shape.get(axis, 1)
    tp = mesh.shape.get("tp", 1)
    local_heads = q.shape[2]
    if local_heads % n != 0:
        raise ValueError(
            f"ulysses needs axis size {n} to divide per-tp-shard heads "
            f"{local_heads} (n_heads {local_heads * tp} / tp {tp})")
    scale = _scale(q, scale)
    q, k, v = (sharding.a2a(t, mesh, axis, split=2, concat=1)
               for t in (q, k, v))
    o = RingAttention.apply(q, k, v, None, axis, causal, scale)
    return sharding.a2a(o, mesh, axis, split=1, concat=2)
