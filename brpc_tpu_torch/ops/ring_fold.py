"""The ring-attention fold: the hand-written CUDA kernels
(``csrc/ring_fold_sm90.cu`` and, at head dim 8, ``csrc/ring_fold_hd8.cu``
on the tensor cores, ``csrc/ring_fold_f32.cu`` and, at head dim 8,
``csrc/ring_fold_f32_hd8.cu`` on the CUDA cores; ``csrc/ring_fold.cu``
holds their C entries) and the plain PyTorch version beside each.

Function (brpc_tpu/parallel/ring_attention.py:56-71, one ring step's fold
of the held K/V block, and its jax.grad; Ulysses' local attention
``_dense_local`` :125-133 is one fold at offsets 0/0)::

    q, dO [B, Cq, H, hd]  k, v [B, Ck, H, hd]  bf16 or f32, last dim
    contiguous; global positions q_off + i of the queries, k_off + j of
    the keys
    s  = f32(T(q . k)) * scale, -1e30 where q_off + i < k_off + j (causal)
    fold (in place on m, l [B, H, Cq] f32 and o [B, H, Cq, hd] f32):
      m' = max(m, rowmax s)  p = exp(s - m')  a = exp(m - m')
      l' = l a + sum p       o' = o a + p . f32(v)
    backward, from lse = m + log l and D = sum_k dO . o / l [B, H, Cq]:
      P = exp(s - lse)  dP = f32(dO) . f32(v)  dS = T(P (dP - D) scale)
      dq += dS . k   dk += dS^T . q   dv += P^T . f32(dO)
    (accumulators in f32: dq [B, H, Cq, hd], dk and dv [B, H, Ck, hd])

m must start at -1e30 or above (the reference starts it at -1e30).  A
wholly future block (causal, every query before every key: the
reference's ``lax.cond`` at :73-78) is skipped without a launch on both
devices; ``<wrapper>.skips`` counts those, ``<wrapper>.launches`` the
kernel's launches.  A CUDA tensor goes to the kernel or raises; only CPU
tensors take the plain version.

Head dims ``KERNEL_HEAD_DIMS`` on the card (8 is the reference tests'
own); the plain version takes any.  In bf16 at head dims 16, 64 and 128 every
kernel takes its products of bf16 values on the tensor cores (dq all
three of them) and p's f32 products (p . f32(v), P^T . f32(dO)) as f32
FMAs on the CUDA cores.  In f32 at those head dims every kernel runs on
the CUDA cores (register tiles, cp.async copies): the forward and dq in
one pass over the keys, dk/dv on transposed tiles.  In bf16 at head dim
8 the forward, dq and dk/dv take the same split on ``mma.sync``
(``csrc/ring_fold_hd8.cu``: one pass, p and dS in registers, dS . k and
dS^T . q on m16n8k16); in f32 there the forward, dq and dk/dv run on
the CUDA cores (``csrc/ring_fold_f32_hd8.cu``: a thread's rows in
registers, the other side's rows of 8 floats through a cp.async ring,
every product an FMA from registers; the forward in one pass, dq with
each row's keys in one thread).  TMA and cp.async copy 16 bytes at a
time, so a view whose base or strides are not 16-byte multiples is
copied first, for every kernel.  ``split_bf16x3`` models the three-part
bf16 split of p that was tried for p's products on the tensor cores.
Bound and design: the kernel sources' notes.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from brpc_tpu_torch import _native
from brpc_tpu_torch.ops.causal_attention import tma_ready

NEG = -1e30
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
KERNEL_HEAD_DIMS = (8, 16, 64, 128)
# split_bf16x3 splits p 2^SPLIT_SHIFT, whose bf16 parts are all normal
# for every f32 p (p >= 2^-149), so the split is exact
SPLIT_SHIFT = 32

_lib = None
_lib_lock = threading.Lock()


def _kernels() -> ctypes.CDLL:
    """The kernel library, built with nvcc at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            L = ctypes.CDLL(_native.build_kernels())
            c = ctypes
            tail = ([c.POINTER(c.c_longlong)] + [c.c_int] * 9
                    + [c.c_float, c.c_void_p])
            L.trpc_ring_fold_fwd.argtypes = [c.c_void_p] * 6 + tail
            L.trpc_ring_fold_bwd_dq.argtypes = [c.c_void_p] * 7 + tail
            L.trpc_ring_fold_bwd_dkdv.argtypes = [c.c_void_p] * 8 + tail
            for fn in (L.trpc_ring_fold_fwd, L.trpc_ring_fold_bwd_dq,
                       L.trpc_ring_fold_bwd_dkdv):
                fn.restype = c.c_int
            _lib = L
    return _lib


def visible(q_off: int, cq: int, k_off: int, causal: bool) -> bool:
    """False for a wholly future block: max query position < min key's."""
    return not causal or q_off + cq - 1 >= k_off


# ---------------------------------------------------------------------------
# the plain versions (CPU tensors)


def scores_plain(q, k, q_off, k_off, causal, scale):
    """[B, H, Cq, Ck] f32: the T product, scaled in f32, masked."""
    s = torch.einsum("bchk,bdhk->bhcd", q, k).float() * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG)
    return s


def ring_fold_plain(q, k, v, m, l, o, q_off, k_off, causal, scale):
    """The fold of one block into (m, l, o), in place (the reference's
    fold, :57-69)."""
    s = scores_plain(q, k, q_off, k_off, causal, scale)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1)
    o_new = o * alpha[..., None] + torch.einsum("bhcd,bdhk->bhck", p,
                                                v.float())
    m.copy_(m_new)
    l.copy_(l_new)
    o.copy_(o_new)


def split_bf16x3(p):
    """The three-part split of an f32 p for its products on the tensor
    cores (a model: the main path never calls it): three bf16 tensors hi,
    mid, lo with f32(hi) + f32(mid) + f32(lo) = p 2^SPLIT_SHIFT exactly,
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) for
    x = p 2^SPLIT_SHIFT.  A part times a bf16 value is exact in f32, so
    the three products summed in IEEE f32 are p's f32 product but for
    the order of the sum.  wgmma does not sum them so: on an H100 its
    truncating additions left the fold's o past the f32 tolerance
    (PERF.md, Findings), and the kernels take p's products on the CUDA
    cores."""
    x = p.float() * 2.0 ** SPLIT_SHIFT
    hi = x.to(torch.bfloat16)
    mid = (x - hi.float()).to(torch.bfloat16)
    lo = (x - hi.float() - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _p_ds(q, k, v, do, lse, delta, q_off, k_off, causal, scale):
    s = scores_plain(q, k, q_off, k_off, causal, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bchk,bdhk->bhcd", do.float(), v.float())
    ds = ((p * (dp - delta[..., None])) * scale).to(q.dtype).float()
    return p, ds


def ring_fold_bwd_dq_plain(q, k, v, do, lse, delta, dq, q_off, k_off,
                           causal, scale):
    """dq += dS . k (f32), in place."""
    _, ds = _p_ds(q, k, v, do, lse, delta, q_off, k_off, causal, scale)
    dq += torch.einsum("bhcd,bdhk->bhck", ds, k.float())


def ring_fold_bwd_dkdv_plain(q, k, v, do, lse, delta, dk, dv, q_off, k_off,
                             causal, scale):
    """dk += dS^T . q and dv += P^T . f32(dO) (f32), in place."""
    p, ds = _p_ds(q, k, v, do, lse, delta, q_off, k_off, causal, scale)
    dk += torch.einsum("bhcd,bchk->bhdk", ds, q.float())
    dv += torch.einsum("bhcd,bchk->bhdk", p, do.float())


# ---------------------------------------------------------------------------
# the wrappers


def _check(q, k, v, do, rows, cols) -> None:
    """q (and do) [B, Cq, H, hd], k and v [B, Ck, H, hd] of one dtype;
    rows: f32 [B, H, Cq]; cols: f32 accumulators [B, H, C, hd]."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"the ring fold takes bf16 or f32, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q, k and v must be [B, C, H, hd]")
    B, Cq, H, hd = q.shape
    for t in (k, v, do):
        if t is None:
            continue
        if t.dtype != q.dtype:
            raise TypeError(f"{t.dtype} != q's {q.dtype}")
        if t.device != q.device:
            raise ValueError("all tensors must be on one device")
    if tuple(v.shape) != tuple(k.shape) or (k.shape[0], k.shape[2],
                                            k.shape[3]) != (B, H, hd):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if do is not None and tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"dO {tuple(do.shape)} != q {tuple(q.shape)}")
    for t, shape in rows + cols:
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"state must be contiguous f32 {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    if Cq == 0 or k.shape[1] == 0:
        raise ValueError("the ring fold needs blocks of at least 1 row")
    if q.device.type == "cuda" and hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the ring fold kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS}, not {hd}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the ring fold runs on cuda or cpu, not "
                         f"{q.device}")


def _kernel_views(*ts):
    """The tensors as the kernels read them: a contiguous last dim (the
    other dims through their strides), base and strides 16-byte multiples
    (what ``tma_ready`` takes: every kernel copies 16 bytes at a time,
    TMA in bf16 at hd 16, 64 and 128, cp.async and 16-byte loads
    elsewhere, the f32 forward, dq and dk/dv at hd 8 among them);
    anything else is copied."""
    return [t if t.stride(-1) == 1 and tma_ready(t)
            else t.clone(memory_format=torch.contiguous_format) for t in ts]


def _strides(ts):
    flat = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch(fn, name, ptrs, strides, q, ck, q_off, k_off, causal,
            scale) -> None:
    B, Cq, H, hd = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, strides, B, Cq, ck, H, hd, _DTYPES[q.dtype],
                int(q_off), int(k_off), int(bool(causal)), float(scale),
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _geometry(q, k):
    B, Cq, H, hd = q.shape
    return (B, H, Cq), (B, H, k.shape[1], hd), (B, H, Cq, hd)


def ring_fold_forward(q, k, v, m, l, o, q_off: int, k_off: int,
                      causal: bool, scale: float) -> bool:
    """Fold the block (k, v) at k_off into the state (m, l, o) of the
    queries q at q_off, in place; False (and no launch) for a wholly
    future block."""
    rows, _, acc = _geometry(q, k)
    _check(q, k, v, None, [(m, rows), (l, rows)], [(o, acc)])
    if not visible(q_off, q.shape[1], k_off, causal):
        ring_fold_forward.skips += 1
        return False
    if q.device.type == "cpu":
        ring_fold_plain(q, k, v, m, l, o, q_off, k_off, causal, scale)
        return True
    q, k, v = _kernel_views(q, k, v)
    _launch(_kernels().trpc_ring_fold_fwd, "ring_fold_fwd",
            [t.data_ptr() for t in (q, k, v, m, l, o)], _strides((q, k, v)),
            q, k.shape[1], q_off, k_off, causal, scale)
    ring_fold_forward.launches += 1
    return True


def ring_fold_backward_dq(q, k, v, do, lse, delta, dq, q_off: int,
                          k_off: int, causal: bool, scale: float) -> bool:
    """dq += the block's dS . k, in place; False for a wholly future
    block."""
    rows, _, acc = _geometry(q, k)
    _check(q, k, v, do, [(lse, rows), (delta, rows)], [(dq, acc)])
    if not visible(q_off, q.shape[1], k_off, causal):
        ring_fold_backward_dq.skips += 1
        return False
    if q.device.type == "cpu":
        ring_fold_bwd_dq_plain(q, k, v, do, lse, delta, dq, q_off, k_off,
                               causal, scale)
        return True
    q, k, v, do = _kernel_views(q, k, v, do)
    _launch(_kernels().trpc_ring_fold_bwd_dq, "ring_fold_bwd_dq",
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dq)],
            _strides((q, k, v, do)), q, k.shape[1], q_off, k_off, causal,
            scale)
    ring_fold_backward_dq.launches += 1
    return True


def ring_fold_backward_dkdv(q, k, v, do, lse, delta, dk, dv, q_off: int,
                            k_off: int, causal: bool, scale: float) -> bool:
    """dk += dS^T . q and dv += P^T . f32(dO), in place; False for a
    wholly future block."""
    rows, kv_acc, _ = _geometry(q, k)
    _check(q, k, v, do, [(lse, rows), (delta, rows)],
           [(dk, kv_acc), (dv, kv_acc)])
    if not visible(q_off, q.shape[1], k_off, causal):
        ring_fold_backward_dkdv.skips += 1
        return False
    if q.device.type == "cpu":
        ring_fold_bwd_dkdv_plain(q, k, v, do, lse, delta, dk, dv, q_off,
                                 k_off, causal, scale)
        return True
    q, k, v, do = _kernel_views(q, k, v, do)
    _launch(_kernels().trpc_ring_fold_bwd_dkdv, "ring_fold_bwd_dkdv",
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)],
            _strides((q, k, v, do)), q, k.shape[1], q_off, k_off, causal,
            scale)
    ring_fold_backward_dkdv.launches += 1
    return True


for _w in (ring_fold_forward, ring_fold_backward_dq, ring_fold_backward_dkdv):
    _w.launches = 0
    _w.skips = 0
del _w
