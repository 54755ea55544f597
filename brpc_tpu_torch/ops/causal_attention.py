"""Causal self-attention over a whole sequence, forward and backward: the
hand-written CUDA kernels (``csrc/causal_attention*.cu``) behind a
``torch.autograd.Function``, and the plain PyTorch version beside them.

Function (brpc_tpu/models/transformer.py:197-203, the gather branch that
training differentiates; the same lines as prefill, decode.py:126-131)::

    q, k, v  [B, S, H, hd]  bf16 or f32, the last dim contiguous
    o        [B, S, H, hd]  same type:
    s = f32(q . k) / sqrt(hd), -1e30 above the diagonal, f32 softmax over
    keys, weights rounded to the working type, o = weights . v

``causal_attention`` runs :class:`CausalAttention` for CUDA tensors (it
launches the kernels or raises) and :func:`causal_attention_plain` for
CPU tensors; nothing on the CUDA path calls the plain version.  The plain
version is the reference's arithmetic op by op, so autograd of it is the
reference's ``jax.grad``.

Three kernels, one wrapper each, and each wrapper counts its launches
(``<wrapper>.launches``):

* :func:`causal_attention_forward`  o and the row log-sum-exp [B, H, S];
* :func:`causal_attention_backward_dq`  dq and the softmax backward's
  row sums D = sum_t p dW [B, H, S] (launched first);
* :func:`causal_attention_backward_dkdv`  dk and dv, from D.

In bf16 all three run on the tensor cores
(``csrc/causal_attention_sm90.cu``: wgmma, TMA).  In f32 all three are
kernels on the CUDA cores (``csrc/causal_attention_f32.cu``: register
tiles, cp.async): the forward in one pass, dq in two (D taken exactly
first), dk/dv on transposed tiles; the C entries of
``csrc/causal_attention.cu`` choose by dtype.  TMA and cp.async copy 16
bytes at a time, so the wrapper copies a view whose base or strides are
not 16-byte multiples.

Head dims ``KERNEL_HEAD_DIMS`` on the card; the plain version takes any.
Bound and design: see the kernel sources' notes.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch
from torch.autograd.function import once_differentiable

from brpc_tpu_torch import _native

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
KERNEL_HEAD_DIMS = (16, 64, 128)

_lib = None
_lib_lock = threading.Lock()


def _kernels() -> ctypes.CDLL:
    """The kernel library, built with nvcc at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            L = ctypes.CDLL(_native.build_kernels())
            c = ctypes
            tail = ([c.POINTER(c.c_longlong)] + [c.c_int] * 5
                    + [c.c_float, c.c_void_p])
            L.trpc_causal_attention_fwd.argtypes = [c.c_void_p] * 5 + tail
            L.trpc_causal_attention_bwd_dq.argtypes = [c.c_void_p] * 7 + tail
            L.trpc_causal_attention_bwd_dkdv.argtypes = (
                [c.c_void_p] * 8 + tail)
            for fn in (L.trpc_causal_attention_fwd,
                       L.trpc_causal_attention_bwd_dq,
                       L.trpc_causal_attention_bwd_dkdv):
                fn.restype = c.c_int
            _lib = L
    return _lib


def causal_attention_plain(q, k, v):
    """The reference's arithmetic (transformer.py:198-203) on tensors: the
    product in the working type, then f32 (JAX promotes it against the
    numpy scalar np.sqrt(hd)), the -1e30 mask, the f32 softmax, the
    weights back in the working type."""
    S, hd = q.shape[1], q.shape[-1]
    scores = torch.einsum("bshk,bthk->bhst", q, k).float() / math.sqrt(hd)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(-1e30, device=q.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", w, v)


def _check(*ts) -> None:
    q = ts[0]
    if q.dtype not in _DTYPES:
        raise TypeError(f"causal_attention takes bf16 or f32, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError("q, k and v must be [B, S, H, hd]")
    for t in ts[1:]:
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"shape {tuple(t.shape)} != q's "
                             f"{tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{t.dtype} != q's {q.dtype}")
        if t.device != q.device:
            raise ValueError("all tensors must be on one device")
    if q.shape[1] == 0:
        raise ValueError("causal_attention needs S >= 1")
    if q.device.type == "cuda" and q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the causal_attention kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS}, not {q.shape[-1]}")


def tma_ready(t) -> bool:
    """TMA's rule for the tensor-core kernels (these and the ring fold's),
    which the f32 CUDA-core kernels' 16-byte cp.async copies share (the
    causal forward, dq and dk/dv, the fold's forward and dk/dv): a
    16-byte aligned base, and positive strides of 16-byte multiples for
    every dim longer than 1."""
    if t.data_ptr() % 16:
        return False
    return all(st > 0 and st * t.element_size() % 16 == 0
               for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _cuda(*ts):
    """The tensors as the kernels read them, after the checks: a
    contiguous last dim (the other dims are read through their strides)
    and what TMA and cp.async take (``tma_ready``); anything else is
    copied."""
    _check(*ts)
    if ts[0].device.type != "cuda":
        raise ValueError(f"the causal_attention kernels run on cuda, not "
                         f"{ts[0].device}")
    return [t if t.stride(-1) == 1 and tma_ready(t)
            else t.clone(memory_format=torch.contiguous_format) for t in ts]


def _strides(ts):
    flat = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch(fn, name, ptrs, strides, q) -> None:
    B, S, H, hd = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, strides, B, S, H, hd, _DTYPES[q.dtype],
                math.sqrt(hd), stream)
    if rc < 0:
        which, code = divmod(-rc, 1000)
        raise RuntimeError(f"{name}: the driver refused the TMA map of "
                           f"{('q', 'k', 'v', 'dO')[which - 1]} "
                           f"(CUresult {code})")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _row_stats(q) -> torch.Tensor:
    B, S, H, _ = q.shape
    return torch.empty((B, H, S), dtype=torch.float32, device=q.device)


def causal_attention_forward(q, k, v):
    """Launch the forward kernel: (o [B, S, H, hd], lse [B, H, S] f32)."""
    q, k, v = _cuda(q, k, v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = _row_stats(q)
    _launch(_kernels().trpc_causal_attention_fwd, "causal_attention_fwd",
            [t.data_ptr() for t in (q, k, v, o, lse)], _strides((q, k, v)), q)
    causal_attention_forward.launches += 1
    return o, lse


def causal_attention_backward_dq(q, k, v, do, lse):
    """Launch the dq kernel: (dq, D [B, H, S] f32 = sum_t p dW)."""
    q, k, v, do = _cuda(q, k, v, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = _row_stats(q)
    _launch(_kernels().trpc_causal_attention_bwd_dq, "causal_attention_bwd_dq",
            [t.data_ptr() for t in (q, k, v, do, lse, dq, delta)],
            _strides((q, k, v, do)), q)
    causal_attention_backward_dq.launches += 1
    return dq, delta


def causal_attention_backward_dkdv(q, k, v, do, lse, delta):
    """Launch the dk/dv kernel, given the dq kernel's D: (dk, dv)."""
    q, k, v, do = _cuda(q, k, v, do)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(_kernels().trpc_causal_attention_bwd_dkdv,
            "causal_attention_bwd_dkdv",
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)],
            _strides((q, k, v, do)), q)
    causal_attention_backward_dkdv.launches += 1
    return dk, dv


causal_attention_forward.launches = 0
causal_attention_backward_dq.launches = 0
causal_attention_backward_dkdv.launches = 0


class CausalAttention(torch.autograd.Function):
    """The kernels under autograd: the forward kernel, then in the
    backward the dq kernel (which also writes D) and the dk/dv kernel."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = causal_attention_forward(q, k, v)
        ctx.save_for_backward(q, k, v, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, delta = causal_attention_backward_dq(q, k, v, do, lse)
        dk, dv = causal_attention_backward_dkdv(q, k, v, do, lse, delta)
        return dq, dk, dv


def causal_attention(q, k, v):
    """Causal attention of q over k, v [B, S, H, hd] -> o [B, S, H, hd];
    differentiable on both devices."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return CausalAttention.apply(q, k, v)
