"""Fused KV append + decode attention: the hand-written CUDA kernel of
the decode step (``csrc/decode_attention.cu``) and its plain PyTorch
version.

Function (brpc_tpu/models/decode.py:178-186, one layer of one step):
write ``k_new[n]`` / ``v_new[n]`` into row ``p[n]`` of the layer's caches
(in place), then attend ``q[n, h]`` over positions ``0..p[n]`` of KV head
``h // (H // KV)`` with scale 1/sqrt(hd) and an f32 softmax; ``o`` comes
back in the working type.

    q                      [N, H, hd]      bf16 or f32
    k_new, v_new           [N, KV, hd]     same type
    k_cache_l, v_cache_l   [N, S, KV, hd]  same type, contiguous
    p                      [N] int32, each in [0, S)

KV == H is the reference's attention (GPT-2); KV < H with H % KV == 0 is
grouped-query attention (LFM2: 32 query heads over 8 KV heads), whose
cache holds the KV heads alone.

``decode_attention`` launches the kernel for CUDA tensors (and raises if
it cannot); for CPU tensors it runs :func:`decode_attention_plain`, which
nothing on the CUDA path calls.  ``decode_attention.launches`` counts the
kernel's launches.  The kernel takes head dims ``KERNEL_HEAD_DIMS`` and
raises at any other; the plain version, which CPU tensors take, any head
dim (as the reference's ``decode_step``).

Bound on the card: memory — the K/V rows of the valid window are read
once and two rows written per (n, KV head).  The kernel splits each
(n, h)'s window over a cluster of eight blocks and merges the eight
partial softmaxes in the same launch; see its source note.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from brpc_tpu_torch import _native

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
KERNEL_HEAD_DIMS = (16, 64, 128)
_MISALIGNED = 716   # cudaErrorMisalignedAddress

_lib = None
_lib_lock = threading.Lock()


def _kernels() -> ctypes.CDLL:
    """The kernel library, built with nvcc at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            L = ctypes.CDLL(_native.build_kernels())
            c = ctypes
            L.trpc_decode_attention_gqa.argtypes = (
                [c.c_void_p] * 7 + [c.c_int] * 6 + [c.c_float, c.c_void_p])
            L.trpc_decode_attention_gqa.restype = c.c_int
            _lib = L
    return _lib


def decode_attention_plain(q, k_new, v_new, k_cache_l, v_cache_l, p):
    """The reference's arithmetic on tensors (decode.py:178-186): scatter,
    then scores over all S positions (the product in the working type,
    divided in f32: JAX promotes it against the numpy scalar
    np.sqrt(hd)), -1e30 outside 0..p, f32 softmax; at KV < H each KV
    head's rows repeated to its query heads."""
    N, S = k_cache_l.shape[0], k_cache_l.shape[1]
    rows = torch.arange(N, device=q.device)
    pl = p.long()
    k_cache_l[rows, pl] = k_new
    v_cache_l[rows, pl] = v_new
    r = q.shape[1] // k_cache_l.shape[2]
    if r > 1:
        k_cache_l = k_cache_l.repeat_interleave(r, dim=2)
        v_cache_l = v_cache_l.repeat_interleave(r, dim=2)
    scores = (torch.einsum("nhk,nshk->nhs", q, k_cache_l).float()
              / math.sqrt(q.shape[-1]))
    valid = torch.arange(S, device=q.device)[None, :] <= pl[:, None]
    scores = torch.where(valid[:, None, :], scores,
                         torch.tensor(-1e30, device=q.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("nhs,nshk->nhk", w, v_cache_l)


def _check(q, k_new, v_new, k_cache_l, v_cache_l, p) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention takes bf16 or f32, got {q.dtype}")
    if q.dim() != 3 or k_cache_l.dim() != 4:
        raise ValueError("q must be [N, H, hd] and the caches "
                         "[N, S, KV, hd]")
    N, H, hd = q.shape
    S, KV = k_cache_l.shape[1], k_cache_l.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not share {KV} KV heads "
                         f"evenly")
    for name, t, shape in (("k_new", k_new, (N, KV, hd)),
                           ("v_new", v_new, (N, KV, hd)),
                           ("k_cache_l", k_cache_l, (N, S, KV, hd)),
                           ("v_cache_l", v_cache_l, (N, S, KV, hd))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if tuple(p.shape) != (N,) or p.dtype != torch.int32:
        raise ValueError("p must be [N] int32")
    tensors = (q, k_new, v_new, k_cache_l, v_cache_l, p)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention takes contiguous tensors")
    if q.device.type == "cuda" and hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the decode_attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, not {hd}")


def decode_attention(q, k_new, v_new, k_cache_l, v_cache_l, p):
    """Append this step's K/V at row p and attend over 0..p; returns o
    [N, H, hd].  Updates the caches in place.  Query head h reads KV head
    h // (H // KV)."""
    _check(q, k_new, v_new, k_cache_l, v_cache_l, p)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, k_cache_l, v_cache_l,
                                      p)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    o = torch.empty_like(q)
    N, H, hd = q.shape
    if N == 0:
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernels().trpc_decode_attention_gqa(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache_l.data_ptr(), v_cache_l.data_ptr(), p.data_ptr(),
            o.data_ptr(), N, k_cache_l.shape[1], H, k_cache_l.shape[2], hd,
            _DTYPES[q.dtype], math.sqrt(hd), stream)
    if rc != 0:
        why = (" (a tensor is not 16-byte aligned)" if rc == _MISALIGNED
               else "")
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {rc}{why}")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
