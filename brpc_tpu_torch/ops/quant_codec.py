"""The int8 codec pass: the hand-written CUDA kernel
(``csrc/quant_codec.cu``) and its plain PyTorch version.

Function (brpc_tpu/parallel/quantize.py:fake_quant_int8, the pass that
``MeshParallelChannel(codec="int8")`` runs on each worker's shard before
the merge, brpc_tpu/parallel/channels.py:679-680): along the LAST axis, in
groups of ``BLOCK`` (256) values of each row, the last group masked,

    flush denormal inputs to zero
    scale = max|group| / 127, a denormal scale flushed to zero
    q     = clamp(round_half_even(x / scale), -127, 127) where scale > 0,
            else 0
    out   = q * scale, in the input's dtype

For bf16 each of those operations is computed in f32 and rounded to bf16,
as PyTorch does.  ``fake_quant_int8`` launches the kernel for a CUDA
tensor (and raises if it cannot); for a CPU tensor it runs
:func:`fake_quant_int8_plain`, which nothing on the CUDA path calls.
``fake_quant_int8.launches`` counts the kernel's launches.

Bound on the card: memory — each value is read once and written once,
with a few operations per value.  The kernel gives each (row, group) one
warp, each lane 8 values in registers, and finds the group's absmax by
shuffles, so the pass reads and writes the tensor once.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from brpc_tpu_torch import _native

BLOCK = 256  # floats per int8 scale block (== codec.h kInt8BlockFloats)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_lib = None
_lib_lock = threading.Lock()


def _kernels() -> ctypes.CDLL:
    """The kernel library, built with nvcc at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            L = ctypes.CDLL(_native.build_kernels())
            c = ctypes
            L.trpc_fake_quant_int8.argtypes = (
                [c.c_void_p] * 2 + [c.c_longlong] * 2 + [c.c_int, c.c_void_p])
            L.trpc_fake_quant_int8.restype = c.c_int
            _lib = L
    return _lib


def blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """x [..., n] -> [..., ceil(n / block), block], the tail zero-padded."""
    n = x.shape[-1]
    pad = (-n) % block
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], (n + pad) // block, block)


def flush(x: torch.Tensor) -> torch.Tensor:
    """Denormals to zero, as the reference's flush-to-zero does."""
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x.abs() < tiny, torch.zeros_like(x), x)


def fake_quant_int8_plain(x: torch.Tensor, block: int = BLOCK):
    """dequantize(quantize(x)) along the last axis in `block`-value
    groups.  The divisor 127 is a tensor on x's device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which is not
    the reference's division."""
    n = x.shape[-1]
    b = blocks(flush(x), block)
    scale = flush(b.abs().amax(dim=-1, keepdim=True)
                  / torch.tensor(127.0, dtype=x.dtype, device=x.device))
    live = scale > 0.0
    q = torch.where(
        live,
        torch.clamp(torch.round(b / torch.where(live, scale,
                                                torch.ones_like(scale))),
                    -127, 127),
        torch.zeros_like(b))
    out = (q * scale).reshape(*x.shape[:-1], -1)[..., :n]
    return out.to(x.dtype)


def fake_quant_int8(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """The int8 codec pass of x (f32 or bf16, at least 1-D); a new tensor
    of x's shape and dtype."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fake_quant_int8 takes float32 or bfloat16, "
                         f"not {x.dtype}")
    if x.dim() == 0:
        raise ValueError("fake_quant_int8 takes a tensor of at least 1 dim")
    if x.device.type == "cpu":
        return fake_quant_int8_plain(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"fake_quant_int8 runs on cuda or cpu, not "
                         f"{x.device}")
    if block != BLOCK:
        raise ValueError(f"the fake_quant_int8 kernel takes blocks of "
                         f"{BLOCK}, not {block}")
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.shape[-1]
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernels().trpc_fake_quant_int8(
            x.data_ptr(), out.data_ptr(), x.numel() // n, n,
            _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fake_quant_int8 kernel launch failed: "
                           f"cudaError {rc}")
    fake_quant_int8.launches += 1
    return out


fake_quant_int8.launches = 0
