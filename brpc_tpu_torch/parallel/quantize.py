"""Quantize->dequantize passes of the wire codec formats, on torch
(port of brpc_tpu/parallel/quantize.py; the serving host rail of
serving/kv_cache.py applies them to KV migration bytes).

Formats mirror native/src/codec.cc:
  int8: per-block (256 floats) scale = max|block| / 127, round half to
        even, clamp to [-127, 127]; all-zero/denormal blocks emit scale 0
        and decode to exact zeros.
        Per-element bound of one pass: |err| <= max|block| / 127.
  bf16: round-to-nearest-even truncation to bfloat16.

Denormals: the reference computes under XLA's CPU flush-to-zero, so a
denormal input reads as 0 and a denormal scale is 0.  PyTorch keeps
denormals, so the port flushes both explicitly, which makes the outputs
equal for every finite input.

Inputs may be tensors or numpy arrays; results are tensors of the input's
dtype.
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.ops import quant_codec
from brpc_tpu_torch.ops.quant_codec import BLOCK, blocks, flush


def fake_quant_int8(x, block: int = BLOCK) -> torch.Tensor:
    """dequantize(quantize(x)) along the LAST axis in `block`-float groups
    — the tensor a peer reconstructs after an int8 wire hop.  Shape and
    dtype preserved.  A CUDA tensor goes through the kernel of
    ops/quant_codec.py; a CPU tensor or numpy array through its plain
    version."""
    x = torch.as_tensor(x)
    if x.device.type == "cuda":
        return quant_codec.fake_quant_int8(x, block)
    return quant_codec.fake_quant_int8_plain(x, block)


def fake_quant_bf16(x) -> torch.Tensor:
    """dequantize(quantize(x)) through bfloat16 (round-to-nearest-even)."""
    x = torch.as_tensor(x)
    return x.to(torch.bfloat16).to(x.dtype)


def fake_quant(x, codec: str, block: int = BLOCK):
    """Apply the named codec's quantize->dequantize pass ("none" = x)."""
    if codec in ("", "none"):
        return x
    if codec == "int8":
        return fake_quant_int8(x, block)
    if codec == "bf16":
        return fake_quant_bf16(x)
    raise ValueError(f"unknown tensor codec {codec!r} "
                     f"(none/int8/bf16)")


def int8_error_bound(x, block: int = BLOCK) -> float:
    """Max per-element error of ONE int8 pass over x (max over blocks of
    max|block|/127), as a python float.  For an n-way dequantize-then-
    reduce SUM, per-worker bounds add."""
    b = blocks(flush(torch.as_tensor(x)), block)
    return float(b.abs().amax() / 127.0) + 1e-30
