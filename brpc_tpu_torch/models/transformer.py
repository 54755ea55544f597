"""Decoder-only transformer LM on PyTorch — port of the single-device
part of brpc_tpu/models/transformer.py, dense and MoE blocks.

Parameters keep the reference's tree names and layouts, so a checkpoint
or a parameter tree moves between the two by name
(:func:`brpc_tpu_torch.weights.params_from_jax`):

    embed [V, D]   pos [S, D]   ln_f.{g, b} [D]
    blocks.{ln1_g, ln1_b, ln2_g, ln2_b} [L, D]
    blocks.{wq, wk, wv} [L, D, H, hd]   blocks.wo [L, H, hd, D]
    blocks.w1 [L, D, F]   blocks.w2 [L, F, D]
    moe.router [n_moe, D, E]   moe.we1 [n_moe, E, D, F]
    moe.we2 [n_moe, E, F, D]   (stacked over the MoE layers only)

Parameters are f32; the products run in ``cfg.dtype`` (bf16 by default)
with f32 layernorm, f32 softmax and f32 logits, as in the reference.
Numerics the port keeps on purpose:

* GELU is the tanh approximation (``jax.nn.gelu``'s default), not
  PyTorch's erf default.
* Attention scores are computed in ``cfg.dtype``, then divided by
  sqrt(hd) in f32 (JAX promotes them against the numpy scalar) before
  the -1e30 causal mask and the softmax; the weights go back to
  ``cfg.dtype`` before the product with V.  On the card this is the
  hand-written kernel ``ops.causal_attention``, forward and backward.
* MoE blocks are the reference's dense top-k switch: every expert runs
  on every token, weighted by the renormalised top-k gate.
* The logits use the tied ``embed``.

:func:`apply` carries gradients (training differentiates it); the
inference paths (``decode.prefill``, ``decode.decode_step``) run under
``torch.no_grad()``.  The reference's per-block ``jax.checkpoint`` is a
memory policy that changes no number and is not ported.

Not ported here: the sharding constraints (one device) and the
ring/Ulysses attention paths.  The reference takes those only on a mesh
with an ``sp`` axis larger than 1 and runs gather attention otherwise;
the port's functions take no mesh, so a ring or Ulysses config runs
gather attention here, as the reference does without a mesh.  Every
entry point takes an explicit ``device`` and runs on ``cuda`` unless the
caller asks for ``cpu``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from brpc_tpu_torch.ops.causal_attention import causal_attention


@dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 1024
    n_experts: int = 0       # 0 = dense-only
    moe_every: int = 2
    moe_topk: int = 1
    dtype: Any = torch.bfloat16
    attn_impl: str = "gather"

    def __post_init__(self):
        if self.attn_impl not in ("gather", "ring", "ulysses"):
            raise ValueError(
                f"attn_impl must be gather|ring|ulysses, "
                f"got {self.attn_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def is_moe(self, layer: int) -> bool:
        return self.n_experts > 0 and self.moe_every > 0 and \
            (layer % self.moe_every == self.moe_every - 1)


def resolve_device(device) -> torch.device:
    """An explicit device; ``cuda`` without a card raises rather than
    running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


class TransformerLM(nn.Module):
    """The parameter tree as a module (no forward: :func:`apply`,
    ``decode.prefill`` and ``decode.decode_step`` are functions over it,
    as in the reference)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        L, D, H, hd, F_ = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.head_dim, cfg.d_ff)

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        self.cfg = cfg
        self.embed = p(cfg.vocab, D)
        self.pos = p(cfg.max_seq, D)
        self.ln_f = nn.ParameterDict({"g": p(D), "b": p(D)})
        self.blocks = nn.ParameterDict({
            "ln1_g": p(L, D), "ln1_b": p(L, D),
            "ln2_g": p(L, D), "ln2_b": p(L, D),
            "wq": p(L, D, H, hd), "wk": p(L, D, H, hd), "wv": p(L, D, H, hd),
            "wo": p(L, H, hd, D),
            "w1": p(L, D, F_), "w2": p(L, F_, D),
        })
        E, n_moe = cfg.n_experts, moe_slot(cfg, L)
        if n_moe:
            self.moe = nn.ParameterDict({
                "router": p(n_moe, D, E),
                "we1": p(n_moe, E, D, F_), "we2": p(n_moe, E, F_, D),
            })


def init(generator: torch.Generator, cfg: ModelConfig,
         device="cuda") -> TransformerLM:
    """Random parameters with the reference's distribution
    (transformer.init: normal / sqrt(fan_in) for every product weight,
    ones/zeros for the norms).  Drawn on the generator's device (the CPU
    for ``torch.Generator()``) and then moved, so one seed gives one
    model on every device.  ``jax.random`` bits cannot be reproduced: to
    compare with the reference, carry its parameters over with
    ``weights.params_from_jax``."""
    model = TransformerLM(cfg, device)
    gdev = generator.device

    def dense(t: torch.Tensor, fan_in: int) -> None:
        draw = torch.randn(t.shape, generator=generator, device=gdev,
                           dtype=torch.float32)
        t.copy_(draw / math.sqrt(fan_in))

    D, F_ = cfg.d_model, cfg.d_ff
    with torch.no_grad():
        dense(model.embed, D)
        dense(model.pos, D)
        model.ln_f["g"].fill_(1.0)
        bl = model.blocks
        bl["ln1_g"].fill_(1.0)
        bl["ln2_g"].fill_(1.0)
        for name in ("wq", "wk", "wv", "wo", "w1"):
            dense(bl[name], D)
        dense(bl["w2"], F_)
        if moe_slot(cfg, cfg.n_layers):
            dense(model.moe["router"], D)
            dense(model.moe["we1"], D)
            dense(model.moe["we2"], F_)
    return model


def moe_slot(cfg: ModelConfig, layer: int) -> int:
    """Index into the stacked MoE leaves for a MoE layer (the number of
    MoE layers for layer = n_layers)."""
    return sum(1 for j in range(layer) if cfg.is_moe(j))


# ---------------------------------------------------------------------------
# forward


def _layernorm(x, g, b):
    x = x.float()
    m = x.mean(-1, keepdim=True)
    v = (x - m).square().mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-5) * g + b


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _causal_attention(q, k, v):
    """q/k/v [B, S, H, hd] in cfg.dtype -> o [B, S, H, hd]: the kernel on
    the card, its plain version on the CPU."""
    return causal_attention(q, k, v)


def _attention(x, lp, i, cfg: ModelConfig):
    xc = x.to(cfg.dtype)
    q = torch.einsum("bsd,dhk->bshk", xc, lp["wq"][i].to(cfg.dtype))
    kk = torch.einsum("bsd,dhk->bshk", xc, lp["wk"][i].to(cfg.dtype))
    v = torch.einsum("bsd,dhk->bshk", xc, lp["wv"][i].to(cfg.dtype))
    o = _causal_attention(q, kk, v)
    return torch.einsum("bshk,hkd->bsd", o.to(cfg.dtype),
                        lp["wo"][i].to(cfg.dtype))


def _ffn(x, lp, i, cfg: ModelConfig):
    xc = x.to(cfg.dtype)
    h = _gelu(torch.einsum("bsd,df->bsf", xc, lp["w1"][i].to(cfg.dtype)))
    return torch.einsum("bsf,fd->bsd", h, lp["w2"][i].to(cfg.dtype))


def _moe_ffn(x, mp, i, cfg: ModelConfig):
    """Dense top-k switch layer (transformer.py:218-236): every expert
    runs on every token, weighted by the renormalised top-k gate."""
    xc = x.to(cfg.dtype)
    logits = torch.einsum("bsd,de->bse", xc, mp["router"][i].to(cfg.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.topk(probs, cfg.moe_topk, dim=-1)
    oh = F.one_hot(topi, cfg.n_experts).to(probs.dtype)
    gates = (oh * topv[..., None]).sum(-2)          # [B, S, E]
    gates = (gates / (gates.sum(-1, keepdim=True) + 1e-9)).to(cfg.dtype)
    h = _gelu(torch.einsum("bsd,edf->besf", xc, mp["we1"][i].to(cfg.dtype)))
    y = torch.einsum("besf,efd->besd", h, mp["we2"][i].to(cfg.dtype))
    return torch.einsum("besd,bse->bsd", y, gates)


def logits_of(model: TransformerLM, x, cfg: ModelConfig):
    """Final norm + tied-embedding logits in f32; x [..., D]."""
    x = _layernorm(x, model.ln_f["g"], model.ln_f["b"])
    return torch.einsum("...d,vd->...v", x.to(cfg.dtype),
                        model.embed.to(cfg.dtype)).float()


def apply(model: TransformerLM, tokens, cfg: Optional[ModelConfig] = None):
    """tokens [B, S] int -> logits [B, S, vocab] f32; differentiable
    with respect to the parameters."""
    cfg = cfg or model.cfg
    tokens = torch.as_tensor(tokens, device=model.embed.device).long()
    S = tokens.shape[1]
    x = model.embed[tokens] + model.pos[:S][None]
    lp = model.blocks
    for i in range(cfg.n_layers):
        x = x + _attention(_layernorm(x, lp["ln1_g"][i], lp["ln1_b"][i]),
                           lp, i, cfg)
        h = _layernorm(x, lp["ln2_g"][i], lp["ln2_b"][i])
        if cfg.is_moe(i):
            x = x + _moe_ffn(h, model.moe, moe_slot(cfg, i), cfg)
        else:
            x = x + _ffn(h, lp, i, cfg)
    return logits_of(model, x, cfg)

