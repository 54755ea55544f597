"""LFM2's block family (HF transformers ``lfm2_moe``): gated short
convolutions and grouped-query attention, dense SwiGLU and routed MoE
feed-forwards, in the port's idiom (f32 parameters, f32 norms, bf16
products, the hand-written causal-attention kernels).

Each layer is ``h = x + mixer(rmsnorm(x)); out = h + ffn(rmsnorm(h))``;
then a final RMSNorm and the head tied to ``embed``.

* ``rmsnorm(x) = x * rsqrt(mean(x^2) + eps) * w`` in f32.
* Conv mixer (``cfg.layer_kinds[i] == "conv"``): ``B, C, u =
  chunk(x in_proj, 3)``; ``y = (C * conv(B * u)) out_proj`` with a
  causal depthwise convolution of width ``cfg.conv_width`` (weights
  [D, 1, width] as HF's ``nn.Conv1d``, padding width - 1, the first S
  outputs kept): ``conv(z)[t] = sum_j w[:, 0, j] z[t + j - width + 1]``.
* Attention (``"attn"``): q, k, v projections (``n_heads`` /
  ``n_kv_heads`` heads of ``head_dim``), RMSNorm over the head dim on q
  and k, rotate-half RoPE at ``rope_theta`` over positions 0..S-1, the
  KV heads repeated to the query heads (KV head j serves query heads
  j r .. j r + r - 1), ``ops.causal_attention``, ``out_proj``.
* FFN: ``w2(silu(w1 x) * w3 x)``, dense (width ``d_ff``) in the first
  ``n_dense_layers`` layers, else the routed experts (width
  ``d_expert``, :mod:`moe`): an f32 router, selection by
  ``topk(sigmoid(logits) + expert_bias)``, weights the chosen
  sigmoids over their sum + 1e-6 times ``routed_scale``.  The layer holds
  experts ``expert_first .. expert_first + experts_held`` of
  ``n_experts``; ``expert_bias`` is a buffer the step does not train.

Leaves are held per layer (``layers.<i>.<name>``), not stacked over the
layers: a stacked leaf's ``[i]`` costs a full-size gradient add per use
in the backward.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from brpc_tpu_torch.models import moe
from brpc_tpu_torch.ops.causal_attention import causal_attention


def leaf_shapes(cfg, i: int) -> dict:
    """{name: (shape, fan_in)} of layer i's parameters (norms: fan_in
    None, initialised to ones)."""
    D, hd = cfg.d_model, cfg.head_dim
    out = {"mix_norm": ((D,), None), "ffn_norm": ((D,), None)}
    if cfg.layer_kinds[i] == "conv":
        out.update(in_proj=((D, 3 * D), D),
                   conv=((D, 1, cfg.conv_width), cfg.conv_width),
                   out_proj=((D, D), D))
    else:
        H, KV = cfg.n_heads, cfg.kv_heads
        out.update(wq=((D, H * hd), D), wk=((D, KV * hd), D),
                   wv=((D, KV * hd), D), wo=((H * hd, D), H * hd),
                   q_norm=((hd,), None), k_norm=((hd,), None))
    if cfg.is_moe(i):
        E, Eh, Fe = cfg.n_experts, cfg.held, cfg.d_expert
        out.update(router=((D, E), D), we1=((Eh, D, Fe), D),
                   we3=((Eh, D, Fe), D), we2=((Eh, Fe, D), Fe))
    else:
        out.update(w1=((D, cfg.d_ff), D), w3=((D, cfg.d_ff), D),
                   w2=((cfg.d_ff, D), cfg.d_ff))
    return out


class Layer(nn.Module):
    """One layer's leaves as attributes; an MoE layer also holds the
    buffer ``expert_bias`` [n_experts]."""

    def __init__(self, cfg, i: int, device):
        super().__init__()
        for name, (shape, _) in leaf_shapes(cfg, i).items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape, device=device)))
        if cfg.is_moe(i):
            self.register_buffer("expert_bias",
                                 torch.zeros(cfg.n_experts, device=device))


def init_params(model, generator: torch.Generator, cfg) -> None:
    """normal / sqrt(fan_in) for every product weight and the embedding,
    ones for the norms, ``expert_bias`` normal x 0.05; drawn on the
    generator's device and copied."""
    gdev = generator.device

    def draw(t, scale):
        t.copy_(torch.randn(t.shape, generator=generator, device=gdev)
                * scale)

    with torch.no_grad():
        draw(model.embed, 1 / math.sqrt(cfg.d_model))
        model.norm_f.fill_(1.0)
        for i, layer in enumerate(model.layers):
            for name, (_, fan_in) in leaf_shapes(cfg, i).items():
                p = getattr(layer, name)
                if fan_in is None:
                    p.fill_(1.0)
                else:
                    draw(p, 1 / math.sqrt(fan_in))
            if cfg.is_moe(i):
                draw(layer.expert_bias, 0.05)


def rmsnorm(x, w, eps: float):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """Rotate-half RoPE of x [B, S, H, hd] (f32) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
        * inv[None]
    ang = torch.cat([ang, ang], -1)[None, :, None]
    x1, x2 = x.chunk(2, -1)
    return x * ang.cos() + torch.cat([-x2, x1], -1) * ang.sin()


def _mm(x, w, dt):
    return x @ w.to(dt)


def short_conv(x, lp, cfg):
    """The gated short-convolution mixer on x [B, S, D] in the products'
    dtype."""
    dt = cfg.dtype
    with record_function("short_conv"):
        b, c, u = _mm(x, lp.in_proj, dt).chunk(3, -1)
        z = b * u
        w = lp.conv.to(dt)[:, 0]                  # [D, width]
        width = w.shape[-1]
        y = z * w[:, width - 1]
        for j in range(1, width):                 # z[t - j]
            y = y + F.pad(z[:, :-j], (0, 0, j, 0)) * w[:, width - 1 - j]
        return _mm(c * y, lp.out_proj, dt)


def attention(x, lp, cfg):
    """QK-normed GQA with RoPE on x [B, S, D] in the products' dtype."""
    dt, hd = cfg.dtype, cfg.head_dim
    B, S, _ = x.shape
    with record_function("attention"):
        q = _mm(x, lp.wq, dt).view(B, S, cfg.n_heads, hd)
        k = _mm(x, lp.wk, dt).view(B, S, cfg.kv_heads, hd)
        v = _mm(x, lp.wv, dt).view(B, S, cfg.kv_heads, hd)
        q = rope(rmsnorm(q, lp.q_norm, cfg.norm_eps), cfg.rope_theta).to(dt)
        k = rope(rmsnorm(k, lp.k_norm, cfg.norm_eps), cfg.rope_theta).to(dt)
        r = cfg.n_heads // cfg.kv_heads
        if r > 1:
            k = k.repeat_interleave(r, dim=2)
            v = v.repeat_interleave(r, dim=2)
        o = causal_attention(q, k, v)
        return _mm(o.reshape(B, S, cfg.n_heads * hd), lp.wo, dt)


def swiglu_ffn(x, lp, cfg):
    dt = cfg.dtype
    return _mm(moe.swiglu(_mm(x, lp.w1, dt), _mm(x, lp.w3, dt)), lp.w2, dt)


def moe_ffn(h, lp, cfg, stats, slot: int):
    """The routed experts on the f32 norm output h [B, S, D]: the router
    in f32, the held experts' products in the products' dtype."""
    dt, k = cfg.dtype, cfg.moe_topk
    shape = h.shape
    h = h.reshape(-1, shape[-1])
    with record_function("moe_route"):
        scores = torch.sigmoid(h @ lp.router)
        topi = torch.topk(scores + lp.expert_bias, k, dim=-1).indices
        topw = scores.gather(-1, topi)
        topw = topw / (topw.sum(-1, keepdim=True) + 1e-6) * cfg.routed_scale
    out = moe.held_experts(h.to(dt), topw, topi, cfg.expert_first,
                           moe.swiglu, lp.we1.to(dt), lp.we3.to(dt),
                           lp.we2.to(dt), stats, slot)
    return out.view(shape)


def apply(model, tokens, cfg):
    """tokens [B, S] -> logits [B, S, vocab] f32."""
    dt, eps = cfg.dtype, cfg.norm_eps
    x = model.embed[tokens]
    slot = 0
    for i, lp in enumerate(model.layers):
        h = rmsnorm(x, lp.mix_norm, eps).to(dt)
        if cfg.layer_kinds[i] == "conv":
            x = x + short_conv(h, lp, cfg)
        else:
            x = x + attention(h, lp, cfg)
        h = rmsnorm(x, lp.ffn_norm, eps)
        if cfg.is_moe(i):
            x = x + moe_ffn(h, lp, cfg, model.expert_stats, slot)
            slot += 1
        else:
            x = x + swiglu_ffn(h.to(dt), lp, cfg)
    x = rmsnorm(x, model.norm_f, eps)
    return (x.to(dt) @ model.embed.to(dt).t()).float()
