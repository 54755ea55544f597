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

The layer is written once, as halves that :func:`apply` (training), the
prefill and the decode step (models/decode.py) put together: the mixer's
input (:func:`mixer_in`), the conv mixer up to its convolution
(:func:`conv_in`), the convolution over a sequence (:func:`conv_seq`) or
one position after a conv state (:func:`conv_step`), its output
(:func:`conv_out`); attention's q, k, v at given positions (:func:`qkv`)
and its output product (:func:`attn_out`); the FFN (:func:`ffn`, rows
that are not valid routing to no expert); the head (:func:`logits`).  A
serving model holds its product weights in the products' dtype
(:func:`hold_products`).
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


def rope(x, theta: float, pos=None):
    """Rotate-half RoPE of x [..., H, hd] (f32) at the positions ``pos``
    (x's leading dims but the heads, or dims they broadcast to; default
    0..S-1 along dim 1 of x [B, S, H, hd])."""
    hd = x.shape[-1]
    if pos is None:
        pos = torch.arange(x.shape[1], device=x.device)
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = pos.to(torch.float32)[..., None] * inv
    ang = torch.cat([ang, ang], -1).unsqueeze(-2)
    x1, x2 = x.chunk(2, -1)
    return x * ang.cos() + torch.cat([-x2, x1], -1) * ang.sin()


def _mm(x, w, dt):
    return x @ w.to(dt)


# the product weights: held in the products' dtype by a serving model
PRODUCT_LEAVES = ("in_proj", "conv", "out_proj", "wq", "wk", "wv", "wo",
                  "w1", "w3", "w2", "we1", "we3", "we2")


def hold_products(model, cfg) -> None:
    """Cast every product weight, experts included, to the products'
    dtype in place, once, and hold the tied head as the embedding's cast
    (the buffer ``head``): the same bits as the cast at each use, which
    then casts nothing.  The embedding table, which the lookup reads in
    f32, the norm gains, the routers and ``expert_bias`` stay in f32.
    Every tensor kept, f32 or cast, owns its storage, so that weights
    made as views of one large draw free it.  A model whose embedding
    changes afterwards (training) keeps a stale head."""
    with torch.no_grad():
        products = {id(getattr(lp, n)) for lp in model.layers
                    for n in PRODUCT_LEAVES if hasattr(lp, n)}
        for t in list(model.parameters()) + list(model.buffers()):
            if id(t) in products:
                t.data = t.data.to(cfg.dtype)
            if t.untyped_storage().nbytes() > t.nbytes:
                t.data = t.data.clone()
        model.register_buffer("head", model.embed.to(cfg.dtype),
                              persistent=False)


def kind_index(cfg, i: int) -> int:
    """Layer i's index among the layers of its kind."""
    return cfg.layer_kinds[:i].count(cfg.layer_kinds[i])


def moe_index(cfg, i: int) -> int:
    """MoE layer i's index among the MoE layers."""
    return sum(cfg.is_moe(j) for j in range(i))


def mixer_in(x, lp, cfg):
    """The mixer's input: the f32 RMSNorm of x, cast to the products'
    dtype."""
    return rmsnorm(x, lp.mix_norm, cfg.norm_eps).to(cfg.dtype)


def conv_in(h, lp, cfg):
    """The conv mixer up to its convolution: (c, z = b * u) of h [..., D]
    in the products' dtype."""
    b, c, u = _mm(h, lp.in_proj, cfg.dtype).chunk(3, -1)
    return c, b * u


def _taps(lp, cfg):
    w = lp.conv.to(cfg.dtype)[:, 0]               # [D, width]
    return w, w.shape[-1]


def conv_seq(z, lp, cfg):
    """The causal depthwise convolution of z [B, S, D] along S, zeros
    before position 0."""
    w, width = _taps(lp, cfg)
    S = z.shape[1]
    y = z * w[:, width - 1]
    for j in range(1, width):                     # z[t - j]
        y = y + F.pad(z, (0, 0, j, 0))[:, :S] * w[:, width - 1 - j]
    return y


def conv_step(z, state, lp, cfg):
    """One position of the convolution: z [N, D] after the state [N,
    width - 1, D] of the positions before it (oldest first), as
    :func:`conv_seq`'s sum, in its order -> (y [N, D], the state shifted
    by one: its last width - 2 rows, then z)."""
    w, width = _taps(lp, cfg)
    y = z * w[:, width - 1]
    for j in range(1, width):      # state[width - 1 - j] = z[t - j]
        y = y + state[:, width - 1 - j] * w[:, width - 1 - j]
    return y, torch.cat([state[:, 1:], z[:, None]], 1)


def conv_tail(z, n, cfg):
    """The conv state after position n - 1 of z [B, S, D]: rows n -
    width + 1 .. n - 1, zeros before position 0 -> [B, width - 1, D];
    `n` an int or a 0-d or [1] int64 tensor (no host read)."""
    keep = cfg.conv_width - 1
    zp = F.pad(z, (0, 0, keep, 0))                # zp[t + keep] = z[t]
    at = torch.arange(keep, device=z.device) + n
    return zp.index_select(1, at)


def conv_out(c, y, lp, cfg):
    return _mm(c * y, lp.out_proj, cfg.dtype)


def short_conv(x, lp, cfg):
    """The gated short-convolution mixer on x [B, S, D] in the products'
    dtype."""
    with record_function("short_conv"):
        c, z = conv_in(x, lp, cfg)
        return conv_out(c, conv_seq(z, lp, cfg), lp, cfg)


def qkv(x, lp, cfg, pos=None):
    """Attention up to the scores on x [..., D] in the products' dtype:
    q [..., H, hd], k and v [..., KV, hd], q and k RMSNormed over the
    head dim in f32 and rotated at ``pos`` (see :func:`rope`), all three
    in the products' dtype."""
    dt, hd, eps = cfg.dtype, cfg.head_dim, cfg.norm_eps
    lead = x.shape[:-1]
    q = _mm(x, lp.wq, dt).view(*lead, cfg.n_heads, hd)
    k = _mm(x, lp.wk, dt).view(*lead, cfg.kv_heads, hd)
    v = _mm(x, lp.wv, dt).view(*lead, cfg.kv_heads, hd)
    q = rope(rmsnorm(q, lp.q_norm, eps), cfg.rope_theta, pos).to(dt)
    k = rope(rmsnorm(k, lp.k_norm, eps), cfg.rope_theta, pos).to(dt)
    return q, k, v


def repeat_kv(t, cfg):
    """KV heads [..., KV, hd] repeated to the query heads: KV head j
    serves query heads j r .. j r + r - 1."""
    r = cfg.n_heads // cfg.kv_heads
    return t.repeat_interleave(r, dim=-2) if r > 1 else t


def attn_out(o, lp, cfg):
    """The output product of the attention's o [..., H, hd]."""
    return _mm(o.flatten(-2), lp.wo, cfg.dtype)


def attention(x, lp, cfg):
    """QK-normed GQA with RoPE on x [B, S, D] in the products' dtype."""
    with record_function("attention"):
        q, k, v = qkv(x, lp, cfg)
        o = causal_attention(q, repeat_kv(k, cfg), repeat_kv(v, cfg))
        return attn_out(o, lp, cfg)


def swiglu_ffn(x, lp, cfg):
    dt = cfg.dtype
    return _mm(moe.swiglu(_mm(x, lp.w1, dt), _mm(x, lp.w3, dt)), lp.w2, dt)


def moe_ffn(h, lp, cfg, stats, slot: int, valid=None):
    """The routed experts on the f32 norm output h [..., D]: the router
    in f32, the held experts' products in the products' dtype.  Rows
    where ``valid`` (h's leading dims, bool) is False route to no expert:
    they are neither computed nor counted, and their output is 0."""
    dt, k = cfg.dtype, cfg.moe_topk
    shape = h.shape
    h = h.reshape(-1, shape[-1])
    with record_function("moe_route"):
        scores = torch.sigmoid(h @ lp.router)
        topi = torch.topk(scores + lp.expert_bias, k, dim=-1).indices
        topw = scores.gather(-1, topi)
        topw = topw / (topw.sum(-1, keepdim=True) + 1e-6) * cfg.routed_scale
        if valid is not None:       # an id outside every held range
            topi = torch.where(valid.reshape(-1, 1), topi, cfg.n_experts)
    out = moe.held_experts(h.to(dt), topw, topi, cfg.expert_first,
                           moe.swiglu, lp.we1.to(dt), lp.we3.to(dt),
                           lp.we2.to(dt), stats, slot)
    return out.view(shape)


def ffn(model, x, i, cfg, valid=None):
    """Layer i after its mixer: x + the dense or routed FFN of the f32
    RMSNorm of x (``valid`` as :func:`moe_ffn`'s)."""
    lp = model.layers[i]
    h = rmsnorm(x, lp.ffn_norm, cfg.norm_eps)
    if cfg.is_moe(i):
        return x + moe_ffn(h, lp, cfg, model.expert_stats,
                           moe_index(cfg, i), valid)
    return x + swiglu_ffn(h.to(cfg.dtype), lp, cfg)


def logits(model, x, cfg):
    """The final f32 RMSNorm and the tied head: f32 logits."""
    x = rmsnorm(x, model.norm_f, cfg.norm_eps)
    head = getattr(model, "head", None)
    if head is None:
        head = model.embed.to(cfg.dtype)
    return (x.to(cfg.dtype) @ head.t()).float()


def apply(model, tokens, cfg):
    """tokens [B, S] -> logits [B, S, vocab] f32."""
    x = model.embed[tokens]
    for i, lp in enumerate(model.layers):
        h = mixer_in(x, lp, cfg)
        if cfg.layer_kinds[i] == "conv":
            x = x + short_conv(h, lp, cfg)
        else:
            x = x + attention(h, lp, cfg)
        x = ffn(model, x, i, cfg)
    return logits(model, x, cfg)
