"""Plain LFM2-MoE in PyTorch, f32 with TF32 off: the yardstick the
program's lfm2 outputs are judged by.  Written from HF transformers'
``lfm2_moe`` equations with plain torch operations; it shares no code
with the program.

    layer:  h = x + mixer(rmsnorm(x)); out = h + ffn(rmsnorm(h))
    rmsnorm(x) = x * rsqrt(mean(x^2) + eps) * w
    conv:   B, C, u = chunk(x in_proj, 3); out_proj(C * conv1d(B * u)),
            a depthwise Conv1d of width L (padding L - 1, no bias), the
            first S outputs kept
    attn:   q, k, v projections; RMSNorm over the head dim on q and k;
            rotate-half RoPE at rope_theta; softmax(q k^T / sqrt(hd))
            under a causal mask, KV head j serving query heads j r ..
            j r + r - 1; out_proj
    dense:  w2(silu(w1 x) * w3 x)
    MoE:    s = sigmoid(x router); chosen = topk(s + expert_bias, k);
            weights s[chosen] / (sum + 1e-6) * routed_scale; each chosen
            expert's SwiGLU times its weight, summed
    head:   rmsnorm, then the embedding's transpose

Departures from the published model, as the configuration file states
them: the head is tied to the embedding (the catalog gives no
``tie_word_embeddings``); the router's product is in f32; no dropout;
and this device's share of the experts: an MoE layer computes only the
part of its held experts (``expert_first`` .. + ``experts_held`` of the
``n_experts`` the router scores), as the program does, and the other
experts' part is left out.

On the card each sequence is its own forward and backward (``rows``),
each layer runs under activation checkpointing (its input is kept, the
rest made again in the backward) and the attention a group of heads at a
time under its own, so that an 8k sequence's activations are one layer's
at most and its scores never all held.

``fp8=True`` is the control: every product (the convolution too) takes
its two operands rounded to float8 e4m3 and sums in f32, the next
precision below the configuration's bf16 products.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .gpt2 import exact_f32, fp8_round

HEAD_GROUP = 4     # query heads a checkpointed attention block holds


def _mm(a, b, fp8: bool):
    if fp8:
        a, b = fp8_round(a), fp8_round(b)
    return a @ b


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """x [B, H, T, hd] at positions 0..T-1."""
    T, hd = x.shape[-2], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] \
        * inv[None]
    cos = torch.cat([ang, ang], -1).cos()
    sin = torch.cat([ang, ang], -1).sin()
    half = hd // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def _conv(h, w, p, m, fp8):
    D, L = m["d_model"], m["conv_width"]
    T = h.shape[1]
    b, c, u = _mm(h, w[p + "in_proj"], fp8).chunk(3, -1)
    z = (b * u).transpose(1, 2)                    # [B, D, T]
    k = w[p + "conv"]
    if fp8:
        z, k = fp8_round(z), fp8_round(k)
    y = F.conv1d(z, k, padding=L - 1, groups=D)[..., :T].transpose(1, 2)
    return _mm(c * y, w[p + "out_proj"], fp8)


def _heads(q, k, v, fp8):
    """Causal softmax attention of q over k, v [B, G, T, hd]."""
    T, hd = q.shape[-2], q.shape[-1]
    s = _mm(q, k.transpose(-1, -2), fp8) / math.sqrt(hd)
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return _mm(p, v, fp8)


def _attn(h, w, p, m, fp8):
    B, T, _ = h.shape
    H, KV = m["n_heads"], m["n_kv_heads"]
    hd, eps = m["d_model"] // H, m["norm_eps"]
    q = _mm(h, w[p + "wq"], fp8).view(B, T, H, hd).transpose(1, 2)
    k = _mm(h, w[p + "wk"], fp8).view(B, T, KV, hd).transpose(1, 2)
    v = _mm(h, w[p + "wv"], fp8).view(B, T, KV, hd).transpose(1, 2)
    q = _rope(_rmsnorm(q, w[p + "q_norm"], eps), m["rope_theta"])
    k = _rope(_rmsnorm(k, w[p + "k_norm"], eps), m["rope_theta"])
    r = H // KV
    outs = []
    for g in range(0, H, HEAD_GROUP):
        kv = torch.arange(g, g + HEAD_GROUP, device=h.device) // r
        args = (q[:, g:g + HEAD_GROUP], k[:, kv], v[:, kv])
        outs.append(checkpoint(_heads, *args, fp8, use_reentrant=False)
                    if torch.is_grad_enabled() else _heads(*args, fp8))
    o = torch.cat(outs, 1).transpose(1, 2).reshape(B, T, H * hd)
    return _mm(o, w[p + "wo"], fp8)


def _swiglu(x, w1, w3, w2, fp8):
    return _mm(F.silu(_mm(x, w1, fp8)) * _mm(x, w3, fp8), w2, fp8)


def _moe(h, w, p, m, fp8):
    """The held experts' part of the MoE layer on h [B, T, D]."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    scores = torch.sigmoid(_mm(x, w[p + "router"], fp8))
    chosen = torch.topk(scores + w[p + "expert_bias"], m["moe_topk"],
                        dim=-1).indices
    wts = scores.gather(-1, chosen)
    wts = wts / (wts.sum(-1, keepdim=True) + 1e-6) * m["routed_scale"]
    out = torch.zeros_like(x)
    e0 = m["expert_first"]
    for j in range(m["experts_held"]):
        tok, slot = (chosen == e0 + j).nonzero(as_tuple=True)
        y = _swiglu(x[tok], w[p + "we1"][j], w[p + "we3"][j],
                    w[p + "we2"][j], fp8)
        out = out.index_add(0, tok, y * wts[tok, slot, None])
    return out.view(shape)


def forward(w: Dict[str, torch.Tensor], tokens: torch.Tensor, m: Dict,
            fp8: bool = False) -> torch.Tensor:
    """tokens [B, T] -> f32 logits [B, T, vocab]; `w` holds the
    parameters and the ``expert_bias`` buffers."""
    x = w["embed"][tokens]
    for i in range(m["n_layers"]):
        x = (checkpoint(_layer, x, w, i, m, fp8, use_reentrant=False)
             if torch.is_grad_enabled() else _layer(x, w, i, m, fp8))
    x = _rmsnorm(x, w["norm_f"], m["norm_eps"])
    return _mm(x, w["embed"].t(), fp8)


def _layer(x, w, i, m, fp8):
    p, eps = f"layers.{i}.", m["norm_eps"]
    mixer = _conv if m["layer_kinds"][i] == "conv" else _attn
    x = x + mixer(_rmsnorm(x, w[p + "mix_norm"], eps), w, p, m, fp8)
    h = _rmsnorm(x, w[p + "ffn_norm"], eps)
    if m["n_experts"] > 0 and i >= m["n_dense_layers"]:
        return x + _moe(h, w, p, m, fp8)
    return x + _swiglu(h, w[p + "w1"], w[p + "w3"], w[p + "w2"], fp8)


def train_steps(w: Dict[str, torch.Tensor], batches: Sequence[torch.Tensor],
                m: Dict, opt: Dict, rows: int, fp8: bool = False,
                keep_rows: Optional[int] = None,
                against: Optional[Dict[str, torch.Tensor]] = None,
                keep_grad1: bool = False) -> Dict:
    """AdamW steps from `w` (its parameters updated in place; the
    ``expert_bias`` buffers left as they are) over `batches` [B, S+1]:
    next-token cross-entropy, the mean over B x S, worked out `rows`
    sequences at a time and summed.  Returns what ``gpt2.train_steps``
    returns, over the parameters alone."""
    b1, b2 = opt["betas"]
    lr, eps, wd = opt["lr"], opt["eps"], opt["weight_decay"]
    fixed = {k: v for k, v in w.items() if k.endswith("expert_bias")}
    params = {k: v.detach().requires_grad_(True) for k, v in w.items()
              if k not in fixed}
    start = {k: v.detach().clone() for k, v in params.items()}
    m1 = {k: torch.zeros_like(v) for k, v in params.items()}
    m2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1, diff, vec = [], {}, {}, {}
    with exact_f32():
        for t, batch in enumerate(batches, start=1):
            if keep_rows is not None:
                batch = batch[:keep_rows]
            B, n = batch.shape[0], batch[:, 1:].numel()
            total = 0.0
            for r in range(0, B, rows):
                blk = batch[r:r + rows]
                logits = forward({**params, **fixed}, blk[:, :-1], m, fp8)
                loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                       blk[:, 1:].reshape(-1),
                                       reduction="sum") / n
                loss.backward()
                total += float(loss.detach())
                del logits, loss
            losses.append(total)
            with torch.no_grad():
                for k, p in params.items():
                    g = p.grad
                    if t == 1:
                        grad1[k] = float(g.norm())
                        if against is not None:
                            diff[k] = float((g - against[k].to(g.device))
                                            .norm())
                        if keep_grad1:
                            vec[k] = g.detach().cpu()
                    m1[k].mul_(b1).add_(g, alpha=1 - b1)
                    m2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    p.mul_(1 - lr * wd)
                    denom = (m2[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                    p.addcdiv_(m1[k], denom, value=-lr / (1 - b1 ** t))
                    p.grad = None
    change = {k: float((params[k].detach() - start[k]).norm())
              for k in params}
    return {"losses": losses, "grad1": grad1, "change": change,
            "grad1_diff": diff, "grad1_vec": vec}
