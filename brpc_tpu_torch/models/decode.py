"""Incremental (KV-cached) decode over a TransformerLM — port of
brpc_tpu/models/decode.py.

``prefill()`` runs the causal forward over a prompt once and hands back
the per-layer K/V it produced; ``decode_step()`` then extends N slots by
one token each against the slot cache ``k/v [L, N, S, H, hd]`` in
``cfg.dtype`` plus ``pos [N]`` int32.  The step's attention is the
hand-written kernel ``ops.decode_attention`` (one launch per layer), the
prefill's the hand-written ``ops.causal_attention`` forward.

Unlike the reference's pure functions, the port updates the cache IN
PLACE: ``install``, ``reset_slot`` and ``decode_step`` write into the
cache's tensors and return the same dict.  Dense only, as the reference
(decode.py:16-18): an MoE config raises ``ValueError``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from brpc_tpu_torch.models.transformer import (
    ModelConfig, TransformerLM, _causal_attention, _gelu, _layernorm,
    logits_of, resolve_device)
from brpc_tpu_torch.ops.decode_attention import decode_attention

# K/V serializes host-side as f32 (the wire the KV block plane moves);
# the cache itself stays in cfg.dtype on the device.
KV_WIRE_DTYPE = np.float32


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """Host-wire bytes one token position contributes to a sequence's
    K/V: 2 (k+v) x L x H x head_dim f32 values."""
    return 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim * \
        KV_WIRE_DTYPE().itemsize


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.n_experts > 0:
        raise ValueError("decode path is dense-only (cfg.n_experts == 0)")


# ---------------------------------------------------------------------------
# cache


def init_cache(cfg: ModelConfig, slots: int, max_len: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    _check_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, slots, max_len, cfg.n_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": torch.zeros((slots,), dtype=torch.int32, device=dev)}


def _tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()  # e.g. kv_from_bytes views of an immutable buffer
    return torch.as_tensor(x)


def install(cache: Dict, slot: int, k, v, length: int) -> Dict:
    """Write a sequence's prefill K/V [L, S, H, hd] (tensors or numpy)
    into `slot` at positions [0:S] and set the slot's valid length."""
    kk = _tensor(k).to(cache["k"].device, cache["k"].dtype)
    vv = _tensor(v).to(cache["v"].device, cache["v"].dtype)
    s = int(kk.shape[1])
    cache["k"][:, slot, :s] = kk
    cache["v"][:, slot, :s] = vv
    cache["pos"][slot] = int(length)
    return cache


def reset_slot(cache: Dict, slot: int) -> Dict:
    """Retire a slot: its row stops advancing; the stale K/V is dead
    weight the next install overwrites."""
    cache["pos"][slot] = 0
    return cache


# ---------------------------------------------------------------------------
# prefill


@torch.no_grad()
def prefill(model: TransformerLM, tokens, cfg: ModelConfig) -> Tuple:
    """tokens [B, S] int -> (last-position logits [B, vocab] f32,
    k [L, B, S, H, hd], v [L, B, S, H, hd]) in cfg.dtype."""
    _check_dense(cfg)
    dev = model.embed.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    S = tokens.shape[1]
    x = model.embed[tokens] + model.pos[:S][None]
    lp = model.blocks
    dt = cfg.dtype
    ks, vs = [], []
    for i in range(cfg.n_layers):
        hc = _layernorm(x, lp["ln1_g"][i], lp["ln1_b"][i]).to(dt)
        q = torch.einsum("bsd,dhk->bshk", hc, lp["wq"][i].to(dt))
        k = torch.einsum("bsd,dhk->bshk", hc, lp["wk"][i].to(dt))
        v = torch.einsum("bsd,dhk->bshk", hc, lp["wv"][i].to(dt))
        ks.append(k)
        vs.append(v)
        o = _causal_attention(q, k, v)
        x = x + torch.einsum("bshk,hkd->bsd", o.to(dt), lp["wo"][i].to(dt))
        h = _layernorm(x, lp["ln2_g"][i], lp["ln2_b"][i])
        hf = _gelu(torch.einsum("bsd,df->bsf", h.to(dt), lp["w1"][i].to(dt)))
        x = x + torch.einsum("bsf,fd->bsd", hf, lp["w2"][i].to(dt))
    return logits_of(model, x[:, -1], cfg), torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# decode


@torch.no_grad()
def decode_step(model: TransformerLM, cache: Dict, tokens, active,
                cfg: ModelConfig) -> Tuple:
    """One token for every slot: tokens [N] int (last emitted token per
    slot), active [N] bool -> (logits [N, vocab] f32, cache).

    Every slot flows through the math (the reference's static shapes):
    each writes its K/V at p = min(pos, S-1), inactive slots too — on a
    row the next install overwrites — and only active slots advance
    `pos`.  The cache is updated in place."""
    _check_dense(cfg)
    dev = model.embed.device
    k_cache, v_cache, pos = cache["k"], cache["v"], cache["pos"]
    S = k_cache.shape[2]
    tokens = torch.as_tensor(tokens, device=dev).long()
    active = torch.as_tensor(active, device=dev)
    lp = model.blocks
    dt = cfg.dtype
    p = torch.clamp(pos, max=S - 1).to(torch.int32)   # write index per slot
    x = model.embed[tokens] + model.pos[p.long()]     # [N, D]
    for i in range(cfg.n_layers):
        hc = _layernorm(x, lp["ln1_g"][i], lp["ln1_b"][i]).to(dt)
        q = torch.einsum("nd,dhk->nhk", hc, lp["wq"][i].to(dt)).contiguous()
        k_new = torch.einsum("nd,dhk->nhk", hc,
                             lp["wk"][i].to(dt)).contiguous()
        v_new = torch.einsum("nd,dhk->nhk", hc,
                             lp["wv"][i].to(dt)).contiguous()
        o = decode_attention(q, k_new, v_new, k_cache[i], v_cache[i], p)
        x = x + torch.einsum("nhk,hkd->nd", o.to(dt), lp["wo"][i].to(dt))
        h = _layernorm(x, lp["ln2_g"][i], lp["ln2_b"][i])
        hf = _gelu(torch.einsum("nd,df->nf", h.to(dt), lp["w1"][i].to(dt)))
        x = x + torch.einsum("nf,fd->nd", hf, lp["w2"][i].to(dt))
    pos += active.to(torch.int32)
    return logits_of(model, x, cfg), cache


# ---------------------------------------------------------------------------
# host-wire (de)serialization — the bytes the KV block plane migrates


def kv_to_bytes(k, v) -> bytes:
    """[L, S, H, hd] k/v pair -> contiguous f32 host bytes (k then v)."""
    ka = torch.as_tensor(k).detach().to("cpu", torch.float32).contiguous()
    va = torch.as_tensor(v).detach().to("cpu", torch.float32).contiguous()
    return ka.numpy().tobytes() + va.numpy().tobytes()


def kv_from_bytes(data: bytes, cfg: ModelConfig, length: int) -> Tuple:
    """Inverse of kv_to_bytes for a `length`-token sequence (numpy)."""
    shape = (cfg.n_layers, length, cfg.n_heads, cfg.head_dim)
    n = int(np.prod(shape))
    flat = np.frombuffer(data, KV_WIRE_DTYPE, count=2 * n)
    return flat[:n].reshape(shape), flat[n:].reshape(shape)
