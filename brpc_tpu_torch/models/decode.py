"""Incremental (KV-cached) decode over a TransformerLM — port of
brpc_tpu/models/decode.py.

``prefill()`` runs the causal forward over a prompt once and hands back
the per-layer K/V it produced; ``decode_step()`` then extends N slots by
one token each against the slot cache ``k/v [L, N, S, H, hd]`` in
``cfg.dtype`` plus ``pos [N]`` int32.  The step's attention is the
hand-written kernel ``ops.decode_attention`` (one launch per layer), the
prefill's the hand-written ``ops.causal_attention`` forward.

On a CUDA device without a mesh ``decode_step`` replays the rest of the
step as CUDA graphs, split at the attention launches into n_layers + 1
segments: 0 is the embedding, the write index p and layer 0's LN1 and
q/k/v products; i (1 <= i < L) is layer i-1's output product, residual,
LN2, MLP and residual, then layer i's LN1 and q/k/v; the last is layer
L-1's tail, the final norm, the tied logits and the advance of ``pos``.
Between segments ``decode_attention`` is looked up in this module and
launched from Python, and its output copied into the next segment's
input.  The graphs replay the eager step's kernels (the same weight
casts, products, f32 norms and logits, in the same dtypes: the same
bits).  A set is captured for one cache, on its first step there (the
serving engine's ``Lockstep`` takes one all-inactive step when built),
and again when an address it reads changes (cache, weights), or the
configuration or the matmul precision flags do; it goes with its cache.
``step_graph_counts(cache)`` gives the sets captured and the steps that
replayed one.  On the CPU and over a mesh every operation is launched
from Python (``_step_eager``).

Unlike the reference's pure functions, the port updates the cache IN
PLACE: ``install``, ``reset_slot`` and ``decode_step`` write into the
cache's tensors and return the same dict.  Dense only, as the reference
(decode.py:16-18): an MoE config raises ``ValueError``, and so does the
lfm2 family, whose conv layers would need a conv-state cache.

Over a mesh (``mesh=``, the reference's dp/tp layout, decode.py:64-65)
every function runs on this rank's shards, with the training forward's
rule for the heads over tp (transformer.py ``_copy``/``_reduce``): the
replicated activation enters the q/k/v and w1 products through
``copy_to(tp)``, and the wo and w2 partial sums leave through
``reduce_from(tp)``, so each kernel runs on ``H/tp`` heads.

* The cache is this rank's shard ``[L, slots/dp, max_len, H/tp, hd]``
  (spec ``CACHE_SPEC``) and ``pos`` its dp block ``[slots/dp]``.
* ``prefill`` does not split its batch over dp (every dp group computes
  it, as the reference does for a batch of one) and returns the GLOBAL
  K/V, gathered over tp: the leader serialises it for the KV plane.
* ``decode_step`` takes the global ``tokens``/``active`` [slots], runs
  this rank's dp block of slots and returns its block of logits
  ``[slots/dp, vocab]``, replicated over tp (the sharded ``apply``'s
  convention).
* ``install``/``reset_slot`` take the global slot (and the global K/V)
  and act only on the dp group that owns the slot.

Axes other than dp and tp replicate the computation (``prune_spec``).
Without a mesh every function is the one-device version above; a mesh
whose axes are all of size one runs no collective and gives its bits.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from brpc_tpu_torch.models.transformer import (
    ModelConfig, TransformerLM, _causal_attention, _copy, _gelu, _layernorm,
    _reduce, logits_of, resolve_device)
from brpc_tpu_torch.ops.decode_attention import decode_attention
from brpc_tpu_torch.parallel import sharding
from brpc_tpu_torch.parallel.mesh import Mesh

# K/V serializes as f32 (the wire the KV block plane moves: host bytes, or
# the same bytes as a device tensor); the cache itself stays in cfg.dtype
# on the device.
KV_WIRE_DTYPE = np.float32
# the cache's layout over a mesh (the reference's P(None, "dp", None, "tp",
# None)) and that of a sequence's K/V [L, S, H, hd] over tp
CACHE_SPEC = (None, "dp", None, "tp", None)
KV_SPEC = (None, None, "tp", None)


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """Wire bytes one token position contributes to a sequence's K/V:
    2 (k+v) x L x H x head_dim f32 values."""
    return 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim * \
        KV_WIRE_DTYPE().itemsize


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "gpt2":
        raise ValueError(
            f"the decode path serves the gpt2 family only: {cfg.family}'s "
            f"short-convolution layers need a conv-state cache beside the "
            f"KV cache, which it does not have")
    if cfg.n_experts > 0:
        raise ValueError("decode path is dense-only (cfg.n_experts == 0)")


# ---------------------------------------------------------------------------
# cache


def init_cache(cfg: ModelConfig, slots: int, max_len: int,
               device="cuda", mesh: Optional[Mesh] = None
               ) -> Dict[str, torch.Tensor]:
    """Slot cache: k/v [L, slots, max_len, H, hd] in cfg.dtype and the
    valid lengths ``pos`` [slots] int32; over a mesh this rank's shard
    [L, slots/dp, max_len, H/tp, hd] and ``pos`` [slots/dp], allocated
    at that size (each layer's rows stay contiguous for the kernel)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, slots, max_len, cfg.n_heads, cfg.head_dim)
    if mesh is not None:
        for axis, n, what in (("dp", slots, "slots"),
                              ("tp", cfg.n_heads, "n_heads")):
            parts = sharding.axis_size(mesh, axis)
            if n % parts:
                raise ValueError(f"{what} = {n} does not split over the "
                                 f"mesh axis {axis!r} of {parts}")
        shape = sharding.local_shape(shape, CACHE_SPEC, mesh)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": torch.zeros(shape[1:2], dtype=torch.int32, device=dev)}


def _tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()  # e.g. kv_from_bytes views of an immutable buffer
    return torch.as_tensor(x)


def _local_row(cache: Dict, slot: int, mesh: Optional[Mesh]):
    """The row of global `slot` in this rank's cache, or None when
    another dp group owns it."""
    if mesh is None:
        return slot
    rows = cache["pos"].shape[0]
    if slot // rows != sharding.axis_index(mesh, "dp"):
        return None
    return slot % rows


def install(cache: Dict, slot: int, k, v, length: int,
            mesh: Optional[Mesh] = None) -> Dict:
    """Write a sequence's prefill K/V [L, S, H, hd] (tensors, on any
    device, or numpy) into `slot` at positions [0:S] and set the slot's
    valid length.  Over a mesh k/v are global and `slot` too: the owning
    dp group keeps its heads, the others leave their shards alone."""
    row = _local_row(cache, slot, mesh)
    if row is None:
        return cache
    if mesh is not None:
        k = sharding.local_slice(k, KV_SPEC, mesh)
        v = sharding.local_slice(v, KV_SPEC, mesh)
    kk, vv = _tensor(k), _tensor(v)
    s = int(kk.shape[1])
    cache["k"][:, row, :s].copy_(kk)
    cache["v"][:, row, :s].copy_(vv)
    cache["pos"][row] = int(length)
    return cache


def reset_slot(cache: Dict, slot: int, mesh: Optional[Mesh] = None) -> Dict:
    """Retire a slot: its row stops advancing; the stale K/V is dead
    weight the next install overwrites."""
    row = _local_row(cache, slot, mesh)
    if row is not None:
        cache["pos"][row] = 0
    return cache


# ---------------------------------------------------------------------------
# prefill


@torch.no_grad()
def prefill(model: TransformerLM, tokens, cfg: ModelConfig,
            mesh: Optional[Mesh] = None) -> Tuple:
    """tokens [B, S] int -> (last-position logits [B, vocab] f32,
    k [L, B, S, H, hd], v [L, B, S, H, hd]) in cfg.dtype.  Over a mesh
    (default: the model's) each rank computes its H/tp heads of the whole
    batch; the logits and the gathered K/V are global on every rank."""
    _check_dense(cfg)
    mesh = model.mesh if mesh is None else mesh
    dev = model.embed.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    S = tokens.shape[1]
    x = model.embed[tokens] + model.pos[:S][None]
    lp = model.blocks
    dt = cfg.dtype
    ks, vs = [], []
    for i in range(cfg.n_layers):
        hc = _copy(_layernorm(x, lp["ln1_g"][i], lp["ln1_b"][i]).to(dt),
                   mesh, "tp")
        q = torch.einsum("bsd,dhk->bshk", hc, lp["wq"][i].to(dt))
        k = torch.einsum("bsd,dhk->bshk", hc, lp["wk"][i].to(dt))
        v = torch.einsum("bsd,dhk->bshk", hc, lp["wv"][i].to(dt))
        ks.append(k)
        vs.append(v)
        o = _causal_attention(q, k, v)
        x = x + _reduce(torch.einsum("bshk,hkd->bsd", o.to(dt),
                                     lp["wo"][i].to(dt)), mesh, "tp")
        h = _copy(_layernorm(x, lp["ln2_g"][i], lp["ln2_b"][i]).to(dt),
                  mesh, "tp")
        hf = _gelu(torch.einsum("bsd,df->bsf", h, lp["w1"][i].to(dt)))
        x = x + _reduce(torch.einsum("bsf,fd->bsd", hf, lp["w2"][i].to(dt)),
                        mesh, "tp")
    k, v = torch.stack(ks), torch.stack(vs)
    if mesh is not None:
        spec = (None, None) + KV_SPEC[1:]          # [L, B, S, H, hd]
        k = sharding.gather_global(k, spec, mesh)
        v = sharding.gather_global(v, spec, mesh)
    return logits_of(model, x[:, -1], cfg), k, v


# ---------------------------------------------------------------------------
# decode


def _embed(model: TransformerLM, tokens, pos, S: int) -> Tuple:
    """The write index p = min(pos, S-1) [N] int32 and the step's input
    x = token + position embedding [N, D]."""
    p = torch.clamp(pos, max=S - 1).to(torch.int32)   # write index per slot
    return p, model.embed[tokens] + model.pos[p.long()]


def _qkv(x, lp, i: int, dt, mesh: Optional[Mesh]) -> Tuple:
    """Layer i's LN1 and q/k/v products: [N, H, hd] each, contiguous."""
    hc = _copy(_layernorm(x, lp["ln1_g"][i], lp["ln1_b"][i]).to(dt),
               mesh, "tp")
    q = torch.einsum("nd,dhk->nhk", hc, lp["wq"][i].to(dt)).contiguous()
    k_new = torch.einsum("nd,dhk->nhk", hc, lp["wk"][i].to(dt)).contiguous()
    v_new = torch.einsum("nd,dhk->nhk", hc, lp["wv"][i].to(dt)).contiguous()
    return q, k_new, v_new


def _tail(x, o, lp, i: int, dt, mesh: Optional[Mesh]):
    """Layer i after its attention: the output product and residual, LN2,
    the MLP and its residual."""
    x = x + _reduce(torch.einsum("nhk,hkd->nd", o.to(dt),
                                 lp["wo"][i].to(dt)), mesh, "tp")
    h = _copy(_layernorm(x, lp["ln2_g"][i], lp["ln2_b"][i]).to(dt),
              mesh, "tp")
    hf = _gelu(torch.einsum("nd,df->nf", h, lp["w1"][i].to(dt)))
    return x + _reduce(torch.einsum("nf,fd->nd", hf, lp["w2"][i].to(dt)),
                       mesh, "tp")


def _finish(model: TransformerLM, x, pos, active, cfg: ModelConfig):
    """Advance the active slots' `pos` and give the logits [N, vocab]."""
    pos += active.to(torch.int32)
    return logits_of(model, x, cfg)


def _step_eager(model: TransformerLM, cache: Dict, tokens, active,
                cfg: ModelConfig, mesh: Optional[Mesh]):
    """decode_step's body, every operation launched from Python: the
    CPU's and a mesh's path, and the graphs' twin in the tests."""
    k_cache, v_cache, pos = cache["k"], cache["v"], cache["pos"]
    lp, dt = model.blocks, cfg.dtype
    p, x = _embed(model, tokens, pos, k_cache.shape[2])
    for i in range(cfg.n_layers):
        q, k_new, v_new = _qkv(x, lp, i, dt, mesh)
        o = decode_attention(q, k_new, v_new, k_cache[i], v_cache[i], p)
        x = _tail(x, o, lp, i, dt, mesh)
    return _finish(model, x, pos, active, cfg)


def _segments(model: TransformerLM, cache: Dict, cfg: ModelConfig,
              tokens, active, o) -> list:
    """The step's work between its attention launches, as n_layers + 1
    functions of the previous one's outputs: 0 gives (x, q, k, v) of
    layer 0 and the write index p; i gives (x, q, k, v) of layer i after
    layer i-1's tail, its attention's output read from `o`; the last
    gives the logits after layer n_layers-1's tail and the advance of
    `pos` by `active`."""
    lp, dt, L = model.blocks, cfg.dtype, cfg.n_layers
    pos = cache["pos"]

    def first():
        p, x = _embed(model, tokens, pos, cache["k"].shape[2])
        return (x,) + _qkv(x, lp, 0, dt, None) + (p,)

    def layer(i):
        def seg(x, *_):
            x = _tail(x, o, lp, i - 1, dt, None)
            return (x,) + _qkv(x, lp, i, dt, None)
        return seg

    def last(x, *_):
        return _finish(model, _tail(x, o, lp, L - 1, dt, None), pos,
                       active, cfg)

    return [first] + [layer(i) for i in range(1, L)] + [last]


class _StepGraphs:
    """decode_step's work between its attention launches, captured as
    n_layers + 1 CUDA graphs for one cache (see :func:`decode_step`).
    The graphs share one memory pool and hold their static inputs
    (tokens, active, the attention's output) and outputs for their
    lifetime; they read the cache's ``pos`` and the weights by address,
    so ``key`` holds those addresses."""

    def __init__(self, model: TransformerLM, cache: Dict, cfg: ModelConfig,
                 key: tuple):
        self.key = key
        dev = cache["pos"].device
        _, N, _, H, hd = cache["k"].shape
        self.tokens = torch.zeros(N, dtype=torch.int64, device=dev)
        self.active = torch.zeros(N, dtype=torch.int32, device=dev)
        self.o = torch.zeros((N, H, hd), dtype=cfg.dtype, device=dev)
        self.kv = [(cache["k"][i], cache["v"][i])
                   for i in range(cfg.n_layers)]
        segs = _segments(model, cache, cfg, self.tokens, self.active, self.o)
        side = torch.cuda.Stream(dev)
        # warm up on the capture's stream (cuBLAS's handle and workspace):
        # `active` is 0, so `pos` keeps its values, and no attention runs
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            outs = ()
            for seg in segs:
                outs = seg(*outs)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        pool = torch.cuda.graph_pool_handle()
        self.graphs, self.outs = [], []
        with torch.cuda.stream(side):
            outs = ()
            for seg in segs:
                g = torch.cuda.CUDAGraph()
                # thread-local: the KV plane's threads may call the driver
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    outs = seg(*outs)
                finally:
                    g.capture_end()
                self.graphs.append(g)
                self.outs.append(outs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.p = self.outs[0][4]

    def run(self, tokens, active):
        """One step: the graphs replayed in order, the module's
        ``decode_attention`` launched between them; a copy of the
        logits."""
        self.tokens.copy_(tokens)
        self.active.copy_(active)
        graphs, outs, kv, p = self.graphs, self.outs, self.kv, self.p
        graphs[0].replay()
        for i in range(len(kv)):
            _, q, k_new, v_new = outs[i][:4]
            self.o.copy_(decode_attention(q, k_new, v_new, kv[i][0],
                                          kv[i][1], p))
            graphs[i + 1].replay()
        return outs[-1].clone()


class _CacheGraphs:
    """A cache's captured set, if any, and its counters: sets captured,
    steps that replayed one."""

    def __init__(self):
        self.graphs: Optional[_StepGraphs] = None
        self.captures = 0
        self.graphed = 0


# id(cache["pos"]) -> its _CacheGraphs; an entry goes with its pos tensor
_CACHE_GRAPHS: Dict[int, _CacheGraphs] = {}


def _graph_key(model: TransformerLM, cache: Dict, cfg: ModelConfig) -> tuple:
    """What a captured set depends on: the configuration, the matmul
    precision flags, and the address, shape and dtype of every tensor
    its graphs and its attention launches read or write."""
    read = (cache["k"], cache["v"], cache["pos"], model.embed, model.pos,
            model.ln_f["g"], model.ln_f["b"], *model.blocks.values())
    m = torch.backends.cuda.matmul
    return (cfg, m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
            m.allow_fp16_reduced_precision_reduction) + tuple(
        (t.data_ptr(), t.shape, t.dtype) for t in read)


def _cache_graphs(cache: Dict) -> _CacheGraphs:
    pos = cache["pos"]
    entry = _CACHE_GRAPHS.get(id(pos))
    if entry is None:
        entry = _CACHE_GRAPHS[id(pos)] = _CacheGraphs()
        weakref.finalize(pos, _CACHE_GRAPHS.pop, id(pos), None)
    return entry


def step_graph_counts(cache: Dict) -> Tuple[int, int]:
    """(graph sets captured, steps replayed through one) for `cache`."""
    entry = _CACHE_GRAPHS.get(id(cache["pos"]))
    return (0, 0) if entry is None else (entry.captures, entry.graphed)


@torch.no_grad()
def decode_step(model: TransformerLM, cache: Dict, tokens, active,
                cfg: ModelConfig, mesh: Optional[Mesh] = None) -> Tuple:
    """One token for every slot: tokens [N] int (last emitted token per
    slot), active [N] bool -> (logits [N, vocab] f32, cache).

    Every slot flows through the math (the reference's static shapes):
    each writes its K/V at p = min(pos, S-1), inactive slots too — on a
    row the next install overwrites — and only active slots advance
    `pos`.  The cache is updated in place.  Over a mesh (default: the
    model's) tokens and active stay global [N] and the logits are this
    rank's dp block [N/dp, vocab].

    On a CUDA device without a mesh the work between the attention
    launches replays CUDA graphs, captured on the cache's first such step
    and again whenever an address they read changes: the same kernels as
    the eager step, in the same order; ``decode_attention`` is still
    launched from Python once a layer.  Elsewhere every operation is
    launched from Python."""
    _check_dense(cfg)
    mesh = model.mesh if mesh is None else mesh
    dev = model.embed.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    active = torch.as_tensor(active, device=dev)
    if mesh is not None or dev.type != "cuda":
        if mesh is not None:
            tokens = sharding.local_slice(tokens, ("dp",), mesh)
            active = sharding.local_slice(active, ("dp",), mesh)
        return _step_eager(model, cache, tokens, active, cfg, mesh), cache
    entry = _cache_graphs(cache)
    key = _graph_key(model, cache, cfg)
    with torch.cuda.device(dev):
        if entry.graphs is None or entry.graphs.key != key:
            entry.graphs = None          # its pool goes before the next
            entry.graphs = _StepGraphs(model, cache, cfg, key)
            entry.captures += 1
        logits = entry.graphs.run(tokens, active)
    entry.graphed += 1
    return logits, cache


# ---------------------------------------------------------------------------
# wire (de)serialization — the bytes the KV block plane migrates


def kv_to_bytes(k, v, device=None):
    """[L, S, H, hd] k/v pair -> the f32 wire, k then v: host bytes, or
    with `device` the same bytes as a flat uint8 tensor there (packed on
    the device, no host crossing)."""
    if device is None:
        ka = torch.as_tensor(k).detach().to("cpu", torch.float32).contiguous()
        va = torch.as_tensor(v).detach().to("cpu", torch.float32).contiguous()
        return ka.numpy().tobytes() + va.numpy().tobytes()
    k, v = torch.as_tensor(k).detach(), torch.as_tensor(v).detach()
    out = torch.empty((2,) + tuple(k.shape), dtype=torch.float32,
                      device=device)
    out[0].copy_(k)
    out[1].copy_(v)
    return out.view(-1).view(torch.uint8)


def kv_from_bytes(data, cfg: ModelConfig, length: int) -> Tuple:
    """Inverse of kv_to_bytes for a `length`-token sequence: numpy views
    of host bytes, or f32 tensor views of a device wire."""
    shape = (cfg.n_layers, length, cfg.n_heads, cfg.head_dim)
    n = int(np.prod(shape))
    if isinstance(data, torch.Tensor):
        flat = data.view(torch.float32)[:2 * n]
        return flat[:n].view(shape), flat[n:].view(shape)
    flat = np.frombuffer(data, KV_WIRE_DTYPE, count=2 * n)
    return flat[:n].reshape(shape), flat[n:].reshape(shape)
