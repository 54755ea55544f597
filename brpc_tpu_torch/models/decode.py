"""Incremental (KV-cached) decode over a TransformerLM — port of
brpc_tpu/models/decode.py.

``prefill()`` runs the causal forward over a prompt once and hands back
the per-layer K/V it produced; ``decode_step()`` then extends N slots by
one token each against the slot cache ``k/v [L, N, S, H, hd]`` in
``cfg.dtype`` plus ``pos [N]`` int32.  The step's attention is the
hand-written kernel ``ops.decode_attention`` (one launch per layer), the
prefill's the hand-written ``ops.causal_attention`` forward.

``prefill`` and ``decode_step`` launch every operation from Python.
``StepGraphs`` and ``PrefillGraphs`` are the same two on one CUDA device
without a mesh, the work between the attention launches replayed as CUDA
graphs, split at those launches into n_layers + 1 segments, with the
attention looked up in this module (``decode_attention``) or in
``transformer`` (``causal_attention``, through ``_causal_attention``) and
launched from Python between them, its output copied into the next
segment's input.  Every segment runs the GPT-2 block of
``transformer._block_in``/``_block_out``, as the eager paths and the
training forward do, so the graphs replay the eager kernels (the same
weight casts, products, f32 norms and logits, in the same dtypes).

* The step (``StepGraphs``, one cache): segment 0 is the embedding, the
  write index p and layer 0's LN1 and q/k/v products; i (1 <= i < L) is
  layer i-1's output product, residual, LN2, MLP and residual, then layer
  i's LN1 and q/k/v; the last is layer L-1's tail, the final norm, the
  tied logits and the advance of ``pos``: ``decode_step``'s bits.
* The prefill (``PrefillGraphs``): one set of segments for each padded
  length 128, 256, ... up to ``max_len``; a prompt of n tokens replays
  the smallest that holds it, the causal kernel running at n between
  the segments.  Padding is exact: everything inside a segment (the
  embedding, the norms, the products, GELU, the residuals) works row by
  row, so the padding rows reach no valid row, and the only operation
  that mixes rows, the attention, sees the prompt's own n rows.  The
  valid rows are those of the eager segments run at the same padded
  length, bit for bit, and ``prefill``'s up to the products' rounding at
  another row count.

A set captures when built and again when an address it reads changes
(cache, weights), or the configuration or the matmul precision flags do,
and counts its ``captures``.  The serving engine's ``Lockstep``, which
owns the cache, holds one of each.

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

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from brpc_tpu_torch.models.transformer import (
    ModelConfig, TransformerLM, _block_in, _block_out, _causal_attention,
    logits_of, resolve_device)
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
    batch; the logits and the gathered K/V are global on every rank.
    Every operation is launched from Python; :class:`PrefillGraphs`
    replays the same work for one prompt at a padded length."""
    _check_dense(cfg)
    mesh = model.mesh if mesh is None else mesh
    dev = model.embed.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    S = tokens.shape[1]
    x = model.embed[tokens] + model.pos[:S][None]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        q, k, v = _block_in(x, model.blocks, i, cfg, mesh)
        ks.append(k)
        vs.append(v)
        x = _block_out(model, x, _causal_attention(q, k, v), i, cfg, mesh)
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


def _finish(model: TransformerLM, x, pos, active, cfg: ModelConfig):
    """Advance the active slots' `pos` and give the logits [N, vocab]."""
    pos += active.to(torch.int32)
    return logits_of(model, x, cfg)


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
    rank's dp block [N/dp, vocab].  Every operation is launched from
    Python; :class:`StepGraphs` replays the same step as CUDA graphs."""
    _check_dense(cfg)
    mesh = model.mesh if mesh is None else mesh
    dev = model.embed.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    active = torch.as_tensor(active, device=dev)
    if mesh is not None:
        tokens = sharding.local_slice(tokens, ("dp",), mesh)
        active = sharding.local_slice(active, ("dp",), mesh)
    k_cache, v_cache, pos = cache["k"], cache["v"], cache["pos"]
    p, x = _embed(model, tokens, pos, k_cache.shape[2])
    for i in range(cfg.n_layers):
        q, k_new, v_new = _block_in(x, model.blocks, i, cfg, mesh)
        o = decode_attention(q, k_new, v_new, k_cache[i], v_cache[i], p)
        x = _block_out(model, x, o, i, cfg, mesh)
    return _finish(model, x, pos, active, cfg), cache


def _segments(model: TransformerLM, cache: Dict, cfg: ModelConfig,
              tokens, active, o) -> list:
    """The step's work between its attention launches, as n_layers + 1
    functions of the previous one's outputs: 0 gives (x, q, k, v) of
    layer 0 and the write index p; i gives (x, q, k, v) of layer i after
    layer i-1's tail, its attention's output read from `o`; the last
    gives the logits after layer n_layers-1's tail and the advance of
    `pos` by `active`."""
    L, pos = cfg.n_layers, cache["pos"]

    def first():
        p, x = _embed(model, tokens, pos, cache["k"].shape[2])
        return (x,) + _block_in(x, model.blocks, 0, cfg) + (p,)

    def layer(i):
        def seg(x, *_):
            x = _block_out(model, x, o, i - 1, cfg)
            return (x,) + _block_in(x, model.blocks, i, cfg)
        return seg

    def last(x, *_):
        return _finish(model, _block_out(model, x, o, L - 1, cfg), pos,
                       active, cfg)

    return [first] + [layer(i) for i in range(1, L)] + [last]


def _graph_key(model: TransformerLM, cfg: ModelConfig, *read) -> tuple:
    """What a captured set depends on: the configuration, the matmul
    precision flags, and the address, shape and dtype of the weights and
    of every other tensor `read` that its graphs and its attention
    launches read or write."""
    read += (model.embed, model.pos, model.ln_f["g"], model.ln_f["b"],
             *model.blocks.values())
    m = torch.backends.cuda.matmul
    return (cfg, m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
            m.allow_fp16_reduced_precision_reduction) + tuple(
        (t.data_ptr(), t.shape, t.dtype) for t in read)


def _capture(segs: list, side: torch.cuda.Stream, pool) -> Tuple[list, list]:
    """Run `segs` in order once on the side stream `side` (cuBLAS's
    handle and workspace for that stream), then capture each there, fed
    the previous one's outputs, as one CUDA graph into `pool` -> (the
    graphs, the outputs each holds).  Nothing is launched between the
    segments: the caller's segments must leave its state as they found
    it without their attention.  Captures that share a pool share their
    stream too: the allocator reuses a freed block only on the stream
    that freed it."""
    device = side.device
    with torch.cuda.device(device):
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            outs = ()
            for seg in segs:
                outs = seg(*outs)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        graphs, held = [], []
        with torch.cuda.stream(side):
            outs = ()
            for seg in segs:
                g = torch.cuda.CUDAGraph()
                # thread-local: the KV plane's threads may make CUDA
                # calls meanwhile
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    outs = seg(*outs)
                finally:
                    g.capture_end()
                graphs.append(g)
                held.append(outs)
        torch.cuda.current_stream(device).wait_stream(side)
    return graphs, held


class StepGraphs:
    """:func:`decode_step` on one CUDA device without a mesh, its work
    between the attention launches captured as n_layers + 1 CUDA graphs
    for one cache, when built.  The graphs share one memory pool and
    hold their static inputs (tokens, active, the attention's output)
    and outputs for their lifetime; they read the cache's ``pos`` and
    the weights by address, so :meth:`run` captures again when an
    address, the configuration or the matmul precision flags change.
    ``captures`` counts the sets captured, ``steps`` the steps run."""

    def __init__(self, model: TransformerLM, cache: Dict, cfg: ModelConfig):
        _check_dense(cfg)
        self.model, self.cache, self.cfg = model, cache, cfg
        self.device = cache["pos"].device
        self.captures = self.steps = 0
        self._capture()

    def _key(self) -> tuple:
        c = self.cache
        return _graph_key(self.model, self.cfg, c["k"], c["v"], c["pos"])

    @torch.no_grad()
    def _capture(self):
        model, cache, cfg = self.model, self.cache, self.cfg
        # the old set's pool goes before the new one is taken
        self.graphs = self.outs = self.p = None
        self.key = self._key()
        dev = self.device
        _, N, _, H, hd = cache["k"].shape
        self.tokens = torch.zeros(N, dtype=torch.int64, device=dev)
        # 0 while the segments are warmed up, so `pos` keeps its values
        self.active = torch.zeros(N, dtype=torch.int32, device=dev)
        self.o = torch.zeros((N, H, hd), dtype=cfg.dtype, device=dev)
        self.kv = [(cache["k"][i], cache["v"][i])
                   for i in range(cfg.n_layers)]
        segs = _segments(model, cache, cfg, self.tokens, self.active, self.o)
        self.graphs, self.outs = _capture(segs, torch.cuda.Stream(dev),
                                          torch.cuda.graph_pool_handle())
        self.p = self.outs[0][4]
        self.captures += 1

    @torch.no_grad()
    def run(self, tokens, active):
        """One step, as :func:`decode_step` (tokens [N] int, active [N],
        on any device) -> a copy of the logits [N, vocab] f32: the graphs
        replayed in order, this module's ``decode_attention`` launched
        between them."""
        with torch.cuda.device(self.device):
            if self._key() != self.key:
                self._capture()
            self.tokens.copy_(tokens)
            self.active.copy_(active)
            graphs, outs, kv, p = self.graphs, self.outs, self.kv, self.p
            graphs[0].replay()
            for i in range(len(kv)):
                _, q, k_new, v_new = outs[i][:4]
                self.o.copy_(decode_attention(q, k_new, v_new, kv[i][0],
                                              kv[i][1], p))
                graphs[i + 1].replay()
            logits = outs[-1].clone()
        self.steps += 1
        return logits


# the prefill's padded lengths are the multiples of this, then max_len
PREFILL_BUCKET = 128


def prefill_buckets(max_len: int) -> list:
    """The padded lengths a :class:`PrefillGraphs` captures: 128, 256,
    ... below `max_len`, then `max_len`."""
    return list(range(PREFILL_BUCKET, max_len, PREFILL_BUCKET)) + [max_len]


def prefill_bucket(n: int, max_len: int) -> Optional[int]:
    """The padded length a prompt of n tokens replays: the smallest of
    :func:`prefill_buckets` that holds it; None above `max_len`."""
    if n > max_len:
        return None
    return min(-(-n // PREFILL_BUCKET) * PREFILL_BUCKET, max_len)


def prefill_buffers(model: TransformerLM, cfg: ModelConfig,
                    max_len: int) -> Dict[str, torch.Tensor]:
    """The static buffers of :func:`_prefill_segments`, at `max_len` on
    the model's device, zeros: the prompt ``tokens`` [1, max_len] int64,
    the ``row`` whose logits are taken [1] int64, the residual stream
    ``x`` [1, max_len, D] in the weights' dtype, ``q`` and the
    attention's output ``o`` [1, max_len, H, hd] and the K/V store
    ``k``, ``v`` [L, 1, max_len, H, hd] in cfg.dtype."""
    dev, dt = model.embed.device, cfg.dtype
    heads = (1, max_len, cfg.n_heads, cfg.head_dim)
    return {
        "tokens": torch.zeros((1, max_len), dtype=torch.int64, device=dev),
        "row": torch.zeros(1, dtype=torch.int64, device=dev),
        "x": torch.zeros((1, max_len, cfg.d_model), dtype=model.embed.dtype,
                         device=dev),
        "q": torch.zeros(heads, dtype=dt, device=dev),
        "o": torch.zeros(heads, dtype=dt, device=dev),
        "k": torch.zeros((cfg.n_layers,) + heads, dtype=dt, device=dev),
        "v": torch.zeros((cfg.n_layers,) + heads, dtype=dt, device=dev)}


def _prefill_segments(model: TransformerLM, cfg: ModelConfig, bufs: Dict,
                      S: int) -> list:
    """The prefill's work between its attention launches at the padded
    length S, over the first S positions of :func:`prefill_buffers`, as
    n_layers + 1 functions: 0 embeds ``tokens`` and runs layer 0's
    ``_block_in``; i (1 <= i < L) runs layer i-1's ``_block_out`` on the
    attention's output read from ``o``, then layer i's ``_block_in``;
    the last runs layer L-1's ``_block_out`` and gives the logits
    [1, vocab] f32 of position ``row``.  Each ``_block_in`` leaves the
    residual stream in ``x``, its q in ``q`` and its k, v in layer i of
    the store; the others return nothing."""
    L = cfg.n_layers
    tokens, x, q, o = (bufs[n][:, :S] for n in ("tokens", "x", "q", "o"))
    k, v = bufs["k"][:, :, :S], bufs["v"][:, :, :S]

    def block_in(h, i):
        x.copy_(h)
        qi, ki, vi = _block_in(h, model.blocks, i, cfg)
        q.copy_(qi)
        k[i].copy_(ki)
        v[i].copy_(vi)
        return ()

    def first():
        return block_in(model.embed[tokens] + model.pos[:S][None], 0)

    def layer(i):
        return lambda: block_in(_block_out(model, x, o, i - 1, cfg), i)

    def last():
        h = _block_out(model, x, o, L - 1, cfg)
        return logits_of(model, h.index_select(1, bufs["row"])[:, 0], cfg)

    return [first] + [layer(i) for i in range(1, L)] + [last]


class PrefillGraphs:
    """:func:`prefill` of one prompt on one CUDA device without a mesh,
    its work between the attention launches captured, when built, as
    n_layers + 1 CUDA graphs (:func:`_prefill_segments`) at each padded
    length of :func:`prefill_buckets` up to `max_len` (at most the
    model's ``max_seq``).  One set of static buffers at `max_len`
    (:func:`prefill_buffers`) serves every length, and every set shares
    one memory pool, replayed one at a time.  The graphs read the
    weights by address, so :meth:`run` captures again when an address,
    the configuration or the matmul precision flags change.
    ``captures`` counts the captures of every set, ``prefills`` the
    prompts run."""

    def __init__(self, model: TransformerLM, cfg: ModelConfig,
                 max_len: int):
        _check_dense(cfg)
        self.model, self.cfg = model, cfg
        self.max_len = min(max_len, cfg.max_seq)
        self.device = model.embed.device
        self.bufs = prefill_buffers(model, cfg, self.max_len)
        self.captures = self.prefills = 0
        self._capture()

    @torch.no_grad()
    def _capture(self):
        # the old sets' pool goes before the new one is taken
        self.sets = None
        self.key = _graph_key(self.model, self.cfg)
        # a row every padded length holds, for the warm-ups' logits
        self.bufs["row"].zero_()
        side = torch.cuda.Stream(self.device)
        pool = torch.cuda.graph_pool_handle()
        # the longest first: each shorter length's temporaries then fit in
        # the pool's blocks that the longer ones freed
        self.sets = {S: _capture(_prefill_segments(self.model, self.cfg,
                                                   self.bufs, S), side, pool)
                     for S in reversed(prefill_buckets(self.max_len))}
        self.captures += 1

    @torch.no_grad()
    def run(self, tokens) -> Tuple:
        """One prompt, tokens [n] int64 on this device with n <=
        ``max_len`` -> (a copy of the last position's logits [1, vocab]
        f32, k, v [L, 1, n, H, hd] in cfg.dtype), as :func:`prefill`: the
        set of the smallest padded length S >= n replayed in order, the
        prompt's tokens in the first n positions (the padding positions
        keep whatever they held), ``_causal_attention`` launched at n
        between the graphs.  k and v are views of the K/V store, valid
        until the next prefill."""
        n = tokens.numel()
        b = self.bufs
        with torch.cuda.device(self.device):
            if _graph_key(self.model, self.cfg) != self.key:
                self._capture()
            graphs, held = self.sets[prefill_bucket(n, self.max_len)]
            b["tokens"][0, :n].copy_(tokens)
            b["row"].fill_(n - 1)
            q, o = b["q"][:, :n], b["o"][:, :n]
            k, v = b["k"][:, :, :n], b["v"][:, :, :n]
            graphs[0].replay()
            for i in range(self.cfg.n_layers):
                o.copy_(_causal_attention(q, k[i], v[i]))
                graphs[i + 1].replay()
            logits = held[-1].clone()
        self.prefills += 1
        return logits, k, v


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
