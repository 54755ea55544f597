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
graphs, split at those launches into one segment more than the
attention layers (GPT-2: n_layers + 1), with the
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
  length of :func:`prefill_buckets` up to ``max_len`` (128, 256, ...
  1024, then an eighth of the power of two below the length apart);
  a prompt of n tokens replays
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
cache's tensors and return the same dict.  The gpt2 family is dense
only, as the reference (decode.py:16-18): its MoE config raises
``ValueError``.

The lfm2 family (models/lfm2.py: gated short convolutions, grouped-query
attention, routed experts) serves on one device through the same
functions and graph sets, with ``lfm2.apply``'s layer halves:

* The cache holds K/V of the attention layers alone at the KV heads,
  ``k``/``v`` [attention layers, slots, max_len, KV, hd], and beside it
  each conv layer's state ``conv`` [conv layers, slots, conv_width - 1,
  D] in cfg.dtype: the last conv_width - 1 rows of B*u, the only history
  a short convolution reads, a fixed size a sequence.  ``install``
  replaces a slot's state whole and ``reset_slot`` zeroes it; a prompt
  shorter than conv_width - 1 sees zeros before it, as HF's padded
  Conv1d does.
* ``prefill`` also returns the conv state after the prompt's last row;
  the step shifts each conv layer's state by one, rotates q and k at
  each slot's own position, and runs ``decode_attention`` with query
  head h reading KV head h // (H // KV).
* The routed experts run at the step's and the prefill's shapes; the
  step's inactive slots and the padded prefill's rows past the prompt
  route to no expert (an id outside the held range), so they are
  neither computed nor counted.
* The graphs split at the attention layers: one more segment than
  attention layers (7 at LFM2-8B-A1B's 6), the conv layers, the FFNs
  and the experts inside them.
* The wire carries the conv state after K/V (``kv_to_bytes``,
  ``kv_from_bytes``), in f32 like them.

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
from torch.profiler import record_function

from brpc_tpu_torch.models import lfm2
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


def _is_lfm2(cfg: ModelConfig) -> bool:
    return cfg.family == "lfm2"


def cached_layers(cfg: ModelConfig) -> int:
    """The layers whose K/V the cache holds: every GPT-2 layer, LFM2's
    attention layers."""
    return cfg.layer_kinds.count("attn") if _is_lfm2(cfg) else cfg.n_layers


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """Wire bytes one token position contributes to a sequence's K/V:
    2 (k+v) x the cached layers x the KV heads x head_dim f32 values."""
    return 2 * cached_layers(cfg) * cfg.kv_heads * cfg.head_dim * \
        KV_WIRE_DTYPE().itemsize


def conv_state_bytes(cfg: ModelConfig) -> int:
    """Wire bytes of one sequence's conv state beside its K/V: the last
    conv_width - 1 rows of B*u, d_model f32 values each, a conv layer (0
    for the gpt2 family)."""
    if not _is_lfm2(cfg):
        return 0
    return cfg.layer_kinds.count("conv") * (cfg.conv_width - 1) * \
        cfg.d_model * KV_WIRE_DTYPE().itemsize


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family == "gpt2" and cfg.n_experts > 0:
        raise ValueError(
            "decode path is dense-only for the gpt2 family (cfg.n_experts "
            "== 0); it serves the lfm2 family's routed experts, with a "
            "cache of its attention layers' K/V at the KV heads beside a "
            "conv state (the last conv_width - 1 rows of B*u) of each conv "
            "layer")


def _one_device(cfg: ModelConfig, mesh: Optional[Mesh]) -> None:
    if mesh is not None and _is_lfm2(cfg):
        raise ValueError("the lfm2 family serves on one device")


# ---------------------------------------------------------------------------
# cache


def init_cache(cfg: ModelConfig, slots: int, max_len: int,
               device="cuda", mesh: Optional[Mesh] = None
               ) -> Dict[str, torch.Tensor]:
    """Slot cache: k/v [L, slots, max_len, KV, hd] in cfg.dtype (L the
    cached layers, KV the KV heads) and the valid lengths ``pos`` [slots]
    int32; over a mesh this rank's shard [L, slots/dp, max_len, H/tp, hd]
    and ``pos`` [slots/dp], allocated at that size (each layer's rows stay
    contiguous for the kernel).  The lfm2 family (one device) also holds
    ``conv`` [conv layers, slots, conv_width - 1, d_model] in cfg.dtype,
    each slot's conv state, zeros until a sequence is installed."""
    _check_dense(cfg)
    _one_device(cfg, mesh)
    dev = resolve_device(device)
    shape = (cached_layers(cfg), slots, max_len, cfg.kv_heads, cfg.head_dim)
    if mesh is not None:
        for axis, n, what in (("dp", slots, "slots"),
                              ("tp", cfg.n_heads, "n_heads")):
            parts = sharding.axis_size(mesh, axis)
            if n % parts:
                raise ValueError(f"{what} = {n} does not split over the "
                                 f"mesh axis {axis!r} of {parts}")
        shape = sharding.local_shape(shape, CACHE_SPEC, mesh)
    cache = {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "pos": torch.zeros(shape[1:2], dtype=torch.int32, device=dev)}
    if _is_lfm2(cfg):
        cache["conv"] = torch.zeros(
            (cfg.layer_kinds.count("conv"), slots, cfg.conv_width - 1,
             cfg.d_model), dtype=cfg.dtype, device=dev)
    return cache


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
            mesh: Optional[Mesh] = None, conv=None) -> Dict:
    """Write a sequence's prefill K/V [L, S, KV, hd] (tensors, on any
    device, or numpy) into `slot` at positions [0:S] and set the slot's
    valid length; an lfm2 cache takes the sequence's conv state ``conv``
    [conv layers, conv_width - 1, d_model] too, which replaces the slot's
    whole.  Over a mesh k/v are global and `slot` too: the owning dp
    group keeps its heads, the others leave their shards alone."""
    row = _local_row(cache, slot, mesh)
    if row is None:
        return cache
    if "conv" in cache:
        if conv is None:
            raise ValueError("an lfm2 sequence installs its conv state "
                             "beside its K/V")
        cache["conv"][:, row].copy_(_tensor(conv))
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
    weight the next install overwrites.  A conv state, which a step reads
    whole, is zeroed."""
    row = _local_row(cache, slot, mesh)
    if row is not None:
        cache["pos"][row] = 0
        if "conv" in cache:
            cache["conv"][:, row].zero_()
    return cache


# ---------------------------------------------------------------------------
# prefill


@torch.no_grad()
def prefill(model: TransformerLM, tokens, cfg: ModelConfig,
            mesh: Optional[Mesh] = None) -> Tuple:
    """tokens [B, S] int -> (last-position logits [B, vocab] f32,
    k [L, B, S, KV, hd], v [L, B, S, KV, hd]) in cfg.dtype, and for the
    lfm2 family also the conv state after the last position, conv [conv
    layers, B, conv_width - 1, d_model] in cfg.dtype.  Over a mesh
    (default: the model's) each rank computes its H/tp heads of the whole
    batch; the logits and the gathered K/V are global on every rank.  The
    lfm2 family takes one prompt (B = 1) and runs the segments of
    :func:`_lfm2_prefill_segments` at S.  Every operation is launched from
    Python; :class:`PrefillGraphs` replays the same work for one prompt at
    a padded length."""
    _check_dense(cfg)
    mesh = model.mesh if mesh is None else mesh
    _one_device(cfg, mesh)
    dev = model.embed.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    if _is_lfm2(cfg):
        # the segments PrefillGraphs replays, run at S = n over fresh
        # buffers
        if tokens.shape[0] != 1:
            raise ValueError("the lfm2 family prefills one prompt at a time")
        n = tokens.shape[1]
        b = prefill_buffers(model, cfg, n)
        b["tokens"].copy_(tokens)
        b["row"].fill_(n - 1)
        logits = _prefill_launches(_lfm2_prefill_segments(model, cfg, b, n),
                                   cfg, b, n)
        return logits, b["k"], b["v"], b["conv"]
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
    `pos`.  The lfm2 family's inactive slots route to no expert and keep
    their conv states.  The cache is updated in place.  Over a mesh (default:
    the model's) tokens and active stay global [N] and the logits are
    this rank's dp block [N/dp, vocab].  Every operation is launched from
    Python; :class:`StepGraphs` replays the same step as CUDA graphs."""
    _check_dense(cfg)
    mesh = model.mesh if mesh is None else mesh
    _one_device(cfg, mesh)
    dev = model.embed.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    active = torch.as_tensor(active, device=dev)
    if _is_lfm2(cfg):
        return _lfm2_step(model, cache, tokens, active, cfg), cache
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


def _lfm2_step(model: TransformerLM, cache: Dict, tokens, active,
               cfg: ModelConfig):
    """The lfm2 step: :func:`_lfm2_segments` in order, ``decode_attention``
    at the KV heads between them -> the logits [N, vocab] f32."""
    N = cache["pos"].shape[0]
    o = torch.zeros((N, cfg.n_heads, cfg.head_dim), dtype=cfg.dtype,
                    device=cache["pos"].device)
    segs = _lfm2_segments(model, cache, cfg, tokens, active, o)
    outs = segs[0]()
    p = outs[4]
    for a in range(cache["k"].shape[0]):
        _, q, k_new, v_new = outs[:4]
        o.copy_(decode_attention(q, k_new, v_new, cache["k"][a],
                                 cache["v"][a], p))
        outs = segs[a + 1](*outs)
    return outs


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


def _write_index(pos, S: int):
    """p = min(pos, S-1) [N] int32: the row each slot writes."""
    return torch.clamp(pos, max=S - 1).to(torch.int32)


def _lfm2_segments(model: TransformerLM, cache: Dict, cfg: ModelConfig,
                   tokens, active, o) -> list:
    """The lfm2 step's work between its attention launches, as one more
    function than the attention layers: 0 embeds `tokens`, runs the conv
    layers before the first attention layer and gives its (x, q, k, v)
    and the write index p; a (1 <= a < A) runs attention layer a-1's
    output product and FFN, its attention's output read from `o`, the
    conv layers after it, and attention layer a's (x, q, k, v); the last
    runs the last attention layer's tail, the conv layers after it, the
    f32 final norm and tied logits, and the advance of `pos` by
    `active`.  A conv layer shifts the active slots' rows of
    ``cache["conv"]``; rows of inactive slots route to no expert.  q and
    k are rotated at each slot's p."""
    pos, S = cache["pos"], cache["k"].shape[2]
    attn = [i for i, kind in enumerate(cfg.layer_kinds) if kind == "attn"]

    def convs(x, lo, hi):
        # only active slots' conv states move: a warm-up (active all 0)
        # and an inactive slot leave theirs as they are
        moving = (active != 0).view(-1, 1, 1)
        for i in range(lo, hi):
            lp = model.layers[i]
            with record_function("short_conv"):
                c, z = lfm2.conv_in(lfm2.mixer_in(x, lp, cfg), lp, cfg)
                state = cache["conv"][lfm2.kind_index(cfg, i)]
                y, shifted = lfm2.conv_step(z, state, lp, cfg)
                state.copy_(torch.where(moving, shifted, state))
                x = x + lfm2.conv_out(c, y, lp, cfg)
            x = lfm2.ffn(model, x, i, cfg, active != 0)
        return x

    def head(x, i):
        lp = model.layers[i]
        with record_function("attention"):
            return (x,) + lfm2.qkv(lfm2.mixer_in(x, lp, cfg), lp, cfg,
                                   _write_index(pos, S))

    def tail(x, i):
        lp = model.layers[i]
        with record_function("attention"):
            x = x + lfm2.attn_out(o, lp, cfg)
        return lfm2.ffn(model, x, i, cfg, active != 0)

    def first():
        x = convs(model.embed[tokens], 0, attn[0])
        return head(x, attn[0]) + (_write_index(pos, S),)

    def middle(a):
        def seg(x, *_):
            x = convs(tail(x, attn[a - 1]), attn[a - 1] + 1, attn[a])
            return head(x, attn[a])
        return seg

    def last(x, *_):
        x = convs(tail(x, attn[-1]), attn[-1] + 1, cfg.n_layers)
        pos.add_(active.to(torch.int32))
        return lfm2.logits(model, x, cfg)

    return [first] + [middle(a) for a in range(1, len(attn))] + [last]


def _step_segments(model: TransformerLM, cache: Dict, cfg: ModelConfig,
                   tokens, active, o) -> list:
    fn = _lfm2_segments if _is_lfm2(cfg) else _segments
    return fn(model, cache, cfg, tokens, active, o)


def _graph_key(model: TransformerLM, cfg: ModelConfig, *read) -> tuple:
    """What a captured set depends on: the configuration, the matmul
    precision flags, and the address, shape and dtype of the weights and
    buffers, of the routed experts' counters, and of every other tensor
    `read` that its graphs and its attention launches read or write."""
    st = model.expert_stats
    read += (*model.parameters(), *model.buffers(),
             *(t for t in (st.counts, st.dropped) if t is not None))
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
    between the attention launches captured as one CUDA graph more than
    the attention layers (GPT-2: n_layers + 1; lfm2: 7 at LFM2-8B-A1B's
    6 attention layers) for one cache, when built.  The graphs share one
    memory pool and hold their static inputs (tokens, active, the
    attention's output) and outputs for their lifetime; they read the
    cache's ``pos`` and the weights by address, so :meth:`run` captures
    again when an address, the configuration or the matmul precision
    flags change.
    ``captures`` counts the sets captured, ``steps`` the steps run."""

    def __init__(self, model: TransformerLM, cache: Dict, cfg: ModelConfig):
        _check_dense(cfg)
        self.model, self.cache, self.cfg = model, cache, cfg
        self.device = cache["pos"].device
        self.captures = self.steps = 0
        self._capture()

    def _key(self) -> tuple:
        return _graph_key(self.model, self.cfg, *self.cache.values())

    @torch.no_grad()
    def _capture(self):
        model, cache, cfg = self.model, self.cache, self.cfg
        # the old set's pool goes before the new one is taken
        self.graphs = self.outs = self.p = None
        dev = self.device
        N = cache["pos"].shape[0]
        self.tokens = torch.zeros(N, dtype=torch.int64, device=dev)
        # 0 while the segments are warmed up, so `pos` keeps its values
        # (and no lfm2 row is routed or counted)
        self.active = torch.zeros(N, dtype=torch.int32, device=dev)
        self.o = torch.zeros((N, cfg.n_heads, cfg.head_dim), dtype=cfg.dtype,
                             device=dev)
        self.kv = [(cache["k"][i], cache["v"][i])
                   for i in range(cache["k"].shape[0])]
        segs = _step_segments(model, cache, cfg, self.tokens, self.active,
                              self.o)
        self.graphs, self.outs = _capture(segs, torch.cuda.Stream(dev),
                                          torch.cuda.graph_pool_handle())
        self.p = self.outs[0][4]
        # after the warm-up, which allocates the experts' counters
        self.key = self._key()
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


# the prefill's padded lengths step by this up to PREFILL_BUCKETS_FINE,
# then by an eighth of the power of two at or below the length, so that
# padding is at most 127 rows below 1024 and under 12.5% of a prompt's
# rows above it
PREFILL_BUCKET = 128
PREFILL_BUCKETS_FINE = 1024


def prefill_buckets(max_len: int) -> list:
    """The padded lengths a :class:`PrefillGraphs` captures: 128, 256,
    ..., 1024, then 1152, 1280, ... 2048, 2304, ... 4096, 4608, ...
    below `max_len`, then `max_len`."""
    out, s = [], PREFILL_BUCKET
    while s < max_len:
        out.append(s)
        s += max(PREFILL_BUCKET, (1 << (s.bit_length() - 1)) // 8)
    return out + [max_len]


def prefill_bucket(n: int, max_len: int) -> Optional[int]:
    """The padded length a prompt of n tokens replays: the smallest of
    :func:`prefill_buckets` that holds it; None above `max_len`."""
    if n > max_len:
        return None
    return next(s for s in prefill_buckets(max_len) if s >= n)


def prefill_buffers(model: TransformerLM, cfg: ModelConfig,
                    max_len: int) -> Dict[str, torch.Tensor]:
    """The static buffers of :func:`_prefill_segments`, at `max_len` on
    the model's device, zeros: the prompt ``tokens`` [1, max_len] int64,
    the ``row`` whose logits are taken [1] int64, the residual stream
    ``x`` [1, max_len, D] (GPT-2: in the weights' dtype; lfm2: f32),
    ``q`` and the attention's output ``o`` [1, max_len, H, hd] and the
    K/V store ``k``, ``v`` [L, 1, max_len, KV, hd] (L the cached layers)
    in cfg.dtype.  The lfm2 family also has the K/V repeated to the
    query heads for the causal kernel, ``kr``, ``vr`` [1, max_len, H,
    hd], and the conv state store ``conv`` [conv layers, 1, conv_width -
    1, D], in cfg.dtype."""
    dev, dt = model.embed.device, cfg.dtype
    heads = (1, max_len, cfg.n_heads, cfg.head_dim)
    kv = (cached_layers(cfg), 1, max_len, cfg.kv_heads, cfg.head_dim)
    bufs = {
        "tokens": torch.zeros((1, max_len), dtype=torch.int64, device=dev),
        "row": torch.zeros(1, dtype=torch.int64, device=dev),
        "x": torch.zeros((1, max_len, cfg.d_model),
                         dtype=(torch.float32 if _is_lfm2(cfg)
                                else model.embed.dtype), device=dev),
        "q": torch.zeros(heads, dtype=dt, device=dev),
        "o": torch.zeros(heads, dtype=dt, device=dev),
        "k": torch.zeros(kv, dtype=dt, device=dev),
        "v": torch.zeros(kv, dtype=dt, device=dev)}
    if _is_lfm2(cfg):
        bufs.update(
            kr=torch.zeros(heads, dtype=dt, device=dev),
            vr=torch.zeros(heads, dtype=dt, device=dev),
            conv=torch.zeros((cfg.layer_kinds.count("conv"), 1,
                              cfg.conv_width - 1, cfg.d_model), dtype=dt,
                             device=dev))
    return bufs


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


def _lfm2_prefill_segments(model: TransformerLM, cfg: ModelConfig,
                           bufs: Dict, S: int) -> list:
    """:func:`_prefill_segments` of the lfm2 family, split at its
    attention layers as :func:`_lfm2_segments`: the prompt's n = ``row``
    + 1 valid rows among S.  Each attention layer's head leaves the
    residual stream in ``x``, q in ``q``, its K/V in its layer of the
    store and repeated in ``kr``, ``vr``; each conv layer leaves the
    state after row n - 1 in its layer of ``conv``; rows at n and past
    route to no expert; the last gives the logits [1, vocab] f32 of
    position ``row``."""
    attn = [i for i, kind in enumerate(cfg.layer_kinds) if kind == "attn"]
    row = bufs["row"]
    tokens, x, q, o, kr, vr = (bufs[n][:, :S] for n in
                               ("tokens", "x", "q", "o", "kr", "vr"))
    k, v = bufs["k"][:, :, :S], bufs["v"][:, :, :S]

    def valid():
        return torch.arange(S, device=row.device) <= row

    def convs(h, lo, hi):
        for i in range(lo, hi):
            lp = model.layers[i]
            with record_function("short_conv"):
                c, z = lfm2.conv_in(lfm2.mixer_in(h, lp, cfg), lp, cfg)
                bufs["conv"][lfm2.kind_index(cfg, i)].copy_(
                    lfm2.conv_tail(z, row + 1, cfg))
                h = h + lfm2.conv_out(c, lfm2.conv_seq(z, lp, cfg), lp, cfg)
            h = lfm2.ffn(model, h, i, cfg, valid())
        return h

    def head(h, i):
        x.copy_(h)
        lp, a = model.layers[i], lfm2.kind_index(cfg, i)
        with record_function("attention"):
            qi, ki, vi = lfm2.qkv(lfm2.mixer_in(h, lp, cfg), lp, cfg,
                                  torch.arange(S, device=h.device))
            q.copy_(qi)
            k[a].copy_(ki)
            v[a].copy_(vi)
            kr.copy_(lfm2.repeat_kv(ki, cfg))
            vr.copy_(lfm2.repeat_kv(vi, cfg))
        return ()

    def tail(i):
        with record_function("attention"):
            h = x + lfm2.attn_out(o, model.layers[i], cfg)
        return lfm2.ffn(model, h, i, cfg, valid())

    def first():
        return head(convs(model.embed[tokens], 0, attn[0]), attn[0])

    def middle(a):
        return lambda: head(convs(tail(attn[a - 1]), attn[a - 1] + 1,
                                  attn[a]), attn[a])

    def last():
        h = convs(tail(attn[-1]), attn[-1] + 1, cfg.n_layers)
        return lfm2.logits(model, h.index_select(1, row)[:, 0], cfg)

    return [first] + [middle(a) for a in range(1, len(attn))] + [last]


def _padded_segments(model: TransformerLM, cfg: ModelConfig, bufs: Dict,
                     S: int) -> list:
    fn = _lfm2_prefill_segments if _is_lfm2(cfg) else _prefill_segments
    return fn(model, cfg, bufs, S)


def _prefill_launches(calls: list, cfg: ModelConfig, bufs: Dict, n: int):
    """Make `calls` (a prefill's segments, or their graphs' replays) in
    order, ``_causal_attention`` launched at the prompt's n rows of
    :func:`prefill_buffers` between each two -> the last call's result."""
    q, o = bufs["q"][:, :n], bufs["o"][:, :n]
    out = calls[0]()
    for i, (k, v) in enumerate(_attention_inputs(cfg, bufs, n)):
        o.copy_(_causal_attention(q, k, v))
        out = calls[i + 1]()
    return out


def _attention_inputs(cfg: ModelConfig, bufs: Dict, n: int) -> list:
    """(k, v) of each attention launch of a prefill of n tokens: views of
    the first n rows of the store (GPT-2) or of ``kr``, ``vr``, which
    each lfm2 head rewrites."""
    if _is_lfm2(cfg):
        return [(bufs["kr"][:, :n], bufs["vr"][:, :n])] * \
            bufs["k"].shape[0]
    return [(bufs["k"][i, :, :n], bufs["v"][i, :, :n])
            for i in range(bufs["k"].shape[0])]


class PrefillGraphs:
    """:func:`prefill` of one prompt on one CUDA device without a mesh,
    its work between the attention launches captured, when built, as one
    CUDA graph more than the attention layers (:func:`_prefill_segments`,
    :func:`_lfm2_prefill_segments`) at each padded length of
    :func:`prefill_buckets` up to `max_len` (at most the model's
    ``max_seq``).  One set of static buffers at `max_len`
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
        # a row every padded length holds, for the warm-ups' logits
        self.bufs["row"].zero_()
        side = torch.cuda.Stream(self.device)
        pool = torch.cuda.graph_pool_handle()
        # the longest first: each shorter length's temporaries then fit in
        # the pool's blocks that the longer ones freed
        self.sets = {S: _capture(_padded_segments(self.model, self.cfg,
                                                  self.bufs, S), side, pool)
                     for S in reversed(prefill_buckets(self.max_len))}
        # after the warm-ups, which allocate the experts' counters
        self.key = _graph_key(self.model, self.cfg)
        self.captures += 1

    @torch.no_grad()
    def run(self, tokens) -> Tuple:
        """One prompt, tokens [n] int64 on this device with n <=
        ``max_len`` -> (a copy of the last position's logits [1, vocab]
        f32, k, v [L, 1, n, KV, hd] in cfg.dtype, and for the lfm2 family
        the conv state [conv layers, 1, conv_width - 1, D]), as
        :func:`prefill`: the set of the smallest padded length S >= n
        replayed in order, the prompt's tokens in the first n positions
        (the padding positions keep whatever they held),
        ``_causal_attention`` launched at n between the graphs.  k, v and
        the conv state are views of the stores, valid until the next
        prefill."""
        n = tokens.numel()
        b = self.bufs
        with torch.cuda.device(self.device):
            if _graph_key(self.model, self.cfg) != self.key:
                self._capture()
            graphs, held = self.sets[prefill_bucket(n, self.max_len)]
            b["tokens"][0, :n].copy_(tokens)
            b["row"].fill_(n - 1)
            _prefill_launches([g.replay for g in graphs], self.cfg, b, n)
            logits = held[-1].clone()
        self.prefills += 1
        out = (logits, b["k"][:, :, :n], b["v"][:, :, :n])
        return out + (b["conv"],) if "conv" in b else out


# ---------------------------------------------------------------------------
# wire (de)serialization — the bytes the KV block plane migrates


def kv_to_bytes(k, v, device=None, conv=None):
    """[L, S, KV, hd] k/v pair (and an lfm2 sequence's conv state [conv
    layers, conv_width - 1, D]) -> the f32 wire, k then v then conv: host
    bytes, or with `device` the same bytes as a flat uint8 tensor there
    (packed on the device, no host crossing)."""
    parts = [torch.as_tensor(t).detach() for t in (k, v, conv)
             if t is not None]
    if device is None:
        return b"".join(t.to("cpu", torch.float32).contiguous().numpy()
                        .tobytes() for t in parts)
    out = torch.empty(sum(t.numel() for t in parts), dtype=torch.float32,
                      device=device)
    at = 0
    for t in parts:
        out[at:at + t.numel()].view(t.shape).copy_(t)
        at += t.numel()
    return out.view(torch.uint8)


def kv_from_bytes(data, cfg: ModelConfig, length: int) -> Tuple:
    """Inverse of kv_to_bytes for a `length`-token sequence -> (k, v), and
    for the lfm2 family (k, v, conv): numpy views of host bytes, or f32
    tensor views of a device wire."""
    shape = (cached_layers(cfg), length, cfg.kv_heads, cfg.head_dim)
    shapes = [shape, shape]
    if _is_lfm2(cfg):
        shapes.append((cfg.layer_kinds.count("conv"), cfg.conv_width - 1,
                       cfg.d_model))
    sizes = [int(np.prod(s)) for s in shapes]
    if isinstance(data, torch.Tensor):
        flat = data.view(torch.float32)
    else:
        flat = np.frombuffer(data, KV_WIRE_DTYPE, count=sum(sizes))
    out, at = [], 0
    for s, n in zip(shapes, sizes):
        out.append(flat[at:at + n].reshape(s))
        at += n
    return tuple(out)
