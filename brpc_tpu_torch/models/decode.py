"""Incremental (KV-cached) decode over a TransformerLM — port of
brpc_tpu/models/decode.py.

``prefill()`` runs the causal forward over a prompt once and hands back
the per-layer K/V it produced; ``decode_step()`` then extends N slots by
one token each against the slot cache ``k/v [L, N, S, H, hd]`` in
``cfg.dtype`` plus ``pos [N]`` int32.  The step's attention is the
hand-written kernel ``ops.decode_attention`` (one launch per layer), the
prefill's the hand-written ``ops.causal_attention`` forward.

``decode_step`` launches every operation from Python.  ``StepGraphs``
is the same step for one cache on one CUDA device without a mesh, the
work between the attention launches replayed as CUDA graphs, split at
those launches into n_layers + 1 segments: 0 is the embedding, the
write index p and layer 0's LN1 and q/k/v products; i (1 <= i < L) is
layer i-1's output product, residual, LN2, MLP and residual, then layer
i's LN1 and q/k/v; the last is layer L-1's tail, the final norm, the
tied logits and the advance of ``pos``.  Between segments
``decode_attention`` is looked up in this module and launched from
Python, and its output copied into the next segment's input.  Both run
the GPT-2 block of ``transformer._block_in``/``_block_out``, as
``prefill`` and the training forward do, so the graphs replay the eager
step's kernels (the same weight casts, products, f32 norms and logits,
in the same dtypes: the same bits).  A ``StepGraphs`` captures when
built and again when an address it reads changes (cache, weights), or
the configuration or the matmul precision flags do, and counts its
``captures`` and ``steps``.  The serving engine's ``Lockstep``, which
owns the cache, holds one.

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
    batch; the logits and the gathered K/V are global on every rank."""
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

    @torch.no_grad()
    def _capture(self):
        model, cache, cfg = self.model, self.cache, self.cfg
        # the old set's pool goes before the new one is taken
        self.graphs = self.outs = self.p = None
        self.key = _graph_key(model, cache, cfg)
        dev = self.device
        _, N, _, H, hd = cache["k"].shape
        self.tokens = torch.zeros(N, dtype=torch.int64, device=dev)
        self.active = torch.zeros(N, dtype=torch.int32, device=dev)
        self.o = torch.zeros((N, H, hd), dtype=cfg.dtype, device=dev)
        self.kv = [(cache["k"][i], cache["v"][i])
                   for i in range(cfg.n_layers)]
        segs = _segments(model, cache, cfg, self.tokens, self.active, self.o)
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            # warm up on the capture's stream (cuBLAS's handle and
            # workspace): `active` is 0, so `pos` keeps its values, and no
            # attention runs
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
                    # thread-local: the KV plane's threads may make CUDA
                    # calls meanwhile
                    g.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                    try:
                        outs = seg(*outs)
                    finally:
                        g.capture_end()
                    self.graphs.append(g)
                    self.outs.append(outs)
            torch.cuda.current_stream(dev).wait_stream(side)
        self.p = self.outs[0][4]
        self.captures += 1

    @torch.no_grad()
    def run(self, tokens, active):
        """One step, as :func:`decode_step` (tokens [N] int, active [N],
        on any device) -> a copy of the logits [N, vocab] f32: the graphs
        replayed in order, this module's ``decode_attention`` launched
        between them."""
        with torch.cuda.device(self.device):
            if _graph_key(self.model, self.cache, self.cfg) != self.key:
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
