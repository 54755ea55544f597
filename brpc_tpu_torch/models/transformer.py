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
* MoE blocks are the reference's top-k switch (softmax gate, top-k
  renormalised, GELU experts) through the routed expert layer
  (:mod:`moe`): each expert runs only on the tokens routed to it.
* The logits use the tied ``embed``.

The GPT-2 block is written once, as two halves over any leading dims:
``_block_in`` (LN1, the q/k/v products) and ``_block_out`` (the output
product, LN2, the dense or routed FFN, both residuals).  :func:`apply`,
``decode.prefill`` and the decode step (``decode.decode_step`` and the
segments of ``decode.StepGraphs``) each put their own attention between
them.  :func:`apply` carries gradients (training differentiates it);
the inference paths run under ``torch.no_grad()``.  The reference's
per-block ``jax.checkpoint`` is a memory policy that changes no number
and is not ported.

Over a mesh (``mesh=``, parallel/mesh.py) the model holds this rank's
shards under the same names and shapes cut by :func:`param_specs` (the
reference's Megatron layout), so checkpoint keys do not change; one seed
gives one global model under every layout.  What XLA inserts for the
reference's sharding constraints is explicit here (parallel/sharding.py):
the replicated activations enter the tp-sharded products through
``copy_to`` and their partial sums leave through ``reduce_from``; gather
attention at sp > 1 all-gathers q, k and v over sp, runs the causal
kernels on the whole sequence and keeps this rank's rows (each row sees
the reference's arithmetic; the reduce-scatter is the backward); a ring
or Ulysses config at sp > 1 runs parallel/ring_attention.py where the
reference does.  Without a mesh a ring or Ulysses config runs gather
attention, as the reference does.  Every entry point takes an explicit
``device`` and runs on ``cuda`` unless the caller asks for ``cpu``.

``cfg.family`` "lfm2" is another block family (:mod:`lfm2`: gated short
convolutions, QK-normed GQA with RoPE, SwiGLU and sigmoid-routed MoE
feed-forwards, leaves held per layer), on one device; :func:`init` and
:func:`apply` dispatch by family, and the GPT-2 path above is unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from brpc_tpu_torch.models import lfm2
from brpc_tpu_torch.models import moe
from brpc_tpu_torch.ops.causal_attention import causal_attention
from brpc_tpu_torch.parallel import sharding
from brpc_tpu_torch.parallel.ring_attention import (ring_attention,
                                                    ulysses_attention)


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
    # the block family: "gpt2" (the fields above) or "lfm2" (models/lfm2.py,
    # which also reads the fields below)
    family: str = "gpt2"
    n_kv_heads: int = 0      # 0 = n_heads
    layer_kinds: Tuple[str, ...] = ()   # lfm2: "conv" or "attn" a layer
    n_dense_layers: int = 0  # lfm2: leading layers with the dense FFN
    d_expert: int = 0        # lfm2: an expert's FFN width
    experts_held: int = 0    # the experts this device holds; 0 = all
    expert_first: int = 0    # the first of them
    routed_scale: float = 1.0   # lfm2: the routing weights' scale
    norm_eps: float = 1e-5   # lfm2: RMSNorm's
    rope_theta: float = 1e6  # lfm2
    conv_width: int = 3      # lfm2: the short convolution's

    def __post_init__(self):
        if self.attn_impl not in ("gather", "ring", "ulysses"):
            raise ValueError(
                f"attn_impl must be gather|ring|ulysses, "
                f"got {self.attn_impl!r}")
        if self.family not in ("gpt2", "lfm2"):
            raise ValueError(f"family must be gpt2|lfm2, got {self.family!r}")
        if self.n_heads % self.kv_heads:
            raise ValueError(f"{self.n_heads} query heads do not share "
                             f"{self.kv_heads} KV heads evenly")
        if self.expert_first < 0 or \
                self.expert_first + self.held > self.n_experts:
            raise ValueError(f"experts {self.expert_first} .. "
                             f"{self.expert_first + self.held} are not "
                             f"among the {self.n_experts}")
        if self.family == "lfm2" and (
                len(self.layer_kinds) != self.n_layers
                or set(self.layer_kinds) - {"conv", "attn"}):
            raise ValueError(f"layer_kinds must give conv|attn for each of "
                             f"the {self.n_layers} layers, got "
                             f"{self.layer_kinds!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def held(self) -> int:
        """The number of experts this device holds."""
        return self.experts_held or self.n_experts

    def is_moe(self, layer: int) -> bool:
        if self.family == "lfm2":
            return self.n_experts > 0 and layer >= self.n_dense_layers
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


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The spec tree matching the parameters (transformer.py:121-149),
    specs as tuples: q/k/v column-parallel on heads (tp), ``wo``
    row-parallel; ``w1`` column- and ``w2`` row-parallel; experts over
    ep with ``we1``/``we2`` over tp inside; the rest replicated."""
    specs: Dict[str, Any] = {
        "embed": (None, None),
        "pos": (None, None),
        "ln_f": {"g": (None,), "b": (None,)},
        "blocks": {
            "ln1_g": (None, None), "ln1_b": (None, None),
            "ln2_g": (None, None), "ln2_b": (None, None),
            "wq": (None, None, "tp", None),
            "wk": (None, None, "tp", None),
            "wv": (None, None, "tp", None),
            "wo": (None, "tp", None, None),
            "w1": (None, None, "tp"),
            "w2": (None, "tp", None),
        },
    }
    if moe_slot(cfg, cfg.n_layers):
        specs["moe"] = {
            "router": (None, None, None),
            "we1": (None, "ep", None, "tp"),
            "we2": (None, "ep", "tp", None),
        }
    return specs


def flat_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """{parameter name ("blocks.wq"): spec}."""
    out = {}
    for top, sub in param_specs(cfg).items():
        if isinstance(sub, dict):
            out.update({f"{top}.{k}": v for k, v in sub.items()})
        else:
            out[top] = sub
    return out


def _global_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """{parameter name: the reference's global shape}."""
    L, D, H, hd, F_ = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.head_dim, cfg.d_ff)
    shapes = {"embed": (cfg.vocab, D), "pos": (cfg.max_seq, D),
              "ln_f.g": (D,), "ln_f.b": (D,)}
    for n in ("ln1_g", "ln1_b", "ln2_g", "ln2_b"):
        shapes[f"blocks.{n}"] = (L, D)
    for n in ("wq", "wk", "wv"):
        shapes[f"blocks.{n}"] = (L, D, H, hd)
    shapes.update({"blocks.wo": (L, H, hd, D), "blocks.w1": (L, D, F_),
                   "blocks.w2": (L, F_, D)})
    E, n_moe = cfg.n_experts, moe_slot(cfg, L)
    if n_moe:
        shapes.update({"moe.router": (n_moe, D, E),
                       "moe.we1": (n_moe, E, D, F_),
                       "moe.we2": (n_moe, E, F_, D)})
    return shapes


class TransformerLM(nn.Module):
    """The parameter tree as a module (no forward: :func:`apply`,
    ``decode.prefill`` and ``decode.decode_step`` are functions over it,
    as in the reference).  With a mesh, each parameter is this rank's
    shard (:func:`param_specs`) of the global tensor of that name."""

    def __init__(self, cfg: ModelConfig, device="cuda", mesh=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self.expert_stats = moe.ExpertStats(moe_slot(cfg, cfg.n_layers))
        if cfg.family == "lfm2":
            if mesh is not None:
                raise ValueError("the lfm2 family runs on one device")
            self.embed = nn.Parameter(torch.zeros((cfg.vocab, cfg.d_model),
                                                  device=dev))
            self.norm_f = nn.Parameter(torch.zeros(cfg.d_model, device=dev))
            self.layers = nn.ModuleList(lfm2.Layer(cfg, i, dev)
                                        for i in range(cfg.n_layers))
            return
        specs = flat_specs(cfg)
        shapes = _global_shapes(cfg)

        def p(name):
            shape = shapes[name]
            if mesh is not None:
                shape = sharding.local_shape(shape, specs[name], mesh)
            return nn.Parameter(torch.zeros(shape, device=dev))

        def group(prefix, names):
            return nn.ParameterDict({n: p(f"{prefix}.{n}") for n in names})

        self.embed = p("embed")
        self.pos = p("pos")
        self.ln_f = group("ln_f", ("g", "b"))
        self.blocks = group("blocks", ("ln1_g", "ln1_b", "ln2_g", "ln2_b",
                                       "wq", "wk", "wv", "wo", "w1", "w2"))
        if moe_slot(cfg, cfg.n_layers):
            self.moe = group("moe", ("router", "we1", "we2"))

    def stats(self) -> Dict[str, Any]:
        """The held experts' assignments per MoE layer
        (``moe_assignments`` [layers][held experts]) and the dropped
        assignments (``moe_dropped``, 0 for the dropless layer), summed on
        the device since the last :meth:`reset_stats`; reading them waits
        for the device."""
        return self.expert_stats.read()

    def reset_stats(self) -> None:
        self.expert_stats.reset()


def init(generator: torch.Generator, cfg: ModelConfig,
         device="cuda", mesh=None) -> TransformerLM:
    """Random parameters with the reference's distribution
    (transformer.init: normal / sqrt(fan_in) for every product weight,
    ones/zeros for the norms).  Drawn on the generator's device (the CPU
    for ``torch.Generator()``) at their global shapes and then moved (on
    a mesh: this rank's shard kept), so one seed gives one global model
    on every device and layout.  ``jax.random`` bits cannot be
    reproduced: to compare with the reference, carry its parameters over
    with ``weights.params_from_jax``."""
    model = TransformerLM(cfg, device, mesh)
    if cfg.family == "lfm2":
        lfm2.init_params(model, generator, cfg)
        return model
    gdev = generator.device
    shapes, specs = _global_shapes(cfg), flat_specs(cfg)
    params = dict(model.named_parameters())

    def dense(name: str, fan_in: int) -> None:
        draw = torch.randn(shapes[name], generator=generator, device=gdev,
                           dtype=torch.float32) / math.sqrt(fan_in)
        if mesh is not None:
            draw = sharding.local_slice(draw, specs[name], mesh)
        params[name].copy_(draw)

    D, F_ = cfg.d_model, cfg.d_ff
    with torch.no_grad():
        dense("embed", D)
        dense("pos", D)
        model.ln_f["g"].fill_(1.0)
        bl = model.blocks
        bl["ln1_g"].fill_(1.0)
        bl["ln2_g"].fill_(1.0)
        for name in ("wq", "wk", "wv", "wo", "w1"):
            dense(f"blocks.{name}", D)
        dense("blocks.w2", F_)
        if moe_slot(cfg, cfg.n_layers):
            dense("moe.router", D)
            dense("moe.we1", D)
            dense("moe.we2", F_)
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


def _copy(x, mesh, axes):
    """A replicated activation entering products sharded over `axes`."""
    return x if mesh is None else sharding.copy_to(x, mesh, axes)


def _reduce(x, mesh, axes):
    """A partial sum over `axes` leaving them."""
    return x if mesh is None else sharding.reduce_from(x, mesh, axes)


def _sp(mesh) -> int:
    return 1 if mesh is None else sharding.axis_size(mesh, "sp")


def _block_in(x, lp, i, cfg: ModelConfig, mesh=None):
    """Layer i up to its attention, over any leading dims of x [..., D]:
    LN1 in f32, the cast to cfg.dtype entering the tp-sharded products,
    and q, k, v [..., H, hd], contiguous."""
    dt = cfg.dtype
    xc = _copy(_layernorm(x, lp["ln1_g"][i], lp["ln1_b"][i]).to(dt), mesh,
               "tp")
    q = torch.einsum("...d,dhk->...hk", xc, lp["wq"][i].to(dt)).contiguous()
    k = torch.einsum("...d,dhk->...hk", xc, lp["wk"][i].to(dt)).contiguous()
    v = torch.einsum("...d,dhk->...hk", xc, lp["wv"][i].to(dt)).contiguous()
    return q, k, v


def _block_out(model: TransformerLM, x, o, i, cfg: ModelConfig, mesh=None):
    """Layer i after its attention's output o [..., H, hd]: the output
    product and residual, LN2 in f32, then the dense GELU FFN or, where
    ``cfg.is_moe(i)``, the routed experts, and the residual."""
    lp, dt = model.blocks, cfg.dtype
    x = x + _reduce(torch.einsum("...hk,hkd->...d", o.to(dt),
                                 lp["wo"][i].to(dt)), mesh, "tp")
    h = _layernorm(x, lp["ln2_g"][i], lp["ln2_b"][i])
    if cfg.is_moe(i):
        return x + _moe_ffn(h, model.moe, moe_slot(cfg, i), cfg, mesh,
                            model.expert_stats)
    hf = _gelu(torch.einsum("...d,df->...f", _copy(h.to(dt), mesh, "tp"),
                            lp["w1"][i].to(dt)))
    return x + _reduce(torch.einsum("...f,fd->...d", hf, lp["w2"][i].to(dt)),
                       mesh, "tp")


def _attend(q, k, v, cfg: ModelConfig, mesh=None):
    """Causal attention of this rank's sequence chunk [B, S/sp, H, hd]:
    the kernel at sp 1, else ring or Ulysses, or gather (the whole
    sequence's attention on every sp rank, this rank's rows kept)."""
    if _sp(mesh) == 1:
        return _causal_attention(q, k, v)
    if cfg.attn_impl != "gather":
        fn = ring_attention if cfg.attn_impl == "ring" else ulysses_attention
        return fn(q, k, v, mesh, axis="sp", causal=True)
    C = q.shape[1]
    at = sharding.axis_index(mesh, "sp") * C
    full = [sharding.gather_seq(t, mesh, "sp") for t in (q, k, v)]
    return _causal_attention(*full)[:, at:at + C]


def _moe_ffn(x, mp, i, cfg: ModelConfig, mesh=None, stats=None):
    """Top-k switch layer (transformer.py:218-236) through the routed
    expert layer: softmax gate, top-k renormalised over its sum + 1e-9,
    GELU experts, each run only on the tokens routed to it.  On a mesh
    this rank holds its ep block of experts and their ffn columns (tp);
    the weights and x enter through ``copy_to`` over (ep, tp), since the
    outputs they make are partial over both.  The router and the experts
    share one cast of x, so that on a mesh of ones the gradient sums are
    the one-device step's."""
    xc = x.to(cfg.dtype)
    shape = xc.shape
    with record_function("moe_route"):
        logits = torch.einsum("bsd,de->bse", xc,
                              mp["router"][i].to(cfg.dtype))
        probs = torch.softmax(logits.float(), dim=-1)
        topv, topi = torch.topk(probs, cfg.moe_topk, dim=-1)
        topw = (topv / (topv.sum(-1, keepdim=True) + 1e-9)).to(cfg.dtype)
    e0 = 0
    if mesh is not None:
        e0 = sharding.axis_index(mesh, "ep") * mp["we1"].shape[1]
        topw = _copy(topw, mesh, ("ep", "tp"))
        xc = _copy(xc, mesh, ("ep", "tp"))
    y = moe.held_experts(
        xc.reshape(-1, shape[-1]), topw.reshape(-1, cfg.moe_topk),
        topi.reshape(-1, cfg.moe_topk), e0, moe.gelu,
        mp["we1"][i].to(cfg.dtype), None, mp["we2"][i].to(cfg.dtype),
        stats, i)
    return _reduce(y.view(shape), mesh, ("ep", "tp"))


def logits_of(model: TransformerLM, x, cfg: ModelConfig):
    """Final norm + tied-embedding logits in f32; x [..., D]."""
    x = _layernorm(x, model.ln_f["g"], model.ln_f["b"])
    return torch.einsum("...d,vd->...v", x.to(cfg.dtype),
                        model.embed.to(cfg.dtype)).float()


def apply(model: TransformerLM, tokens, cfg: Optional[ModelConfig] = None,
          mesh=None):
    """tokens [B, S] int -> logits [B, S, vocab] f32; differentiable
    with respect to the parameters.  On a mesh (default: the model's),
    tokens are this rank's dp shard [B/dp, S] and the logits this rank's
    [B/dp, S/sp, vocab]: the sequence chunk at its sp index."""
    cfg = cfg or model.cfg
    mesh = model.mesh if mesh is None else mesh
    tokens = torch.as_tensor(tokens, device=model.embed.device).long()
    if cfg.family == "lfm2":
        return lfm2.apply(model, tokens, cfg)
    S = tokens.shape[1]
    at = 0
    if mesh is not None:
        sp = _sp(mesh)
        if S % sp:
            raise ValueError(f"sequence of {S} does not split {sp} ways")
        S //= sp
        at = sharding.axis_index(mesh, "sp") * S
        tokens = tokens[:, at:at + S]
    x = model.embed[tokens] + model.pos[at:at + S][None]
    for i in range(cfg.n_layers):
        q, k, v = _block_in(x, model.blocks, i, cfg, mesh)
        x = _block_out(model, x, _attend(q, k, v, cfg, mesh), i, cfg, mesh)
    return logits_of(model, x, cfg)
