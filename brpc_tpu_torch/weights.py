"""Parameters and training state carried between the reference and the
port.

``jax.random`` bits cannot be drawn by torch, so a comparison of the two
models starts from ONE parameter tree: the reference's
``transformer.init`` output, handed over as numpy arrays (``np.asarray``
of each leaf, or an ``.npz`` saved from it).  A training state moves in
the reference's checkpoint format (brpc_tpu/models/checkpoint.py): flat
keys joined by "/" from the reference's ``TrainState`` tree::

    params/embed  params/blocks/wq  params/moe/router ...
    opt_state/0/count  opt_state/0/mu/<param>  opt_state/0/nu/<param>
    step

``opt_state/0`` is optax's ``ScaleByAdamState`` (adamw's first link; its
other links hold no arrays): ``mu``/``nu`` are AdamW's ``exp_avg`` /
``exp_avg_sq`` and ``count`` its ``step``.  This module only reads and
writes arrays; it never imports jax.

Over a mesh the arrays stay global: reading slices each leaf (the
parameter and its two AdamW slots alike) to this rank's shard by
``transformer.param_specs``, and writing gathers every leaf from the
ranks (``sharding.gather_global``, a collective every rank reaches) to
rank 0.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from brpc_tpu_torch.models.transformer import (ModelConfig, TransformerLM,
                                               flat_specs)
from brpc_tpu_torch.parallel import sharding

ADAM = "opt_state/0"


def config_from_tree(tree: Mapping[str, Any], **over) -> ModelConfig:
    """The ModelConfig whose shapes the tree has (dtype etc. from `over`;
    n_experts from the MoE router, moe_every from `over` or the default)."""
    vocab, d_model = np.shape(tree["embed"])
    max_seq = np.shape(tree["pos"])[0]
    n_layers, _, n_heads, _ = np.shape(tree["blocks"]["wq"])
    d_ff = np.shape(tree["blocks"]["w1"])[2]
    kw = dict(vocab=int(vocab), d_model=int(d_model), n_heads=int(n_heads),
              n_layers=int(n_layers), d_ff=int(d_ff), max_seq=int(max_seq))
    if "moe" in tree:
        kw["n_experts"] = int(np.shape(tree["moe"]["router"])[2])
    kw.update(over)
    return ModelConfig(**kw)


def _param_name(path: str) -> str:
    """Tree path ("blocks/wq") -> the module's parameter name."""
    return path.replace("/", ".")


def _flat(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested tree -> {"a/b/c": leaf}, keyed as the reference's
    checkpoint keys its pytree: mapping keys, namedtuple and dataclass
    field names, sequence indices."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(_flat(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _params_flat(tree: Mapping[str, Any]) -> Dict[str, Any]:
    return {_param_name(k): v for k, v in _flat(tree).items()}


def _local(model: TransformerLM, name: str, arr) -> np.ndarray:
    """A writable f32 copy of the global array `arr` of parameter `name`,
    cut to this rank's shard on a mesh."""
    arr = np.asarray(arr, np.float32)
    if model.mesh is not None:
        arr = sharding.local_slice(arr, flat_specs(model.cfg)[name],
                                   model.mesh)
    return np.array(arr, np.float32)


def _global(model: TransformerLM, name: str, t: torch.Tensor,
            keep: bool = True) -> Optional[np.ndarray]:
    """The global array of parameter `name` (or of its AdamW slot) from
    this rank's shard `t`: gathered on a mesh (a collective).  A rank
    that does not `keep` it drops the gathered copy at once (None)."""
    t = t.detach()
    if model.mesh is not None:
        t = sharding.gather_global(t, flat_specs(model.cfg)[name],
                                   model.mesh)
    if not keep:
        return None
    return t.to("cpu", torch.float32, copy=True).numpy()   # no alias


def _load(model: TransformerLM, flat: Mapping[str, Any]) -> None:
    """Copy {param name: global array} into the model (this rank's shard
    of each on a mesh), names and shapes checked."""
    want = dict(model.named_parameters())
    missing = set(want) - set(flat)
    extra = set(flat) - set(want)
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    with torch.no_grad():
        for name, p in want.items():
            arr = _local(model, name, flat[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(p.shape)} of {model.cfg}")
            p.copy_(torch.from_numpy(arr))


def params_from_jax(tree: Mapping[str, Any],
                    cfg: Optional[ModelConfig] = None,
                    device="cuda", mesh=None) -> TransformerLM:
    """The reference's parameter tree (nested mapping of arrays with its
    names and layouts, the MoE subtree included) as a TransformerLM on
    `device` (on a mesh: this rank's shards).  With no `cfg`, the
    dimensions come from the shapes and the rest from the defaults."""
    cfg = cfg or config_from_tree(tree)
    model = TransformerLM(cfg, device, mesh)
    _load(model, _params_flat(tree))
    return model


def state_keys(model: TransformerLM) -> list:
    """The checkpoint keys of a training state of `model`."""
    names = [n.replace(".", "/") for n, _ in model.named_parameters()]
    return ([f"params/{n}" for n in names] + [f"{ADAM}/count"]
            + [f"{ADAM}/{m}/{n}" for m in ("mu", "nu") for n in names]
            + ["step"])


def train_state_to_flat(state) -> Dict[str, np.ndarray]:
    """A TrainState as the reference's checkpoint arrays (the inverse of
    :func:`train_state_from_jax`).  AdamW slots not created yet (before the
    first step) are zeros, as optax's ``adamw.init`` gives them.  On a
    mesh every leaf is gathered to its global shape, one at a time: a
    collective that every rank reaches.  Rank 0 gets the whole state;
    every other rank gets {} and holds no leaf past its gather."""
    model, opt = state.params, state.opt_state
    holds = (model.mesh is None or not dist.is_initialized()
             or dist.get_rank() == 0)
    out: Dict[str, np.ndarray] = {}
    count = 0
    for name, p in model.named_parameters():
        key = name.replace(".", "/")
        out[f"params/{key}"] = _global(model, name, p, holds)
        slot = opt.state.get(p, {})
        for m, field in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            val = slot.get(field)
            out[f"{ADAM}/{m}/{key}"] = _global(
                model, name, torch.zeros_like(p) if val is None else val,
                holds)
        if "step" in slot:
            count = int(slot["step"])
    if not holds:
        return {}
    out[f"{ADAM}/count"] = np.asarray(count, np.int32)
    out["step"] = np.asarray(int(state.step), np.int32)
    return out


def _flat_state(src) -> Dict[str, Any]:
    if isinstance(src, (str, os.PathLike)):
        with np.load(src) as z:
            return {k: z[k] for k in z.files}
    flat = dict(src) if isinstance(src, Mapping) else _flat(src)
    if any("/" in k for k in flat):
        return flat
    return _flat(flat)   # a nested mapping


def train_state_from_jax(src, cfg: Optional[ModelConfig] = None,
                         lr: float = 1e-3, device="cuda", mesh=None):
    """A TrainState of the port from a training state in the reference's
    form: the path of a checkpoint ``.npz``, its flat {key: array} mapping,
    or the reference's ``TrainState`` tree itself with numpy leaves
    (``jax.tree.map(np.asarray, state)``).  The model lands on `device`
    (on a mesh: this rank's shard of every leaf);
    AdamW (``train.make_optimizer(lr)``) gets mu -> ``exp_avg``,
    nu -> ``exp_avg_sq`` and count -> ``step``.  A missing leaf raises
    ``KeyError``."""
    from brpc_tpu_torch.models.train import TrainState, make_optimizer
    flat = _flat_state(src)
    params = {k[len("params/"):]: v for k, v in flat.items()
              if k.startswith("params/")}
    nested: Dict[str, Any] = {}
    for key, val in params.items():
        *outer, leaf = key.split("/")
        node = nested
        for part in outer:
            node = node.setdefault(part, {})
        node[leaf] = val
    model = TransformerLM(cfg or config_from_tree(nested), device, mesh)
    missing = [k for k in state_keys(model) if k not in flat]
    if missing:
        raise KeyError(f"checkpoint missing leaf {missing[0]!r}")
    _load(model, {_param_name(k): v for k, v in params.items()})
    opt = make_optimizer(lr)(model)
    _load_adam(opt, model, flat)
    step = torch.tensor(int(flat["step"]), dtype=torch.int32)
    return TrainState(params=model, opt_state=opt, step=step)


def _load_adam(opt: torch.optim.Optimizer, model: TransformerLM,
               flat: Mapping[str, Any]) -> None:
    """AdamW's per-parameter state from the checkpoint's optax slots."""
    count = float(np.asarray(flat[f"{ADAM}/count"]))
    opt.state.clear()
    for name, p in model.named_parameters():
        key = name.replace(".", "/")

        def slot(m):
            arr = _local(model, name, flat[f"{ADAM}/{m}/{key}"])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{ADAM}/{m}/{key}: shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            return torch.from_numpy(arr).to(p.device)

        # torch keeps a non-capturable step as a CPU f32 scalar
        opt.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                        "exp_avg": slot("mu"), "exp_avg_sq": slot("nu")}
