"""Training step for the LM on PyTorch — port of brpc_tpu/models/train.py.

The step is forward (``transformer.apply``, bf16 products, f32 logits) ->
next-token cross-entropy -> autograd -> AdamW.  ``torch.optim.AdamW``
with the reference's optax settings (lr, b1 0.9, b2 0.95, eps 1e-8,
weight decay 0.01 on every parameter: optax's ``adamw`` masks nothing)
computes the same update: decoupled decay, bias-corrected moments, eps
outside the square root.  The attention inside ``apply`` is the
hand-written kernel, forward and backward; everything else is plain
torch autograd.

Unlike the reference's pure step, the port's step updates the state IN
PLACE (parameters, optimizer slots, step count) and returns the same
object beside the loss.

Over a mesh (train.py:46-103) every rank runs the step on its shards:
tokens arrive as its dp shard [B/dp, S+1] (train.py:70-73); its loss is
its share of the reference's global mean (its NLL sum over the global
B * S), and the returned loss is the sum of the shares over (dp, sp).
After the backward every gradient is all-reduced over dp and sp; a
gradient replicated over tp or ep is equal across those ranks already
(the model's ``copy_to`` ops sum its partials).  AdamW then runs on the
local shards, so its ``exp_avg``/``exp_avg_sq`` are sharded like their
parameters, as the reference's tree-position matching (:76-95) makes
them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from brpc_tpu_torch.models.transformer import (ModelConfig, TransformerLM,
                                               apply, resolve_device)
from brpc_tpu_torch.parallel import sharding

BATCH_AXES = ("dp", "sp")   # the axes the loss and the gradients sum over


@dataclass
class TrainState:
    params: TransformerLM
    opt_state: torch.optim.Optimizer
    step: torch.Tensor      # int32 scalar on the CPU


def loss_fn(params: TransformerLM, tokens, cfg: Optional[ModelConfig] = None,
            mesh=None) -> torch.Tensor:
    """Next-token CE; targets are tokens shifted left; mean over B * S of
    f32 logits (train.py:33-39).  On a mesh (default: the model's): this
    rank's share of that mean, from its dp shard of tokens [B/dp, S+1]
    and its sp chunk of the positions."""
    mesh = params.mesh if mesh is None else mesh
    tokens = torch.as_tensor(tokens, device=params.embed.device).long()
    logits = apply(params, tokens[:, :-1], cfg, mesh)
    targets = tokens[:, 1:]
    if mesh is not None:
        C = logits.shape[1]
        at = sharding.axis_index(mesh, "sp") * C
        targets = targets[:, at:at + C]
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))
    if mesh is None:
        return loss
    return loss * (1.0 / sharding.axis_size(mesh, BATCH_AXES))


def sum_gradients(model: TransformerLM, mesh) -> None:
    """Every gradient summed over dp and sp, in place (one all-reduce of
    the flattened gradients per axis)."""
    grads = []
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = sharding.summed(mesh, BATCH_AXES, _flatten_dense_tensors(grads))
    for g, s in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(s)


def make_optimizer(lr: float = 1e-3
                   ) -> Callable[[TransformerLM], torch.optim.AdamW]:
    """The optimizer factory: model -> AdamW over every parameter, with
    the reference's ``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01)``
    settings."""
    def build(model: TransformerLM) -> torch.optim.AdamW:
        return torch.optim.AdamW(model.parameters(), lr=lr,
                                 betas=(0.9, 0.95), eps=1e-8,
                                 weight_decay=0.01)
    return build


def make_train_step(cfg: ModelConfig, mesh=None, lr: float = 1e-3,
                    device="cuda"):
    """Returns (optimizer factory, step): build a state with
    ``TrainState(model, tx(model), torch.zeros((), dtype=torch.int32))``;
    ``step(state, tokens [B, S+1]) -> (state, loss)`` takes one AdamW step
    in place on `device` (``cuda`` unless the caller asks for ``cpu``).
    With a mesh the model is this rank's shards (``init(..., mesh=)``),
    tokens its dp shard, and the loss the global one on every rank."""
    dev = resolve_device(device)
    tx = make_optimizer(lr)

    def step(state: TrainState, tokens) -> Tuple[TrainState, torch.Tensor]:
        model, opt = state.params, state.opt_state
        if model.embed.device.type != dev.type:
            raise ValueError(f"the state lies on {model.embed.device}, the "
                             f"step runs on {dev}")
        if getattr(model.mesh, "shape", None) != getattr(mesh, "shape", None):
            raise ValueError("the state's mesh is not the step's")
        opt.zero_grad(set_to_none=True)
        # named ranges for torch.profiler; on a CUDA device the backward's
        # nodes run on autograd's own threads and show under their names
        with record_function("forward"):
            loss = loss_fn(model, tokens, cfg, mesh)
        with record_function("backward"):
            loss.backward()
            if mesh is not None:
                sum_gradients(model, mesh)
        with record_function("optimizer"):
            opt.step()
        state.step += 1
        loss = loss.detach()
        if mesh is not None:
            loss = sharding.summed(mesh, BATCH_AXES,
                                   loss.reshape(1)).reshape(())
        return state, loss

    return tx, step
