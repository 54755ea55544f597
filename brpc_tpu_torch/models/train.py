"""Training step for the LM on PyTorch — port of brpc_tpu/models/train.py
on one device.

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
object beside the loss.  Meshes and sharding are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from brpc_tpu_torch.models.transformer import (ModelConfig, TransformerLM,
                                               apply, resolve_device)


@dataclass
class TrainState:
    params: TransformerLM
    opt_state: torch.optim.Optimizer
    step: torch.Tensor      # int32 scalar on the CPU


def loss_fn(params: TransformerLM, tokens,
            cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """Next-token CE; targets are tokens shifted left; mean over B * S of
    f32 logits (train.py:33-39)."""
    tokens = torch.as_tensor(tokens, device=params.embed.device).long()
    logits = apply(params, tokens[:, :-1], cfg)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


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


def make_train_step(cfg: ModelConfig, lr: float = 1e-3, device="cuda"):
    """Returns (optimizer factory, step): build a state with
    ``TrainState(model, tx(model), torch.zeros((), dtype=torch.int32))``;
    ``step(state, tokens [B, S+1]) -> (state, loss)`` takes one AdamW step
    in place on `device` (``cuda`` unless the caller asks for ``cpu``)."""
    dev = resolve_device(device)
    tx = make_optimizer(lr)

    def step(state: TrainState, tokens) -> Tuple[TrainState, torch.Tensor]:
        model, opt = state.params, state.opt_state
        if model.embed.device.type != dev.type:
            raise ValueError(f"the state lies on {model.embed.device}, the "
                             f"step runs on {dev}")
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens, cfg)
        loss.backward()
        opt.step()
        state.step += 1
        return state, loss.detach()

    return tx, step
