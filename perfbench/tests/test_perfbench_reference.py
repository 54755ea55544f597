"""The plain reference against the port's CPU path at a tiny size, in f32:
the forward, greedy decoding through the port's cache, and three AdamW
steps agree; the float8 control's steps do not."""

from __future__ import annotations

import torch

import tiny
from perfbench import harness, weights
from perfbench.drivers import train as train_driver
from perfbench.reference import gpt2

M = dict(tiny.MODEL)


def _model(w):
    from brpc_tpu_torch.models import transformer as T
    model = T.TransformerLM(harness.model_config(M), device="meta")
    model.load_state_dict({k: v.clone() for k, v in w.items()}, assign=True)
    return model


def test_forward_matches_the_port():
    from brpc_tpu_torch.models import transformer as T
    w = weights.make_weights(M, 3, "cpu")
    tokens = torch.randint(0, M["vocab"], (2, 40),
                           generator=torch.Generator().manual_seed(1))
    got = T.apply(_model(w), tokens).detach()
    want = gpt2.forward(w, tokens, M)
    assert (got - want).abs().max() < 1e-4


def test_greedy_decode_through_the_cache_has_no_gap():
    from brpc_tpu_torch.models import decode as D
    w = weights.make_weights(M, 4, "cpu")
    model, cfg = _model(w), harness.model_config(M)
    prompt = torch.randint(0, M["vocab"], (1, 12),
                           generator=torch.Generator().manual_seed(2))
    logits, k, v = D.prefill(model, prompt, cfg)
    cache = D.init_cache(cfg, 2, M["max_seq"], "cpu")
    D.install(cache, 1, k[:, 0], v[:, 0], 12)
    served = [int(logits[0].argmax())]
    for _ in range(10):
        tokens = torch.tensor([0, served[-1]])
        out, cache = D.decode_step(model, cache, tokens,
                                   torch.tensor([False, True]), cfg)
        served.append(int(out[1].argmax()))
    gaps = gpt2.served_gaps(w, M, prompt[0].tolist(), served)
    assert len(gaps) == 11 and max(gaps) < 1e-5


def test_three_adamw_steps_match_the_port():
    from brpc_tpu_torch.models import train
    ctx = tiny.context("gpt2-medium.pretrain")
    mix, w = ctx.mix, weights.make_weights(M, ctx.seed, "cpu")
    cfg = harness.model_config(M)
    model = _model(w)
    tx, step = train.make_train_step(cfg, lr=mix["lr"], device="cpu")
    state = train.TrainState(model, tx(model),
                             torch.zeros((), dtype=torch.int32))
    batches = train_driver.reference_batches(ctx)
    losses, vecs = [], {}
    for t, b in enumerate(batches):
        state, loss = step(state, b)
        losses.append(float(loss))
        if t == 0:
            vecs = {n: state.opt_state.state[p]["exp_avg"] / 0.1
                    for n, p in model.named_parameters()}
    change = {n: float((p.detach() - w[n]).norm())
              for n, p in model.named_parameters()}
    got = {"losses": losses, "change": change,
           "grad1": {n: float(v.norm()) for n, v in vecs.items()}}
    ref = train_driver.reference(ctx, against=vecs, keep_grad1=True)
    gaps = train_driver.gaps(got, ref, ref["grad1_diff"])
    assert set(gaps) == {"loss_gap", "grad_gap", "change_gap", "grad_diff"}
    assert all(v < 1e-4 for v in gaps.values()), gaps
    fp8 = train_driver.reference(ctx, fp8=True, against=ref["grad1_vec"])
    control = train_driver.gaps(fp8, ref, fp8["grad1_diff"])
    assert control["grad_diff"] > 1e-2, control
