"""The lfm2 block family and the routed expert layer (brpc_tpu_torch/models/
lfm2.py, moe.py) on the CPU at a tiny size, against the benchmark's plain
reference (perfbench/reference/lfm2_moe.py) and against the dense switch's
formula.

Tolerances, in f32 on both sides (the port's plain kernels on the CPU):
the same equations in another order of sums, so logits within atol 1e-4 /
rtol 1e-5 (as tests/test_torch_train.py holds the port to JAX) and
gradients within atol 1e-6 / rtol 1e-4.  The AdamW step moves an element
by about lr * sign(g) at step 1, so an element whose gradient is near 0
may move the other way in either implementation: where |g| > SIGN_FLOOR
the changes agree within 1e-6, everywhere each moves by at most
lr (1 + wd |p|) (tests/test_torch_train.py's rule).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from brpc_tpu_torch.models import decode as D
from brpc_tpu_torch.models import lfm2, moe
from brpc_tpu_torch.models import train as Tr
from brpc_tpu_torch.models import transformer as T
from perfbench.reference import lfm2_moe as R

MODEL = dict(family="lfm2", vocab=128, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=4, layer_kinds=("conv", "conv", "attn", "conv"),
             n_dense_layers=1, d_ff=96, d_expert=32, n_experts=8,
             experts_held=4, expert_first=0, moe_topk=2, routed_scale=1.0,
             norm_eps=1e-5, rope_theta=1e6, conv_width=3,
             max_seq=32)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
LR, WD = 1e-3, 0.01
SIGN_FLOOR = 1e-6
# the GPT-2 MoE configurations of tests/test_torch_train.py
GPT_MOE = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
               max_seq=64, n_experts=4, moe_every=2)


def _cfg(**over):
    return T.ModelConfig(dtype=torch.float32, **dict(MODEL, **over))


def _m(cfg):
    """The reference's "model" group of a ModelConfig."""
    keys = ("vocab", "d_model", "n_heads", "n_kv_heads", "n_layers",
            "n_dense_layers", "d_ff", "d_expert", "n_experts",
            "experts_held", "expert_first", "moe_topk", "routed_scale",
            "norm_eps", "rope_theta", "conv_width")
    return dict({k: getattr(cfg, k) for k in keys},
                layer_kinds=list(cfg.layer_kinds))


def _model(cfg, seed=0):
    return T.init(torch.Generator().manual_seed(seed), cfg, "cpu")


def _tokens(seed, shape, vocab=MODEL["vocab"]):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape)).long()


def _weights(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_logits_match_the_reference():
    cfg = _cfg()
    model = _model(cfg)
    toks = _tokens(1, (2, 32))
    got = T.apply(model, toks, cfg)
    with R.exact_f32():
        want = R.forward(_weights(model), toks, _m(cfg))
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               **LOGITS_TOL)


def test_one_adamw_step_matches_the_reference():
    cfg = _cfg()
    model = _model(cfg, seed=2)
    w, start = _weights(model), _weights(model)
    toks = _tokens(3, (2, 33))
    tx, step = Tr.make_train_step(cfg, lr=LR, device="cpu")
    state = Tr.TrainState(model, tx(model), torch.zeros((), dtype=torch.int32))
    _, loss = step(state, toks)
    opt = state.opt_state
    ref = R.train_steps(w, [toks], _m(cfg), {"betas": (0.9, 0.95), "lr": LR,
                                              "eps": 1e-8,
                                              "weight_decay": WD},
                        rows=1, keep_grad1=True)
    np.testing.assert_allclose(loss.item(), ref["losses"][0], rtol=1e-6)
    names = dict(model.named_parameters())
    assert set(ref["grad1_vec"]) == set(names)
    for name, p in names.items():
        g = (opt.state[p]["exp_avg"] / 0.1).numpy()
        want_g = ref["grad1_vec"][name].numpy()
        np.testing.assert_allclose(g, want_g, err_msg=name, **GRAD_TOL)
        moved = (p.detach() - start[name]).numpy()
        want = (w[name] - start[name]).numpy()
        sure = np.abs(want_g) > SIGN_FLOOR
        np.testing.assert_allclose(moved[sure], want[sure], atol=1e-6,
                                   err_msg=name)
        p0 = np.abs(start[name].numpy())        # f32 rounds p - p0 too
        cap = LR * (1 + WD * p0) + 1e-7 + 2 * np.spacing(p0)
        assert (np.abs(moved) <= cap).all(), name


def _parts(h, lp, cfg):
    return lfm2.moe_ffn(h, lp, cfg, None, 0)


def test_held_shares_add_up_to_the_uncut_layer():
    """Two ranks' disjoint held ranges (experts 0-3 and 4-7 of 8) give
    parts that sum to the reference's layer with every expert held."""
    whole = _cfg(experts_held=8)
    model = _model(whole, seed=4)
    lp = model.layers[1]
    h = torch.randn(2, 16, MODEL["d_model"],
                    generator=torch.Generator().manual_seed(5))
    parts = []
    for e0 in (0, 4):
        cfg = _cfg(experts_held=4, expert_first=e0)
        share = lfm2.Layer(cfg, 1, "cpu")
        with torch.no_grad():
            for name, p in lp.named_parameters():
                q = getattr(share, name)
                q.copy_(p[e0:e0 + 4] if name.startswith("we") else p)
            share.expert_bias.copy_(lp.expert_bias)
        parts.append(_parts(h, share, cfg))
    w = {f"layers.1.{k}": v.detach() for k, v in lp.state_dict().items()}
    with R.exact_f32():
        want = R._moe(h, w, "layers.1.", _m(whole), False)
    np.testing.assert_allclose((parts[0] + parts[1]).detach().numpy(),
                               want.numpy(), atol=1e-6, rtol=1e-5)
    assert not torch.allclose(parts[0], torch.zeros_like(parts[0]))


def _dense_switch(x, mp, i, cfg):
    """transformer.py:218-236's formula: every expert on every token,
    weighted by the renormalised top-k softmax gate."""
    logits = torch.einsum("bsd,de->bse", x, mp["router"][i])
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.topk(probs, cfg.moe_topk, dim=-1)
    gates = (F.one_hot(topi, cfg.n_experts) * topv[..., None]).sum(-2)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    h = F.gelu(torch.einsum("bsd,edf->besf", x, mp["we1"][i]),
               approximate="tanh")
    y = torch.einsum("besf,efd->besd", h, mp["we2"][i])
    return torch.einsum("besd,bse->bsd", y, gates)


@pytest.mark.parametrize("topk", [1, 2])
def test_routed_switch_equals_the_dense_formula(topk):
    """Outputs and every gradient.  Gradients within rtol 1e-4 and an atol
    of 1e-6 of the largest gradient element: a top-1 router's gradient
    comes only through the renormalisation's 1e-9, rounding noise that
    the two orders of work make differently (as
    tests/test_torch_sharded_train.py's floor rule)."""
    cfg = T.ModelConfig(dtype=torch.float32, moe_topk=topk, **GPT_MOE)
    model = _model(cfg, seed=6)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 24, GPT_MOE["d_model"], generator=gen)
    r = torch.randn(2, 24, GPT_MOE["d_model"], generator=gen)
    leaves = list(model.moe.values())
    got = T._moe_ffn(x, model.moe, 0, cfg)
    want = _dense_switch(x, model.moe, 0, cfg)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=1e-6, rtol=1e-5)
    g_got = torch.autograd.grad((got * r).sum(), leaves)
    g_want = torch.autograd.grad((want * r).sum(), leaves)
    scale = max(float(g.abs().max()) for g in g_want)
    for name, a, b in zip(model.moe.keys(), g_got, g_want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=name)


def test_routed_switch_computes_no_unselected_expert():
    """An expert that no token selects has NaN weights: the dense switch's
    output is NaN (0 x NaN), the routed layer's is finite and equal to the
    formula without that expert, and the counters never see it."""
    cfg = T.ModelConfig(dtype=torch.float32, moe_topk=2, **GPT_MOE)
    model = _model(cfg, seed=8)
    # x > 0 and expert 3's router column -1: its logit is -sum(x), about
    # -50, so it is never among any token's top 2 of 4
    x = torch.randn(2, 24, GPT_MOE["d_model"],
                    generator=torch.Generator().manual_seed(9)).abs()
    with torch.no_grad():
        model.moe["router"][0, :, 3] = -1.0
    with torch.no_grad():
        want = _dense_switch(x, model.moe, 0, cfg)
        model.moe["we1"][0, 3] = float("nan")
        model.moe["we2"][0, 3] = float("nan")
        assert torch.isnan(_dense_switch(x, model.moe, 0, cfg)).all()
    model.reset_stats()
    got = T._moe_ffn(x, model.moe, 0, cfg, stats=model.expert_stats)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               atol=1e-6, rtol=1e-5)
    st = model.stats()
    assert st["moe_assignments"][0][3] == 0
    assert sum(st["moe_assignments"][0]) == 2 * 24 * 2
    assert st["moe_dropped"] == 0


def test_counters_sum_to_every_assignment_when_all_experts_are_held():
    cfg = _cfg(experts_held=8)
    model = _model(cfg, seed=10)
    T.apply(model, _tokens(11, (3, 20)), cfg)
    st = model.stats()
    assert len(st["moe_assignments"]) == 3          # MoE layers 1, 2, 3
    assert all(sum(c) == 3 * 20 * 2 for c in st["moe_assignments"])
    assert st["moe_dropped"] == 0
    model.reset_stats()
    assert model.stats() == {"moe_assignments": [], "moe_dropped": 0}


def test_held_range_sees_only_its_experts():
    cfg = _cfg(experts_held=3, expert_first=5)
    topi = torch.tensor([[0, 5], [7, 6], [5, 1], [2, 4]])
    p = moe.plan(topi, 5, 3)
    assert p.counts().tolist() == [2, 1, 1]
    assert int(p.dropped()) == 0
    assert p.valid.tolist() == [True] * 4 + [False] * 4
    assert topi.reshape(-1)[p.order[:4]].tolist() == [5, 5, 6, 7]
    assert (p.order[p.inv] == torch.arange(8)).all()
    assert cfg.held == 3


@pytest.mark.parametrize("t", [0, 9, 31])
def test_the_short_conv_is_causal(t):
    """Changing position t moves the conv mixer's outputs at t, t+1 and
    t+2 (its width) and no other."""
    cfg = _cfg()
    lp = _model(cfg, seed=12).layers[0]
    x = torch.randn(2, 32, MODEL["d_model"],
                    generator=torch.Generator().manual_seed(13))
    y0 = lfm2.short_conv(x, lp, cfg)
    x2 = x.clone()
    x2[:, t] += 1.0
    moved = (lfm2.short_conv(x2, lp, cfg) - y0).abs().amax((0, 2))
    reach = set(range(t, min(t + cfg.conv_width, 32)))
    for s in range(32):
        assert (moved[s] > 0) == (s in reach), (s, float(moved[s]))


def test_the_whole_model_is_causal():
    cfg = _cfg()
    model = _model(cfg, seed=14)
    toks = _tokens(15, (1, 32))
    a = T.apply(model, toks, cfg)
    toks2 = toks.clone()
    toks2[0, 20] = (toks2[0, 20] + 1) % MODEL["vocab"]
    b = T.apply(model, toks2, cfg)
    assert torch.equal(a[:, :20], b[:, :20])
    assert not torch.equal(a[:, 20], b[:, 20])


def test_the_grouped_product_plain_version():
    a = torch.randn(10, 6)
    b = torch.randn(3, 6, 4)
    ends = torch.tensor([2, 2, 7])
    out = moe.grouped_mm(a, b, ends)
    want = torch.cat([a[0:2] @ b[0], a[2:7] @ b[2], torch.zeros(3, 4)])
    torch.testing.assert_close(out, want)
    c = torch.randn(10, 5)
    wg = moe.grouped_mm(a.t(), c, ends)
    torch.testing.assert_close(wg, torch.stack(
        [a[0:2].t() @ c[0:2], torch.zeros(6, 5), a[2:7].t() @ c[2:7]]))


def test_config_refuses_what_it_cannot_build():
    with pytest.raises(ValueError, match="layer_kinds"):
        _cfg(layer_kinds=("conv", "attn"))
    with pytest.raises(ValueError, match="KV heads"):
        _cfg(n_kv_heads=3)
    with pytest.raises(ValueError, match="are not among"):
        _cfg(expert_first=6)
    with pytest.raises(ValueError, match="one device"):
        T.TransformerLM(_cfg(), "cpu", mesh=object())


def test_decode_refuses_the_gpt2_family_with_experts():
    """The decode path serves the lfm2 family's routed experts, not the
    gpt2 family's switch layers; its message says what the lfm2 cache
    holds."""
    cfg = T.ModelConfig(dtype=torch.float32, **GPT_MOE)
    model = _model(cfg)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    for call in (lambda: D.init_cache(cfg, 1, 8, "cpu"),
                 lambda: D.prefill(model, toks, cfg),
                 lambda: D.StepGraphs(model, {}, cfg)):
        with pytest.raises(ValueError, match="dense-only(.|\n)*conv state"):
            call()
    assert set(D.init_cache(_cfg(), 1, 8, "cpu")) == {"k", "v", "pos",
                                                       "conv"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc for the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_step_on_the_card_makes_no_host_sync(card):
    """One bf16 lfm2 step (hd 64 for the kernels) with every expert held,
    under ``set_sync_debug_mode("error")``; its counters sum to T x k in
    every MoE layer and drop nothing."""
    cfg = T.ModelConfig(**dict(MODEL, vocab=512, d_model=256, d_ff=512,
                               d_expert=128, n_experts=32, experts_held=32,
                               moe_topk=4, max_seq=256))
    model = T.init(torch.Generator().manual_seed(0), cfg, "cuda")
    tx, step = Tr.make_train_step(cfg, lr=LR, device="cuda")
    state = Tr.TrainState(model, tx(model), torch.zeros((), dtype=torch.int32))
    toks = torch.randint(0, 512, (2, 257), device=card)
    step(state, toks)                       # the kernels' build
    torch.cuda.synchronize()
    model.reset_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, loss = step(state, toks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert math.isfinite(float(loss))
    st = model.stats()
    assert [sum(c) for c in st["moe_assignments"]] == [2 * 256 * 4] * 3
    assert st["moe_dropped"] == 0


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
def test_grouped_products_match_the_loop_on_the_card(card, gated):
    """The expert layer in bf16 on the card (``torch._grouped_mm``: three
    products forward, six backward, the weight gradients grouped by rows)
    against the same layer through the loop over the groups, in f32 on
    the same bf16 values: the output and the gradients of x, of the
    routing weights and of every expert weight within 2% of the loop's
    norm (bf16 rounds h1, h3, the activation and each product once).
    The held range [2, 6) of 8 experts leaves every assignment of
    experts 0, 1, 6 and 7 past the last group end, and expert 3 is chosen
    by no token: an empty group, whose weight gradients are 0, as are
    the outputs and input gradients of tokens with no held expert."""
    T_, D_, F_, E, k, e0, n_held = 300, 256, 128, 8, 2, 2, 4
    g = torch.Generator(device="cuda").manual_seed(31)
    pool = torch.tensor([0, 1, 2, 4, 5, 6, 7], device=card)
    topi = pool[torch.rand(T_, len(pool), generator=g, device=card)
                .argsort(-1)[:, :k]]
    topw = torch.rand(T_, k, generator=g, device=card) + 0.1
    x = torch.randn(T_, D_, generator=g, device=card).to(torch.bfloat16)
    w1, w3 = (torch.randn(n_held, D_, F_, generator=g, device=card)
              .div(D_ ** 0.5).to(torch.bfloat16) for _ in range(2))
    w2 = torch.randn(n_held, F_, D_, generator=g, device=card) \
        .div(F_ ** 0.5).to(torch.bfloat16)
    dout = torch.randn(T_, D_, generator=g, device=card).to(torch.bfloat16)
    act = moe.swiglu if gated else moe.gelu
    p = moe.plan(topi, e0, n_held)
    assert p.counts().tolist()[1] == 0 and not bool(p.valid.all())

    def run(dtype):
        leaves = [t.to(dtype).requires_grad_() if t.is_floating_point()
                  else t for t in (x, w1, w3, w2)]
        tw = topw.clone().requires_grad_()
        xs, a1, a3, a2 = leaves
        out = moe.HeldExperts.apply(xs, tw, p, act, a1, a3 if gated else None,
                                    a2)
        wrt = [xs, tw, a1, a2] + ([a3] if gated else [])
        return [out.detach()] + list(torch.autograd.grad(
            out, wrt, dout.to(dtype)))

    got, want = run(torch.bfloat16), run(torch.float32)
    names = ["out", "dx", "dtopw", "dw1", "dw2", "dw3"]
    for name, a, b in zip(names, got, want):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, b) < 0.02, (name, _rel(a, b))
    held = ((topi >= e0) & (topi < e0 + n_held)).any(-1)
    assert (~held).any()
    for a in (got[0], got[1]):
        assert (a[~held] == 0).all()
    for a in got[3:]:
        assert (a[1] == 0).all()
