"""The port's MoE model and training step (brpc_tpu_torch/models/
transformer.py, train.py) against the JAX reference (brpc_tpu/models/) on
the CPU.

One parameter tree, drawn by the reference's ``transformer.init`` and
carried into the port with ``weights``; tokens from numpy seeds.  The
reference runs in-process on jax-CPU, the port with ``device="cpu"``,
both in f32.  Tolerances (only the order of the sums differs): logits
atol 1e-4 / rtol 1e-5 (as test_torch_model.py), the loss rtol 1e-6,
every parameter's gradient atol 1e-6 / rtol 1e-4.

The AdamW step: at step 1 the update is about lr * sign(g), so an element
whose gradient is near 0 can move by up to 2 lr in either framework with
the other sign.  Rule: where |g| > SIGN_FLOOR (1e-6, a hundred times
AdamW's eps) the post-step parameters agree within 1e-6; everywhere, each
framework's step moves an element by at most lr (1 + wd |p|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import train as ref_train
from brpc_tpu.models import transformer as ref_tf
from brpc_tpu_torch import weights
from brpc_tpu_torch.models import decode as D
from brpc_tpu_torch.models import train as Tr
from brpc_tpu_torch.models import transformer as T

SHAPE = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64, n_experts=4, moe_every=2)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
LR = 1e-3
SIGN_FLOOR = 1e-6


def _configs(**over):
    kw = dict(SHAPE, **over)
    return (ref_tf.ModelConfig(dtype=jnp.float32, **kw),
            T.ModelConfig(dtype=torch.float32, **kw))


def _tree(ref_cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, ref_tf.init(jax.random.PRNGKey(seed), ref_cfg))


def _tokens(seed, shape, vocab=SHAPE["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def test_moe_params_keep_the_reference_tree():
    ref_cfg, cfg = _configs()
    tree = _tree(ref_cfg)
    model = weights.params_from_jax(tree, device="cpu")
    assert model.cfg.n_experts == 4
    names = dict(model.named_parameters())
    for leaf in ("router", "we1", "we2"):
        np.testing.assert_array_equal(names[f"moe.{leaf}"].detach().numpy(),
                                      tree["moe"][leaf])
    drawn = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    for name, p in drawn.named_parameters():
        assert tuple(p.shape) == tuple(names[name].shape), name
    assert [T.moe_slot(cfg, i) for i in range(cfg.n_layers)] == \
        [ref_tf.moe_slot(ref_cfg, i) for i in range(cfg.n_layers)]
    np.testing.assert_allclose(
        drawn.moe["we2"].detach().std().item(), 1 / np.sqrt(SHAPE["d_ff"]),
        rtol=0.05)


@pytest.mark.parametrize("topk", [1, 2])
def test_moe_apply_matches_reference(topk):
    ref_cfg, cfg = _configs(moe_topk=topk)
    tree = _tree(ref_cfg)
    model = weights.params_from_jax(tree, cfg, device="cpu")
    toks = _tokens(1, (2, 24))
    want = ref_tf.apply(tree, jnp.asarray(toks), ref_cfg)
    got = T.apply(model, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGITS_TOL)


@pytest.mark.parametrize("topk", [1, 2])
def test_loss_and_every_gradient_match_jax_value_and_grad(topk):
    ref_cfg, cfg = _configs(moe_topk=topk)
    tree = _tree(ref_cfg)
    model = weights.params_from_jax(tree, cfg, device="cpu")
    toks = _tokens(2, (2, 25))
    want_loss, want_grads = jax.value_and_grad(ref_train.loss_fn)(
        tree, jnp.asarray(toks), ref_cfg)
    loss = Tr.loss_fn(model, torch.from_numpy(toks), cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    flat = weights._params_flat(jax.tree_util.tree_map(np.asarray,
                                                       want_grads))
    names = dict(model.named_parameters())
    assert set(flat) == set(names)
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), flat[name],
                                   err_msg=name, **GRAD_TOL)


def _ref_state(ref_cfg, seed=0):
    tx, step = ref_train.make_train_step(ref_cfg, mesh=None, lr=LR)
    params = ref_tf.init(jax.random.PRNGKey(seed), ref_cfg)
    state = ref_train.TrainState(params=params, opt_state=tx.init(params),
                                 step=jnp.zeros((), jnp.int32))
    return state, step


def test_one_adamw_step_matches_make_train_step():
    ref_cfg, cfg = _configs()
    rstate, rstep = _ref_state(ref_cfg)
    state = weights.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, rstate), cfg, lr=LR,
        device="cpu")
    _, step = Tr.make_train_step(cfg, lr=LR, device="cpu")
    toks = _tokens(3, (2, 25))
    grads = jax.grad(ref_train.loss_fn)(rstate.params, jnp.asarray(toks),
                                        ref_cfg)
    r1, rloss = rstep(rstate, jnp.asarray(toks))
    p1, loss = step(state, torch.from_numpy(toks))
    assert p1 is state and int(p1.step) == int(r1.step) == 1
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-6)
    g = weights._params_flat(jax.tree_util.tree_map(np.asarray, grads))
    before = weights._params_flat(jax.tree_util.tree_map(np.asarray,
                                                         rstate.params))
    after = weights._params_flat(jax.tree_util.tree_map(np.asarray,
                                                        r1.params))
    clear = 0
    for name, p in p1.params.named_parameters():
        got, want, p0 = p.detach().numpy(), after[name], before[name]
        big = np.abs(g[name]) > SIGN_FLOOR
        clear += int(big.sum())
        np.testing.assert_allclose(got[big], want[big], atol=1e-6, rtol=0,
                                   err_msg=name)
        reach = LR * (1 + 0.01 * np.abs(p0)) + 1e-7
        assert (np.abs(got - p0) <= reach).all(), name
        assert (np.abs(want - p0) <= reach).all(), name
        adam = p1.opt_state.state[p]
        assert float(adam["step"]) == 1.0
    # the strict leg covers most elements (pos rows past S get no gradient)
    assert clear > 0.5 * sum(p.numel() for p in p1.params.parameters())


def test_loss_falls_over_six_steps():
    """The one-device form of test_parallel.py:128-147 (lr 1e-2)."""
    _, cfg = _configs()
    model = T.init(torch.Generator().manual_seed(1), cfg, "cpu")
    tx, step = Tr.make_train_step(cfg, lr=1e-2, device="cpu")
    state = Tr.TrainState(model, tx(model), torch.zeros((), dtype=torch.int32))
    toks = torch.from_numpy(_tokens(4, (4, 33)))
    state, l0 = step(state, toks)
    for _ in range(5):
        state, l1 = step(state, toks)
    assert l1.item() < l0.item(), (l0.item(), l1.item())
    assert int(state.step) == 6


def _tiny(moe=False):
    return T.ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                         d_ff=64, max_seq=32, n_experts=4 if moe else 0,
                         moe_every=2)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_model_forward_single(moe):
    """The port's forms of test_parallel.py:108-126."""
    cfg = _tiny(moe)
    model = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert hasattr(model, "moe") == moe
    logits = T.apply(model, torch.zeros((2, 16), dtype=torch.int32), cfg)
    assert logits.shape == (2, 16, 64)
    assert torch.isfinite(logits).all()


def test_inference_stays_gradient_free():
    cfg = _tiny()
    model = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert all(p.requires_grad for p in model.parameters())
    logits, k, v = D.prefill(model, torch.zeros((1, 5), dtype=torch.int32),
                             cfg)
    assert not (logits.requires_grad or k.requires_grad or v.requires_grad)
    cache = D.init_cache(cfg, 1, 8, "cpu")
    out, _ = D.decode_step(model, cache, torch.zeros(1, dtype=torch.int32),
                           torch.ones(1, dtype=torch.bool), cfg)
    assert not out.requires_grad
    assert T.apply(model, torch.zeros((1, 5), dtype=torch.int32),
                   cfg).requires_grad


def test_train_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda default is valid")
    cfg = _tiny(moe=True)
    model = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    state = Tr.TrainState(model, Tr.make_optimizer()(model),
                          torch.zeros((), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Tr.make_train_step(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        weights.train_state_from_jax(weights.train_state_to_flat(state), cfg)
    _, step = Tr.make_train_step(cfg, device="meta")
    with pytest.raises(ValueError, match="lies on cpu"):
        step(state, torch.zeros((1, 5), dtype=torch.int32))
