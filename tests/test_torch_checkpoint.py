"""TrainState checkpoint/restore of the port (brpc_tpu_torch/models/
checkpoint.py) and its format, which is the reference's
(brpc_tpu/models/checkpoint.py): a checkpoint written by either package
restores in the other.

The port's forms of tests/test_checkpoint.py:26-66 (round trip, atomic
save, a missing leaf fails loudly), then both directions across the
packages: a JAX-written checkpoint restores in the port and its next
step's loss matches the reference's next step (f32, rtol 1e-6); a
port-written checkpoint restores with the reference's ``restore``
against a JAX template, with identical keys and equal arrays.  The
reference's mesh-layout restore needs a mesh and waits for the port's
parallel/ modules.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import checkpoint as ref_ckpt
from brpc_tpu.models import train as ref_train
from brpc_tpu.models import transformer as ref_tf
from brpc_tpu_torch import weights
from brpc_tpu_torch.models import checkpoint, train
from brpc_tpu_torch.models import transformer as T

SHAPE = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_seq=32, n_experts=4, moe_every=2)


def _tiny_state():
    cfg = T.ModelConfig(dtype=torch.float32, **SHAPE)
    tx, step = train.make_train_step(cfg, device="cpu")
    model = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    state = train.TrainState(model, tx(model),
                             torch.zeros((), dtype=torch.int32))
    return cfg, step, state


def _leaves(state):
    return weights.train_state_to_flat(state)


def test_save_restore_roundtrip(tmp_path):
    _, step, state = _tiny_state()
    tokens = torch.ones((2, 17), dtype=torch.int32)
    state, _ = step(state, tokens)

    path = str(tmp_path / "ck.npz")
    n = checkpoint.save(path, state)
    assert n > 0 and os.path.exists(path)

    restored = checkpoint.restore(path, state)
    assert restored is not state
    a, b = _leaves(state), _leaves(restored)
    assert list(a) == list(b)
    for key in a:                                     # bit-identical
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)

    # training continues deterministically from the restored state
    _, loss_a = step(state, tokens)
    s_b, loss_b = step(restored, tokens)
    assert loss_a.item() == pytest.approx(loss_b.item(), rel=1e-6)
    assert int(s_b.step) == 2


def test_save_is_atomic(tmp_path):
    _, _, state = _tiny_state()
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, state)
    before = os.path.getsize(path)
    # a second save replaces, never truncates-in-place
    checkpoint.save(path, state)
    assert os.path.getsize(path) == before
    assert not os.path.exists(path + ".tmp")


def test_restore_missing_leaf_fails_loudly(tmp_path):
    _, _, state = _tiny_state()
    path = str(tmp_path / "ck.npz")
    np.savez(path, **{"params/bogus": np.zeros(2)})
    with pytest.raises(KeyError):
        checkpoint.restore(path, state)
    full = _leaves(state)
    del full["opt_state/0/nu/moe/we1"]
    np.savez(path, **full)
    with pytest.raises(KeyError, match="opt_state/0/nu/moe/we1"):
        checkpoint.restore(path, state)


def _ref():
    cfg = ref_tf.ModelConfig(dtype=jnp.float32, **SHAPE)
    tx, step = ref_train.make_train_step(cfg, mesh=None)
    params = ref_tf.init(jax.random.key(0), cfg)
    state = ref_train.TrainState(params=params, opt_state=tx.init(params),
                                 step=jnp.zeros((), jnp.int32))
    return cfg, step, state


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, SHAPE["vocab"], (2, 17),
                                                dtype=np.int32)


def test_a_jax_checkpoint_restores_in_the_port_and_steps_alike(tmp_path):
    _, rstep, rstate = _ref()
    rstate, _ = rstep(rstate, jnp.asarray(_tokens(1)))
    path = str(tmp_path / "jax.npz")
    ref_ckpt.save(path, rstate)

    cfg, step, template = _tiny_state()
    state = checkpoint.restore(path, template)
    assert int(state.step) == 1
    direct = weights.train_state_from_jax(path, lr=1e-3, device="cpu")
    assert direct.params.cfg.n_experts == SHAPE["n_experts"]
    assert _leaves(direct).keys() == _leaves(state).keys()
    stored = dict(np.load(path))
    got = _leaves(state)
    assert set(got) == set(stored)
    for key in stored:
        assert got[key].dtype == stored[key].dtype, key
        np.testing.assert_array_equal(got[key], stored[key], err_msg=key)

    toks = _tokens(2)
    r2, rloss = rstep(rstate, jnp.asarray(toks))
    s2, loss = step(state, torch.from_numpy(toks))
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-6)
    assert int(s2.step) == int(r2.step) == 2


def test_a_port_checkpoint_restores_with_the_reference(tmp_path):
    _, step, state = _tiny_state()
    state, _ = step(state, torch.from_numpy(_tokens(3)))
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, state)

    _, _, template = _ref()
    restored = ref_ckpt.restore(path, template)
    want = ref_ckpt._flatten(restored)
    got = _leaves(state)
    assert set(want) == set(got) == set(ref_ckpt._flatten(template))
    for key, arr in want.items():
        assert arr.dtype == got[key].dtype, key
        np.testing.assert_array_equal(arr, got[key], err_msg=key)
    assert int(restored.step) == 1
