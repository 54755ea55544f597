"""Checkpoints over a mesh (brpc_tpu_torch/models/checkpoint.py,
weights.py with ``mesh=``) and the port's multi-rank entry point
(brpc_tpu_torch/entry.py) on the CPU.

* Across layouts, as tests/test_checkpoint.py:69: a state stepped once at
  ``auto_mesh(4, ("dp","tp"))`` (dp2 x tp2) is saved, restored onto
  ``auto_mesh(4, ("dp","sp"))`` (dp2 x sp2), and every leaf (parameters,
  AdamW's mu and nu, counts) equals the saved one bit for bit; one more
  step from either layout gives the same loss within 1e-6.
* Across packages: a checkpoint the reference wrote restores onto a port
  mesh with every leaf bit-equal, and the port's next step matches the
  reference's next step from that state (loss within 1e-5).
* ``entry.dryrun_multichip(8, device_type="cpu")`` runs its eight gloo
  ranks and each prints the reference's summary line; asking for cuda
  without cards raises.

The port's ranks are one gloo world of 4 processes (``run_world``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import ModelConfig as RefConfig
from brpc_tpu.models import TrainState as RefState
from brpc_tpu.models import checkpoint as ref_checkpoint
from brpc_tpu.models import init as ref_init
from brpc_tpu.models import make_train_step as ref_make_train_step
from brpc_tpu_torch import entry
from test_torch_parallel import run_world

MODEL = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
             max_seq=32, n_experts=0, moe_every=2)
WORLD = 4

_BODY = f"""
MODEL = {MODEL!r}
""" + r"""
import os

from brpc_tpu_torch import weights
from brpc_tpu_torch.models import checkpoint
from brpc_tpu_torch.models import train as Tr
from brpc_tpu_torch.models import transformer as T
from brpc_tpu_torch.parallel import auto_mesh, sharding


def fresh(mesh, seed):
    cfg = T.ModelConfig(dtype=torch.float32, **MODEL)
    tx, step = Tr.make_train_step(cfg, mesh, lr=1e-3, device="cpu")
    model = T.init(torch.Generator().manual_seed(seed), cfg, "cpu", mesh)
    return step, Tr.TrainState(model, tx(model),
                               torch.zeros((), dtype=torch.int32))


def run(rank, world, data):
    d = str(data["workdir"])
    tokens = torch.from_numpy(data["tokens"])
    out = {}
    mesh_a = auto_mesh(world, ("dp", "tp"), device_type="cpu")
    mesh_b = auto_mesh(world, ("dp", "sp"), device_type="cpu")
    shard_a = sharding.local_slice(tokens, ("dp", None), mesh_a)
    shard_b = sharding.local_slice(tokens, ("dp", None), mesh_b)

    # across layouts: dp2 x tp2 -> dp2 x sp2
    step_a, state_a = fresh(mesh_a, 0)
    state_a, _ = step_a(state_a, shard_a)
    path = os.path.join(d, "port.npz")
    out["layout/bytes"] = torch.tensor(checkpoint.save(path, state_a))
    step_b, template = fresh(mesh_b, 1)
    restored = checkpoint.restore(path, template)
    flat = weights.train_state_to_flat(restored)     # gathered
    if rank == 0:
        out.update({f"layout/leaf/{k}": torch.from_numpy(v)
                    for k, v in flat.items()})
    _, loss_a = step_a(state_a, shard_a)
    _, loss_b = step_b(restored, shard_b)
    out["layout/loss_a"], out["layout/loss_b"] = loss_a, loss_b

    # across packages: the reference's file onto dp2 x tp2
    step_a, template = fresh(mesh_a, 2)
    state = checkpoint.restore(os.path.join(d, "ref.npz"), template)
    flat = weights.train_state_to_flat(state)
    if rank == 0:
        out.update({f"package/leaf/{k}": torch.from_numpy(v)
                    for k, v in flat.items()})
    _, loss = step_a(state, shard_a)
    out["package/loss"] = loss
    return out
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's stepped state written to ref.npz, its next loss,
    and the tokens both packages step on."""
    d = tmp_path_factory.mktemp("sharded_ckpt")
    cfg = RefConfig(dtype=jnp.float32, **MODEL)
    tx, step = ref_make_train_step(cfg, mesh=None, lr=1e-3)
    params = ref_init(jax.random.key(3), cfg)
    state = RefState(params=params, opt_state=tx.init(params),
                     step=jnp.zeros((), jnp.int32))
    tokens = np.random.default_rng(4).integers(
        0, MODEL["vocab"], (4, 17)).astype(np.int32)
    state, _ = step(state, jnp.asarray(tokens))
    ref_checkpoint.save(str(d / "ref.npz"), state)
    _, next_loss = step(state, jnp.asarray(tokens))
    return d, tokens, float(next_loss)


@pytest.fixture(scope="module")
def world(setup):
    d, tokens, _ = setup
    return run_world(_BODY, {"workdir": np.array(str(d)), "tokens": tokens},
                     world=WORLD)


def _leaves(part, prefix):
    return {k[len(prefix):]: v for k, v in part.items()
            if k.startswith(prefix)}


def test_a_checkpoint_moves_across_mesh_layouts(world, setup):
    d = setup[0]
    with np.load(d / "port.npz") as z:
        saved = {k: z[k] for k in z.files}
    restored = _leaves(world[0], "layout/leaf/")
    assert set(restored) == set(saved)
    assert int(saved["step"]) == 1 and float(np.abs(
        saved["opt_state/0/mu/blocks/wq"]).max()) > 0
    for k, v in saved.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
    assert not os.path.exists(d / "port.npz.tmp")
    assert all(int(p["layout/bytes"]) == os.path.getsize(d / "port.npz")
               for p in world)
    for p in world:
        np.testing.assert_allclose(float(p["layout/loss_b"]),
                                   float(p["layout/loss_a"]), rtol=1e-6)


def test_a_reference_checkpoint_restores_onto_a_port_mesh(world, setup):
    d, _, next_loss = setup
    with np.load(d / "ref.npz") as z:
        saved = {k: z[k] for k in z.files}
    restored = _leaves(world[0], "package/leaf/")
    assert set(restored) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
    for p in world:
        np.testing.assert_allclose(float(p["package/loss"]), next_loss,
                                   rtol=1e-5)


def test_dryrun_multichip_on_eight_gloo_ranks(capsys):
    lines = entry.dryrun_multichip(8, device_type="cpu")
    assert len(lines) == 8
    for ln in lines:
        assert ln.startswith("gloo: dryrun_multichip(8): mesh={'dp': 2, "
                             "'ep': 2, 'sp': 1, 'tp': 2} loss="), ln
        assert "ring_mesh={'dp': 4, 'sp': 2} ring_loss=" in ln, ln
        assert ln.endswith(" ok") and "nan" not in ln, ln
    assert len(set(lines)) == 1     # every rank sees the global losses
    assert capsys.readouterr().out.count("dryrun_multichip(8)") == 8


def test_entry_forward_and_the_cuda_refusal():
    fn, args = entry.entry(device="cpu")
    assert tuple(fn(*args).shape) == (2, 32, 256)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda dryrun is valid")
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        entry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        entry.dryrun_multichip(2, device_type="tpu")
