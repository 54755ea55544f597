"""The port's sharded training step (brpc_tpu_torch/models/train.py with a
mesh, transformer.py's shards, parallel/sharding.py) against the
reference's ``make_train_step(cfg, mesh)`` on the CPU.

The reference runs in this process on its 8-device CPU mesh; the port as
one gloo world of 8 processes for the module (``run_world``), each rank
holding its shards of ONE parameter tree (the reference's init, sliced
by ``weights.params_from_jax(..., mesh=)``) and its dp shard of the
tokens.  Cases, as tests/test_parallel.py:123-148 and
tests/test_ring_attention.py:135-160 run them:

* ``moe``: the MoE config at ``auto_mesh(8, ("dp","ep","sp","tp"))`` =
  dp2 x ep2 x tp2, gather attention;
* ``ring``, ``ulysses``, ``gather``: a dense config at dp2 x sp2 x tp2
  with each of the three attentions over sp (the hand-written backward
  of the all-to-all and of the sequence gather run only here at sp > 1).

In f32 the loss of one step is within 1e-5 relative of the reference
step's, and every gradient, gathered from the ranks, within 1e-4 of
``jax.value_and_grad(loss_fn)(params, tokens, cfg, mesh)`` in relative
norm; a gradient whose largest element stays below GRAD_FLOOR of the
largest gradient element anywhere is held to 1e-6 absolute instead (as
tests/test_torch_train.py holds every gradient): the top-1 router, whose
gates renormalise to 1, gets its gradient only through the 1e-9 of the
renormalisation, a few 1e-10 of noise in either framework.  A gradient
replicated over tp or ep (and, after the step's all-reduce, over dp and
sp) is bit-equal on every rank that holds it.  In bf16 the loss falls
over 6 steps at lr 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from brpc_tpu.models import train as ref_train
from brpc_tpu.models import transformer as ref_tf
from brpc_tpu.parallel import auto_mesh as ref_auto_mesh
from brpc_tpu.parallel.mesh import make_mesh as ref_make_mesh
from brpc_tpu_torch.models import transformer as T
from test_torch_parallel import run_world

LR = 1e-3
# name: (mesh axes, config, tokens shape)
CASES = {
    "moe": ({"dp": 2, "ep": 2, "sp": 1, "tp": 2},
            dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                 max_seq=32, n_experts=4, moe_every=2), (4, 33)),
    "ring": ({"dp": 2, "sp": 2, "tp": 2},
             dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                  max_seq=128, attn_impl="ring"), (4, 65)),
    "ulysses": ({"dp": 2, "sp": 2, "tp": 2},
                dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                     max_seq=128, attn_impl="ulysses"), (4, 65)),
    "gather": ({"dp": 2, "sp": 2, "tp": 2},
               dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                    max_seq=128, attn_impl="gather"), (4, 65)),
}
BF16_STEPS = 6
GRAD_FLOOR = 1e-6

_BODY = f"""
CASES = {CASES!r}
LR = {LR!r}
BF16_STEPS = {BF16_STEPS!r}
""" + r"""
from brpc_tpu_torch import weights
from brpc_tpu_torch.models import train as Tr
from brpc_tpu_torch.models import transformer as T
from brpc_tpu_torch.parallel import make_mesh, sharding


def tree_of(data, prefix):
    tree = {}
    for key, val in data.items():
        if key.startswith(prefix):
            *outer, leaf = key[len(prefix):].split("/")
            node = tree
            for part in outer:
                node = node.setdefault(part, {})
            node[leaf] = val
    return tree


def dp_shard(data, key, mesh):
    return sharding.local_slice(torch.from_numpy(data[key]), ("dp", None),
                                mesh)


def run(rank, world, data):
    out = {}
    for name, (axes, kw, _) in CASES.items():
        mesh = make_mesh(axes, device_type="cpu")
        cfg = T.ModelConfig(dtype=torch.float32, **kw)
        model = weights.params_from_jax(tree_of(data, f"{name}/params/"),
                                        cfg, "cpu", mesh)
        tx, step = Tr.make_train_step(cfg, mesh, lr=LR, device="cpu")
        state = Tr.TrainState(model, tx(model),
                              torch.zeros((), dtype=torch.int32))
        state, loss = step(state, dp_shard(data, f"{name}/tokens", mesh))
        out[f"{name}/loss"] = loss
        specs = T.flat_specs(cfg)
        for pname, p in model.named_parameters():
            full = sharding.gather_global(p.grad, specs[pname], mesh)
            if rank == 0:
                out[f"{name}/grad/{pname}"] = full
            out[f"{name}/local/{pname}"] = p.grad
    axes, kw, _ = CASES["moe"]
    mesh = make_mesh(axes, device_type="cpu")
    cfg = T.ModelConfig(dtype=torch.bfloat16, **kw)
    tx, step = Tr.make_train_step(cfg, mesh, lr=1e-2, device="cpu")
    model = T.init(torch.Generator().manual_seed(1), cfg, "cpu", mesh)
    state = Tr.TrainState(model, tx(model), torch.zeros((), dtype=torch.int32))
    tokens = dp_shard(data, "moe/tokens", mesh)
    losses = []
    for _ in range(BF16_STEPS):
        state, loss = step(state, tokens)
        losses.append(loss.item())
    out["bf16/losses"] = torch.tensor(losses)
    out["bf16/step"] = state.step
    return out
"""


def _flat(tree, prefix="", sep="/"):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}{sep}", sep))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _ref_mesh(name):
    axes = CASES[name][0]
    if name == "moe":
        mesh = ref_auto_mesh(8, axis_names=("dp", "ep", "sp", "tp"))
        assert dict(mesh.shape) == axes
        return mesh
    return ref_make_mesh(axes)


@pytest.fixture(scope="module")
def reference():
    """{case: (params, tokens, loss of make_train_step(cfg, mesh),
    {param name: gradient})} in f32."""
    out = {}
    for seed, (name, (_, kw, shape)) in enumerate(CASES.items()):
        mesh = _ref_mesh(name)
        cfg = ref_tf.ModelConfig(dtype=jnp.float32, **kw)
        params = ref_tf.init(jax.random.key(seed), cfg)
        sharded = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            params, ref_tf.param_specs(cfg),
            is_leaf=lambda x: isinstance(x, P))
        tokens = np.random.default_rng(seed + 10).integers(
            0, kw["vocab"], shape).astype(np.int32)
        jtokens = jax.device_put(tokens, NamedSharding(mesh, P("dp", None)))
        _, grads = jax.jit(lambda p, t: jax.value_and_grad(
            ref_train.loss_fn)(p, t, cfg, mesh))(sharded, jtokens)
        tx, step = ref_train.make_train_step(cfg, mesh, lr=LR, donate=False)
        state = ref_train.TrainState(params=sharded,
                                     opt_state=tx.init(sharded),
                                     step=jnp.zeros((), jnp.int32))
        _, loss = step(state, jtokens)
        out[name] = (jax.tree.map(np.asarray, params), tokens, float(loss),
                     {k.replace("/", "."): v for k, v in
                      _flat(jax.tree.map(np.asarray, grads)).items()})
    return out


@pytest.fixture(scope="module")
def world(reference):
    data = {}
    for name, (params, tokens, _, _) in reference.items():
        data.update(_flat(params, f"{name}/params/"))
        data[f"{name}/tokens"] = tokens
    return run_world(_BODY, data)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_the_reference_step(world, reference, name):
    want = reference[name][2]
    for part in world:      # the global loss on every rank
        np.testing.assert_allclose(float(part[f"{name}/loss"]), want,
                                   rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_gathered_gradient_matches_value_and_grad(world, reference,
                                                        name):
    want = reference[name][3]
    got = {k[len(f"{name}/grad/"):]: v for k, v in world[0].items()
           if k.startswith(f"{name}/grad/")}
    assert set(got) == set(want)
    floor = GRAD_FLOOR * max(float(np.abs(w).max()) for w in want.values())
    for pname, g in got.items():
        w = want[pname]
        assert g.shape == w.shape, pname
        if np.abs(w).max() < floor:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0,
                                       err_msg=pname)
            continue
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 1e-4, (pname, rel)


def _coords(rank, axes):
    return dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))


@pytest.mark.parametrize("name", sorted(CASES))
def test_replicated_gradients_are_equal_across_their_ranks(world, name):
    """Ranks that hold the same shard of a parameter (the same index on
    the axes its spec names) hold the same gradient, bit for bit."""
    axes, kw, _ = CASES[name]
    specs = T.flat_specs(T.ModelConfig(**kw))
    for pname, spec in specs.items():
        named = [a for a in spec if a in axes]
        held = {}
        for rank, part in enumerate(world):
            at = _coords(rank, axes)
            key = tuple(at[a] for a in named)
            g = part[f"{name}/local/{pname}"]
            if key in held:
                np.testing.assert_array_equal(
                    g, held[key], err_msg=f"{pname} rank {rank}")
            held[key] = g
        assert len(held) == int(np.prod([axes[a] for a in named]))


def test_bf16_sharded_loss_decreases(world):
    for part in world:
        losses = part["bf16/losses"]
        assert np.isfinite(losses).all() and (losses > 0).all()
        assert losses[-1] < losses[0], losses
        assert int(part["bf16/step"]) == BF16_STEPS
    np.testing.assert_array_equal(world[0]["bf16/losses"],
                                  world[-1]["bf16/losses"])
