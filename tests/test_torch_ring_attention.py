"""Ring and Ulysses attention of the port (brpc_tpu_torch/parallel/
ring_attention.py) against the reference (brpc_tpu/parallel/
ring_attention.py) on the CPU: every case of tests/test_ring_attention.py.

The reference runs in this process on its 8-device CPU mesh (conftest.py)
on global arrays.  The port runs as one gloo world of 8 processes for the
whole module (``run_world``): each rank takes its shard of the same numpy
inputs, runs the port's per-rank function, and the test puts the ranks'
outputs together as the reference's sharding says (q, k, v and the
output at (dp, sp, tp, None); the logits at (dp, sp, None), equal across
tp).  At the reference's tolerances, f32: outputs within 1e-5 of the
dense reference and of the reference's ring or Ulysses output,
gradients within 1e-4, the model's logits within 2e-4 of the reference's
gather and ring/Ulysses logits.  The port's counterpart of the
reference's jit-once case is a second call giving the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from brpc_tpu.models import ModelConfig as RefConfig
from brpc_tpu.models import apply as ref_apply
from brpc_tpu.models import init as ref_init
from brpc_tpu.models.transformer import param_specs as ref_param_specs
from brpc_tpu.parallel import ring_attention as ref_ra
from brpc_tpu.parallel.mesh import make_mesh as ref_make_mesh
from brpc_tpu_torch.parallel import make_mesh
from brpc_tpu_torch.parallel.ring_attention import ulysses_attention
from test_torch_parallel import run_world

MESHES = {"sp": {"dp": 2, "sp": 4}, "sptp": {"dp": 2, "sp": 2, "tp": 2}}
QKV_SPEC = ("dp", "sp", "tp", None)
# name: (mesh, function, causal, seed, S) as the reference's cases
ATTN = {
    "ring_causal": ("sp", "ring", True, 0, 32),
    "ring_full": ("sp", "ring", False, 0, 32),
    "ring_dp_tp": ("sptp", "ring", True, 1, 32),
    "ring_again": ("sp", "ring", True, 3, 32),
    "ulysses_causal": ("sp", "ulysses", True, 0, 32),
    "ulysses_full": ("sp", "ulysses", False, 0, 32),
    "ulysses_dp_tp": ("sptp", "ulysses", True, 4, 32),
}
GRAD_CASE = ("sp", 2, 16)      # mesh, seed, S: gradients against dense
MODEL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=32)
IMPLS = ("gather", "ring", "ulysses")

_BODY = f"""
MESHES = {MESHES!r}
QKV_SPEC = {QKV_SPEC!r}
ATTN = {ATTN!r}
GRAD_CASE = {GRAD_CASE!r}
MODEL = {MODEL!r}
IMPLS = {IMPLS!r}
""" + r"""
from brpc_tpu_torch import weights
from brpc_tpu_torch.models import transformer as T
from brpc_tpu_torch.parallel import make_mesh, sharding
from brpc_tpu_torch.parallel.ring_attention import (ring_attention,
                                                    ulysses_attention)


def shard(data, key, mesh, spec=QKV_SPEC):
    return sharding.local_slice(torch.from_numpy(data[key]), spec,
                                mesh).contiguous()


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


def run(rank, world, data):
    out = {}
    meshes = {k: make_mesh(v, device_type="cpu") for k, v in MESHES.items()}
    for name, (mname, fn, causal, _, _) in ATTN.items():
        mesh = meshes[mname]
        q, k, v = (shard(data, f"{name}/{t}", mesh) for t in "qkv")
        f = ring_attention if fn == "ring" else ulysses_attention
        out[f"{name}/o"] = f(q, k, v, mesh, axis="sp", causal=causal)
        if name == "ring_again":
            out[f"{name}/o2"] = f(q, k, v, mesh, axis="sp", causal=causal)
    mesh = meshes[GRAD_CASE[0]]
    q, k, v = (shard(data, f"grad/{t}", mesh).requires_grad_(True)
               for t in "qkv")
    o = ring_attention(q, k, v, mesh, axis="sp", causal=True)
    for t, g in zip("qkv", torch.autograd.grad(o.sum(), (q, k, v))):
        out[f"grad/d{t}"] = g
    mesh = meshes["sptp"]
    tree = tree_of(data, "apply/params/")
    tokens = shard(data, "apply/tokens", mesh, ("dp", None))
    for impl in IMPLS:
        cfg = T.ModelConfig(dtype=torch.float32, attn_impl=impl, **MODEL)
        model = weights.params_from_jax(tree, cfg, "cpu", mesh)
        with torch.no_grad():
            out[f"apply/{impl}"] = T.apply(model, tokens, cfg)
    return out
"""


def _qkv(seed, S, B=2, H=4, K=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, K)).astype(np.float32)
            for _ in range(3)]


def _flat(tree, prefix):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def inputs():
    data = {}
    for name, (_, _, _, seed, S) in ATTN.items():
        for t, a in zip("qkv", _qkv(seed, S)):
            data[f"{name}/{t}"] = a
    for t, a in zip("qkv", _qkv(GRAD_CASE[1], GRAD_CASE[2])):
        data[f"grad/{t}"] = a
    cfg = RefConfig(dtype=jnp.float32, **MODEL)
    params = jax.tree.map(np.asarray, ref_init(jax.random.key(0), cfg))
    data.update(_flat(params, "apply/params/"))
    data["apply/tokens"] = np.random.default_rng(1).integers(
        0, MODEL["vocab"], (4, 32)).astype(np.int32)
    return data, params


@pytest.fixture(scope="module")
def world(inputs):
    return run_world(_BODY, inputs[0])


def _coords(rank, axes):
    return dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))


def assemble(parts, key, axes, spec):
    """The global array from the ranks' parts of `key`, sharded by `spec`
    over the mesh `axes` (rank-major as make_mesh lays it out); ranks
    that hold the same block must agree bit for bit."""
    axes = {a: axes[a] for a in ("dp", "ep", "sp", "tp") if a in axes}
    first = parts[0][key]
    shape = [n * (axes.get(a, 1) if a else 1)
             for n, a in zip(first.shape, spec)]
    out = np.full(shape, np.nan, first.dtype)
    seen = {}
    for rank, part in enumerate(parts):
        at = _coords(rank, axes)
        idx = tuple(slice(at[a] * n, (at[a] + 1) * n) if a in axes
                    else slice(None) for n, a in zip(part[key].shape, spec))
        block = tuple((s.start, s.stop) for s in idx)
        if block in seen:
            np.testing.assert_array_equal(part[key], seen[block],
                                          err_msg=f"{key} rank {rank}")
        seen[block] = part[key]
        out[idx] = part[key]
    assert not np.isnan(out).any()
    return out


def dense_reference(q, k, v, causal):
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = jnp.einsum("bshk,bthk->bhst", q, k).astype(jnp.float32) * scale
    if causal:
        S = q.shape[1]
        mask = jnp.tril(jnp.ones((S, S), bool))
        s = jnp.where(mask[None, None], s, -1e30)
    w = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhst,bthk->bshk", w,
                      v.astype(jnp.float32)).astype(q.dtype)


@pytest.mark.parametrize("name", sorted(ATTN))
def test_matches_dense_and_the_reference(world, inputs, name):
    mname, fn, causal, _, _ = ATTN[name]
    q, k, v = (inputs[0][f"{name}/{t}"] for t in "qkv")
    got = assemble(world, f"{name}/o", MESHES[mname], QKV_SPEC)
    want = dense_reference(q, k, v, causal)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    ref_fn = ref_ra.ring_attention if fn == "ring" else \
        ref_ra.ulysses_attention
    ref = ref_fn(q, k, v, ref_make_mesh(MESHES[mname]), axis="sp",
                 causal=causal)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_a_second_call_gives_the_same_bits(world):
    mesh = MESHES[ATTN["ring_again"][0]]
    np.testing.assert_array_equal(
        assemble(world, "ring_again/o", mesh, QKV_SPEC),
        assemble(world, "ring_again/o2", mesh, QKV_SPEC))


def test_gradients_match_dense(world, inputs):
    q, k, v = (inputs[0][f"grad/{t}"] for t in "qkv")
    want = jax.grad(lambda q, k, v: dense_reference(q, k, v, True).sum(),
                    argnums=(0, 1, 2))(q, k, v)
    for t, w in zip("qkv", want):
        got = assemble(world, f"grad/d{t}", MESHES[GRAD_CASE[0]], QKV_SPEC)
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-4, rtol=1e-4)


def test_head_divisibility_enforced():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 32, H=2))
    mesh = make_mesh(MESHES["sp"], devices=range(8), device_type="cpu")
    with pytest.raises(ValueError, match="divide"):   # 2 heads, sp = 4
        ulysses_attention(q, k, v, mesh, axis="sp")
    with pytest.raises(ValueError):
        ref_ra.ulysses_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 ref_make_mesh(MESHES["sp"]), axis="sp")


@pytest.fixture(scope="module")
def reference_logits(inputs):
    data, params = inputs
    mesh = ref_make_mesh(MESHES["sptp"])
    cfg_g = RefConfig(dtype=jnp.float32, **MODEL)
    specs = ref_param_specs(cfg_g)
    sharded = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        params, specs, is_leaf=lambda x: isinstance(x, P))
    tokens = jax.device_put(data["apply/tokens"],
                            NamedSharding(mesh, P("dp", "sp")))
    out = {}
    for impl in IMPLS:
        cfg = RefConfig(dtype=jnp.float32, attn_impl=impl, **MODEL)
        out[impl] = np.asarray(jax.jit(
            lambda p, t, cfg=cfg: ref_apply(p, t, cfg, mesh))(sharded,
                                                             tokens))
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_transformer_forward_matches_the_reference(world, reference_logits,
                                                   impl):
    """The port's logits at dp2 x sp2 x tp2 against the reference's with
    the same config and against its gather logits (test_ring_attention.py
    :107-133)."""
    got = assemble(world, f"apply/{impl}", MESHES["sptp"],
                   ("dp", "sp", None))
    for want in (reference_logits[impl], reference_logits["gather"]):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
