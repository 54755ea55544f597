"""The port's device examples run clean on the CPU and agree with the
reference's, as tests/test_examples.py and tests/test_param_server.py
hold the reference's: each example in its own subprocess with --device
cpu (gloo worlds of 8 ranks; the fake CUDA driver's two devices for the
plane), its last stdout line the JSON asserted here.

    examples/ici_performance_torch.py        raw, HbmEcho and --stream
    examples/mesh_collectives_torch.py       merges over tp at dp2 x tp4
    examples/param_server_allreduce_torch.py --codec none | int8
    examples/long_context_ring_torch.py      logits against the reference's
    examples/memcache_client_torch.py        output against the reference's
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from brpc_tpu.models import ModelConfig as RefConfig
from brpc_tpu.models import apply as ref_apply
from brpc_tpu.models import init as ref_init
from brpc_tpu.models.transformer import param_specs as ref_param_specs
from brpc_tpu.parallel.channels import (MeshParallelChannel as RefParallel,
                                        MeshPartitionChannel as RefPartition)
from brpc_tpu.parallel.mesh import make_mesh as ref_make_mesh
from brpc_tpu_torch import _native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def _run(args, timeout=300, env_extra=None, cwd=REPO):
    env = dict(os.environ)
    env.update(env_extra or {})
    r = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, f"{args} failed:\n{r.stdout}\n{r.stderr}"
    return r


def _example(name, *args, timeout=300, env_extra=None):
    r = _run([os.path.join(EXAMPLES, name), *args], timeout, env_extra)
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_ici_performance_stream_on_the_fake_plane():
    """Raw round trips, HbmEcho over a tpu:// channel that settles
    'device' and sends zero-copy, and --stream on the fake driver's two
    devices: every d2d hop's and every frame's bytes equal to what was
    sent, each frame one d2d copy (d2d_transfers == frames) and no host
    landing (extra_host_copies 0), every buffer freed."""
    _native.build_core()
    j = _example("ici_performance_torch.py", "--device", "cpu", "--stream",
                 "--size-mb", "1", "--seconds", "1")
    assert j["available"] and j["platform"] == "cuda", j
    assert j["devices"] == 2, j
    raw, rpc, st = j["raw"], j["rpc"], j["stream"]
    assert raw["rounds"] > 0 and raw["roundtrip_gbps"] > 0, raw
    assert rpc["transport"] == "device", rpc
    assert rpc["rounds"] > 0 and rpc["zero_copy_sends"] == rpc["rounds"]
    assert rpc["gather_copies"] == 0, rpc
    assert st["d2d_hops"] > 0 and st["frames"] > 0, st
    assert st["bytes_equal"], st
    assert st["bytes_checked"] == (st["d2d_hops"] + st["frames"]) << 20
    assert st["d2d_transfers"] == st["frames"], st
    assert st["extra_host_copies"] == 0 and st["gather_copies"] == 0, st
    assert st["check_reads"] == st["frames"], st
    assert j["live_buffers_end"] == 0, j


def test_ici_performance_says_when_the_plane_is_unavailable():
    """No loadable driver: the reference's explicit line, not a figure."""
    _native.build_core()
    j = _example("ici_performance_torch.py", "--seconds", "0.1",
                 env_extra={"TRPC_CUDA_DRIVER": "/nonexistent/libcuda.so.1"})
    assert j["available"] is False and j["fallback"] == "tcp", j
    assert "not loadable" in j["reason"], j


@pytest.fixture(scope="module")
def reference_merges():
    """The reference example's merges on its 8-device CPU mesh."""
    mesh = ref_make_mesh({"dp": 2, "tp": 4})
    x = jnp.ones((8, 8))
    merged = RefParallel(mesh, "tp", merger="add").call_tensor(x)
    part = RefPartition(mesh, "tp")
    return {"allreduce_value": float(merged[0, 0]),
            "allreduce_shape": list(merged.shape),
            "gather_shape": list(part.call_gather(x).shape),
            "reduce_scatter_shape": list(part.call_reduce_scatter(
                jnp.ones((16, 8))).shape)}


def test_mesh_collectives_matches_the_reference(reference_merges):
    """MeshParallelChannel(merger="add") and MeshPartitionChannel over tp
    on 8 gloo ranks at dp2 x tp4: x's entry summed over the 4 tp members,
    the gather and reduce_scatter merges' global shapes, all as the
    reference's mesh gives them; a bus bandwidth measured over 4 members."""
    j = _example("mesh_collectives_torch.py", "--device", "cpu")
    assert j["mesh"] == {"dp": 2, "tp": 4} and j["backend"] == "gloo", j
    assert {k: j[k] for k in reference_merges} == reference_merges, j
    assert j["allreduce_value"] == 4.0, j
    assert j["reduce_scatter_local_shape"] == [1, 8], j
    assert j["busbw_gbps"] > 0 and "busbw_note" not in j, j


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_param_server_allreduce(codec):
    """ResNet-50's 25,557,032 gradient values, one row per dp worker on 8
    gloo ranks: the merge equal to the dense sum (none), or off it by more
    than 0 and at most the workers' int8 bounds added; the rates measured
    (tests/test_param_server.py's assertions and its codec leg's)."""
    j = _example("param_server_allreduce_torch.py", "--device", "cpu",
                 "--codec", codec, timeout=600)
    assert 25_000_000 < j["params"] < 26_000_000, j
    assert j["params"] == 25_557_032, j
    assert j["numeric_check"] == "ok" and j["codec"] == codec, j
    assert j["devices"] >= 8 and j["platform"] == "cpu", j
    assert j["allreduce_busbw_gbps"] > 0 and j["probe_busbw_gbps"] > 0, j
    if codec == "none":
        assert j["codec_max_abs_err"] is None, j
    else:
        assert 0.0 < j["codec_max_abs_err"] <= j["codec_err_bound"], j


LONG_CFG = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                max_seq=4096, attn_impl="ring")


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def reference_long_context(tmp_path_factory):
    """The reference example's weights (init(jax.random.key(0), cfg)) as
    an npz, and its forward's logits on the 8-device CPU mesh at dp2 x
    sp2 x tp2 (examples/long_context_ring.py:37-50)."""
    mesh = ref_make_mesh({"dp": 2, "sp": 2, "tp": 2})
    cfg = RefConfig(dtype=jnp.float32, **LONG_CFG)
    params = ref_init(jax.random.key(0), cfg)
    path = tmp_path_factory.mktemp("long_context") / "weights.npz"
    np.savez(path, **_flat(params))
    sharded = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        params, ref_param_specs(cfg), is_leaf=lambda x: isinstance(x, P))
    tokens = jax.device_put(jnp.zeros((2, 4096), jnp.int32),
                            NamedSharding(mesh, P("dp", None)))
    logits = jax.jit(lambda p, t: ref_apply(p, t, cfg, mesh))(sharded,
                                                             tokens)
    return path, np.asarray(logits)


def test_long_context_ring_matches_the_reference(reference_long_context,
                                                 tmp_path):
    """S = 4096 over sp 2 on 8 gloo ranks at dp2 x sp2 x tp2 with the
    reference's weights: the logits [2, 4096, 256], gathered over dp and
    sp, within 1e-4 of the reference example's forward."""
    weights, want = reference_long_context
    out = tmp_path / "logits.npy"
    j = _example("long_context_ring_torch.py", "--device", "cpu",
                 "--weights", str(weights), "--out", str(out))
    assert j["mesh"] == {"dp": 2, "sp": 2, "tp": 2}, j
    assert j["logits_shape"] == [2, 4096, 256] and j["finite"], j
    assert j["weights"] == "reference npz", j
    got = np.load(out)
    assert got.shape == want.shape == (2, 4096, 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_memcache_client_prints_what_the_reference_prints():
    """The binary-protocol client against the port's MiniMemcached: set,
    get, incr, a batched multi_get and a CAS, line for line the output of
    examples/memcache_client.py."""
    port = _run([os.path.join(EXAMPLES, "memcache_client_torch.py")], 120)
    ref = _run(["memcache_client.py"], 120,
               {"JAX_PLATFORMS": "cpu"}, cwd=EXAMPLES)
    lines = port.stdout.strip().splitlines()
    assert lines[:-1] == ref.stdout.strip().splitlines()
    j = json.loads(lines[-1])
    assert j["cas"] == "compare-and-swapped" and j["incr"] == [41, 42], j
    assert j["multi_get"] == {f"key-{i}": f"value-{i}" for i in range(5)}
