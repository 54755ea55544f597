"""The port's mesh and collectives (brpc_tpu_torch/parallel/) against the
reference (brpc_tpu/parallel/) on the CPU.

The reference runs in this process on its 8-device CPU mesh (conftest.py)
and its verbs take and return global arrays.  The port's verbs take and
return one rank's part, so the port runs as a gloo world of 8 processes
(one world for the whole module, every case in it); each rank saves its
results, and the test puts the ranks' parts together as the reference's
output sharding says and compares them with the reference's global
output EXACTLY.  The inputs are integer-valued f32 from a numpy seed, so
every sum is exact in f32 whatever order the collective adds in.

The mesh legs run on two meshes: ``dp8`` (the verbs over dp) and
``dp2xtp4`` (the verbs over tp, each dp row with its own input), where a
verb that used the wrong process group would mix the rows.
"""

import os
import socket
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from brpc_tpu.parallel import collectives as ref_c
from brpc_tpu.parallel import mesh as ref_mesh
from brpc_tpu_torch.parallel import mesh as port_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
WORLD_TIMEOUT_S = 240

# What a rank process runs around a module's `run(rank, world, data)`,
# which returns {name: tensor}.  The ranks import neither jax nor the
# reference.
_RANK_IMPORTS = """
import sys
import numpy as np
import torch
import torch.distributed as dist
"""
_RANK_MAIN = r"""
rank, world, port, data_path, out_path = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
try:
    out = run(rank, world, dict(np.load(data_path)))
finally:
    dist.destroy_process_group()
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "brpc_tpu")]
np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(body: str, data: dict, world: int = WORLD) -> list:
    """Run `body` (defining run(rank, world, data)) in `world` gloo ranks;
    returns each rank's {name: ndarray}."""
    script = _RANK_IMPORTS + body + _RANK_MAIN
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    with tempfile.TemporaryDirectory() as tmp:
        data_path = os.path.join(tmp, "data.npz")
        np.savez(data_path, **data)
        port = _free_port()
        procs, logs = [], []
        try:
            for r in range(world):
                log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", script, str(r), str(world),
                     str(port), data_path, os.path.join(tmp, f"{r}.npz")],
                    env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
            for p in procs:
                p.wait(timeout=WORLD_TIMEOUT_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = []
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            if p.returncode != 0:
                failed.append(f"rank {r} exit {p.returncode}:\n"
                              f"{log.read()[-3000:]}")
            log.close()
        assert not failed, "\n".join(failed)
        return [dict(np.load(os.path.join(tmp, f"{r}.npz")))
                for r in range(world)]


# name: (verb, keyword arguments, input, the dim the reference shards its
# output on over the axis, or None where every member holds all of it)
CASES = {
    "all_reduce_add": ("all_reduce", {"op": "add"}, "vec", 0),
    "all_reduce_max": ("all_reduce", {"op": "max"}, "vec", 0),
    "all_reduce_min": ("all_reduce", {"op": "min"}, "vec", 0),
    "all_gather_tiled": ("all_gather", {"tiled": True}, "vec", None),
    "all_gather_stacked": ("all_gather", {"tiled": False}, "vec", None),
    "reduce_scatter": ("reduce_scatter", {}, "rs", 0),
    "ring_permute_1": ("ring_permute", {"shift": 1}, "vec", 0),
    "ring_permute_3": ("ring_permute", {"shift": 3}, "vec", 0),
    "all_to_all": ("all_to_all", {}, "a2a", 1),
}
# mesh: (axes, the axis the verbs run over)
MESHES = {"dp8": ({"dp": 8}, "dp"), "dp2xtp4": ({"dp": 2, "tp": 4}, "tp")}

_BODY = f"""
CASES = {CASES!r}
MESHES = {MESHES!r}
""" + r"""
from brpc_tpu_torch.parallel import collectives, make_mesh


def run(rank, world, data):
    out = {}
    for mname, (axes, axis) in MESHES.items():
        mesh = make_mesh(axes, device_type="cpu")
        n = mesh.shape[axis]
        row, i = divmod(rank, n)            # this rank's place on the axis
        for name, (verb, kw, inp, _) in CASES.items():
            x = data[f"{inp}_row{row}"]
            k = x.shape[0] // n
            shard = torch.from_numpy(x[i * k:(i + 1) * k])
            out[f"{mname}/{name}"] = getattr(collectives, verb)(
                mesh, axis, shard, **kw)
        out[f"{mname}/busbw"] = torch.tensor(collectives.bus_bandwidth_gbps(
            mesh, axis, mbytes_per_shard=0.25, iters=2))
    return out
"""


def _inputs():
    rng = np.random.default_rng(0)

    def ints(*shape):
        return rng.integers(-1000, 1000, shape).astype(np.float32)

    return {f"{inp}_row{row}": ints(*shape)
            for row in range(2)
            for inp, shape in (("vec", (16, 3)), ("rs", (128, 3)),
                               ("a2a", (16, 16, 2)))}


@pytest.fixture(scope="module")
def world():
    data = _inputs()
    return data, run_world(_BODY, data)


def _reference(mname, name, data, row):
    axes, axis = MESHES[mname]
    verb, kw, inp, _ = CASES[name]
    mesh = ref_mesh.make_mesh(axes)
    return np.asarray(getattr(ref_c, verb)(
        mesh, axis, jnp.asarray(data[f"{inp}_row{row}"]), **kw))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mname", sorted(MESHES))
def test_verb_matches_reference(world, mname, name):
    data, results = world
    axes, axis = MESHES[mname]
    n = axes[axis]
    out_dim = CASES[name][3]
    for row in range(WORLD // n):
        want = _reference(mname, name, data, row)
        parts = [results[r][f"{mname}/{name}"]
                 for r in range(row * n, (row + 1) * n)]
        if out_dim is None:
            for part in parts:
                np.testing.assert_array_equal(part, want)
        else:
            np.testing.assert_array_equal(np.concatenate(parts, out_dim),
                                          want)


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_bus_bandwidth_runs(world, mname):
    _, results = world
    assert all(float(r[f"{mname}/busbw"]) > 0 for r in results)


# --- factoring, in process (no process group) -------------------------------


def _same_mesh(got, want):
    assert got.axis_names == want.axis_names
    assert list(got.shape.items()) == list(want.shape.items())
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.ranks, ids)


@pytest.mark.parametrize("axes", [
    {"dp": 2, "tp": 4}, {"dp": -1, "tp": 2}, {"fanout": 4, "tp": 2},
    {"tp": 2, "dp": 2, "ep": 2}, {"sp": 2, "pp": 2, "dp": -1},
    {"part": 8}])
def test_make_mesh_factors_as_the_reference(axes):
    _same_mesh(port_mesh.make_mesh(axes, devices=range(8),
                                   device_type="cpu"),
               ref_mesh.make_mesh(axes))


@pytest.mark.parametrize("axes", [
    {"dp": 3}, {"pt": 8}, {"dp": -1, "tp": -1}, {"dp": -1, "tp": 3}])
def test_make_mesh_refuses_what_the_reference_refuses(axes):
    with pytest.raises(ValueError):
        ref_mesh.make_mesh(axes)
    with pytest.raises(ValueError):
        port_mesh.make_mesh(axes, devices=range(8), device_type="cpu")


@pytest.mark.parametrize("n, names", [
    (8, ("dp", "ep", "sp", "tp")), (4, ("dp", "tp")), (8, ("dp", "sp")),
    (6, ("dp", "sp", "tp")), (7, ("dp", "tp")), (8, ("dp", "sp", "tp"))])
def test_auto_mesh_priority_as_the_reference(n, names):
    _same_mesh(port_mesh.auto_mesh(n, axis_names=names, device_type="cpu"),
               ref_mesh.auto_mesh(n, axis_names=names))


def test_prune_spec_and_axis_size_as_the_reference():
    axes = {"dp": 2, "sp": 4}
    ref_m = ref_mesh.make_mesh(axes)
    port_m = port_mesh.make_mesh(axes, devices=range(8), device_type="cpu")
    for spec in (("dp", "sp", "tp", None), (("dp", "tp"), None, "sp"),
                 (("dp", "sp"), "ep")):
        assert port_mesh.prune_spec(spec, port_m) == tuple(
            ref_mesh.prune_spec(PartitionSpec(*spec), ref_m))
    for name in ("dp", "sp", "tp"):
        assert port_mesh.axis_size(port_m, name) == \
            ref_mesh.axis_size(ref_m, name)


def test_a_mesh_needs_a_process_group_of_its_size():
    m = port_mesh.make_mesh({"dp": 8}, devices=range(8), device_type="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        m.group("dp")


def test_chip_smoke_merges_the_param_server_gradient_size():
    """chip_smoke.PS_PARAMS is the parameter count of the reference's
    parameter-server example (its shape table, read without importing
    the example, which sets up jax)."""
    import ast

    import chip_smoke
    path = os.path.join(REPO, "examples", "param_server_allreduce.py")
    tree = ast.parse(open(path).read(), path)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "resnet50_param_shapes")
    ns = {}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    count = sum(int(np.prod(s)) for _, s in ns["resnet50_param_shapes"]())
    assert chip_smoke.PS_PARAMS == count
