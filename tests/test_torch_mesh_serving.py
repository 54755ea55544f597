"""Serving over a mesh on the CPU: the port's sharded decode
(brpc_tpu_torch/models/decode.py with ``mesh=``) and its lockstep engine
(serving/engine.py, serving/lockstep.py) against the reference.

* Pure compute.  The reference runs in this process on its 8-device CPU
  mesh (jitted ``prefill`` and ``decode_step`` with ``mesh=``, eager
  ``install``); the port as gloo worlds (``run_world``), each rank on its
  shards of ONE parameter tree (the reference's ``transformer.init`` at
  ``tiny_config()`` in f32, carried over by ``weights.params_from_jax``).
  Two prefills go into slots of different dp groups, then STEPS decode
  steps run with slots idle, at ``dp2 x tp4`` and ``dp4 x tp2`` (worlds
  of 8) and at ``dp1 x sp2 x tp2`` (a world of 4: sp replicates).  Each
  rank's logits are held to the reference's block within atol 1e-4 /
  rtol 1e-5 (f32; only the order of the tp sums differs), its cache shard
  and ``pos`` to the matching slice of the reference's cache and the
  gathered prefill K/V to the reference's within 1e-5.
* The engine.  ``ServingEngine(mesh=)`` over a gloo world of 8 at
  ``dp2 x tp4`` (``entry.launch_world``: the leader on the fake CUDA
  driver, the followers on no plane) streams the same greedy tokens over
  ``LLM.Generate`` as the port's one-device engine and as the
  reference's engine on its ``dp2 x tp4`` mesh.  A token may differ only
  where the greedy choice is a tie within the logits' tolerance: the
  top-2 margin at each position is read from the one-device model and
  reported.
* The reference's mesh legs of tests/test_serving.py (every cancel
  surface, :110-248; the budget shed, preemption and the host-rail codec)
  run the port's copies of those legs (tests/test_torch_serving.py) on a
  ``dp2 x tp4`` world: the leader runs the leg, each follower replays
  its engines.  Both end in ``assert_drained()`` and ``live_buffers ==
  0``.
"""

import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import decode as ref_decode
from brpc_tpu.models import transformer as ref_tf
from brpc_tpu.parallel.mesh import make_mesh as ref_make_mesh
from brpc_tpu_torch import _native
from brpc_tpu_torch.entry import launch_world
from brpc_tpu_torch.models import decode as D
from brpc_tpu_torch.models import transformer as T
from brpc_tpu_torch.parallel import make_mesh
from brpc_tpu_torch.serving import ServingEngine
from brpc_tpu_torch.weights import params_from_jax
from test_torch_parallel import run_world
from test_torch_serving import (CANCEL_CODE, PREEMPT_CODE, REF_ENGINE_CODE,
                                SERVE_TAIL, _build_reference_core, _run)

LOGITS_TOL = dict(atol=1e-4, rtol=1e-5)
KV_TOL = dict(atol=1e-5, rtol=0)
# two logits (|logit| < 10 here) each within LOGITS_TOL of the reference's
# can change places only where their margin is below twice the tolerance
TIE = 2 * (LOGITS_TOL["atol"] + 10 * LOGITS_TOL["rtol"])
# tiny_config() (serving/engine.py) in f32
SHAPE = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64, n_experts=0)
SLOTS = 4
MAX_LEN = 64
PROMPT_LENS = (7, 12)
INSTALL_SLOTS = (0, 3)        # dp groups 0 and the last, in every layout
STEPS = 4
# active slots per step: slots 1 and 2 never installed, slot 3 idle
# (holding its K/V) in the last two steps
ACTIVE = [[1, 0, 0, 1], [1, 0, 0, 1], [1, 0, 0, 0], [1, 0, 0, 0]]
LAYOUTS = {"dp2_tp4": {"dp": 2, "tp": 4}, "dp4_tp2": {"dp": 4, "tp": 2},
           "dp1_sp2_tp2": {"dp": 1, "sp": 2, "tp": 2}}
ENGINE_AXES = {"dp": 2, "tp": 4}
MAX_NEW = 8                   # SERVE_TAIL's max_new_tokens


def _world(axes) -> int:
    return math.prod(axes.values())


def _inputs():
    rng = np.random.default_rng(5)
    data = {f"prompt{j}": rng.integers(0, SHAPE["vocab"], n).astype(np.int64)
            for j, n in enumerate(PROMPT_LENS)}
    data["tokens"] = rng.integers(0, SHAPE["vocab"],
                                  (STEPS, SLOTS)).astype(np.int64)
    data["active"] = np.asarray(ACTIVE, bool)
    return data


def _tree(seed=0):
    cfg = ref_tf.ModelConfig(dtype=jnp.float32, **SHAPE)
    return cfg, jax.tree_util.tree_map(
        np.asarray, ref_tf.init(jax.random.PRNGKey(seed), cfg))


def _flat(tree, prefix="params/"):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


# ---------------------------------------------------------------------------
# pure compute: the reference on its CPU mesh, the port in gloo worlds
# ---------------------------------------------------------------------------

_COMPUTE_BODY = f"""
LAYOUTS = {LAYOUTS!r}
SHAPE = {SHAPE!r}
SLOTS, MAX_LEN, STEPS = {SLOTS!r}, {MAX_LEN!r}, {STEPS!r}
INSTALL_SLOTS = {INSTALL_SLOTS!r}
""" + r"""
import math
from brpc_tpu_torch import weights
from brpc_tpu_torch.models import decode as D
from brpc_tpu_torch.models import transformer as T
from brpc_tpu_torch.parallel import make_mesh


def tree_of(data):
    tree = {}
    for key, val in data.items():
        if key.startswith("params/"):
            *outer, leaf = key[len("params/"):].split("/")
            node = tree
            for part in outer:
                node = node.setdefault(part, {})
            node[leaf] = val
    return tree


def run(rank, world, data):
    cfg = T.ModelConfig(dtype=torch.float32, **SHAPE)
    out = {}
    for name, axes in LAYOUTS.items():
        if math.prod(axes.values()) != world:
            continue
        mesh = make_mesh(axes, device_type="cpu")
        model = weights.params_from_jax(tree_of(data), cfg, "cpu", mesh)
        cache = D.init_cache(cfg, SLOTS, MAX_LEN, "cpu", mesh)
        for j, slot in enumerate(INSTALL_SLOTS):
            prompt = torch.from_numpy(data[f"prompt{j}"])
            logits, k, v = D.prefill(model, prompt[None], cfg)
            out[f"{name}/prefill{j}/logits"] = logits
            out[f"{name}/prefill{j}/k"] = k
            out[f"{name}/prefill{j}/v"] = v
            D.install(cache, slot, k[:, 0], v[:, 0], len(prompt), mesh)
        for t in range(STEPS):
            logits, cache = D.decode_step(model, cache, data["tokens"][t],
                                          data["active"][t], cfg)
            out[f"{name}/step{t}/logits"] = logits
        for key in ("k", "v", "pos"):
            out[f"{name}/cache/{key}"] = cache[key]
    return out
"""


def _reference_run(tree, cfg, axes, data):
    """The reference's jitted prefill / decode_step and eager install on
    its mesh of `axes` (the first devices of the 8-device CPU mesh)."""
    mesh = ref_make_mesh(axes, devices=jax.devices()[:_world(axes)])
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prefill = jax.jit(lambda p, t: ref_decode.prefill(p, t, cfg, mesh))
    step = jax.jit(lambda p, c, t, a: ref_decode.decode_step(p, c, t, a, cfg,
                                                             mesh))
    cache = ref_decode.init_cache(cfg, SLOTS, MAX_LEN, mesh)
    out = {}
    for j, slot in enumerate(INSTALL_SLOTS):
        prompt = data[f"prompt{j}"].astype(np.int32)
        logits, k, v = prefill(params, jnp.asarray(prompt[None]))
        out[f"prefill{j}/logits"] = np.asarray(logits)
        out[f"prefill{j}/k"] = np.asarray(k)
        out[f"prefill{j}/v"] = np.asarray(v)
        cache = ref_decode.install(cache, slot, k[:, 0], v[:, 0], len(prompt))
    for t in range(STEPS):
        logits, cache = step(params, cache,
                             jnp.asarray(data["tokens"][t].astype(np.int32)),
                             jnp.asarray(data["active"][t]))
        out[f"step{t}/logits"] = np.asarray(logits)
    for key in ("k", "v", "pos"):
        out[f"cache/{key}"] = np.asarray(cache[key])
    return out


@pytest.fixture(scope="module")
def compute():
    """(reference {layout: outputs}, port {layout: [rank outputs]})."""
    ref_cfg, tree = _tree()
    data = _inputs()
    want = {name: _reference_run(tree, ref_cfg, axes, data)
            for name, axes in LAYOUTS.items()}
    payload = dict(data, **_flat(tree))
    got = {}
    for world in sorted({_world(a) for a in LAYOUTS.values()}):
        parts = run_world(_COMPUTE_BODY, payload, world=world)
        for name, axes in LAYOUTS.items():
            if _world(axes) == world:
                got[name] = [{k[len(name) + 1:]: v for k, v in p.items()
                              if k.startswith(name + "/")} for p in parts]
    return want, got


def _coords(axes, rank):
    """{axis: index} of `rank` on the port's mesh (tp innermost)."""
    names = [a for a in ("pp", "dp", "ep", "sp", "tp") if a in axes]
    idx = np.unravel_index(rank, [axes[a] for a in names])
    return dict(zip(names, (int(i) for i in idx)))


def _block(n, parts, i):
    k = n // parts
    return slice(i * k, (i + 1) * k)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_prefill_logits_and_gathered_kv_match_the_reference(compute, name):
    want, got = compute
    for part in got[name]:
        for j in range(len(PROMPT_LENS)):
            np.testing.assert_allclose(part[f"prefill{j}/logits"],
                                       want[name][f"prefill{j}/logits"],
                                       **LOGITS_TOL)
            for key in ("k", "v"):
                np.testing.assert_allclose(part[f"prefill{j}/{key}"],
                                           want[name][f"prefill{j}/{key}"],
                                           **KV_TOL)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_decode_logits_are_each_dp_block_of_the_reference(compute, name):
    want, got = compute
    axes = LAYOUTS[name]
    dp = axes.get("dp", 1)
    for rank, part in enumerate(got[name]):
        rows = _block(SLOTS, dp, _coords(axes, rank).get("dp", 0))
        for t in range(STEPS):
            ref = want[name][f"step{t}/logits"][rows]
            assert part[f"step{t}/logits"].shape == ref.shape
            np.testing.assert_allclose(part[f"step{t}/logits"], ref,
                                       **LOGITS_TOL)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_cache_shards_are_slices_of_the_reference_cache(compute, name):
    want, got = compute
    axes = LAYOUTS[name]
    dp, tp = axes.get("dp", 1), axes.get("tp", 1)
    for rank, part in enumerate(got[name]):
        at = _coords(axes, rank)
        rows = _block(SLOTS, dp, at.get("dp", 0))
        heads = _block(SHAPE["n_heads"], tp, at.get("tp", 0))
        for key in ("k", "v"):
            ref = want[name][f"cache/{key}"][:, rows, :, heads]
            assert part[f"cache/{key}"].shape == ref.shape
            np.testing.assert_allclose(part[f"cache/{key}"], ref, **KV_TOL)
        np.testing.assert_array_equal(part["cache/pos"],
                                      want[name]["cache/pos"][rows])


def test_greedy_tokens_agree_where_the_margin_exceeds_the_tolerance(
        compute, record_property):
    """Over tp the row-parallel sums run in another order than the
    reference's: a greedy token may differ only at a top-2 margin below
    TIE (the smallest margin is recorded as a property of the test)."""
    want, got = compute
    margins = []
    for name, axes in LAYOUTS.items():
        dp = axes.get("dp", 1)
        for rank, part in enumerate(got[name]):
            rows = _block(SLOTS, dp, _coords(axes, rank).get("dp", 0))
            for t in range(STEPS):
                ref = want[name][f"step{t}/logits"][rows]
                top2 = np.sort(ref, axis=-1)[:, -2:]
                margin = top2[:, 1] - top2[:, 0]
                margins.append(float(margin.min()))
                same = part[f"step{t}/logits"].argmax(-1) == ref.argmax(-1)
                assert np.all(same | (margin <= TIE)), (name, rank, t, margin)
    record_property("smallest_top2_margin", min(margins))


def test_cache_and_engine_refuse_what_does_not_split():
    """slots over dp and heads over tp must divide (no process group:
    the refusals come before any collective); a device that contradicts
    the mesh's is refused."""
    cfg = T.ModelConfig(dtype=torch.float32, **SHAPE)
    mesh = make_mesh({"dp": 2, "tp": 4}, devices=range(8), device_type="cpu")
    with pytest.raises(ValueError, match="'dp'"):
        D.init_cache(cfg, 3, MAX_LEN, "cpu", mesh)
    wide = make_mesh({"dp": 1, "tp": 8}, devices=range(8), device_type="cpu")
    with pytest.raises(ValueError, match="'tp'"):
        D.init_cache(cfg, SLOTS, MAX_LEN, "cpu", wide)
    with pytest.raises(ValueError, match="conflicts with the mesh"):
        ServingEngine(cfg=cfg, mesh=mesh, device="cuda")


def test_mesh_device_is_the_ranks_card_not_the_threads_current(
        monkeypatch):
    """On a host of 4 cards rank 0's device is card 0 even where the
    calling thread's current device has moved (the device plane makes
    the last card's context current when it starts): otherwise a
    leader that starts its plane before its engine serves from another
    rank's card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    mesh = make_mesh({"tp": 4}, devices=range(4))
    assert mesh.device == torch.device("cuda", 0)


def test_one_device_cache_is_unchanged_without_a_mesh():
    cfg = T.ModelConfig(dtype=torch.float32, **SHAPE)
    cache = D.init_cache(cfg, SLOTS, MAX_LEN, "cpu")
    assert tuple(cache["k"].shape) == (SHAPE["n_layers"], SLOTS, MAX_LEN,
                                       SHAPE["n_heads"], 16)
    assert tuple(cache["pos"].shape) == (SLOTS,)


# ---------------------------------------------------------------------------
# the engine over a gloo world: token identity, cancel, preemption
# ---------------------------------------------------------------------------

# What each rank of an engine world runs (entry.launch_world's target).
RANKS_CODE = r'''
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist

from brpc_tpu_torch import tpu_plane, weights
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.server import Server
from brpc_tpu_torch.serving import ServingEngine
from brpc_tpu_torch.serving.engine import tiny_config
from brpc_tpu_torch.serving.kv_cache import KvBlockPlane


def _tree(path):
    z = np.load(path)
    return {"embed": z["embed"], "pos": z["pos"],
            "ln_f": {k[5:]: z[k] for k in z.files if k.startswith("ln_f.")},
            "blocks": {k[7:]: z[k] for k in z.files
                       if k.startswith("blocks.")}}


def _stream(engine, prompts, max_new):
    server = Server()
    engine.register(server)
    addr = f"127.0.0.1:{server.start('127.0.0.1:0')}"
    engine.start()
    out = []
    for prompt in prompts:
        ch = Channel(addr, ChannelOptions(timeout_ms=120000, max_retry=0))
        _, st = ch.create_stream("LLM.Generate", json.dumps(
            {"prompt": prompt, "max_new_tokens": max_new}).encode())
        toks = []
        while True:
            b = st.read(timeout_s=120)
            if b is None:
                break
            toks.append(int.from_bytes(b, "little"))
        st.destroy()
        ch.close()
        out.append(toks)
    engine.stop()
    engine.assert_drained()
    server.destroy()
    return out


def serve(mesh, npz, prompts, max_new):
    """The leader streams `prompts` from the mesh engine, then from a
    one-device engine of the same parameters in the same process."""
    cfg = tiny_config()
    tree = _tree(npz)
    leader = dist.get_rank() == 0
    if leader:
        assert tpu_plane.init(), tpu_plane.error()
    engine = ServingEngine(
        cfg=cfg, params=weights.params_from_jax(tree, cfg, "cpu", mesh),
        mesh=mesh, n_slots=2,
        kv=KvBlockPlane(block_bytes=4096, n_blocks=32) if leader else None)
    if not leader:
        refused = []
        for call in (lambda: engine.register(None),
                     lambda: engine.handle(None, b"{}"),
                     lambda: engine.method_cap, engine.stats,
                     engine.assert_drained):
            try:
                call()
            except RuntimeError as e:
                refused.append(str(e))
        engine.start()
        engine.stop()
        return {"ops": engine.dev.ops, "refused": refused}
    got = _stream(engine, prompts, max_new)
    one = ServingEngine(cfg=cfg, params=weights.params_from_jax(tree, cfg,
                                                                 "cpu"),
                        n_slots=2, device="cpu",
                        kv=KvBlockPlane(block_bytes=4096, n_blocks=32))
    want = _stream(one, prompts, max_new)
    return {"mesh": got, "one": want, "ops": engine.dev.ops,
            "stats": engine.stats(),
            "live_buffers": tpu_plane.stats()["live_buffers"]}


def fail(mesh):
    """The leader's prefill raises after its broadcast, so the followers
    wait inside that prefill's collectives; the leader's stop() must
    raise, and its rank exit, rather than broadcast again."""
    from brpc_tpu_torch.serving import lockstep
    leader = dist.get_rank() == 0
    engine = ServingEngine(
        cfg=tiny_config(), mesh=mesh, n_slots=2,
        kv=KvBlockPlane(block_bytes=4096, n_blocks=32) if leader else None)
    if not leader:
        engine.start()
        engine.stop()        # the launcher kills this rank
        return {}

    def broken(*args, **kw):
        raise RuntimeError("injected prefill fault")

    lockstep.D.prefill = broken
    server = Server()
    engine.register(server)
    addr = f"127.0.0.1:{server.start('127.0.0.1:0')}"
    engine.start()
    ch = Channel(addr, ChannelOptions(timeout_ms=120000, max_retry=0))
    _, st = ch.create_stream("LLM.Generate", json.dumps(
        {"prompt": [1, 2, 3], "max_new_tokens": 2}).encode())
    engine._thread.join(60)             # the loop ends with the fault
    st.destroy()
    ch.close()
    server.destroy()
    engine.stop()
    return {"stopped": True}


def leg(mesh, code, n_engines):
    """Rank 0 runs a leg of tests/test_torch_serving.py on the mesh; every
    other rank follows each of the leg's n_engines engines in turn."""
    if dist.get_rank() == 0:
        scope = {"__name__": "leader", "mesh": mesh}
        exec(code, scope)
        return {"stats": scope["engine"].stats()}
    ops = []
    for _ in range(n_engines):
        engine = ServingEngine(cfg=tiny_config(), mesh=mesh, n_slots=2)
        engine.start()
        engine.stop()
        ops.append(engine.dev.ops)
    return {"ops": ops}
'''


@pytest.fixture(scope="module")
def fake_env():
    _native.build_core()
    return {"TRPC_CUDA_DRIVER": _native.build_fake_driver()}


@pytest.fixture(scope="module")
def ranks_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ranks") / "ranks.py"
    path.write_text(RANKS_CODE)
    return str(path)


@pytest.fixture(scope="module")
def served(tmp_path_factory, ranks_file, fake_env):
    """The prompts, the parameters (the reference's init) and what the
    engine world streamed."""
    ref_cfg, tree = _tree(seed=3)
    flat = {"embed": tree["embed"], "pos": tree["pos"]}
    flat.update({f"ln_f.{k}": v for k, v in tree["ln_f"].items()})
    flat.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    npz = str(tmp_path_factory.mktemp("params") / "params.npz")
    np.savez(npz, **flat)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 128, n).tolist() for n in (5, 12, 20)]
    ranks = launch_world(_world(ENGINE_AXES), ENGINE_AXES,
                         f"{ranks_file}:serve", (npz, prompts, MAX_NEW),
                         device_type="cpu", leader_env=fake_env)
    return prompts, tree, npz, ranks


def _margins(tree, prompt, tokens):
    """The top-2 margin of the one-device model's logits at each greedy
    position of `tokens` after `prompt` (f32, T.apply)."""
    cfg = T.ModelConfig(dtype=torch.float32, **SHAPE)
    model = params_from_jax(tree, cfg, "cpu")
    seq = torch.tensor([prompt + tokens[:-1]])
    with torch.no_grad():
        logits = T.apply(model, seq, cfg)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).tolist()


def _assert_same_greedy(got, want, tree, prompts, record_property):
    """Equal streams, or streams that part at a tie: where they first
    differ, the top-2 margin is below TIE.  The smallest margin along the
    streams is recorded as a property of the test."""
    smallest = math.inf
    for prompt, g, w in zip(prompts, got, want):
        assert len(g) == len(w) == MAX_NEW, (got, want)
        margins = _margins(tree, prompt, w)
        smallest = min(smallest, min(margins))
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                assert margins[i] <= TIE, (i, margins[i], got, want)
                break
    record_property("smallest_top2_margin", smallest)


def test_mesh_engine_streams_the_one_device_engines_tokens(
        served, record_property):
    prompts, tree, _, ranks = served
    leader = ranks[0]
    _assert_same_greedy(leader["mesh"], leader["one"], tree, prompts,
                        record_property)
    assert leader["live_buffers"] == 0, leader
    assert leader["stats"]["prefills"] == len(prompts), leader["stats"]


def test_followers_replay_every_device_operation_of_the_leader(served):
    _, _, _, ranks = served
    want = ranks[0]["ops"]
    assert want["prefill"] == want["install"] == 3 and want["step"] > 0
    assert all(r["ops"] == want for r in ranks[1:]), ranks


def test_followers_refuse_the_leaders_calls(served):
    """register, handle, method_cap, stats and assert_drained belong to
    the leader: a follower raises at the call, naming the leader."""
    _, _, _, ranks = served
    for r in ranks[1:]:
        assert len(r["refused"]) == 5, r
        assert all("follows" in m and "leader (rank 0)" in m
                   for m in r["refused"]), r


def test_a_failed_leader_loop_ends_its_world(ranks_file, fake_env):
    """A fault in the leader's decode loop after a broadcast: the
    leader's stop() raises it with no further collective, its rank exits
    non-zero and the launcher stops the followers it left waiting."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        launch_world(2, {"tp": 2}, f"{ranks_file}:fail",
                     device_type="cpu", leader_env=fake_env)
    msg = str(e.value)
    assert "rank 0 exit 1" in msg, msg
    assert "injected prefill fault" in msg, msg
    assert "the decode loop failed" in msg, msg
    assert time.monotonic() - t0 < 120


def test_mesh_engine_streams_the_reference_mesh_engines_tokens(
        served, tmp_path, record_property):
    """The reference engine on its dp2 x tp4 CPU mesh (its own native
    core over the fake PJRT plugin, in a subprocess) against the port's
    engine world."""
    prompts, tree, npz, ranks = served
    core, pjrt_fake = _build_reference_core(str(tmp_path))
    code = REF_ENGINE_CODE.replace(
        "engine = ServingEngine(cfg=tiny_config(), params=params, n_slots=2,",
        "from brpc_tpu.parallel.mesh import make_mesh\n"
        "engine = ServingEngine(cfg=tiny_config(), params=params,\n"
        "                       mesh=make_mesh({'dp': 2, 'tp': 4}), "
        "n_slots=2,")
    assert "mesh=make_mesh" in code
    ref = _run(code + SERVE_TAIL, env_extra={"JAX_PLATFORMS": "cpu"},
               args=(npz, json.dumps(prompts), core, pjrt_fake))
    assert ref.returncode == 0, ref.stdout + ref.stderr
    line = [ln for ln in ref.stdout.splitlines()
            if ln.startswith("TOKENS ")][-1]
    want = json.loads(line[len("TOKENS "):])
    _assert_same_greedy(ranks[0]["mesh"], want, tree, prompts,
                        record_property)


def _on_mesh(code: str, engines: int) -> str:
    """A leg of tests/test_torch_serving.py with its engines on `mesh`."""
    assert code.count('device="cpu"') == engines
    return code.replace('device="cpu"', "mesh=mesh")


def test_every_cancel_surface_frees_blocks_on_a_mesh(ranks_file, fake_env):
    """Mid-stream RST, abrupt disconnect, explicit RPC cancel and a
    SIGKILL'd client over dp2 x tp4: blocks freed exactly once, the plane
    balanced to zero, the prefill->decode hop on the local d2d rail."""
    ranks = launch_world(_world(ENGINE_AXES), ENGINE_AXES,
                         f"{ranks_file}:leg", (_on_mesh(CANCEL_CODE, 1), 1),
                         device_type="cpu", leader_env=fake_env)
    es = ranks[0]["stats"]
    assert es["canceled"] >= 3 and es["kv_live_seqs"] == 0, es
    assert all(r["ops"][0]["reset"] >= 3 for r in ranks[1:]), ranks


def test_budget_shed_preemption_and_host_codec_on_a_mesh(ranks_file,
                                                         fake_env):
    """An over-budget prompt sheds at submit, pool-dry growth preempts the
    youngest sequence and the host-rail int8 codec keeps decode right,
    over dp2 x tp4."""
    ranks = launch_world(_world(ENGINE_AXES), ENGINE_AXES,
                         f"{ranks_file}:leg",
                         (_on_mesh(PREEMPT_CODE, 2), 2),
                         device_type="cpu", leader_env=fake_env)
    es = ranks[0]["stats"]
    assert es["preemptions"] >= 1 and es["shed_budget"] >= 1, es
    assert all(len(r["ops"]) == 2 and r["ops"][1]["install"] == 1
               for r in ranks[1:]), ranks
