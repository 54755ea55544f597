"""The serving engine's own counters and rpcz spans (brpc_tpu_torch/serving/)
on the CPU tiny engine.

One subprocess over the fake CUDA driver (as tests/test_torch_serving.py
runs the engine) serves two rounds of Generate streams, more than the
slots hold so that requests wait: the first with ``enable_rpcz`` off,
counting every ``Span`` built, the second with it on, reading the traces
back over the server's ``/rpcz``.  It wraps the engine's admit and step
to read the counters around each call, and polls ``engine.stats()``
while the streams run.  The tests below read that one run.  The spill
read-back and the ring's resize run in-process (no native library).

The KV route's legs serve the same prompts once on each route: on the
device (the fake driver's memory is host memory, which the engine's
``cpu`` views) and on the host (``TRPC_FAKE_CUDA_MEMORY_TYPE=device``:
the driver calls it device memory, which ``cpu`` cannot view), each with
the decode device 0 (rail "none") and 1 (rail "local"), and with every
fake operation delayed, so that a hand-off out of order reads stale
bytes.  The same run on the card is the ``cuda`` leg.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from brpc_tpu_torch import _native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COUNTERS = ("queue_wait_us", "prefill_us", "kv_route_us", "kv_route_bytes",
            "step_issue_us", "step_sync_us", "emit_us", "rail_none")
ROUTE = ("kv_to_bytes", "seq_alloc", "seq_migrate", "seq_fetch",
         "kv_from_bytes", "install")

SERVE_CODE = r"""
import json, threading, time, urllib.request
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch.rpc import span
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.server import Server, ServerOptions
from brpc_tpu_torch.serving import ServingEngine
from brpc_tpu_torch.serving.engine import tiny_config
from brpc_tpu_torch.serving.kv_cache import KvBlockPlane
from brpc_tpu_torch.utils import flags

built = [0]


class Counted(span.Span):          # every Span the process builds
    def __init__(self, *a, **kw):
        built[0] += 1
        super().__init__(*a, **kw)


span.Span = Counted
assert tpu_plane.init(), tpu_plane.error()
cfg = tiny_config()
engine = ServingEngine(cfg=cfg, device="cpu", n_slots=2, max_waiting=8,
                       kv=KvBlockPlane(block_bytes=4096, n_blocks=64,
                                       decode_device=0))
server = Server(ServerOptions(
    method_max_concurrency={"LLM.Generate": engine.method_cap}))
engine.register(server)
port = server.start("127.0.0.1:0")
addr = f"127.0.0.1:{port}"

admits, walls = [], []
inner_admit, inner_step = engine._admit, engine.dev.step


def admit(seq):
    keys = ("kv_route_bytes", "prefills", "prefill_us", "kv_route_us")
    before = [getattr(engine, k) for k in keys]
    inner_admit(seq)
    admits.append([seq.prompt_len] + [getattr(engine, k) - b
                                      for k, b in zip(keys, before)])


def step(tokens, active):
    t = time.monotonic_ns()
    out = inner_step(tokens, active)
    walls.append(time.monotonic_ns() - t)
    return out


engine._admit, engine.dev.step = admit, step
engine.start()

snaps, polling = [], threading.Event()


def poll():
    while not polling.is_set():
        snaps.append(engine.stats())
        time.sleep(0.002)


def stream(plen, max_new, out):
    ch = Channel(addr, ChannelOptions(timeout_ms=60000, max_retry=0))
    _, st = ch.create_stream("LLM.Generate", json.dumps(
        {"prompt": list(range(1, plen + 1)),
         "max_new_tokens": max_new}).encode())
    n = 0
    while st.read(timeout_s=120) is not None:
        n += 1
    st.destroy()
    ch.close()
    out.append(n)


def serve_round(lengths):
    got = []
    ts = [threading.Thread(target=stream, args=(p, 6, got))
          for p in lengths]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts), "a stream hung"
    assert got == [6] * len(lengths), got
    return engine.stats()


poller = threading.Thread(target=poll)
poller.start()
off = serve_round([5, 9, 12, 7, 3, 10])
built_off = built[0]
flags.set_flag("enable_rpcz", True)
on = serve_round([6, 11, 4, 8, 13, 2])
flags.set_flag("enable_rpcz", False)
polling.set()
poller.join(10)
snaps.append(engine.stats())


def get(path):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=30) as r:
        return json.load(r)


traces = {}
for s in get("/rpcz?max_scan=5000"):
    # the Generate's server span (a child of the client's), a step's root
    if (s["method"], s["kind"]) in (("LLM.Generate", "server"),
                                    ("LLM.decode_step", "local")):
        traces.setdefault(s["method"], []).append(
            get(f"/rpcz?max_scan=5000&trace_id={s['trace_id']}"))
engine.stop()
engine.assert_drained()
server.destroy()
print("RESULT " + json.dumps({
    "cfg": [cfg.n_layers, cfg.d_model], "off": off, "on": on,
    "built_off": built_off, "admits": admits, "walls": walls,
    "snaps": snaps, "traces": traces}))
"""


@pytest.fixture(scope="module")
def served():
    _native.build_core()
    env = dict(os.environ, TRPC_CUDA_DRIVER=_native.build_fake_driver())
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", SERVE_CODE], env=env,
                       capture_output=True, text=True, timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and lines, \
        f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-4000:]}"
    return json.loads(lines[-1][len("RESULT "):])


def test_every_new_counter_moves_and_never_goes_down(served):
    snaps = served["snaps"]
    for key in COUNTERS:
        values = [s[key] for s in snaps]
        assert values[-1] > values[0], (key, values[0], values[-1])
        assert all(b >= a for a, b in zip(values, values[1:])), key
    for round_ in ("off", "on"):
        st = served[round_]
        assert all(st[k] > 0 for k in COUNTERS if k != "queue_wait_us"), st


def test_step_issue_and_sync_fit_inside_the_steps_wall_time(served):
    st = served["snaps"][-1]
    assert st["steps"] == len(served["walls"])
    inside = st["step_issue_us"] + st["step_sync_us"]
    assert 0 < inside <= sum(served["walls"]) // 1000


def test_kv_route_bytes_are_four_crossings_of_each_admits_kv(served):
    L, d = served["cfg"]
    admits = served["admits"]
    assert len(admits) == 12
    for plen, moved, installed, _, _ in admits:
        assert installed == 1
        assert moved == 32 * L * plen * d, (plen, moved)
    assert served["snaps"][-1]["kv_route_bytes"] == \
        sum(32 * L * plen * d for plen, *_ in admits)


def test_queue_wait_counts_the_waiting_room(served):
    off, on = served["off"], served["on"]
    assert off["queue_wait_us"] > 0     # six streams on two slots wait
    assert on["queue_wait_us"] > off["queue_wait_us"]
    assert on["admitted"] == 12


def test_the_three_rails_sum_to_the_prefills(served):
    for st in (served["off"], served["on"]):
        assert st["rail_none"] + st["rail_local"] + st["rail_host"] == \
            st["prefills"]
        assert st["rail_none"] == st["prefills"]    # one device: no hop


def test_each_installed_admit_adds_its_prefill_and_route_time(served):
    admits = served["admits"]
    for _, _, installed, prefill_us, route_us in admits:
        assert installed == 1 and prefill_us > 0 and route_us > 0
    st = served["snaps"][-1]
    assert st["prefills"] == len(admits)
    assert st["prefill_us"] == sum(a[3] for a in admits)
    assert st["kv_route_us"] == sum(a[4] for a in admits)


def test_no_span_is_built_with_rpcz_off(served):
    assert served["built_off"] == 0


def _tree(spans):
    by_id = {s["span_id"]: s for s in spans}
    kids = {}
    for s in spans:
        kids.setdefault(s["parent_span_id"], []).append(s)
    return by_id, kids


def _holds(parent, child):
    return parent["start_ns"] <= child["start_ns"] <= child["end_ns"] \
        <= parent["end_ns"]


def test_a_generate_is_one_trace_of_queue_admit_and_first_token(served):
    gens = served["traces"]["LLM.Generate"]
    assert len(gens) == 6
    for spans in gens:
        assert len({s["trace_id"] for s in spans}) == 1
        by_id, kids = _tree(spans)
        root = [s for s in spans if s["method"] == "LLM.Generate"
                and s["kind"] == "server"]
        assert len(root) == 1
        top = {s["method"]: s for s in kids[root[0]["span_id"]]}
        assert set(top) == {"queue", "admit", "first_token"}, sorted(top)
        # the stream's server span ends once the stream is accepted; the
        # queue starts inside it
        assert root[0]["start_ns"] <= top["queue"]["start_ns"] \
            <= root[0]["end_ns"]
        assert top["queue"]["end_ns"] <= top["admit"]["start_ns"] \
            <= top["admit"]["end_ns"] <= top["first_token"]["start_ns"]
        admit = {s["method"]: s for s in kids[top["admit"]["span_id"]]}
        assert set(admit) == {"prefill", "kv_route"}
        route = sorted(kids[admit["kv_route"]["span_id"]],
                       key=lambda s: s["start_ns"])
        assert tuple(s["method"] for s in route) == ROUTE
        for s in spans:
            assert s["start_ns"] > 0 and s["end_ns"] >= s["start_ns"]
            assert s["latency_us"] == (s["end_ns"] - s["start_ns"]) // 1000
            parent = by_id.get(s["parent_span_id"])
            if parent is not None and parent["kind"] == "local":
                assert _holds(parent, s), (parent["method"], s["method"])
        assert all(a["end_ns"] == b["start_ns"]
                   for a, b in zip(route, route[1:]))


def test_a_decode_step_is_one_trace_of_issue_sync_and_emit(served):
    steps = served["traces"]["LLM.decode_step"]
    assert len(steps) >= 6
    grows = 0
    for spans in steps:
        assert len({s["trace_id"] for s in spans}) == 1
        by_id, kids = _tree(spans)
        root = [s for s in spans if s["method"] == "LLM.decode_step"][0]
        assert any(a.endswith(("batch 1", "batch 2"))
                   for a in root["annotations"]), root["annotations"]
        top = sorted(kids[root["span_id"]], key=lambda s: s["start_ns"])
        assert [s["method"] for s in top] == ["issue", "sync", "emit"]
        assert top[0]["end_ns"] == top[1]["start_ns"]
        for s in spans:
            if s is not root:
                assert _holds(by_id[s["parent_span_id"]], s)
        for s in kids.get(top[2]["span_id"], []):
            assert s["method"] == "grow"
            grows += 1
    assert grows > 0    # 4-token blocks: the streams grow as they decode


# argv: the engine's device, its dtype, the KV plane's decode device;
# prints one JSON line
ROUTE_CODE = r"""
import hashlib, json, sys, time
import torch
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.server import Server
from brpc_tpu_torch.serving import ServingEngine
from brpc_tpu_torch.serving.engine import tiny_config
from brpc_tpu_torch.serving.kv_cache import KvBlockPlane

device, dtype, decode_device = sys.argv[1], sys.argv[2], int(sys.argv[3])
assert tpu_plane.init(), tpu_plane.error()
cfg = tiny_config(dtype=getattr(torch, dtype))
engine = ServingEngine(cfg=cfg, device=device, n_slots=2, max_waiting=4,
                       kv=KvBlockPlane(block_bytes=4096, n_blocks=32,
                                       decode_device=decode_device))
server = Server()
engine.register(server)
addr = f"127.0.0.1:{server.start('127.0.0.1:0')}"
inner_prefill, inner_install = engine.dev.prefill, engine.dev.install
inner_alloc, inner_admit = engine.kv.seq_alloc, engine._admit
admits, cur = [], {}


def prefill(prompt):
    out = inner_prefill(prompt)
    cur["k"], cur["v"] = out[1][:, 0].clone(), out[2][:, 0].clone()
    return out


def seq_alloc(seq_id, kv):
    cur["blocks"] = inner_alloc(seq_id, kv)
    return cur["blocks"]


def install(slot, k, v, length):
    inner_install(slot, k, v, length)
    got_k = engine.cache["k"][:, slot, :length]
    got_v = engine.cache["v"][:, slot, :length]
    cur["equal"] = (torch.equal(got_k, cur["k"])
                    and torch.equal(got_v, cur["v"]))
    cur["digest"] = hashlib.sha256(
        got_k.float().cpu().numpy().tobytes()
        + got_v.float().cpu().numpy().tobytes()).hexdigest()


def admit(seq):
    before = engine.kv_route_bytes
    inner_admit(seq)
    admits.append({"plen": seq.prompt_len, "blocks": cur["blocks"],
                   "equal": cur["equal"], "digest": cur["digest"],
                   "route_bytes": engine.kv_route_bytes - before})


engine.dev.prefill, engine.dev.install = prefill, install
engine.kv.seq_alloc, engine._admit = seq_alloc, admit
engine.start()
p0 = tpu_plane.stats()
for plen in (5, 10, 12, 7):
    ch = Channel(addr, ChannelOptions(timeout_ms=60000, max_retry=0))
    _, st = ch.create_stream("LLM.Generate", json.dumps(
        {"prompt": [(3 * i + plen) % cfg.vocab + 1 for i in range(plen)],
         "max_new_tokens": 12}).encode())
    n = 0
    while st.read(timeout_s=120) is not None:
        n += 1
    assert n == 12, n
    st.destroy()
    ch.close()
# a cancel mid-stream: its blocks, grown ones too, go back
ch = Channel(addr, ChannelOptions(timeout_ms=60000, max_retry=0))
_, st = ch.create_stream("LLM.Generate", json.dumps(
    {"prompt_len": 8, "max_new_tokens": 40}).encode())
for _ in range(10):
    assert st.read(timeout_s=120) is not None
st.rst(errors.ECANCELED)
st.destroy()
ch.close()
deadline = time.monotonic() + 60
while engine.stats()["canceled"] < 1 and time.monotonic() < deadline:
    time.sleep(0.02)
p1, es = tpu_plane.stats(), engine.stats()
engine.stop()
engine.assert_drained()
server.destroy()
live = tpu_plane.stats()["live_buffers"]
# a grown block reads back as zeros, on a block the cache held dirty
kv = KvBlockPlane(block_bytes=4096, n_blocks=4, decode_device=decode_device)
kv.seq_alloc(1, b"\x07" * 4096)
kv.seq_migrate(1)
kv.seq_free(1)
kv.seq_alloc(2, b"\x01")
kv.seq_grow(2)
grown = kv._seqs[2].blocks[-1]
grown.wait()
zeros = grown.to_host() == bytes(4096)
if kv.device_route(device):
    where = kv.pool.view_device(decode_device)
    zeros = zeros and int(grown.view(where).count_nonzero()) == 0
kv.seq_free(2)
kv.assert_balanced()
print("RESULT " + json.dumps({
    "cfg": [cfg.n_layers, cfg.d_model], "admits": admits,
    "device_route": engine.kv.device_route(device),
    "h2d_bytes": p1["h2d_bytes"] - p0["h2d_bytes"],
    "d2h_bytes": p1["d2h_bytes"] - p0["d2h_bytes"],
    "stats": es, "live": live, "grown_zeros": zeros,
    "live_after": tpu_plane.stats()["live_buffers"]}))
"""

ROUTE_CASES = [("device", 0), ("device", 1), ("host", 0), ("host", 1)]


def _serve_route(route, decode_device):
    _native.build_core()
    env = dict(os.environ, TRPC_CUDA_DRIVER=_native.build_fake_driver(),
               TRPC_FAKE_CUDA_DELAY_US="200",
               TRPC_FAKE_CUDA_MEMORY_TYPE="host" if route == "device"
               else "device")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return _result(subprocess.run(
        [sys.executable, "-c", ROUTE_CODE, "cpu", "float32",
         str(decode_device)], env=env, capture_output=True, text=True,
        timeout=300))


def _result(r):
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and lines, \
        f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-4000:]}"
    return json.loads(lines[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def routes():
    _native.build_core()
    _native.build_fake_driver()
    with ThreadPoolExecutor(len(ROUTE_CASES)) as ex:
        futs = {case: ex.submit(_serve_route, *case) for case in ROUTE_CASES}
        return {case: f.result() for case, f in futs.items()}


def _blocks(plen):
    return -(-plen * 1024 // 4096)    # tiny_config: 1,024 wire bytes a token


@pytest.mark.parametrize("route,decode_device", ROUTE_CASES)
def test_both_routes_install_the_same_rows_bytes_and_blocks(
        routes, route, decode_device):
    got = routes[(route, decode_device)]
    other = routes[("host" if route == "device" else "device",
                    decode_device)]
    L, d = got["cfg"]
    assert got["device_route"] is (route == "device")
    assert [a["plen"] for a in got["admits"][:4]] == [5, 10, 12, 7]
    for a, b in zip(got["admits"], other["admits"]):
        assert a["equal"], a               # the prefill's K/V, bit for bit
        assert a["digest"] == b["digest"]
        assert a["route_bytes"] == b["route_bytes"] == 32 * L * a["plen"] * d
        assert a["blocks"] == b["blocks"] == _blocks(a["plen"])
    st = got["stats"]
    assert st["kv_grown_blocks"] == other["stats"]["kv_grown_blocks"] > 0
    assert st["rail_none" if decode_device == 0 else "rail_local"] == 5


@pytest.mark.parametrize("route,decode_device", ROUTE_CASES)
def test_kv_host_bytes_count_the_blocks_host_crossings(
        routes, route, decode_device):
    got = routes[(route, decode_device)]
    st = got["stats"]
    admitted = sum(a["blocks"] for a in got["admits"])
    crossings = got["h2d_bytes"] + got["d2h_bytes"]
    assert st["kv_host_bytes"] == crossings
    if route == "device":
        assert crossings == 0
        assert st["kv_device_fills"] == admitted + st["kv_grown_blocks"]
    else:   # up and back once each; the grown blocks stay on the device
        assert crossings == 2 * 4096 * admitted
        assert st["kv_device_fills"] == st["kv_grown_blocks"]


@pytest.mark.parametrize("route,decode_device", ROUTE_CASES)
def test_a_grown_block_is_zeros_and_a_cancel_drains_the_plane(
        routes, route, decode_device):
    got = routes[(route, decode_device)]
    assert got["grown_zeros"]
    assert got["stats"]["canceled"] == 1
    assert got["live"] == 0 and got["live_after"] == 0


@pytest.mark.cuda
def test_an_admit_on_the_card_moves_no_host_bytes():
    """The route on the real driver: the wire packed in HBM, the blocks
    filled and read there, the installed bf16 K/V the prefill's bit for
    bit, no h2d or d2h byte over the whole run, a grown block zeros."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and its driver (libcuda.so.1)")
    env = dict(os.environ)
    env.pop("TRPC_CUDA_DRIVER", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    got = _result(subprocess.run(
        [sys.executable, "-c", ROUTE_CODE, "cuda", "bfloat16", "0"],
        env=env, capture_output=True, text=True, timeout=600))
    assert got["device_route"] is True
    assert all(a["equal"] for a in got["admits"]), got["admits"]
    assert got["h2d_bytes"] == 0 and got["d2h_bytes"] == 0
    assert got["stats"]["kv_host_bytes"] == 0
    assert got["grown_zeros"] and got["live"] == 0


def test_a_spill_file_without_the_monotonic_stamps_reads_back(tmp_path):
    from brpc_tpu_torch.rpc import span
    from brpc_tpu_torch.utils import flags, recordio
    old = {"trace_id": 7, "span_id": 8, "parent_span_id": 0,
           "kind": "server", "method": "Echo", "remote_side": "",
           "start_ts": 1000.0, "latency_us": 5, "error_code": 0,
           "annotations": []}
    w = recordio.RecordWriter(str(tmp_path / "spans-1000000-1-1.rio"))
    w.write(json.dumps(old).encode())
    w.close()
    before = flags.get_flag("rpcz_persist_dir")
    flags.set_flag("rpcz_persist_dir", str(tmp_path))
    try:
        got = span.read_persisted(2000.0, 10)
    finally:
        flags.set_flag("rpcz_persist_dir", before)
    assert [(s.trace_id, s.method, s.start_ns, s.end_ns) for s in got] == \
        [(7, "Echo", 0, 0)]
    new = span.Span(trace_id=1, span_id=2, start_ts=5.0, start_ns=10,
                    end_ns=2010)
    back = span._span_from_payload(span._span_to_payload(new))
    assert (back.start_ns, back.end_ns) == (10, 2010)
    assert {"start_ns", "end_ns"} <= set(new.describe())


def test_rpcz_keep_spans_resizes_the_ring_at_run_time():
    from brpc_tpu_torch.rpc import span
    from brpc_tpu_torch.utils import flags
    before = flags.get_flag("rpcz_keep_spans")
    try:
        span.clear()
        for i in range(5):
            span._store.add(span.Span(trace_id=1, span_id=i + 1))
        flags.set_flag("rpcz_keep_spans", 3)
        assert [s.span_id for s in span._store.recent(100, None)] == \
            [5, 4, 3]
        span._store.add(span.Span(trace_id=1, span_id=6))
        assert len(span._store.recent(100, None)) == 3
        flags.set_flag("rpcz_keep_spans", 10)
        for i in range(6, 12):
            span._store.add(span.Span(trace_id=1, span_id=i + 1))
        assert len(span._store.recent(100, None)) == 9
        with pytest.raises(flags.FlagError):
            flags.set_flag("rpcz_keep_spans", -1)
        assert len(span._store.recent(100, None)) == 9
    finally:
        flags.set_flag("rpcz_keep_spans", before)
        span.clear()
