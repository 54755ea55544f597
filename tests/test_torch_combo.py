"""The port's combo channels (brpc_tpu_torch/parallel/channels.py, a copy
of the reference's) — the legs of tests/test_combo.py.

The host legs are the reference's, on the port's Server/Channel: real
loopback servers on ephemeral ports behind list:// naming.

The mesh legs run the Mesh* channels in a gloo world of 8 CPU processes
(test_torch_parallel.run_world) and compare the ranks' parts, put
together, with the reference's global output on its 8-device CPU mesh.
The int8 codec's merge: each worker's quantized shard is bit-equal to
the reference's; the merged sum is bit-equal to the reference's where
f32 addition is exact in any order (scales that are powers of two), and
on the parameter-server pattern of examples/param_server_allreduce.py
it is within the reassociation of its n terms (the collective library
and XLA add in other orders: up to n - 1 roundings of the sum, rtol
n * 2^-23) and within the added per-worker int8_error_bounds of the
exact sum, as that example checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from brpc_tpu.parallel import channels as ref_channels
from brpc_tpu.parallel import make_mesh as ref_make_mesh
from brpc_tpu.parallel import quantize as ref_q
from brpc_tpu_torch.parallel import (CallMapper, DynamicPartitionChannel,
                                     FirstResponseMerger, ParallelChannel,
                                     PartitionChannel, ResponseMerger,
                                     SelectiveChannel, SubCall, quantize)
from brpc_tpu_torch.rpc import Channel, RpcError, Server, errors
from test_torch_parallel import WORLD, run_world


def make_server(name: bytes):
    s = Server()

    def who(cntl, req):
        return name + b":" + req

    def sum_ints(cntl, req):
        vals = [int(x) for x in req.split(b",") if x]
        return str(sum(vals)).encode()

    s.add_service("Who", who)
    s.add_service("Sum", sum_ints)
    s.start("127.0.0.1:0")
    return s


@pytest.fixture(scope="module")
def trio():
    servers = [make_server(f"s{i}".encode()) for i in range(3)]
    yield servers
    for s in servers:
        s.stop()
        s.destroy()


# --- ParallelChannel -------------------------------------------------------


def test_parallel_broadcast_concat(trio):
    pc = ParallelChannel()
    chans = [Channel(f"127.0.0.1:{s.port}") for s in trio]
    for ch in chans:
        pc.add_channel(ch)
    out = pc.call("Who", b"x")
    assert out == b"s0:xs1:xs2:x"  # in-order merge of all members
    for ch in chans:
        ch.close()


def test_parallel_mapper_shards_request(trio):
    """CallMapper splits the request per member (scatter, ≙ the
    partition_echo example's per-partition requests)."""

    class ShardMapper(CallMapper):
        def map(self, i, n, method, payload, attachment):
            parts = payload.split(b",")
            share = parts[i::n]
            return SubCall(method, b",".join(share))

    class SumMerger(ResponseMerger):
        def merge(self, results):
            return str(sum(int(r) for r in results
                           if r is not None)).encode()

    pc = ParallelChannel(SumMerger())
    chans = [Channel(f"127.0.0.1:{s.port}") for s in trio]
    for ch in chans:
        pc.add_channel(ch, ShardMapper())
    out = pc.call("Sum", b"1,2,3,4,5,6,7,8,9")
    assert out == b"45"
    for ch in chans:
        ch.close()


def test_parallel_skip(trio):
    class SkipOdd(CallMapper):
        def map(self, i, n, method, payload, attachment):
            return None if i % 2 else SubCall(method, payload)

    pc = ParallelChannel()
    chans = [Channel(f"127.0.0.1:{s.port}") for s in trio]
    for ch in chans:
        pc.add_channel(ch, SkipOdd())
    assert pc.call("Who", b"y") == b"s0:ys2:y"
    for ch in chans:
        ch.close()


def test_parallel_fail_limit(trio):
    pc = ParallelChannel(fail_limit=1, timeout_ms=300)
    chans = [Channel(f"127.0.0.1:{s.port}") for s in trio[:2]]
    dead = Channel("127.0.0.1:1")  # nothing listens here
    for ch in chans:
        pc.add_channel(ch)
    pc.add_channel(dead)
    out = pc.call("Who", b"z")  # 1 failure tolerated
    assert out == b"s0:zs1:z"

    strict = ParallelChannel(timeout_ms=300)  # fail_limit=None: all or bust
    for ch in chans:
        strict.add_channel(ch)
    strict.add_channel(dead)
    with pytest.raises(RpcError):
        strict.call("Who", b"z")
    for ch in chans:
        ch.close()
    dead.close()


def test_first_response_merger(trio):
    pc = ParallelChannel(FirstResponseMerger())
    chans = [Channel(f"127.0.0.1:{s.port}") for s in trio]
    for ch in chans:
        pc.add_channel(ch)
    assert pc.call("Who", b"r") == b"s0:r"
    for ch in chans:
        ch.close()


# --- PartitionChannel ------------------------------------------------------


@pytest.fixture(scope="module")
def partitioned(trio):
    """trio servers tagged as a 2-partition scheme + one 3-scheme straggler
    that must be ignored by a partition_count=2 channel."""
    s0, s1, s2 = trio
    url = (f"list://127.0.0.1:{s0.port} 0/2,"
           f"127.0.0.1:{s1.port} 1/2,"
           f"127.0.0.1:{s2.port} 0/3")
    return url


def test_partition_channel_fans_to_all_partitions(partitioned):
    class TagMapper(CallMapper):
        def map(self, i, n, method, payload, attachment):
            return SubCall(method, payload + f"@{i}/{n}".encode())

    pch = PartitionChannel(partitioned, partition_count=2,
                           call_mapper=TagMapper())
    assert pch.partitions_ready() == 2
    out = pch.call("Who", b"p")
    # partition 0 = s0, partition 1 = s1; 0/3-tagged s2 ignored
    assert out == b"s0:p@0/2s1:p@1/2"
    pch.close()


def test_partition_channel_missing_partition():
    # only partition 0 of 2 exists
    srv = make_server(b"only")
    try:
        pch = PartitionChannel(f"list://127.0.0.1:{srv.port} 0/2",
                               partition_count=2)
        with pytest.raises(RpcError) as ei:
            pch.call("Who", b"x")
        assert ei.value.code == errors.ENOSERVICE
        pch.close()
    finally:
        srv.stop()
        srv.destroy()


def test_partition_channel_missing_shares_fail_budget():
    """A missing partition and a failed RPC draw from the SAME fail_limit:
    1 missing of 3 with fail_limit=1 succeeds, fail_limit=0 fails — and the
    merger still sees one positional slot per logical partition."""
    s0, s1 = make_server(b"p0"), make_server(b"p1")
    slots = {}

    class Recorder(ResponseMerger):
        def merge(self, results):
            slots["n"] = len(results)
            return b"".join(r for r in results if r is not None)

    try:
        url = (f"list://127.0.0.1:{s0.port} 0/3,"
               f"127.0.0.1:{s1.port} 1/3")  # partition 2 missing
        pch = PartitionChannel(url, partition_count=3,
                               response_merger=Recorder(), fail_limit=1)
        out = pch.call("Who", b"x")
        assert out == b"p0:xp1:x"
        assert slots["n"] == 3  # merger saw the missing partition's slot
        pch.close()
        strict = PartitionChannel(url, partition_count=3, fail_limit=0)
        with pytest.raises(RpcError):
            strict.call("Who", b"x")
        strict.close()
    finally:
        for s in (s0, s1):
            s.stop()
            s.destroy()


def test_dynamic_partition_channel(trio):
    """Two schemes live at once; capacity weighting picks only complete
    ones (the 3-way scheme has 1/3 partitions -> capacity 0)."""
    s0, s1, s2 = trio
    url = (f"list://127.0.0.1:{s0.port} 0/2,"
           f"127.0.0.1:{s1.port} 1/2,"
           f"127.0.0.1:{s2.port} 0/3")
    dpc = DynamicPartitionChannel(url)
    caps = dpc.scheme_capacities()
    assert caps[2] == 1 and caps[3] == 0
    out = dpc.call("Who", b"d")  # must route to the complete 2-way scheme
    assert out == b"s0:ds1:d"
    dpc.close()


# --- SelectiveChannel ------------------------------------------------------


def test_selective_failover(trio):
    sel = SelectiveChannel(max_retry=2)
    dead = Channel("127.0.0.1:1", timeout_ms=200)
    live = Channel(f"127.0.0.1:{trio[0].port}")
    sel.add_channel(dead)
    sel.add_channel(live)
    # first pick hits the dead channel, failover lands on the live one
    assert sel.call("Who", b"f") == b"s0:f"
    # dead one is now isolated: next calls go straight to live
    assert sel.call("Who", b"g") == b"s0:g"
    dead.close()
    live.close()


def test_selective_nests_parallel(trio):
    """Sub-channels can be combo channels (slice-level failover over a
    fan-out group, SURVEY §2.9)."""
    pc = ParallelChannel()
    chans = [Channel(f"127.0.0.1:{s.port}") for s in trio[:2]]
    for ch in chans:
        pc.add_channel(ch)
    sel = SelectiveChannel()
    sel.add_channel(pc)
    assert sel.call("Who", b"n") == b"s0:ns1:n"
    for ch in chans:
        ch.close()


# --- mesh lowering (a gloo world of WORLD ranks) ----------------------------

P_INT8 = 1000          # values a worker; 3 full 256-value blocks + 232
P_PS = 5000            # the param-server pattern, cut from ResNet-50's 25.5M

_BODY = r"""
from brpc_tpu_torch.parallel import (MeshParallelChannel,
                                     MeshPartitionChannel, make_mesh,
                                     quantize)


def run(rank, world, data):
    def shard(x):
        k = x.shape[0] // world
        return torch.from_numpy(x[rank * k:(rank + 1) * k])

    fan = make_mesh({"fanout": world}, device_type="cpu")
    add = MeshParallelChannel(fan, "fanout", merger="add")
    cat = MeshParallelChannel(fan, "fanout", merger="concat")
    part = MeshPartitionChannel(make_mesh({"part": world},
                                          device_type="cpu"), "part")
    dp = make_mesh({"dp": world}, device_type="cpu")
    int8 = MeshParallelChannel(dp, "dp", merger="add", codec="int8")
    out = {"channel_count": torch.tensor(add.channel_count()),
           "partition_count": torch.tensor(part.partition_count()),
           "add": add.call_tensor(shard(data["rows"])),
           "concat": cat.call_tensor(shard(data["ones"])),
           "reduce_scatter": part.call_reduce_scatter(shard(data["grad"])),
           "gather": part.call_gather(shard(data["grad"])),
           "all_to_all": part.call_all_to_all(shard(data["a2a"]))}
    for name in ("int8_exact", "int8_ps"):
        out[name] = int8.call_tensor(shard(data[name]))
        out[name + "_shard"] = quantize.fake_quant(shard(data[name]),
                                                    "int8")
    return out
"""


def _int8_exact_rows(rng):
    """Worker i's row: every 256-value block's absmax is exactly
    127 * 2^e_i, so its int8 scale is 2^e_i and the dequantized values
    are multiples of 2^e_i, which f32 sums exactly in any order."""
    rows = []
    for i in range(WORLD):
        top = 127.0 * 2.0 ** (i % 7 - 3)
        row = rng.uniform(-0.999, 0.999, P_INT8) * top
        for b in range(0, P_INT8, 256):
            row[b + rng.integers(0, min(256, P_INT8 - b))] = \
                top * rng.choice([-1.0, 1.0])
        rows.append(row)
    return np.stack(rows).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(1)
    flat = np.arange(P_PS, dtype=np.float32) % 97
    return {
        "rows": np.stack([np.arange(16, dtype=np.float32) + i
                          for i in range(WORLD)]),
        "ones": np.ones((WORLD, 2), np.float32),
        "grad": rng.integers(-50, 50, (64, 4)).astype(np.float32),
        "a2a": rng.integers(-50, 50, (WORLD, 16)).astype(np.float32),
        "int8_exact": _int8_exact_rows(rng),
        "int8_ps": np.stack([flat * (i + 1) for i in range(WORLD)]),
    }


@pytest.fixture(scope="module")
def world():
    data = _inputs()
    return data, run_world(_BODY, data)


def _ref_mesh(axis):
    return ref_make_mesh({axis: WORLD})


def _parts(results, name):
    return [r[name] for r in results]


def test_mesh_parallel_channel_allreduce(world):
    """Row i = member i's contribution; the merge (all-reduce over the
    axis) replaces the host-side ResponseMerger."""
    data, results = world
    ref = ref_channels.MeshParallelChannel(_ref_mesh("fanout"), "fanout",
                                           merger="add")
    want = np.asarray(ref.call_tensor(jnp.asarray(data["rows"])))
    np.testing.assert_array_equal(
        want, np.tile(8.0 * np.arange(16) + 28.0, (8, 1)))
    np.testing.assert_array_equal(np.concatenate(_parts(results, "add")),
                                  want)
    assert all(int(r["channel_count"]) == WORLD for r in results)


def test_mesh_parallel_channel_concat(world):
    data, results = world
    ref = ref_channels.MeshParallelChannel(_ref_mesh("fanout"), "fanout",
                                           merger="concat")
    want = np.asarray(ref.call_tensor(jnp.asarray(data["ones"])))
    for part in _parts(results, "concat"):
        assert part.shape == (8, 2)     # tiled gather of the 8 shards
        np.testing.assert_array_equal(part, want)


@pytest.mark.parametrize("call, out_dim", [
    ("call_reduce_scatter", 0), ("call_gather", None),
    ("call_all_to_all", 1)])
def test_mesh_partition_channel_matches_reference(world, call, out_dim):
    data, results = world
    ref = ref_channels.MeshPartitionChannel(_ref_mesh("part"), "part")
    inp = data["a2a" if call == "call_all_to_all" else "grad"]
    want = np.asarray(getattr(ref, call)(jnp.asarray(inp)))
    name = call[len("call_"):]
    parts = _parts(results, name)
    if out_dim is None:
        for part in parts:
            np.testing.assert_array_equal(part, want)
    else:
        np.testing.assert_array_equal(np.concatenate(parts, out_dim), want)
    assert all(int(r["partition_count"]) == WORLD for r in results)


def _int8_merge(world, name):
    data, results = world
    rows = data[name]
    ref = ref_channels.MeshParallelChannel(_ref_mesh("dp"), "dp",
                                           merger="add", codec="int8")
    want = np.asarray(ref.call_tensor(jnp.asarray(rows)))
    ref_shards = np.asarray(ref_q.fake_quant(jnp.asarray(rows), "int8"))
    for r in range(WORLD):     # each worker's wire hop, bit for bit
        np.testing.assert_array_equal(results[r][name + "_shard"][0],
                                      ref_shards[r])
    got = np.concatenate(_parts(results, name))
    exact = rows.astype(np.float64).sum(0)
    bound = sum(quantize.int8_error_bound(rows[i]) for i in range(WORLD))
    err = np.abs(got[0].astype(np.float64) - exact).max()
    assert 0.0 < err <= bound, (err, bound)
    for part in got[1:]:
        np.testing.assert_array_equal(part, got[0])
    return got, want


def test_mesh_int8_merge_equals_reference_exactly(world):
    got, want = _int8_merge(world, "int8_exact")
    np.testing.assert_array_equal(got, want)


def test_mesh_int8_merge_on_the_param_server_pattern(world):
    got, want = _int8_merge(world, "int8_ps")
    np.testing.assert_allclose(got, want, rtol=WORLD * 2.0 ** -23, atol=0)
