"""The CUDA plane's pools (brpc_tpu_torch/csrc/cuda_plane.cc) on the fake
CUDA driver (csrc/cuda_fake.cc): the device-buffer cache, the page-locked
landing-zone and staging pool, the out-of-memory retry, and peer access.

The fake counts every driver entry point it serves
(``trpc_fake_cuda_calls``) and injects out-of-memory errors on request
(``trpc_fake_cuda_inject_oom``); the tests reach both through ctypes on
the same library the plane dlopens.  It aborts the process when a block
is freed, written or handed out again while a copy on it is pending, or
when a host function makes a CUDA call, so every leg checks those rules
too.  Each leg runs in a subprocess: the plane is process-global.
"""

import os
import subprocess
import sys

import pytest

from brpc_tpu_torch import _native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fake_env():
    _native.build_core()
    return {"TRPC_CUDA_DRIVER": _native.build_fake_driver(),
            "TRPC_FAKE_CUDA_DELAY_US": "500"}


def _run(code: str, env_extra=None, timeout=180):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if env_extra:
        env.update(env_extra)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)


PRELUDE = r"""
import ctypes, os
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch._native import lib

fake = ctypes.CDLL(os.environ["TRPC_CUDA_DRIVER"])
fake.trpc_fake_cuda_calls.argtypes = [ctypes.c_char_p]
fake.trpc_fake_cuda_calls.restype = ctypes.c_ulonglong
fake.trpc_fake_cuda_inject_oom.argtypes = [ctypes.c_char_p, ctypes.c_int]
ALLOCATING = ("cuMemAlloc_v2", "cuMemFree_v2", "cuMemHostRegister_v2",
              "cuMemHostUnregister", "cuMemHostAlloc", "cuMemFreeHost")


def calls(names=ALLOCATING):
    return {n: fake.trpc_fake_cuda_calls(n.encode()) for n in names}


def pattern(n, salt):
    row = bytes(range(salt % 256, 256)) + bytes(range(salt % 256))
    return (row * (n // 256 + 1))[:n]
"""


STEADY_CODE = PRELUDE + r"""
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.server import Server

assert tpu_plane.init(), tpu_plane.error()
srv = Server()
srv.add_hbm_echo_service()
srv.start("127.0.0.1:0")
ch = Channel(f"tpu://0/0@127.0.0.1:{srv.port}",
             ChannelOptions(max_retry=0, timeout_ms=60_000))
SIZES = (4096, 1 << 20, 8 << 20, 12345)


def round_trip(n, salt, zones=1):
    # h2d (staged), d2d on the card and to the other one, d2h of each,
    # and an HbmEcho attachment (the IOBuf route) of the same bytes
    data = pattern(n, salt)
    a = tpu_plane.h2d(data, device=0)
    a.wait()
    b = tpu_plane.d2d(a, 0)
    c = tpu_plane.d2d(a, 1)
    for buf in (a, b, c):
        assert buf.to_host() == data
    if zones > 1:   # hold several landing zones of this size at once
        L = lib()
        held = []
        for buf in (a, b, c)[:zones]:
            out = ctypes.POINTER(ctypes.c_uint8)()
            assert L.trpc_tpu_d2h(buf.handle, ctypes.byref(out)) == n
            held.append(out)
        for out in held:
            L.trpc_tpu_buf_release(out)
    cntl = Controller()
    assert ch.call("HbmEcho", b"x", attachment=data, cntl=cntl) == b"x"
    assert cntl.response_attachment == data
    for buf in (a, b, c):
        buf.free()


for salt, n in enumerate(SIZES * 2):      # warm: every class, 3 zones each
    round_trip(n, salt, zones=3)
warm_calls, warm_pools = calls(), tpu_plane.pool_stats()
assert warm_calls["cuMemAlloc_v2"] > 0 and warm_calls["cuMemHostAlloc"] > 0
for rep in range(4):
    for salt, n in enumerate(SIZES):
        round_trip(n, 31 * rep + salt)
steady_calls, steady_pools = calls(), tpu_plane.pool_stats()
assert steady_calls == warm_calls, (warm_calls, steady_calls)
for pool in ("device", "host"):
    w, s = warm_pools[pool], steady_pools[pool]
    assert s["misses"] == w["misses"], (pool, w, s)
    assert s["hits"] >= w["hits"] + 16, (pool, w, s)
    assert s["releases"] == w["releases"] == 0, (pool, w, s)
assert steady_calls["cuMemHostRegister_v2"] == 0
assert steady_calls["cuMemHostUnregister"] == 0
ch.close()
srv.destroy()
stats = tpu_plane.stats()
assert stats["live_buffers"] == 0, stats
assert stats["errors"] == 0, stats
print("STEADY-OK", steady_pools)
"""


OOM_CODE = PRELUDE + r"""
assert tpu_plane.init(), tpu_plane.error()
one = pattern(1 << 20, 1)
b = tpu_plane.h2d(one, device=0)
b.wait()
b.free()                                   # a 1 MiB block cached
p0 = tpu_plane.pool_stats()["device"]
assert p0["cached_bytes"] == 1 << 20, p0
frees0 = calls()["cuMemFree_v2"]

# one out-of-memory: the cache goes back to the driver, the retry holds
fake.trpc_fake_cuda_inject_oom(b"device", 1)
two = pattern(2 << 20, 2)
b = tpu_plane.h2d(two, device=0)           # a 2 MiB class: a miss
b.wait()
assert b.to_host() == two
p1 = tpu_plane.pool_stats()["device"]
assert p1["oom_retries"] == p0["oom_retries"] + 1, (p0, p1)
assert p1["releases"] == p0["releases"] + 1, (p0, p1)
assert p1["cached_bytes"] == 0, p1
assert calls()["cuMemFree_v2"] == frees0 + 1
b.free()

# the retry fails too: the transfer fails with the driver's reason
fake.trpc_fake_cuda_inject_oom(b"device", 2)
try:
    tpu_plane.h2d(pattern(4 << 20, 3), device=0)
    raise SystemExit("h2d must fail when the retry runs out of memory")
except IOError as e:
    assert "cuMemAlloc_v2: out of memory" in str(e), e
c = tpu_plane.h2d(two, device=0)
c.wait()
fake.trpc_fake_cuda_inject_oom(b"device", 2)
try:
    tpu_plane.d2d(c, 1)
    raise SystemExit("d2d must fail when the retry runs out of memory")
except IOError as e:
    assert "d2d: cuMemAlloc_v2: out of memory" in str(e), e
c.free()

# the page-locked pool: the same retry, and the same failure
h0 = tpu_plane.pool_stats()["host"]
fake.trpc_fake_cuda_inject_oom(b"host", 1)
odd = pattern(50000, 4)                    # a 64 KiB class: a miss
b = tpu_plane.h2d(odd, device=1)
b.wait()
assert b.to_host() == odd
h1 = tpu_plane.pool_stats()["host"]
assert h1["oom_retries"] == h0["oom_retries"] + 1, (h0, h1)
b.free()
fake.trpc_fake_cuda_inject_oom(b"host", 2)
try:
    tpu_plane.h2d(pattern(300000, 5))      # no staging block to be had
    raise SystemExit("h2d must fail when no staging block can be had")
except IOError as e:
    assert "h2d: cuMemHostAlloc: out of memory" in str(e), e
big = tpu_plane.h2d(pattern(3 << 20, 6), device=1)   # one 4 MiB block
big.wait()
L = lib()
held = ctypes.POINTER(ctypes.c_uint8)()
assert L.trpc_tpu_d2h(big.handle, ctypes.byref(held)) == 3 << 20
fake.trpc_fake_cuda_inject_oom(b"host", 2)
try:
    big.to_host()                          # a second zone: a miss
    raise SystemExit("to_host must fail when no landing zone can be had")
except IOError as e:
    assert "d2h: cuMemHostAlloc: out of memory" in str(e), e
L.trpc_tpu_buf_release(held)
fake.trpc_fake_cuda_inject_oom(b"host", 0)
big.free()

# the plane works on after every failure
d = tpu_plane.h2d(two, device=0)
d.wait()
assert d.to_host() == two
d.free()
live = tpu_plane.stats()["live_buffers"]
print("OOM-OK", live)
"""


BURST_CODE = PRELUDE + r"""
assert tpu_plane.init(), tpu_plane.error()
N, NBYTES = 40, 5 << 20                   # 40 blocks of the 8 MiB class:
                                          # 320 MiB, above the 256 MiB floor


def burst():
    bufs = [tpu_plane.fill(NBYTES, 0) for _ in range(N)]
    for b in bufs:
        b.wait()
    for b in bufs:
        b.free()                          # all at once, as retirements do


burst()
p0, c0 = tpu_plane.pool_stats()["device"], calls()
assert p0["cached_bytes"] == N * (8 << 20), p0
assert p0["releases"] == 0, p0
for _ in range(3):
    burst()
p1, c1 = tpu_plane.pool_stats()["device"], calls()
assert c1 == c0, (c0, c1)
assert p1["misses"] == p0["misses"] and p1["releases"] == 0, (p0, p1)
assert p1["hits"] == p0["hits"] + 3 * N, (p0, p1)

# an out-of-memory hands the whole burst back to the driver
fake.trpc_fake_cuda_inject_oom(b"device", 1)
odd = tpu_plane.fill(3 << 20, 0)          # a 4 MiB class: a miss
odd.wait()
odd.free()
p2 = tpu_plane.pool_stats()["device"]
assert p2["oom_retries"] == p1["oom_retries"] + 1, (p1, p2)
assert p2["releases"] == N and p2["cached_bytes"] == 4 << 20, p2
assert tpu_plane.stats()["live_buffers"] == 0, tpu_plane.stats()
print("BURST-OK")
"""


PEER_CODE = PRELUDE + r"""
import sys

cu = fake
assert cu.cuInit(0) == 0


def current():
    c = ctypes.c_void_p()
    assert cu.cuCtxGetCurrent(ctypes.byref(c)) == 0
    return c.value


def primary(dev):
    d, c = ctypes.c_int(), ctypes.c_void_p()
    assert cu.cuDeviceGet(ctypes.byref(d), dev) == 0
    assert cu.cuDevicePrimaryCtxRetain(ctypes.byref(c), d) == 0
    return c.value


refused = sys.argv[1] == "refused"
ctx0, ctx1 = primary(0), primary(1)
assert cu.cuCtxSetCurrent(ctypes.c_void_p(ctx0)) == 0
if not refused:
    # as PyTorch may have done: device 0's context already reaches 1
    assert cu.cuCtxEnablePeerAccess(ctypes.c_void_p(ctx1), 0) == 0
assert tpu_plane.init(), tpu_plane.error()
assert current() == ctx0, "init moved the caller's context"
peer = tpu_plane.pool_stats()["peer_access"]
want = [[0, 0], [0, 0]] if refused else [[0, 1], [1, 0]]
assert peer == want, peer
enabled = fake.trpc_fake_cuda_calls(b"cuCtxEnablePeerAccess")
assert enabled == (0 if refused else 3), enabled

names = ("cuMemcpyDtoDAsync_v2", "cuMemcpyPeerAsync")
data = pattern(1 << 20, 9)
for src, dst in ((0, 1), (1, 0)):
    a = tpu_plane.h2d(data, device=src)
    a.wait()
    before = calls(names)
    hop = tpu_plane.d2d(a, dst)
    hop.wait()
    after = calls(names)
    assert current() == ctx0
    path = "cuMemcpyPeerAsync" if refused else "cuMemcpyDtoDAsync_v2"
    other = ({*names} - {path}).pop()
    assert after[path] == before[path] + 1, (before, after)
    assert after[other] == before[other], (before, after)
    assert hop.to_host() == data
    hop.free()
    a.free()
assert tpu_plane.stats()["live_buffers"] == 0
print("PEER-OK", peer)
"""


FAKE_RULE_CODE = r"""
import ctypes, os, sys
cu = ctypes.CDLL(os.environ["TRPC_CUDA_DRIVER"])
P = ctypes.c_void_p
cu.cuMemcpyHtoDAsync_v2.argtypes = [ctypes.c_uint64, P, ctypes.c_size_t, P]
cu.cuMemcpyDtoHAsync_v2.argtypes = [P, ctypes.c_uint64, ctypes.c_size_t, P]
cu.cuMemFreeHost.argtypes = [P]
assert cu.cuInit(0) == 0
ctx, dev = P(), ctypes.c_int()
assert cu.cuDeviceGet(ctypes.byref(dev), 0) == 0
assert cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev) == 0
assert cu.cuCtxSetCurrent(ctx) == 0
stream, dptr, host = P(), ctypes.c_uint64(), P()
assert cu.cuStreamCreate(ctypes.byref(stream), 1) == 0
assert cu.cuMemAlloc_v2(ctypes.byref(dptr), 4096) == 0
assert cu.cuMemHostAlloc(ctypes.byref(host), 4096, 1) == 0
src = ctypes.create_string_buffer(4096)
rule = sys.argv[1]
if rule == "device_reuse":     # a second write into a block under a copy
    assert cu.cuMemcpyHtoDAsync_v2(dptr, src, 4096, stream) == 0
    cu.cuMemcpyHtoDAsync_v2(dptr, src, 4096, stream)
elif rule == "host_reuse":     # a zone handed out again under its copy
    assert cu.cuMemcpyDtoHAsync_v2(host, dptr, 4096, stream) == 0
    cu.cuMemcpyDtoHAsync_v2(host, dptr, 4096, stream)
elif rule == "host_free":      # a zone freed under its copy
    assert cu.cuMemcpyDtoHAsync_v2(host, dptr, 4096, stream) == 0
    cu.cuMemFreeHost(host)
print("NOT-ABORTED")
"""


def test_steady_state_transfers_allocate_nothing(fake_env):
    """After a warm-up, round trips at 4 KiB, 1 MiB, 8 MiB and an odd
    size (staged h2d, d2d on a card and across, d2h, an HbmEcho
    attachment) make no cuMemAlloc_v2, cuMemFree_v2,
    cuMemHostRegister_v2, cuMemHostUnregister, cuMemHostAlloc or
    cuMemFreeHost call; every byte comes back equal, both pools count
    hits and no miss, and no buffer is left live."""
    r = _run(STEADY_CODE, env_extra=fake_env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "STEADY-OK" in r.stdout


def test_a_burst_of_frees_waits_in_the_cache_for_the_next_allocations(
        fake_env):
    """Blocks freed all at once, more than the 256 MiB floor, stay cached
    up to the most the device had live: the allocations that follow take
    them back with no miss and no cuMemAlloc_v2 or cuMemFree_v2.  An
    out-of-memory still hands every cached block back."""
    r = _run(BURST_CODE, env_extra=fake_env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BURST-OK" in r.stdout


def test_out_of_memory_releases_the_cache_and_retries_once(fake_env):
    """An injected CUDA_ERROR_OUT_OF_MEMORY hands the device's cached
    blocks back to the driver and the retry succeeds; when the retry
    fails too, h2d and d2d fail with the driver's reason.  The same for
    the page-locked pool (staging and landing zones).  The plane works
    on afterwards and no buffer is left live."""
    r = _run(OOM_CODE, env_extra=fake_env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OOM-OK 0" in r.stdout, r.stdout


@pytest.mark.parametrize("access", ["granted", "refused"])
def test_peer_access_at_init(fake_env, access):
    """Init enables peer access between the fake's two devices (one pair
    already enabled by the caller, which the driver answers "already
    enabled", counts as granted), holds the caller's context, and a d2d
    across the pair copies directly; where the driver refuses the pair,
    the plane reports no access and the hop takes cuMemcpyPeerAsync."""
    env = dict(fake_env)
    if access == "refused":
        env["TRPC_FAKE_CUDA_NO_PEER"] = "1"
    code = PEER_CODE.replace("sys.argv[1]", repr(access))
    r = _run(code, env_extra=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PEER-OK" in r.stdout


@pytest.mark.parametrize("rule,message", [
    ("device_reuse", "a device block written while a copy on it is pending"),
    ("host_reuse", "a page-locked host block reused while a copy on it is "
                   "pending"),
    ("host_free", "cuMemFreeHost under a pending copy")])
def test_fake_driver_aborts_on_reuse_under_a_pending_copy(fake_env, rule,
                                                          message):
    """The fake's rules that the pool legs rely on really abort: a block
    written, or a page-locked block reused or freed, while a copy on it
    is still queued."""
    env = dict(fake_env)
    env["TRPC_FAKE_CUDA_DELAY_US"] = "500000"
    code = FAKE_RULE_CODE.replace("sys.argv[1]", repr(rule))
    r = _run(code, env_extra=env)
    assert r.returncode != 0 and "NOT-ABORTED" not in r.stdout, r.stdout
    assert message in r.stderr, r.stderr


STEADY_ROUNDS_CODE = PRELUDE + r"""
import sys
sys.path.insert(0, os.environ["PYTHONPATH"].split(os.pathsep)[0])
import chip_smoke
assert tpu_plane.init(), tpu_plane.error()
chip_smoke._plane_steady_round(0)
p0, c0 = tpu_plane.pool_stats(), calls()
for r in range(1, 6):
    chip_smoke._plane_steady_round(r)
p1, c1 = tpu_plane.pool_stats(), calls()
assert c1 == c0, (c0, c1)
for pool in ("device", "host"):
    assert p1[pool]["misses"] == p0[pool]["misses"], (p0, p1)
    assert p1[pool]["hits"] > p0[pool]["hits"], (p0, p1)
assert tpu_plane.stats()["live_buffers"] == 0, tpu_plane.stats()
print("OK")
"""


def test_chip_smoke_steady_rounds_reuse_pools_with_fresh_bytes(fake_env):
    """chip_smoke's steady loop of the plane phase on the fake: each round
    moves bytes of its own with two h2d in flight and a d2d source freed
    under its copy, every result compares equal, and after a warm round
    no round allocates, frees or page-locks in the driver."""
    r = _run(STEADY_ROUNDS_CODE, env_extra=fake_env)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr
