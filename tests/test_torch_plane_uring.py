"""The CUDA plane's d2h landing zones on io_uring's registered slots
(brpc_tpu_torch/csrc/cuda_plane.cc), on the fake CUDA driver
(csrc/cuda_fake.cc), against the reference's rule (native/src/tpu.cc's
zc_host_alloc and tpu_host_free): with the io_uring transport up, a zone
that fits a slot is one of the ring's fixed buffers, leaves the host as a
fixed-buffer SEND_ZC and goes back to the ring when the socket is done
with it; otherwise it comes from the page-locked pool.

* The reference's own leg (tests/test_io_uring.py,
  ``test_registered_pool_backs_d2h_landing_zones``) on the port: an
  HbmEcho attachment of 1 MiB over ``tpu://`` with SEND_ZC pinned on.
* Steady state: HbmEcho and d2h round trips at 1 MiB (a slot) and 8 MiB
  (larger than a slot: the pool) with bytes of their own; after the
  slots' first use no registration, unregistration or page-locked
  allocation is made, and the 8 MiB zones are pool hits.
* A driver that refuses to page-lock a slot: the slot is tried once and
  goes back to the ring, its zones come from the pool, the bytes come
  back equal.
* With io_uring off the zones come from the pool and nothing is
  registered.
* The fake's registration rules: an overlap and an unknown base are
  refused with the driver's codes, the refusal knob refuses, and a copy
  into a registered range holds it as a page-locked block is held (a
  second copy or an unregistration under it aborts).

Each leg runs in a subprocess on ephemeral ports: the plane, the ring
engine and the use_io_uring flag are process-global.  The fake aborts
the process on a block freed, written or handed out again under a
pending copy, or on a CUDA call from a host function, so every leg
checks those rules too.
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


@pytest.fixture(scope="module")
def sendzc(fake_env):
    """Whether this kernel takes io_uring and IORING_OP_SEND_ZC, asked
    of the port's core in a process of its own."""
    r = _run("from brpc_tpu_torch._native import lib\n"
             "L = lib()\n"
             "print('RING', L.trpc_io_uring_available())\n"
             "L.trpc_set_io_uring(1)\n"
             "print('SZC', L.trpc_sendzc_available())\n", fake_env)
    assert r.returncode == 0, r.stdout + r.stderr
    if "RING 1" not in r.stdout:
        pytest.skip("kernel refuses io_uring")
    return "SZC 1" in r.stdout


PRELUDE = r"""
import ctypes, json, os, time
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch._native import lib
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.server import Server
from brpc_tpu_torch.utils import flags

fake = ctypes.CDLL(os.environ["TRPC_CUDA_DRIVER"])
fake.trpc_fake_cuda_calls.argtypes = [ctypes.c_char_p]
fake.trpc_fake_cuda_calls.restype = ctypes.c_ulonglong
ALLOCATING = ("cuMemHostRegister_v2", "cuMemHostUnregister",
              "cuMemHostAlloc", "cuMemFreeHost")


def calls(names=ALLOCATING):
    return {n: fake.trpc_fake_cuda_calls(n.encode()) for n in names}


def counters():
    buf = ctypes.create_string_buffer(1 << 16)
    n = lib().trpc_native_metrics_dump(buf, len(buf))
    out = {}
    for line in buf.raw[:n].decode().splitlines():
        k, _, v = line.partition(" ")
        if k:
            out[k] = int(v)
    return out


def settled(deadline_s=10.0):
    # zerocopy notifications trail the responses: wait until every
    # SEND_ZC retired and every slot is back in the ring
    end = time.time() + deadline_s
    c = counters()
    while (c.get("native_uring_sendzc_retired", 0) <
           c.get("native_uring_sendzc_submitted", 0) or
           c.get("native_uring_zc_pool_in_use", 0) != 0) and \
            time.time() < end:
        time.sleep(0.05)
        c = counters()
    return c


def pattern(n, salt):
    row = bytes(range(salt % 256, 256)) + bytes(range(salt % 256))
    return (row * (n // 256 + 1))[:n]


flags.set_flag("use_io_uring", USE_IO_URING)
srv = Server()
srv.add_hbm_echo_service()
srv.start("127.0.0.1:0")
assert tpu_plane.init(), tpu_plane.error()
ch = Channel(f"tpu://0/0@127.0.0.1:{srv.port}",
             ChannelOptions(max_retry=0, timeout_ms=60_000))


def echo(n, salt):
    # an HbmEcho attachment (the server's d2h zone leaves as the response)
    # and a d2h read back in Python (the zone handed back once copied)
    data = pattern(n, salt)
    cntl = Controller()
    assert ch.call("HbmEcho", b"x", attachment=data, cntl=cntl) == b"x"
    assert cntl.response_attachment == data, (n, salt)
    b = tpu_plane.h2d(data, device=0)
    assert b.to_host() == data, (n, salt)
    b.free()


def finish(tag, **extra):
    c = settled()
    ch.close()
    srv.destroy()
    stats = tpu_plane.stats()
    assert stats["live_buffers"] == 0, stats
    assert stats["errors"] == 0, stats
    out = {k: v for k, v in c.items() if "uring" in k}
    out.update(extra)
    print(tag, json.dumps(out))
"""


REFERENCE_LEG = PRELUDE.replace("USE_IO_URING", "True") + r"""
# the reference's leg, as tests/test_io_uring.py runs it on brpc_tpu
data = bytes(bytearray(range(256)) * 4096)  # 1MB
cntl = Controller()
assert ch.call("HbmEcho", b"ping", attachment=data, cntl=cntl) == b"ping"
assert cntl.response_attachment == data
c = settled()
assert c["native_uring_sendzc_fixed"] >= 1, c
assert c["native_uring_zc_pool_slots"] >= 1, c
assert c["native_uring_zc_pool_in_use"] == 0, c
finish("REFERENCE-OK")
"""


STEADY_LEG = PRELUDE.replace("USE_IO_URING", "True") + r"""
SIZES = (1 << 20, 8 << 20)
for salt in range(3):                       # first use of the slots
    for n in SIZES:
        echo(n, salt)
settled()
warm, warm_host = calls(), tpu_plane.pool_stats()["host"]
fixed0 = counters()["native_uring_sendzc_fixed"]
assert warm["cuMemHostRegister_v2"] >= 1, warm
for salt in range(3, 13):
    for n in SIZES:
        echo(n, salt)
c = settled()
steady, host = calls(), tpu_plane.pool_stats()["host"]
assert steady == warm, (warm, steady)
assert host["misses"] == warm_host["misses"], (warm_host, host)
# each 8 MiB round takes two zones of the pool (the echo's, to_host's)
assert host["hits"] >= warm_host["hits"] + 20, (warm_host, host)
assert c["native_uring_sendzc_fixed"] >= fixed0 + 10, (fixed0, c)
slots = tpu_plane.pool_stats()["slots"]
assert slots == {"registered": steady["cuMemHostRegister_v2"],
                 "refused": 0}, (slots, steady)
finish("STEADY-OK", registered=steady["cuMemHostRegister_v2"])
"""


REFUSED_LEG = PRELUDE.replace("USE_IO_URING", "True") + r"""
for salt in range(3):                       # the slots' first use
    echo(1 << 20, salt)
settled()
first, host0 = calls(), tpu_plane.pool_stats()["host"]
assert 1 <= first["cuMemHostRegister_v2"] <= counters()[
    "native_uring_zc_pool_slots"], first
for salt in range(3, 13):
    echo(1 << 20, salt)
c = settled()
later, host = calls(), tpu_plane.pool_stats()["host"]
assert later == first, (first, later)       # each slot tried once, ever
assert c["native_uring_sendzc_fixed"] == 0, c   # the zones are the pool's
assert host["hits"] >= host0["hits"] + 20, (host0, host)
assert c["native_uring_zc_pool_in_use"] == 0, c
slots = tpu_plane.pool_stats()["slots"]
assert slots == {"registered": 0,
                 "refused": later["cuMemHostRegister_v2"]}, (slots, later)
finish("REFUSED-OK", registered=later["cuMemHostRegister_v2"])
"""


DEFAULT_LEG = PRELUDE.replace("USE_IO_URING", "False") + r"""
for salt in range(4):
    echo(1 << 20, salt)
c = settled()
host = tpu_plane.pool_stats()["host"]
assert calls()["cuMemHostRegister_v2"] == 0, calls()
assert tpu_plane.pool_stats()["slots"] == {"registered": 0, "refused": 0}
assert c.get("native_uring_sendzc_submitted", 0) == 0, c
assert host["hits"] >= 6, host
finish("DEFAULT-OK")
"""


def _leg(code, env, tag):
    r = _run(code, env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert tag in r.stdout, r.stdout
    return r.stdout


def test_reference_leg_d2h_zones_ride_registered_slots(fake_env, sendzc):
    """tests/test_io_uring.py::...test_registered_pool_backs_d2h_landing_
    zones on the port: with SEND_ZC pinned on, a 1 MiB HbmEcho
    attachment lands in a registered slot and leaves as a fixed-buffer
    SEND_ZC (native_uring_sendzc_fixed >= 1), and the slot goes back to
    the ring once the notification dropped the block."""
    if not sendzc:
        pytest.skip("kernel lacks IORING_OP_SEND_ZC")
    _leg(REFERENCE_LEG, {**fake_env, "TRPC_SENDZC_FORCE": "1"},
         "REFERENCE-OK")


def test_steady_slots_and_pool_make_no_driver_call(fake_env, sendzc):
    """With io_uring on, HbmEcho and d2h rounds at 1 MiB and 8 MiB with
    bytes of their own come back equal; after the slots' first use no
    cuMemHostRegister_v2, cuMemHostUnregister, cuMemHostAlloc or
    cuMemFreeHost call is made, the 8 MiB zones are hits of the
    page-locked pool, and the 1 MiB attachments keep leaving on fixed
    buffers."""
    if not sendzc:
        pytest.skip("kernel lacks IORING_OP_SEND_ZC")
    _leg(STEADY_LEG, {**fake_env, "TRPC_SENDZC_FORCE": "1"}, "STEADY-OK")


def test_a_refused_slot_is_tried_once_and_the_pool_serves(fake_env, sendzc):
    """A driver that refuses to page-lock (TRPC_FAKE_CUDA_NO_HOST_
    REGISTER): each slot it refused is tried once, ever, and handed back
    to the ring; the zones come from the pool (no fixed-buffer send), the
    bytes come back equal, and no slot stays out of the ring."""
    if not sendzc:
        pytest.skip("kernel lacks IORING_OP_SEND_ZC")
    _leg(REFUSED_LEG, {**fake_env, "TRPC_SENDZC_FORCE": "1",
                       "TRPC_FAKE_CUDA_NO_HOST_REGISTER": "1"},
         "REFUSED-OK")


def test_without_io_uring_the_pool_serves_every_zone(fake_env):
    """The default path: with io_uring off every zone is a page-locked
    pool block and nothing is registered with the driver."""
    _leg(DEFAULT_LEG, fake_env, "DEFAULT-OK")


FAKE_REGISTER_CODE = r"""
import ctypes, os, sys
cu = ctypes.CDLL(os.environ["TRPC_CUDA_DRIVER"])
P = ctypes.c_void_p
cu.cuMemHostRegister_v2.argtypes = [P, ctypes.c_size_t, ctypes.c_uint]
cu.cuMemHostUnregister.argtypes = [P]
cu.cuMemcpyDtoHAsync_v2.argtypes = [P, ctypes.c_uint64, ctypes.c_size_t, P]
assert cu.cuInit(0) == 0
ctx, dev = P(), ctypes.c_int()
assert cu.cuDeviceGet(ctypes.byref(dev), 0) == 0
assert cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev) == 0
assert cu.cuCtxSetCurrent(ctx) == 0
stream, dptr = P(), ctypes.c_uint64()
assert cu.cuStreamCreate(ctypes.byref(stream), 1) == 0
assert cu.cuMemAlloc_v2(ctypes.byref(dptr), 4096) == 0
mem = ctypes.create_string_buffer(4 * 4096)
base = ctypes.addressof(mem)
rule = sys.argv[1]
if rule == "codes":
    assert cu.cuMemHostRegister_v2(base + 4096, 8192, 1) == 0
    for off, n in ((0, 8192), (8192, 4096), (4096, 4096), (0, 4 * 4096),
                   (3 * 4096 - 1, 2)):
        rc = cu.cuMemHostRegister_v2(base + off, n, 1)
        assert rc == 712, (off, n, rc)     # ALREADY_REGISTERED
    assert cu.cuMemHostRegister_v2(base, 4096, 1) == 0      # adjacent
    assert cu.cuMemHostRegister_v2(base + 3 * 4096, 4096, 1) == 0
    assert cu.cuMemHostUnregister(base + 8192) == 713   # NOT_REGISTERED
    for off in (4096, 0, 3 * 4096):
        assert cu.cuMemHostUnregister(base + off) == 0
    assert cu.cuMemHostUnregister(base) == 713
    os.environ["TRPC_FAKE_CUDA_NO_HOST_REGISTER"] = "1"
    assert cu.cuMemHostRegister_v2(base, 4096, 1) == 800    # refused
    print("CODES-OK")
    sys.exit(0)
assert cu.cuMemHostRegister_v2(base, 4 * 4096, 1) == 0
assert cu.cuMemcpyDtoHAsync_v2(base + 4096, dptr, 4096, stream) == 0
if rule == "reuse":        # a slot handed out again under its copy
    cu.cuMemcpyDtoHAsync_v2(base + 4096, dptr, 4096, stream)
elif rule == "unregister":  # a slot unregistered under its copy
    cu.cuMemHostUnregister(base)
print("NOT-ABORTED")
"""


def test_fake_registration_codes_and_refusal(fake_env):
    """cuMemHostRegister_v2 records its range and refuses an overlap
    (712) but not a neighbour; cuMemHostUnregister of a base it does not
    hold says 713; TRPC_FAKE_CUDA_NO_HOST_REGISTER refuses (800)."""
    code = FAKE_REGISTER_CODE.replace("sys.argv[1]", repr("codes"))
    r = _run(code, fake_env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "CODES-OK" in r.stdout


@pytest.mark.parametrize("rule,message", [
    ("reuse", "reused while a copy on it is pending"),
    ("unregister", "cuMemHostUnregister under a pending copy")])
def test_fake_holds_a_registered_range_to_the_pending_copy_rule(fake_env,
                                                                rule,
                                                                message):
    """A DtoH copy into a registered range is pending until it ran: a
    second copy into it, or its unregistration, before then aborts."""
    code = FAKE_REGISTER_CODE.replace("sys.argv[1]", repr(rule))
    r = _run(code, {**fake_env, "TRPC_FAKE_CUDA_DELAY_US": "500000"})
    assert r.returncode != 0, r.stdout
    assert "NOT-ABORTED" not in r.stdout
    assert message in r.stderr, r.stderr
