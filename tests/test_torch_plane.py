"""The port's CUDA device plane (brpc_tpu_torch/csrc/cuda_plane.cc +
brpc_tpu_torch/tpu_plane.py) on the fake CUDA driver (csrc/cuda_fake.cc).

These are the five fake-backed legs of tests/test_tpu_plane.py (:92,
:152, :192, :366, :377), re-run on the port: the same scenarios and
assertions, with the PJRT plugin replaced by the fake libcuda, its knobs
renamed TRPC_FAKE_CUDA_*, and the platform reading "cuda".  Each leg runs
in a subprocess: the plane client is process-global, and the port's core
and the reference's core are never loaded into one process.

The fake driver aborts the process if the plane makes a CUDA call inside
a host function or frees device memory under a pending copy, so every
leg also checks those two rules of the real driver.
"""

import os
import subprocess
import sys

import pytest

from brpc_tpu_torch import _native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fake_env():
    """Both libraries built once per module; every completion delayed so
    each butex-wake path really parks."""
    _native.build_core()
    return {"TRPC_CUDA_DRIVER": _native.build_fake_driver(),
            "TRPC_FAKE_CUDA_DELAY_US": "2000"}


def _run(code: str, env_extra=None, timeout=180):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if env_extra:
        env.update(env_extra)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)


FALLBACK_CODE = r"""
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.server import Server
from brpc_tpu_torch.rpc import errors

# the plane must fail loudly, with a reason
assert not tpu_plane.init(), "plane must be unavailable with a bogus plugin"
assert tpu_plane.error(), "unavailability must carry a reason"

srv = Server()
srv.add_service("Echo", lambda cntl, req: b"tcp:" + req)
srv.add_hbm_echo_service()
srv.start("127.0.0.1:0")

ch = Channel(f"tpu://0/0@127.0.0.1:{srv.port}",
             ChannelOptions(max_retry=0, timeout_ms=5000))
# plain calls still work over the TCP control plane...
assert ch.call("Echo", b"hi") == b"tcp:hi"
# ...and the handshake SETTLED EXPLICITLY in fallback (both ends probed)
assert ch.transport_state == "fallback_tcp", ch.transport_state
# device-dependent service fails loudly, not silently
try:
    ch.call("HbmEcho", b"x", attachment=b"a" * 1024)
    raise SystemExit("HbmEcho must fail without a device plane")
except errors.RpcError as e:
    assert "device plane unavailable" in str(e), e
ch.close()
srv.destroy()
print("FALLBACK-OK")
"""


DEVICE_CODE = r"""
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.server import Server

assert tpu_plane.init(), tpu_plane.error()
before = tpu_plane.stats()

# raw plane round-trip: butex-woken completion, data integrity
data = bytes(bytearray(range(256)) * 1024)  # 256KB
buf = tpu_plane.h2d(data)
buf.wait()
assert buf.to_host() == data
buf.free()

# RPC attachment round-trip through device memory (HbmEcho, native end to end)
srv = Server()
srv.add_hbm_echo_service()
srv.start("127.0.0.1:0")
ch = Channel(f"tpu://0/0@127.0.0.1:{srv.port}",
             ChannelOptions(max_retry=0, timeout_ms=60_000))
from brpc_tpu_torch.rpc.controller import Controller
cntl = Controller()
resp = ch.call("HbmEcho", b"ping", attachment=data, cntl=cntl)
assert resp == b"ping"
assert cntl.response_attachment == data
assert ch.transport_state == "device", ch.transport_state
after = tpu_plane.stats()
assert after["h2d_transfers"] >= before["h2d_transfers"] + 2
assert after["d2h_transfers"] >= before["d2h_transfers"] + 2
assert after["errors"] == before["errors"]
ch.close()
srv.destroy()
print("DEVICE-OK")
"""


ZERO_COPY_CODE = r"""
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.server import Server

assert tpu_plane.init(), tpu_plane.error()
srv = Server()
srv.add_hbm_echo_service()
srv.start("127.0.0.1:0")
ch = Channel(f"tpu://0/0@127.0.0.1:{srv.port}",
             ChannelOptions(max_retry=0, timeout_ms=30_000))
data = bytes(bytearray(range(256)) * 1024)  # 256KB, one IOBuf block
before = tpu_plane.stats()
cntl = Controller()
resp = ch.call("HbmEcho", b"ping", attachment=data, cntl=cntl)
assert resp == b"ping" and cntl.response_attachment == data
after = tpu_plane.stats()
# the single-block attachment DMAs from the block itself, both
# directions (client send + server send-back): pointer identity, no
# gather — a regression to silent gathering fails here
assert after["zero_copy_sends"] >= before["zero_copy_sends"] + 1, (before, after)
assert after["gather_copies"] == before["gather_copies"], (before, after)
ch.close()
srv.destroy()
print("ZERO-COPY-OK")
"""


FAULT_CODE = r"""
import os, time
from brpc_tpu_torch import tpu_plane

assert tpu_plane.init(), tpu_plane.error()
assert tpu_plane.platform() == "cuda"
assert tpu_plane.device_count() == 2
data = b"\xa5" * 4096

# second addressable device works end-to-end
b = tpu_plane.h2d(data, device=1)
b.wait()
assert b.to_host() == data
b.free()

# raw device-to-device: new buffer on the target device, source intact
b = tpu_plane.h2d(data, device=0)
b.wait()
c = tpu_plane.d2d(b, 1)
assert c.to_host() == data
assert b.to_host() == data  # source untouched
before_d2d = tpu_plane.stats()["d2d_transfers"]
assert before_d2d >= 1
b.free(); c.free()

# sync create failure surfaces at h2d() with the plane's reason
os.environ["TRPC_FAKE_CUDA_FAIL"] = "h2d"
try:
    tpu_plane.h2d(data)
    raise SystemExit("h2d must fail")
except IOError as e:
    assert "injected failure" in str(e), e
del os.environ["TRPC_FAKE_CUDA_FAIL"]

# residency event completing WITH an error -> wait() raises IOError
os.environ["TRPC_FAKE_CUDA_FAIL"] = "ready"
b = tpu_plane.h2d(data)
try:
    b.wait()
    raise SystemExit("wait must fail")
except IOError:
    pass
b.free()
del os.environ["TRPC_FAKE_CUDA_FAIL"]

# copy event completing WITH an error -> to_host() raises IOError
os.environ["TRPC_FAKE_CUDA_FAIL"] = "d2h"
b = tpu_plane.h2d(data)
b.wait()
try:
    b.to_host()
    raise SystemExit("to_host must fail")
except IOError:
    pass
b.free()
del os.environ["TRPC_FAKE_CUDA_FAIL"]

# DROPPED copy event: the wait is BOUNDED (never wedges the thread) and
# the plane records the reason
os.environ["TRPC_FAKE_CUDA_DROP_D2H_EVENT"] = "1"
os.environ["TRPC_TPU_D2H_TIMEOUT_US"] = "300000"
b = tpu_plane.h2d(data)
b.wait()
t0 = time.monotonic()
try:
    b.to_host()
    raise SystemExit("dropped event must time out")
except IOError:
    elapsed = time.monotonic() - t0
    assert 0.2 < elapsed < 5.0, elapsed
assert "never completed" in tpu_plane.error(), tpu_plane.error()
b.free()
del os.environ["TRPC_FAKE_CUDA_DROP_D2H_EVENT"]

# the plane keeps working after every injected fault
b = tpu_plane.h2d(data)
b.wait()
assert b.to_host() == data
b.free()
stats = tpu_plane.stats()
assert stats["errors"] >= 3
assert stats["live_buffers"] == 0, stats
print("FAULTS-OK")
"""


DEVICE_STREAM_CODE = r"""
import time
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.server import Server
from brpc_tpu_torch.rpc.stream import StreamProtocolError

assert tpu_plane.init(), tpu_plane.error()
accepted = []

def handler(cntl, req):
    accepted.append(cntl.accept_stream())
    return b"ok"

srv = Server()
srv.add_service("TensorSink", handler)
srv.start("127.0.0.1:0")

# --- LOCAL rail: tpu:// channel, handshake exchanges plane uids --------
ch = Channel(f"tpu://0/0@127.0.0.1:{srv.port}",
             ChannelOptions(max_retry=0, timeout_ms=30_000))
resp, st = ch.create_stream("TensorSink", b"")
assert resp == b"ok"
assert ch.transport_state == "device", ch.transport_state
server_half = accepted[0]

frames = [bytes([i]) * (64 * 1024) for i in range(8)]
before = tpu_plane.stats()
for f in frames:
    buf = tpu_plane.h2d(f, device=0)
    st.write_device(buf)  # ownership transfers to the stream
got = [server_half.read_device(device=1, timeout_s=30) for _ in frames]
after = tpu_plane.stats()
# 8 tensors moved dev0->dev1 on the local rail: one CopyToDevice each,
# ZERO host landings beyond the 8 creation h2ds, ZERO gathers
assert after["d2d_transfers"] == before["d2d_transfers"] + 8, (before, after)
assert after["gather_copies"] == before["gather_copies"], (before, after)
assert after["h2d_transfers"] == before["h2d_transfers"] + 8, (before, after)
assert after["d2h_transfers"] == before["d2h_transfers"], (before, after)
# content survives (the verification d2h comes after the accounting)
assert got[3].to_host() == frames[3]
for b in got:
    b.free()

# --- HOST rail: a POOLED connection never carries the tag-14/15 probe,
# so the socket has no shared-client evidence and the frame must fall
# back to explicit host bytes.  (A plain single channel would SocketMap-
# share the probed connection above and legitimately keep the local rail.)
ch2 = Channel(f"127.0.0.1:{srv.port}",
              ChannelOptions(connection_type="pooled"))
resp, st2 = ch2.create_stream("TensorSink", b"")
server_half2 = accepted[1]
b4 = tpu_plane.stats()
buf = tpu_plane.h2d(frames[5], device=0)
st2.write_device(buf)
# a host read on a device frame is a typed error and consumes nothing
deadline = time.monotonic() + 10
while server_half2.pending_bytes == 0 and time.monotonic() < deadline:
    time.sleep(0.01)
try:
    server_half2.read(timeout_s=1)
    raise SystemExit("read() must reject a device frame")
except StreamProtocolError:
    pass
rbuf = server_half2.read_device(device=1, timeout_s=30)
assert rbuf.to_host() == frames[5]
rbuf.free()
a4 = tpu_plane.stats()
assert a4["d2d_transfers"] == b4["d2d_transfers"], (b4, a4)   # no rail
assert a4["d2h_transfers"] >= b4["d2h_transfers"] + 1          # explicit
assert a4["gather_copies"] == b4["gather_copies"], (b4, a4)

for s in (st, st2, *accepted):
    s.destroy()
ch.close(); ch2.close(); srv.destroy()
live = tpu_plane.stats()["live_buffers"]
assert live == 0, live
print("DEVICE-STREAM-OK")
"""


def test_fallback_is_explicit():
    """No loadable driver: the plane is unavailable with a reason, tpu://
    channels settle in the explicit fallback_tcp state, and HbmEcho
    fails loudly."""
    _native.build_core()
    r = _run(FALLBACK_CODE,
             env_extra={"TRPC_CUDA_DRIVER": "/nonexistent/libcuda.so.1"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FALLBACK-OK" in r.stdout


def test_device_roundtrip_on_fake_plane(fake_env):
    """Raw plane round trip, HbmEcho attachment through device memory,
    the handshake settling in 'device', counters advancing."""
    r = _run(DEVICE_CODE, env_extra=fake_env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "DEVICE-OK" in r.stdout


def test_zero_copy_attachment_counters(fake_env):
    r = _run(ZERO_COPY_CODE, env_extra=fake_env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ZERO-COPY-OK" in r.stdout


def test_device_payload_streams(fake_env):
    """Tensor streams dev0->dev1 over the local rail (handle passing +
    cuMemcpyPeerAsync, zero host copies) and the explicit host rail."""
    r = _run(DEVICE_STREAM_CODE, env_extra=fake_env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "DEVICE-STREAM-OK" in r.stdout


def test_fault_injection_on_fake_plane(fake_env):
    """Failed, asynchronously failed and dropped completions: errors
    surface with reasons, the d2h wait is bounded, the plane survives."""
    r = _run(FAULT_CODE, env_extra=fake_env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FAULTS-OK" in r.stdout


CONTEXT_CODE = r"""
import ctypes, os, sys, threading
from brpc_tpu_torch import tpu_plane

# the driver the plane binds: dlopen of the same path is the same library,
# so this handle reads the same per-thread current context
cu = ctypes.CDLL(os.environ.get("TRPC_CUDA_DRIVER") or "libcuda.so.1")
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

def hold(want, where):
    got = current()
    assert got == want, f"{where}: the thread's context {got} != {want}"

def exercise(want):
    data = bytes(bytearray(range(256)) * 64)
    one = tpu_plane.h2d(data, device=1)
    one.wait()
    hold(want, "h2d to device 1")
    zero = tpu_plane.h2d(data, device=0)
    zero.wait()
    hop = tpu_plane.d2d(zero, 1)
    hop.wait()
    hold(want, "d2d 0 -> 1")
    assert hop.to_host() == data and one.to_host() == data
    hold(want, "d2h from device 1")
    for b in (one, zero, hop):
        b.free()
    hold(want, "free on device 1")

def thread(fn):
    err = []
    def run():
        try:
            fn()
        except BaseException as e:
            err.append(e)
    t = threading.Thread(target=run)
    t.start()
    t.join(60)
    assert not t.is_alive()
    if err:
        raise err[0]

start = sys.argv[1]      # the context of the thread that starts the plane
ctx0 = primary(0)
assert primary(1) != ctx0
if start == "device0":
    assert cu.cuCtxSetCurrent(ctypes.c_void_p(ctx0)) == 0
want = ctx0 if start == "device0" else None
hold(want, "before init")
assert tpu_plane.init(), tpu_plane.error()
hold(want, "after init")
exercise(want)
thread(lambda: exercise(None))            # a thread with no context
thread(lambda: (cu.cuCtxSetCurrent(ctypes.c_void_p(ctx0)),
                exercise(ctx0)))          # one with device 0's
if "torch_device" in sys.argv[2:]:        # the same, as torch reads it
    import torch
    torch.cuda.set_device(0)
    exercise(current())
    assert torch.cuda.current_device() == 0, torch.cuda.current_device()
assert tpu_plane.stats()["live_buffers"] == 0
print("CONTEXT-OK")
"""


@pytest.mark.parametrize("start", ["device0", "none"])
def test_plane_restores_the_callers_context(fake_env, start):
    """The plane moves none of its caller's CUDA state (ROADMAP queue 3):
    a thread whose current context is device 0's primary context, or
    none, still has it after tpu_plane.init() and after an h2d to device
    1, a d2d 0 -> 1, a d2h and a free on device 1; so do a fresh thread
    and one that made device 0's context current.  The fake driver's
    current context is per thread, as the real driver's."""
    code = CONTEXT_CODE.replace("sys.argv[1]", repr(start))
    r = _run(code, env_extra=fake_env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "CONTEXT-OK" in r.stdout


def _races(exe, fake_env, extra=None):
    env = dict(os.environ)
    env.update(fake_env)
    env["TRPC_FAKE_CUDA_DELAY_US"] = "300"
    env.update(extra or {})
    return subprocess.run([exe], env=env, capture_output=True, text=True,
                          timeout=300)


def test_plane_races_against_the_core(fake_env):
    """csrc/test_plane_races.cc against the core library: a free racing
    each transfer, wait and d2h racing the free, a double free,
    round-trips and d2d hops on both devices from 6 threads, each
    thread's current context (device 0's or none) unchanged after every
    round, every slot drained; then, where the kernel takes io_uring,
    d2h zones from the ring's registered slots raced the same way."""
    r = _races(_native.build_plane_races(), fake_env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ALL PLANE RACES PASSED" in r.stdout, r.stdout
    assert "moved_contexts=0" in r.stdout, r.stdout
    assert "slot_races" in r.stdout, r.stdout


def test_plane_races_under_asan(fake_env, tmp_path):
    """The same races in one AddressSanitizer binary of the harness and
    the core's sources (the reference's test_cpp_stress_sanitized
    [address] for this plane): no use after free, double free or
    overflow, and the sanitizer writes no report.  Leak detection is
    off: LeakSanitizer's stop-the-world tracer faults (signal 11) in a
    container that restricts ptrace, and the plane keeps its singletons
    for the process's life on purpose."""
    log = tmp_path / "asan"
    r = _races(_native.build_plane_races(asan=True), fake_env,
               {"ASAN_OPTIONS": f"detect_leaks=0:log_path={log}"})
    reports = "".join(p.read_text(errors="replace")
                      for p in tmp_path.glob("asan*"))
    assert r.returncode == 0, r.stdout + r.stderr + reports
    assert "ALL PLANE RACES PASSED" in r.stdout, r.stdout
    assert "slot_races" in r.stdout, r.stdout
    assert not reports, reports


@pytest.mark.cuda
def test_plane_restores_the_callers_device_across_cards():
    """The context leg on the real driver, with torch's current device
    read after the plane copied to and from device 1."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the plane's copies to device 1 "
                    "are what could leave another card current")
    code = CONTEXT_CODE.replace("sys.argv[1]", repr("device0")).replace(
        "sys.argv[2:]", "['torch_device']")
    r = _run(code, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "CONTEXT-OK" in r.stdout


@pytest.mark.cuda
def test_device_roundtrip_on_real_plane():
    """The DEVICE leg on the real driver and card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and its driver (libcuda.so.1)")
    r = _run(DEVICE_CODE, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "DEVICE-OK" in r.stdout
