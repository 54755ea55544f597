"""ctypes loader for the port's native core (libbrpc_tpu_torch_core.so).

The library is the C++ host core of ``native/src`` (fibers, IOBuf,
sockets, the RPC wire, streams, metrics) compiled from its sources in
place, with the device plane ``native/src/tpu.cc`` replaced by the CUDA
driver-API plane ``brpc_tpu_torch/csrc/cuda_plane.cc``.  It implements the
same ``tpu.h`` contract, so ``capi.cc``, ``rpc.cc`` and ``stream.cc``
compile unchanged and the C ABI below is the reference's ABI.

Everything is built at first use into ``brpc_tpu_torch/_native/build/``
(gitignored): the core with parallel g++, the fake libcuda the CPU tests
bind (``csrc/cuda_fake.cc``), the plane's race harness with and
without AddressSanitizer (``csrc/test_plane_races.cc``), and, on a
machine with ``nvcc``, the hand-written kernels (``csrc/*.cu``).  A build runs under an ``fcntl``
lock (test runners import this module from several processes at once)
and installs by atomic rename, so a process that already mapped a
library keeps its copy.  A content stamp of the inputs decides whether a
library is current.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
_REPO = os.path.dirname(_PKG)
NATIVE_SRC = os.path.join(_REPO, "native")
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

CORE_NAME = "libbrpc_tpu_torch_core.so"
FAKE_NAME = "libcuda_fake.so"
KERNELS_NAME = "libbrpc_tpu_torch_kernels.so"

CXXFLAGS = ["-std=gnu++17", "-O2", "-DNDEBUG", "-fPIC", "-pthread"]
NVCCFLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC"]
PTXAS_REPORT = os.path.join(BUILD_DIR, KERNELS_NAME + ".ptxas.txt")

# wall seconds of each build this process ran (absent: it was current)
build_seconds: Dict[str, float] = {}

_lib = None
_lib_lock = threading.Lock()


def _digest(inputs: List[str], flags: List[str]) -> str:
    h = hashlib.sha256("\0".join(flags).encode())
    for path in inputs:
        h.update(path.encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _build(name: str, inputs: List[str], flags: List[str],
           make: Callable[[str], None]) -> str:
    """Return the path of library `name`, rebuilding it when the stamp of
    `inputs` + `flags` changed.  `make(out)` writes the library to
    `out`; the result is installed by rename under the build lock."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, name)
    stamp_path = out + ".stamp"
    key = _digest(inputs, flags)

    def current() -> bool:
        if not os.path.exists(out) or not os.path.exists(stamp_path):
            return False
        with open(stamp_path) as f:
            return f.read() == key

    if current():
        return out
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if current():
            return out
        t0 = time.monotonic()
        tmp = f"{out}.tmp.{os.getpid()}"
        make(tmp)
        os.replace(tmp, out)
        with open(stamp_path + ".tmp", "w") as f:
            f.write(key)
        os.replace(stamp_path + ".tmp", stamp_path)
        build_seconds[name] = time.monotonic() - t0
    return out


def _run(cmd: List[str]) -> str:
    """Run one build step; returns what it printed."""
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"build step failed: {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    return r.stdout + r.stderr


def _core_sources() -> List[str]:
    """native/sources.lst read in place, with the PJRT plane swapped for
    the CUDA plane."""
    out = []
    with open(os.path.join(NATIVE_SRC, "sources.lst")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line == "src/tpu.cc":
                out.append(os.path.join(CSRC, "cuda_plane.cc"))
            else:
                out.append(os.path.join(NATIVE_SRC, line))
    return out


def _headers() -> List[str]:
    return sorted(glob.glob(os.path.join(NATIVE_SRC, "src", "*.h")))


def build_core() -> str:
    """Build (if stale) and return the path of the core library."""
    cxx = os.environ.get("CXX", "g++")
    sources = _core_sources()
    compat = os.path.join(CSRC, "compat")
    flags = CXXFLAGS + ["-I" + compat, "-I" + os.path.join(NATIVE_SRC, "src")]

    def make(out: str) -> None:
        objdir = tempfile.mkdtemp(prefix="obj-", dir=BUILD_DIR)
        try:
            objs = [os.path.join(objdir, f"{i}.o")
                    for i in range(len(sources))]
            with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
                for fut in [ex.submit(_run, [cxx, *flags, "-c", s, "-o", o])
                            for s, o in zip(sources, objs)]:
                    fut.result()
            _run([cxx, *flags, "-shared", *objs, "-o", out, "-ldl"])
        finally:
            shutil.rmtree(objdir, ignore_errors=True)

    inputs = sources + _headers() + [os.path.join(compat, "linux",
                                                      "io_uring.h")]
    return _build(CORE_NAME, inputs, [cxx] + flags, make)


def build_fake_driver() -> str:
    """Build (if stale) and return the path of the fake libcuda."""
    cxx = os.environ.get("CXX", "g++")
    src = os.path.join(CSRC, "cuda_fake.cc")
    flags = CXXFLAGS + ["-shared"]
    return _build(FAKE_NAME, [src], [cxx] + flags,
                  lambda out: _run([cxx, *flags, src, "-o", out]))


RACES_NAME = "test_plane_races"
ASAN_FLAGS = ["-std=gnu++17", "-O1", "-g", "-fno-omit-frame-pointer",
              "-fsanitize=address", "-fPIC", "-pthread"]


def build_plane_races(asan: bool = False) -> str:
    """Build (if stale) and return the path of the plane's race harness
    (``csrc/test_plane_races.cc``): linked against the core library, or,
    with `asan`, one AddressSanitizer binary of the harness and the
    core's sources compiled again.  Run it with ``TRPC_CUDA_DRIVER``
    naming the fake driver (:func:`build_fake_driver`)."""
    cxx = os.environ.get("CXX", "g++")
    src = os.path.join(CSRC, "test_plane_races.cc")
    include = ["-I" + os.path.join(CSRC, "compat"),
               "-I" + os.path.join(NATIVE_SRC, "src")]
    if not asan:
        core = build_core()
        flags = CXXFLAGS + include
        link = ["-L" + BUILD_DIR, "-l:" + CORE_NAME,
                "-Wl,-rpath,$ORIGIN", "-ldl"]
        return _build(RACES_NAME, [src, core], [cxx] + flags + link,
                      lambda out: _run([cxx, *flags, src, "-o", out,
                                        *link]))
    sources = _core_sources() + [src]
    flags = ASAN_FLAGS + include

    def make(out: str) -> None:
        objdir = tempfile.mkdtemp(prefix="asan-", dir=BUILD_DIR)
        try:
            objs = [os.path.join(objdir, f"{i}.o")
                    for i in range(len(sources))]
            with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
                for fut in [ex.submit(_run, [cxx, *flags, "-c", s, "-o", o])
                            for s, o in zip(sources, objs)]:
                    fut.result()
            _run([cxx, *flags, *objs, "-o", out, "-ldl"])
        finally:
            shutil.rmtree(objdir, ignore_errors=True)

    inputs = sources + _headers() + [os.path.join(CSRC, "compat", "linux",
                                                      "io_uring.h")]
    return _build(RACES_NAME + "_asan", inputs, [cxx] + flags, make)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build_kernels() -> str:
    """Build (if stale) and return the path of the kernel library, one
    nvcc for each .cu source, all started together (the .cuh headers
    they include join the stamp).  What ptxas -v reported for each kernel
    is kept beside it, in PTXAS_REPORT."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    cflags = [f for f in NVCCFLAGS if f != "-shared"] + ["-Xptxas=-v"]

    def make(out: str) -> None:
        nvcc = _nvcc()
        objdir = tempfile.mkdtemp(prefix="cuobj-", dir=BUILD_DIR)
        try:
            objs = [os.path.join(objdir, f"{i}.o")
                    for i in range(len(sources))]
            with ThreadPoolExecutor(max(1, len(sources))) as ex:
                futs = [ex.submit(_run, [nvcc, *cflags, "-c", s, "-o", o])
                        for s, o in zip(sources, objs)]
                report = "".join(f.result() for f in futs)
            _run([nvcc, *NVCCFLAGS, *objs, "-o", out])
            with open(PTXAS_REPORT, "w") as f:
                f.write(report)
        finally:
            shutil.rmtree(objdir, ignore_errors=True)

    return _build(KERNELS_NAME, sources + headers, cflags, make)


def lib() -> ctypes.CDLL:
    """The loaded native core (building it if needed)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        L = ctypes.CDLL(build_core())
        _declare(L)
        _lib = L
        return L


FIBER_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

# HTTP request dispatcher: (token, verb, path, query, headers, headers_len,
# body, body_len, user) — headers is "lower-key: value\n" lines
HTTP_FN = ctypes.CFUNCTYPE(
    None, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.c_void_p)

# Progressive body chunk callback of the HTTP client (user, data, len)
HTTP_CHUNK_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t)


def _declare(L: ctypes.CDLL) -> None:
    c = ctypes
    L.trpc_init.argtypes = [c.c_int]
    L.trpc_init.restype = c.c_int
    L.trpc_workers.restype = c.c_int
    L.trpc_runtime_stats.argtypes = [c.POINTER(c.c_uint64)]
    L.trpc_runtime_stats.restype = None

    L.trpc_fiber_start.argtypes = [c.POINTER(c.c_uint64), FIBER_FN, c.c_void_p]
    L.trpc_fiber_start.restype = c.c_int
    L.trpc_fiber_join.argtypes = [c.c_uint64]
    L.trpc_fiber_join.restype = c.c_int
    L.trpc_fiber_start_bound.argtypes = [c.c_int, c.POINTER(c.c_uint64),
                                         FIBER_FN, c.c_void_p]
    L.trpc_fiber_start_bound.restype = c.c_int
    L.trpc_fiber_jump_group.argtypes = [c.c_int]
    L.trpc_fiber_jump_group.restype = c.c_int
    L.trpc_fiber_worker_index.argtypes = []
    L.trpc_fiber_worker_index.restype = c.c_int
    L.trpc_fiber_register_worker_hook.argtypes = [c.c_void_p, c.c_void_p]
    L.trpc_fiber_register_worker_hook.restype = c.c_int
    L.trpc_fiber_key_create.argtypes = [c.POINTER(c.c_uint64), c.c_void_p]
    L.trpc_fiber_key_create.restype = c.c_int
    L.trpc_fiber_key_delete.argtypes = [c.c_uint64]
    L.trpc_fiber_key_delete.restype = c.c_int
    L.trpc_fiber_setspecific.argtypes = [c.c_uint64, c.c_void_p]
    L.trpc_fiber_setspecific.restype = c.c_int
    L.trpc_fiber_getspecific.argtypes = [c.c_uint64]
    L.trpc_fiber_getspecific.restype = c.c_void_p
    L.trpc_fiber_yield.restype = None
    L.trpc_fiber_usleep.argtypes = [c.c_int64]
    L.trpc_fiber_usleep.restype = None
    L.trpc_in_fiber.restype = c.c_int

    L.trpc_butex_create.restype = c.c_void_p
    L.trpc_butex_destroy.argtypes = [c.c_void_p]
    L.trpc_butex_destroy.restype = None
    L.trpc_butex_load.argtypes = [c.c_void_p]
    L.trpc_butex_load.restype = c.c_int32
    L.trpc_butex_store.argtypes = [c.c_void_p, c.c_int32]
    L.trpc_butex_store.restype = None
    L.trpc_butex_add.argtypes = [c.c_void_p, c.c_int32]
    L.trpc_butex_add.restype = c.c_int32
    L.trpc_butex_wait.argtypes = [c.c_void_p, c.c_int32, c.c_int64]
    L.trpc_butex_wait.restype = c.c_int
    L.trpc_butex_wake.argtypes = [c.c_void_p]
    L.trpc_butex_wake.restype = c.c_int
    L.trpc_butex_wake_all.argtypes = [c.c_void_p]
    L.trpc_butex_wake_all.restype = c.c_int

    # server
    L.trpc_server_create.restype = c.c_void_p
    L.trpc_server_add_echo.argtypes = [c.c_void_p]
    L.trpc_server_add_echo.restype = c.c_int
    L.trpc_server_add_service.argtypes = [c.c_void_p, c.c_char_p,
                                          c.c_void_p, c.c_void_p]
    L.trpc_server_add_service.restype = c.c_int
    L.trpc_server_start.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    L.trpc_server_start.restype = c.c_int
    L.trpc_server_port.argtypes = [c.c_void_p]
    L.trpc_server_port.restype = c.c_int
    L.trpc_server_stop.argtypes = [c.c_void_p]
    L.trpc_server_stop.restype = c.c_int
    L.trpc_server_destroy.argtypes = [c.c_void_p]
    L.trpc_server_destroy.restype = None
    L.trpc_server_requests.argtypes = [c.c_void_p]
    L.trpc_server_requests.restype = c.c_uint64
    L.trpc_respond.argtypes = [c.c_uint64, c.c_int32, c.c_char_p,
                               c.c_char_p, c.c_size_t, c.c_char_p,
                               c.c_size_t]
    L.trpc_respond.restype = c.c_int
    L.trpc_respond_compressed.argtypes = [c.c_uint64, c.c_int32, c.c_char_p,
                                          c.c_char_p, c.c_size_t, c.c_char_p,
                                          c.c_size_t, c.c_int]
    L.trpc_respond_compressed.restype = c.c_int
    L.trpc_token_compress.argtypes = [c.c_uint64]
    L.trpc_token_compress.restype = c.c_int
    # pluggable-Authenticator surface (rpc/auth.py)
    L.trpc_token_auth.argtypes = [c.c_uint64, c.c_char_p, c.c_size_t]
    L.trpc_token_auth.restype = c.c_size_t
    L.trpc_token_peer.argtypes = [c.c_uint64, c.c_char_p, c.c_size_t]
    L.trpc_token_peer.restype = c.c_size_t

    # HTTP on the shared port
    L.trpc_server_set_http_handler.argtypes = [c.c_void_p, c.c_void_p,
                                               c.c_void_p]
    L.trpc_server_set_http_handler.restype = None
    L.trpc_http_respond.argtypes = [c.c_uint64, c.c_int, c.c_char_p,
                                    c.c_char_p, c.c_size_t]
    L.trpc_http_respond.restype = c.c_int
    L.trpc_http_respond_trailers.argtypes = [c.c_uint64, c.c_int,
                                             c.c_char_p, c.c_char_p,
                                             c.c_size_t, c.c_char_p]
    L.trpc_http_respond_trailers.restype = c.c_int

    # redis on the shared port
    L.trpc_server_set_redis_handler.argtypes = [c.c_void_p, c.c_void_p,
                                                c.c_void_p]
    L.trpc_server_set_redis_handler.restype = None
    L.trpc_redis_respond.argtypes = [c.c_uint64, c.c_char_p, c.c_size_t]
    L.trpc_redis_respond.restype = c.c_int

    # framed thrift on the shared port
    L.trpc_server_set_thrift_handler.argtypes = [c.c_void_p, c.c_void_p,
                                                 c.c_void_p]
    L.trpc_server_set_thrift_handler.restype = None
    L.trpc_thrift_respond.argtypes = [c.c_uint64, c.c_char_p, c.c_size_t]
    L.trpc_thrift_respond.restype = c.c_int

    # user-registered protocols on the shared port
    L.trpc_server_register_protocol.argtypes = [
        c.c_void_p, c.c_char_p, c.c_char_p, c.c_size_t, c.c_void_p,
        c.c_void_p, c.c_void_p]
    L.trpc_server_register_protocol.restype = c.c_int
    L.trpc_proto_respond.argtypes = [c.c_uint64, c.c_char_p, c.c_size_t]
    L.trpc_proto_respond.restype = c.c_int

    # HTTP/2 client
    L.trpc_h2_client_create.argtypes = [c.c_char_p, c.c_int, c.c_int64,
                                        c.POINTER(c.c_int)]
    L.trpc_h2_client_create.restype = c.c_void_p
    L.trpc_h2_client_create_tls.argtypes = [c.c_char_p, c.c_int, c.c_int64,
                                            c.c_int, c.c_char_p,
                                            c.POINTER(c.c_int)]
    L.trpc_h2_client_create_tls.restype = c.c_void_p
    L.trpc_h2_client_call.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p,
                                      c.c_char_p, c.c_char_p, c.c_size_t,
                                      c.c_int64, c.POINTER(c.c_void_p)]
    L.trpc_h2_client_call.restype = c.c_int
    L.trpc_h2_result_status.argtypes = [c.c_void_p]
    L.trpc_h2_result_status.restype = c.c_int
    for f in ("headers", "body", "trailers"):
        fn = getattr(L, f"trpc_h2_result_{f}")
        fn.argtypes = [c.c_void_p, c.POINTER(c.POINTER(c.c_uint8))]
        fn.restype = c.c_size_t
    L.trpc_h2_result_destroy.argtypes = [c.c_void_p]
    L.trpc_h2_result_destroy.restype = None
    L.trpc_h2_client_destroy.argtypes = [c.c_void_p]
    L.trpc_h2_client_destroy.restype = None

    # progressive (chunked) HTTP responses
    L.trpc_http_respond_progressive.argtypes = [c.c_uint64, c.c_int,
                                                c.c_char_p]
    L.trpc_http_respond_progressive.restype = c.c_uint64
    L.trpc_pa_write.argtypes = [c.c_uint64, c.c_char_p, c.c_size_t]
    L.trpc_pa_write.restype = c.c_int
    L.trpc_pa_close.argtypes = [c.c_uint64]
    L.trpc_pa_close.restype = c.c_int
    L.trpc_pa_close_trailers.argtypes = [c.c_uint64, c.c_char_p]
    L.trpc_pa_close_trailers.restype = c.c_int

    # auth
    L.trpc_server_set_auth.argtypes = [c.c_void_p, c.c_char_p, c.c_size_t]
    L.trpc_server_set_auth.restype = None
    L.trpc_channel_set_auth.argtypes = [c.c_void_p, c.c_char_p, c.c_size_t]
    L.trpc_channel_set_auth.restype = None
    L.trpc_channel_set_connection_type.argtypes = [c.c_void_p, c.c_int]
    L.trpc_channel_set_connection_type.restype = None

    # introspection
    L.trpc_server_conn_stats.argtypes = [c.c_void_p, c.c_char_p, c.c_size_t]
    L.trpc_server_conn_stats.restype = c.c_size_t
    L.trpc_socket_dump.argtypes = [c.c_char_p, c.c_size_t]
    L.trpc_socket_dump.restype = c.c_size_t
    L.trpc_ids_dump.argtypes = [c.c_char_p, c.c_size_t]
    L.trpc_ids_dump.restype = c.c_size_t

    # io_uring transport
    L.trpc_set_io_uring.argtypes = [c.c_int]
    L.trpc_set_io_uring.restype = None
    L.trpc_io_uring_available.argtypes = []
    L.trpc_io_uring_available.restype = c.c_int
    L.trpc_set_sendzc.argtypes = [c.c_int]
    L.trpc_set_sendzc.restype = None
    L.trpc_set_sendzc_threshold.argtypes = [c.c_uint64]
    L.trpc_set_sendzc_threshold.restype = None
    L.trpc_sendzc_available.argtypes = []
    L.trpc_sendzc_available.restype = c.c_int
    L.trpc_sendzc_active.argtypes = []
    L.trpc_sendzc_active.restype = c.c_int

    # crc32c
    L.trpc_crc32c_extend.argtypes = [c.c_uint32, c.c_char_p, c.c_size_t]
    L.trpc_crc32c_extend.restype = c.c_uint32
    L.trpc_crc32c_hardware.argtypes = []
    L.trpc_crc32c_hardware.restype = c.c_int

    # snappy codec
    L.trpc_snappy_max_compressed_length.argtypes = [c.c_size_t]
    L.trpc_snappy_max_compressed_length.restype = c.c_size_t
    L.trpc_snappy_compress.argtypes = [c.c_char_p, c.c_size_t, c.c_char_p]
    L.trpc_snappy_compress.restype = c.c_size_t
    L.trpc_snappy_uncompressed_length.argtypes = [c.c_char_p, c.c_size_t]
    L.trpc_snappy_uncompressed_length.restype = c.c_size_t
    L.trpc_snappy_decompress.argtypes = [c.c_char_p, c.c_size_t, c.c_char_p,
                                         c.c_size_t]
    L.trpc_snappy_decompress.restype = c.c_size_t

    # payload-codec rail (native/src/codec.h)
    L.trpc_set_payload_codec.argtypes = [c.c_int]
    L.trpc_set_payload_codec.restype = None
    L.trpc_payload_codec.restype = c.c_int
    L.trpc_set_codec_min_bytes.argtypes = [c.c_int64]
    L.trpc_set_codec_min_bytes.restype = None
    L.trpc_codec_id.argtypes = [c.c_char_p]
    L.trpc_codec_id.restype = c.c_int
    L.trpc_codec_name.argtypes = [c.c_int]
    L.trpc_codec_name.restype = c.c_char_p
    L.trpc_codec_encode.argtypes = [c.c_int, c.c_char_p, c.c_size_t,
                                    c.POINTER(c.POINTER(c.c_uint8)),
                                    c.POINTER(c.c_int)]
    L.trpc_codec_encode.restype = c.c_int64
    L.trpc_codec_decode.argtypes = [c.c_int, c.c_char_p, c.c_size_t,
                                    c.POINTER(c.POINTER(c.c_uint8))]
    L.trpc_codec_decode.restype = c.c_int64
    L.trpc_codec_buf_free.argtypes = [c.POINTER(c.c_uint8)]
    L.trpc_codec_buf_free.restype = None
    L.trpc_codec_roundtrip_chained.argtypes = [c.c_int, c.c_char_p,
                                               c.c_size_t, c.c_size_t,
                                               c.POINTER(c.c_double)]
    L.trpc_codec_roundtrip_chained.restype = c.c_int

    L.trpc_set_usercode_workers.argtypes = [c.c_int]
    L.trpc_set_usercode_workers.restype = None
    L.trpc_set_event_dispatcher_num.argtypes = [c.c_int]
    L.trpc_set_event_dispatcher_num.restype = None

    # runtime sharding (native/src/shard.h): boot-frozen shard count +
    # SO_REUSEPORT listener gate + cross-shard hop counter
    L.trpc_set_shards.argtypes = [c.c_int]
    L.trpc_set_shards.restype = c.c_int
    L.trpc_shard_count.restype = c.c_int
    L.trpc_set_reuseport.argtypes = [c.c_int]
    L.trpc_set_reuseport.restype = c.c_int
    L.trpc_reuseport_enabled.restype = c.c_int
    L.trpc_current_shard.restype = c.c_int
    L.trpc_cross_shard_hops.restype = c.c_uint64

    # channel
    L.trpc_channel_create.argtypes = [c.c_char_p, c.c_int]
    L.trpc_channel_create.restype = c.c_void_p
    L.trpc_channel_destroy.argtypes = [c.c_void_p]
    L.trpc_channel_destroy.restype = None
    L.trpc_channel_set_connect_timeout.argtypes = [c.c_void_p, c.c_int64]
    L.trpc_channel_set_connect_timeout.restype = None
    L.trpc_channel_call.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p,
                                    c.c_size_t, c.c_char_p, c.c_size_t,
                                    c.c_int64, c.POINTER(c.c_void_p)]
    L.trpc_channel_call.restype = c.c_int
    L.trpc_channel_call_compressed.argtypes = [
        c.c_void_p, c.c_char_p, c.c_char_p, c.c_size_t, c.c_char_p,
        c.c_size_t, c.c_int64, c.c_int, c.POINTER(c.c_void_p)]
    L.trpc_channel_call_compressed.restype = c.c_int
    # replay rail (native/src/dump.h): wire-form bytes from a captured
    # sample, codec tags 16/17 stamped verbatim, encode skipped
    L.trpc_channel_call_raw.argtypes = [
        c.c_void_p, c.c_char_p, c.c_char_p, c.c_size_t, c.c_char_p,
        c.c_size_t, c.c_int64, c.c_int, c.c_int, c.c_int,
        c.POINTER(c.c_void_p)]
    L.trpc_channel_call_raw.restype = c.c_int
    L.trpc_result_compress.argtypes = [c.c_void_p]
    L.trpc_result_compress.restype = c.c_int
    L.trpc_result_error_code.argtypes = [c.c_void_p]
    L.trpc_result_error_code.restype = c.c_int32
    L.trpc_result_error_text.argtypes = [c.c_void_p]
    L.trpc_result_error_text.restype = c.c_char_p
    L.trpc_result_data.argtypes = [c.c_void_p,
                                   c.POINTER(c.POINTER(c.c_uint8))]
    L.trpc_result_data.restype = c.c_size_t
    L.trpc_result_attachment.argtypes = [c.c_void_p,
                                         c.POINTER(c.POINTER(c.c_uint8))]
    L.trpc_result_attachment.restype = c.c_size_t
    L.trpc_result_destroy.argtypes = [c.c_void_p]
    L.trpc_result_destroy.restype = None

    # streaming RPC
    L.trpc_channel_call_stream.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p,
                                           c.c_size_t, c.c_char_p, c.c_size_t,
                                           c.c_int64, c.c_uint64,
                                           c.POINTER(c.c_void_p)]
    L.trpc_channel_call_stream.restype = c.c_int
    L.trpc_stream_create.argtypes = [c.c_uint64]
    L.trpc_stream_create.restype = c.c_uint64
    L.trpc_token_stream_id.argtypes = [c.c_uint64]
    L.trpc_token_stream_id.restype = c.c_uint64
    L.trpc_stream_accept.argtypes = [c.c_uint64, c.c_uint64]
    L.trpc_stream_accept.restype = c.c_uint64
    L.trpc_stream_write.argtypes = [c.c_uint64, c.c_char_p, c.c_size_t,
                                    c.c_int64]
    L.trpc_stream_write.restype = c.c_int
    L.trpc_stream_read.argtypes = [c.c_uint64, c.c_int64,
                                   c.POINTER(c.POINTER(c.c_uint8))]
    L.trpc_stream_read.restype = c.c_int64
    L.trpc_stream_buf_free.argtypes = [c.POINTER(c.c_uint8)]
    L.trpc_stream_buf_free.restype = None
    L.trpc_stream_close.argtypes = [c.c_uint64]
    L.trpc_stream_close.restype = c.c_int
    L.trpc_stream_rst.argtypes = [c.c_uint64, c.c_int32]
    L.trpc_stream_rst.restype = c.c_int
    L.trpc_stream_rst_code.argtypes = [c.c_uint64]
    L.trpc_stream_rst_code.restype = c.c_int32
    L.trpc_stream_destroy.argtypes = [c.c_uint64]
    L.trpc_stream_destroy.restype = None
    L.trpc_stream_remote_closed.argtypes = [c.c_uint64]
    L.trpc_stream_remote_closed.restype = c.c_int
    L.trpc_stream_failed.argtypes = [c.c_uint64]
    L.trpc_stream_failed.restype = c.c_int
    L.trpc_stream_pending_bytes.argtypes = [c.c_uint64]
    L.trpc_stream_pending_bytes.restype = c.c_int64

    L.trpc_set_usercode_max_inflight.argtypes = [c.c_int64]
    L.trpc_set_usercode_max_inflight.restype = None

    # overload-control plane (native/src/overload.h): reloadable master
    # switch + gradient clamps, folded per-family reads for /status, the
    # per-method max_concurrency table, and the deterministic test hooks
    L.trpc_set_overload.argtypes = [c.c_int]
    L.trpc_set_overload.restype = None
    L.trpc_overload_active.argtypes = []
    L.trpc_overload_active.restype = c.c_int
    L.trpc_set_overload_min_concurrency.argtypes = [c.c_int]
    L.trpc_set_overload_min_concurrency.restype = None
    L.trpc_set_overload_max_concurrency.argtypes = [c.c_int]
    L.trpc_set_overload_max_concurrency.restype = None
    L.trpc_set_overload_window_ms.argtypes = [c.c_int]
    L.trpc_set_overload_window_ms.restype = None
    L.trpc_overload_limit.argtypes = [c.c_int]
    L.trpc_overload_limit.restype = c.c_int64
    L.trpc_overload_inflight.argtypes = [c.c_int]
    L.trpc_overload_inflight.restype = c.c_int64
    L.trpc_overload_rejects.argtypes = [c.c_int]
    L.trpc_overload_rejects.restype = c.c_uint64
    L.trpc_overload_admits.argtypes = [c.c_int]
    L.trpc_overload_admits.restype = c.c_uint64
    L.trpc_server_set_method_max_concurrency.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int64]
    L.trpc_server_set_method_max_concurrency.restype = c.c_int
    L.trpc_overload_test_feed.argtypes = [c.c_int, c.c_int, c.c_int64,
                                          c.c_int, c.c_int64]
    L.trpc_overload_test_feed.restype = None
    L.trpc_overload_test_reset.argtypes = [c.c_int, c.c_int]
    L.trpc_overload_test_reset.restype = None

    # client egress fast path: request corking + serialize-once fan-out
    L.trpc_set_client_cork.argtypes = [c.c_int]
    L.trpc_set_client_cork.restype = None
    L.trpc_client_cork_active.argtypes = []
    L.trpc_client_cork_active.restype = c.c_int
    L.trpc_fanout_call.argtypes = [
        c.POINTER(c.c_void_p), c.c_int, c.c_char_p, c.c_char_p, c.c_size_t,
        c.c_char_p, c.c_size_t, c.c_int64, c.POINTER(c.c_void_p)]
    L.trpc_fanout_call.restype = c.c_int

    # million-connection ingress: accept-storm pacing + memory diet
    L.trpc_set_accept_rate.argtypes = [c.c_int]
    L.trpc_set_accept_rate.restype = None
    L.trpc_set_accept_burst.argtypes = [c.c_int]
    L.trpc_set_accept_burst.restype = None
    L.trpc_set_accept_max_pending.argtypes = [c.c_int]
    L.trpc_set_accept_max_pending.restype = None
    L.trpc_set_idle_kick_ms.argtypes = [c.c_int]
    L.trpc_set_idle_kick_ms.restype = None

    # ingress fast path: run-to-completion dispatch + response corking
    L.trpc_set_inline_dispatch.argtypes = [c.c_int]
    L.trpc_set_inline_dispatch.restype = None
    L.trpc_inline_dispatch_active.argtypes = []
    L.trpc_inline_dispatch_active.restype = c.c_int
    L.trpc_set_inline_budget_requests.argtypes = [c.c_int]
    L.trpc_set_inline_budget_requests.restype = None
    L.trpc_set_inline_budget_us.argtypes = [c.c_int64]
    L.trpc_set_inline_budget_us.restype = None
    L.trpc_token_arm_ns.argtypes = [c.c_uint64]
    L.trpc_token_arm_ns.restype = c.c_int64

    # deadline-budget propagation
    L.trpc_set_deadline_propagate.argtypes = [c.c_int]
    L.trpc_set_deadline_propagate.restype = None
    L.trpc_deadline_propagate_active.argtypes = []
    L.trpc_deadline_propagate_active.restype = c.c_int
    L.trpc_set_deadline_reserve_us.argtypes = [c.c_int64]
    L.trpc_set_deadline_reserve_us.restype = None
    L.trpc_deadline_reserve_us.argtypes = []
    L.trpc_deadline_reserve_us.restype = c.c_int64
    L.trpc_token_deadline_left_us.argtypes = [c.c_uint64,
                                              c.POINTER(c.c_int64)]
    L.trpc_token_deadline_left_us.restype = c.c_int
    L.trpc_server_enable_redis_cache.argtypes = [c.c_void_p]
    L.trpc_server_enable_redis_cache.restype = c.c_int
    L.trpc_server_http_cache_put.argtypes = [c.c_void_p, c.c_char_p,
                                             c.c_int, c.c_char_p,
                                             c.c_char_p, c.c_size_t]
    L.trpc_server_http_cache_put.restype = c.c_int

    # TLS (tls.h)
    L.trpc_tls_available.restype = c.c_int
    L.trpc_tls_error.restype = c.c_char_p
    L.trpc_server_set_tls.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p,
                                      c.c_char_p]
    L.trpc_server_set_tls.restype = c.c_int
    L.trpc_channel_set_tls.argtypes = [c.c_void_p, c.c_int, c.c_char_p,
                                       c.c_char_p, c.c_char_p]
    L.trpc_channel_set_tls.restype = c.c_int

    # fiber sync primitives (fiber_sync.h)
    L.trpc_mutex_create.restype = c.c_void_p
    L.trpc_mutex_destroy.argtypes = [c.c_void_p]
    L.trpc_mutex_destroy.restype = None
    L.trpc_mutex_lock.argtypes = [c.c_void_p]
    L.trpc_mutex_lock.restype = None
    L.trpc_mutex_trylock.argtypes = [c.c_void_p]
    L.trpc_mutex_trylock.restype = c.c_int
    L.trpc_mutex_unlock.argtypes = [c.c_void_p]
    L.trpc_mutex_unlock.restype = None
    L.trpc_cond_create.restype = c.c_void_p
    L.trpc_cond_destroy.argtypes = [c.c_void_p]
    L.trpc_cond_destroy.restype = None
    L.trpc_cond_wait.argtypes = [c.c_void_p, c.c_void_p, c.c_int64]
    L.trpc_cond_wait.restype = c.c_int
    L.trpc_cond_notify_one.argtypes = [c.c_void_p]
    L.trpc_cond_notify_one.restype = None
    L.trpc_cond_notify_all.argtypes = [c.c_void_p]
    L.trpc_cond_notify_all.restype = None
    L.trpc_countdown_create.argtypes = [c.c_int]
    L.trpc_countdown_create.restype = c.c_void_p
    L.trpc_countdown_destroy.argtypes = [c.c_void_p]
    L.trpc_countdown_destroy.restype = None
    L.trpc_countdown_signal.argtypes = [c.c_void_p, c.c_int]
    L.trpc_countdown_signal.restype = None
    L.trpc_countdown_add.argtypes = [c.c_void_p, c.c_int]
    L.trpc_countdown_add.restype = None
    L.trpc_countdown_wait.argtypes = [c.c_void_p, c.c_int64]
    L.trpc_countdown_wait.restype = c.c_int
    L.trpc_rwlock_create.restype = c.c_void_p
    L.trpc_rwlock_destroy.argtypes = [c.c_void_p]
    L.trpc_rwlock_destroy.restype = None
    L.trpc_rwlock_rdlock.argtypes = [c.c_void_p]
    L.trpc_rwlock_rdlock.restype = None
    L.trpc_rwlock_rdunlock.argtypes = [c.c_void_p]
    L.trpc_rwlock_rdunlock.restype = None
    L.trpc_rwlock_wrlock.argtypes = [c.c_void_p]
    L.trpc_rwlock_wrlock.restype = None
    L.trpc_rwlock_wrunlock.argtypes = [c.c_void_p]
    L.trpc_rwlock_wrunlock.restype = None

    # native metrics seam + profiler (metrics.h, profiler.h)
    L.trpc_native_metrics_dump.argtypes = [c.c_char_p, c.c_size_t]
    L.trpc_native_metrics_dump.restype = c.c_size_t
    # hot-path telemetry plane (metrics.h): per-shard latency
    # histograms, native rpcz span rings, cross-hop trace context
    L.trpc_set_telemetry.argtypes = [c.c_int]
    L.trpc_set_telemetry.restype = None
    L.trpc_telemetry_active.argtypes = []
    L.trpc_telemetry_active.restype = c.c_int
    L.trpc_telemetry_percentile_us.argtypes = [c.c_int, c.c_double]
    L.trpc_telemetry_percentile_us.restype = c.c_int64
    L.trpc_telemetry_count.argtypes = [c.c_int]
    L.trpc_telemetry_count.restype = c.c_uint64
    L.trpc_telemetry_inflight.argtypes = [c.c_int]
    L.trpc_telemetry_inflight.restype = c.c_int64
    L.trpc_telemetry_family_name.argtypes = [c.c_int]
    L.trpc_telemetry_family_name.restype = c.c_char_p
    L.trpc_telemetry_families.argtypes = []
    L.trpc_telemetry_families.restype = c.c_int
    L.trpc_telemetry_prom_dump.argtypes = [c.c_char_p, c.c_size_t]
    L.trpc_telemetry_prom_dump.restype = c.c_size_t
    L.trpc_set_rpcz.argtypes = [c.c_int]
    L.trpc_set_rpcz.restype = None
    L.trpc_rpcz_active.argtypes = []
    L.trpc_rpcz_active.restype = c.c_int
    L.trpc_set_rpcz_budget.argtypes = [c.c_int64]
    L.trpc_set_rpcz_budget.restype = None
    L.trpc_rpcz_drain.argtypes = [c.c_char_p, c.c_size_t]
    L.trpc_rpcz_drain.restype = c.c_size_t
    # native flight recorder (native/src/dump.h): wire-form traffic
    # capture on the fast paths + length-prefixed v2 sample drain
    L.trpc_set_dump.argtypes = [c.c_int]
    L.trpc_set_dump.restype = None
    L.trpc_dump_active.argtypes = []
    L.trpc_dump_active.restype = c.c_int
    L.trpc_set_dump_budget.argtypes = [c.c_int64]
    L.trpc_set_dump_budget.restype = None
    L.trpc_dump_drain.argtypes = [c.c_char_p, c.c_size_t]
    L.trpc_dump_drain.restype = c.c_size_t
    L.trpc_trace_set_current.argtypes = [c.c_uint64, c.c_uint64, c.c_int]
    L.trpc_trace_set_current.restype = None
    L.trpc_trace_current.argtypes = [c.POINTER(c.c_uint64),
                                     c.POINTER(c.c_uint64)]
    L.trpc_trace_current.restype = c.c_int
    L.trpc_trace_annotate.argtypes = [c.c_char_p]
    L.trpc_trace_annotate.restype = None
    L.trpc_token_trace.argtypes = [c.c_uint64, c.POINTER(c.c_uint64),
                                   c.POINTER(c.c_uint64)]
    L.trpc_token_trace.restype = c.c_int
    # schedule perturbation / replay (native/src/sched_perturb.h)
    L.trpc_sched_set_seed.argtypes = [c.c_uint64]
    L.trpc_sched_set_seed.restype = None
    L.trpc_sched_seed.argtypes = []
    L.trpc_sched_seed.restype = c.c_uint64
    L.trpc_sched_trace_hash.argtypes = []
    L.trpc_sched_trace_hash.restype = c.c_uint64
    L.trpc_sched_trace_dump.argtypes = [c.c_char_p, c.c_size_t]
    L.trpc_sched_trace_dump.restype = c.c_size_t
    L.trpc_profiler_start.argtypes = [c.c_int]
    L.trpc_profiler_start.restype = c.c_int
    # void* out-pointer (not c_char_p: ctypes would convert to bytes and
    # lose the pointer we must pass back to trpc_profiler_free)
    L.trpc_profiler_stop.argtypes = [c.POINTER(c.c_void_p)]
    L.trpc_profiler_stop.restype = c.c_size_t
    L.trpc_profiler_free.argtypes = [c.c_void_p]
    L.trpc_profiler_free.restype = None
    L.trpc_profiler_running.restype = c.c_int
    L.trpc_symbolize.argtypes = [c.c_void_p, c.c_char_p, c.c_size_t]
    L.trpc_symbolize.restype = c.c_size_t

    # device data plane (native/src/tpu.h: PJRT plugin dlopen'd at runtime)
    L.trpc_tpu_plane_init.argtypes = [c.c_char_p]
    L.trpc_tpu_plane_init.restype = c.c_int
    L.trpc_tpu_plane_available.restype = c.c_int
    L.trpc_tpu_plane_error.restype = c.c_char_p
    L.trpc_tpu_plane_platform.restype = c.c_char_p
    L.trpc_tpu_device_count.restype = c.c_int
    L.trpc_tpu_h2d.argtypes = [c.c_char_p, c.c_size_t, c.c_int]
    L.trpc_tpu_h2d.restype = c.c_uint64
    L.trpc_tpu_buf_wait.argtypes = [c.c_uint64, c.c_int64]
    L.trpc_tpu_buf_wait.restype = c.c_int
    L.trpc_tpu_buf_size.argtypes = [c.c_uint64]
    L.trpc_tpu_buf_size.restype = c.c_int64
    L.trpc_tpu_d2h.argtypes = [c.c_uint64,
                               c.POINTER(c.POINTER(c.c_uint8))]
    L.trpc_tpu_d2h.restype = c.c_int64
    L.trpc_tpu_buf_release.argtypes = [c.POINTER(c.c_uint8)]
    L.trpc_tpu_buf_release.restype = None
    L.trpc_tpu_buf_free.argtypes = [c.c_uint64]
    L.trpc_tpu_buf_free.restype = None
    L.trpc_tpu_plane_stats.argtypes = [c.POINTER(c.c_uint64)]
    L.trpc_tpu_plane_stats.restype = None
    L.trpc_tpu_d2d.argtypes = [c.c_uint64, c.c_int]
    L.trpc_tpu_d2d.restype = c.c_uint64
    L.trpc_tpu_plane_uid.restype = c.c_uint64
    # the CUDA plane's own entries (csrc/cuda_plane.cc)
    L.trpc_cuda_h2d_staged.argtypes = [c.c_char_p, c.c_size_t, c.c_int]
    L.trpc_cuda_h2d_staged.restype = c.c_uint64
    L.trpc_cuda_pool_stats.argtypes = [c.POINTER(c.c_uint64)]
    L.trpc_cuda_pool_stats.restype = None
    L.trpc_cuda_slot_stats.argtypes = [c.POINTER(c.c_uint64)]
    L.trpc_cuda_slot_stats.restype = None
    L.trpc_cuda_peer_access.argtypes = [c.POINTER(c.c_uint8), c.c_int]
    L.trpc_cuda_peer_access.restype = c.c_int
    L.trpc_cuda_fill.argtypes = [c.c_uint64, c.c_size_t, c.c_int]
    L.trpc_cuda_fill.restype = c.c_uint64
    L.trpc_cuda_buf_addr.argtypes = [c.c_uint64, c.POINTER(c.c_uint64),
                                     c.POINTER(c.c_uint64)]
    L.trpc_cuda_buf_addr.restype = c.c_int
    L.trpc_cuda_buffer_memory.argtypes = [c.c_int, c.POINTER(c.c_int),
                                          c.POINTER(c.c_int)]
    L.trpc_cuda_buffer_memory.restype = c.c_int
    L.trpc_stream_write_device.argtypes = [c.c_uint64, c.c_uint64,
                                           c.c_int64]
    L.trpc_stream_write_device.restype = c.c_int
    L.trpc_stream_read_device.argtypes = [
        c.c_uint64, c.c_int, c.c_int64, c.POINTER(c.c_uint64),
        c.POINTER(c.c_uint64)]
    L.trpc_stream_read_device.restype = c.c_int
    L.trpc_server_add_hbm_echo.argtypes = [c.c_void_p, c.c_char_p]
    L.trpc_server_add_hbm_echo.restype = c.c_int
    L.trpc_channel_request_device_plane.argtypes = [c.c_void_p, c.c_int]
    L.trpc_channel_request_device_plane.restype = None
    L.trpc_channel_transport_state.argtypes = [c.c_void_p]
    L.trpc_channel_transport_state.restype = c.c_int

    # heap + contention profiler (heap_profiler.h)
    L.trpc_heap_profiler_enable.argtypes = [c.c_int64]
    L.trpc_heap_profiler_enable.restype = None
    L.trpc_heap_profiler_enabled.restype = c.c_int
    L.trpc_heap_dump.argtypes = [c.c_int, c.POINTER(c.c_void_p)]
    L.trpc_heap_dump.restype = c.c_size_t
    L.trpc_contention_dump.argtypes = [c.POINTER(c.c_void_p)]
    L.trpc_contention_dump.restype = c.c_size_t
    L.trpc_contention_profiler_set.argtypes = [c.c_int]
    L.trpc_contention_profiler_set.restype = None

    L.trpc_server_add_tls_sni.argtypes = [c.c_void_p, c.c_char_p,
                                          c.c_char_p, c.c_char_p]
    L.trpc_server_add_tls_sni.restype = c.c_int

    # streaming h2/gRPC client
    L.trpc_h2_stream_open.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p,
                                      c.c_char_p, c.POINTER(c.c_int)]
    L.trpc_h2_stream_open.restype = c.c_void_p
    L.trpc_h2_stream_write.argtypes = [c.c_void_p, c.c_char_p, c.c_size_t,
                                       c.c_int64]
    L.trpc_h2_stream_write.restype = c.c_int
    L.trpc_h2_stream_close_send.argtypes = [c.c_void_p]
    L.trpc_h2_stream_close_send.restype = c.c_int
    L.trpc_h2_stream_read.argtypes = [c.c_void_p, c.c_int64,
                                      c.POINTER(c.POINTER(c.c_uint8))]
    L.trpc_h2_stream_read.restype = c.c_int64
    L.trpc_h2_stream_chunk_free.argtypes = [c.POINTER(c.c_uint8)]
    L.trpc_h2_stream_chunk_free.restype = None
    L.trpc_h2_stream_status.argtypes = [c.c_void_p]
    L.trpc_h2_stream_status.restype = c.c_int
    L.trpc_h2_stream_headers.argtypes = [c.c_void_p,
                                         c.POINTER(c.POINTER(c.c_uint8))]
    L.trpc_h2_stream_headers.restype = c.c_size_t
    L.trpc_h2_stream_trailers.argtypes = [c.c_void_p,
                                          c.POINTER(c.POINTER(c.c_uint8))]
    L.trpc_h2_stream_trailers.restype = c.c_size_t
    L.trpc_h2_stream_destroy.argtypes = [c.c_void_p]
    L.trpc_h2_stream_destroy.restype = None

    # RPC cancellation (≙ Controller::StartCancel / NotifyOnCancel)
    L.trpc_channel_call_cancelable.argtypes = [
        c.c_void_p, c.c_char_p, c.c_char_p, c.c_size_t, c.c_char_p,
        c.c_size_t, c.c_int64, c.c_uint64, c.c_int,
        c.POINTER(c.c_uint64), c.POINTER(c.c_void_p)]
    L.trpc_channel_call_cancelable.restype = c.c_int
    L.trpc_call_cancel.argtypes = [c.c_uint64]
    L.trpc_call_cancel.restype = c.c_int
    L.trpc_call_canceled.argtypes = [c.c_uint64]
    L.trpc_call_canceled.restype = c.c_int
    L.trpc_call_wait_canceled.argtypes = [c.c_uint64, c.c_int64]
    L.trpc_call_wait_canceled.restype = c.c_int

    # HTTP client (the framework's own; rpc/http_client.py)
    L.trpc_channel_set_http.argtypes = [c.c_void_p, c.c_char_p]
    L.trpc_channel_set_http.restype = None
    L.trpc_http_client_call.argtypes = [
        c.c_void_p, c.c_char_p, c.c_char_p, c.c_char_p, c.c_char_p,
        c.c_size_t, c.c_int64, HTTP_CHUNK_CB, c.c_void_p,
        c.POINTER(c.c_void_p)]
    L.trpc_http_client_call.restype = c.c_int
    L.trpc_http_result_status.argtypes = [c.c_void_p]
    L.trpc_http_result_status.restype = c.c_int
    L.trpc_http_result_error_text.argtypes = [c.c_void_p]
    L.trpc_http_result_error_text.restype = c.c_char_p
    L.trpc_http_result_headers.argtypes = [
        c.c_void_p, c.POINTER(c.POINTER(c.c_uint8))]
    L.trpc_http_result_headers.restype = c.c_size_t
    L.trpc_http_result_body.argtypes = [
        c.c_void_p, c.POINTER(c.POINTER(c.c_uint8))]
    L.trpc_http_result_body.restype = c.c_size_t
    L.trpc_http_result_destroy.argtypes = [c.c_void_p]
    L.trpc_http_result_destroy.restype = None

    # bench
    L.trpc_run_echo_bench.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_int,
                                      c.c_int, c.c_int, c.c_double,
                                      c.POINTER(c.c_double)]
    L.trpc_run_echo_bench.restype = c.c_int
