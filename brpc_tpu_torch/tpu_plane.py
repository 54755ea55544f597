"""Device data plane — the CUDA plane under ``tpu://`` endpoints.

Python face of ``brpc_tpu_torch/csrc/cuda_plane.cc``, which implements
the plane contract of ``native/src/tpu.h`` on the CUDA driver API (the
module keeps the name ``tpu_plane`` so the host modules carried over from
the reference resolve it unchanged):

* ``init()`` dlopens the CUDA driver (``$TRPC_CUDA_DRIVER``, else
  ``libcuda.so.1``), retains each device's primary context — the one
  PyTorch uses — and creates one stream per device.  No PyTorch
  involvement: the native core talks to the driver directly.
* ``h2d()/d2h()`` move bytes host<->device memory through asynchronous
  copies whose completion (a host function on the copy's stream) stores 1
  into a butex and wakes the waiting fibers: a fiber awaiting a device
  transfer costs no thread.
* Device buffers come from a cache per device, and h2d staging blocks
  and d2h landing zones from a page-locked pool, so a transfer in steady
  state allocates, frees and page-locks nothing; with the io_uring
  transport up a landing zone that fits one of the ring's registered
  slots is that slot instead (page-locked once, on its first use), so
  the attachment leaves the host as a fixed-buffer SEND_ZC, as the
  reference's plane does.  :func:`pool_stats` counts the pools' hits and
  misses and the slots taken, and says which device pairs have peer
  access.
* A buffer can also be filled on its device, with no host bytes: one
  copy from a tensor's memory or zeros (:func:`fill`), and a ready
  buffer viewed as a ``torch`` tensor over its own memory
  (:meth:`DeviceBuffer.view`) on the device :func:`torch_device` names:
  ``cuda:<n>`` on a card, ``cpu`` over the fake driver's host memory.
* RPC attachments ride this plane zero-copy: a large attachment lands in
  ONE IOBuf block and that block's memory is the copy source —
  ``stats()["zero_copy_sends"]`` counts the pointer-identity transfers,
  ``gather_copies`` the multi-block sends that needed one gather.
* Channels to ``tpu://`` endpoints run an explicit handshake on the
  connection's first call (meta tag 14) and settle into ``device`` or
  ``fallback_tcp`` — visible via ``Channel.transport_state``, never a
  silent downgrade.  Without a loadable driver the plane is unavailable
  with a reason (:func:`error`) and channels settle ``fallback_tcp``.
"""

from __future__ import annotations

import ctypes
import errno
import threading
from typing import Dict, Optional

from brpc_tpu_torch._native import lib

TRANSPORT_STATES = {0: "tcp", 1: "handshaking", 2: "device",
                    3: "fallback_tcp"}


def init(driver_path: Optional[str] = None) -> bool:
    """Bring up the device plane; returns availability.  Idempotent.
    With no path the native side tries ``$TRPC_CUDA_DRIVER``, then
    ``libcuda.so.1``.  On failure the reason is in :func:`error` and
    callers fall back to TCP explicitly."""
    L = lib()
    L.trpc_tpu_plane_init(driver_path.encode() if driver_path else None)
    return bool(L.trpc_tpu_plane_available())


def available() -> bool:
    return bool(lib().trpc_tpu_plane_available())


def error() -> str:
    return (lib().trpc_tpu_plane_error() or b"").decode()


def platform() -> str:
    return (lib().trpc_tpu_plane_platform() or b"").decode()


def device_count() -> int:
    return lib().trpc_tpu_device_count()


class DeviceBuffer:
    """A byte buffer resident in device memory.  Handle semantics are versioned
    (ABA-safe) like SocketIds; ``free()`` is idempotent.

    Source lifetime is handled natively: :func:`h2d` copies the bytes
    once, into a page-locked staging block that goes back to the pool
    when the transfer is done — Python object lifetimes never gate the
    DMA."""

    __slots__ = ("_id", "_len")

    def __init__(self, buf_id: int, length: int):
        self._id = buf_id
        self._len = length

    def __len__(self) -> int:
        return self._len

    @property
    def handle(self) -> int:
        return self._id

    def wait(self, timeout_s: float = 30.0) -> None:
        """Block (fiber-friendly) until the buffer is resident on the device."""
        rc = lib().trpc_tpu_buf_wait(self._id, int(timeout_s * 1e6))
        if rc == 0:
            return
        if rc == -errno.ETIMEDOUT:
            raise TimeoutError(f"device transfer not ready: rc={rc}")
        raise IOError(f"device transfer failed: rc={rc} ({error()})")

    def to_host(self) -> bytes:
        """Copy the buffer back to host memory (through a page-locked
        landing zone, handed back to the pool once copied out)."""
        L = lib()
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = L.trpc_tpu_d2h(self._id, ctypes.byref(out))
        if n < 0:
            raise IOError(f"d2h failed: rc={n} ({error()})")
        try:
            return ctypes.string_at(out, n)
        finally:
            L.trpc_tpu_buf_release(out)

    def view(self, device: str):
        """The buffer's bytes as a uint8 tensor over its own memory on
        `device` (what :func:`torch_device` says of its plane device), no
        copy.  Waits until the buffer is resident.  The view is valid
        until the buffer is freed; the caller orders its own reads and
        writes against the plane's copies."""
        import torch
        self.wait()
        ptr, n = ctypes.c_uint64(), ctypes.c_uint64()
        rc = lib().trpc_cuda_buf_addr(self._id, ctypes.byref(ptr),
                                      ctypes.byref(n))
        if rc != 0:
            raise IOError(f"device buffer not viewable: rc={rc} ({error()})")
        if device == "cpu":
            mem = (ctypes.c_uint8 * n.value).from_address(ptr.value)
            return torch.frombuffer(mem, dtype=torch.uint8)
        return torch.as_tensor(_CudaRange(ptr.value, n.value), device=device)

    def free(self) -> None:
        lib().trpc_tpu_buf_free(self._id)

    def __enter__(self) -> "DeviceBuffer":
        return self

    def __exit__(self, *exc) -> None:
        self.free()


def h2d(data: bytes, device: int = 0) -> DeviceBuffer:
    """Copy ``data`` into device memory; returns immediately (transfer is async —
    ``wait()`` parks on the completion butex).  The bytes are copied once,
    into a page-locked staging block the copy reads from."""
    if not available():
        raise RuntimeError(f"device plane unavailable: {error()}")
    buf_id = lib().trpc_cuda_h2d_staged(data, len(data), device)
    if buf_id == 0:
        raise IOError(f"h2d failed: {error()}")
    return DeviceBuffer(buf_id, len(data))


_MEMORY_HOST, _MEMORY_DEVICE = 1, 2     # the driver's CUmemorytype


def fill(nbytes: int, device: int = 0, src=None) -> DeviceBuffer:
    """A buffer of `nbytes` on `device` filled on the device itself, on
    the plane's stream: one copy of the first `nbytes` of `src` (a
    contiguous tensor on :func:`torch_device` of `device`, its writes
    complete, kept by the caller until the buffer is ready), or zeros
    without one.  Returns at once; ``wait()`` parks until it is filled."""
    if not available():
        raise RuntimeError(f"device plane unavailable: {error()}")
    ptr = 0
    if src is not None:
        if not src.is_contiguous() or src.nbytes < nbytes:
            raise ValueError(f"fill source must be contiguous and hold "
                             f"{nbytes} bytes")
        ptr = src.data_ptr()
    buf_id = lib().trpc_cuda_fill(ptr, nbytes, device)
    if buf_id == 0:
        raise IOError(f"device fill failed: {error()}")
    return DeviceBuffer(buf_id, nbytes)


def torch_device(device: int) -> Optional[str]:
    """The torch device that views plane device `device`'s buffers
    without a copy: ``"cuda:<n>"`` where the driver says they are device
    memory of its device n (whose primary context PyTorch shares),
    ``"cpu"`` where it says they are host memory (the fake driver's);
    None when the plane is down or the driver says neither."""
    if not available():
        return None
    memtype, ordinal = ctypes.c_int(), ctypes.c_int()
    if lib().trpc_cuda_buffer_memory(device, ctypes.byref(memtype),
                                     ctypes.byref(ordinal)) != 0:
        return None
    return {_MEMORY_DEVICE: f"cuda:{ordinal.value}",
            _MEMORY_HOST: "cpu"}.get(memtype.value)


class _CudaRange:
    """A device byte range as ``__cuda_array_interface__`` (version 3,
    no stream: the caller orders the accesses)."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {
            "shape": (n,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 3}


def stats() -> Dict[str, int]:
    """Plane counters (feeds /vars via the native metrics seam)."""
    out = (ctypes.c_uint64 * 11)()
    lib().trpc_tpu_plane_stats(out)
    keys = ("h2d_transfers", "d2h_transfers", "h2d_bytes", "d2h_bytes",
            "events_fired", "gather_copies", "zero_copy_sends",
            "live_buffers", "errors", "d2d_transfers", "d2d_bytes")
    return dict(zip(keys, out))


POOL_KEYS = ("hits", "misses", "cached_bytes", "releases", "oom_retries")


def pool_stats() -> Dict[str, object]:
    """The plane's pools: ``device`` (the device-buffer caches, summed
    over devices) and ``host`` (the page-locked pool of h2d staging
    blocks and of the d2h landing zones that no io_uring slot takes),
    each with hits and misses (a miss allocates from the driver), the
    free bytes cached, releases (blocks handed back to the driver: above
    the cache limit, or to retry an allocation that ran out of memory)
    and out-of-memory retries; ``slots``, io_uring's registered slots
    taken as d2h zones (with the ring transport up): ``registered``
    (page-locked with the driver, each once, on its first use) and
    ``refused`` (by the driver, or outside the ring's fixed-buffer
    table: their zones come from the pool); and ``peer_access``, the
    device pairs [i][j] whose context i reaches device j's memory
    directly."""
    L = lib()
    out = (ctypes.c_uint64 * 10)()
    L.trpc_cuda_pool_stats(out)
    slots = (ctypes.c_uint64 * 2)()
    L.trpc_cuda_slot_stats(slots)
    n = max(device_count(), 1)
    peer = (ctypes.c_uint8 * (n * n))()
    n = L.trpc_cuda_peer_access(peer, n * n)
    return {"device": dict(zip(POOL_KEYS, out[:5])),
            "host": dict(zip(POOL_KEYS, out[5:])),
            "slots": {"registered": slots[0], "refused": slots[1]},
            "peer_access": [[int(peer[i * n + j]) for j in range(n)]
                            for i in range(n)]}


def plane_uid() -> int:
    """Nonzero token identifying THIS process's device plane; exchanged in
    the tpu:// handshake so connections learn whether both ends share one
    plane (enabling device-to-device stream frames)."""
    return lib().trpc_tpu_plane_uid()


def d2d(buf: DeviceBuffer, device: int) -> DeviceBuffer:
    """Copy a device buffer to another device of THIS process
    (cuMemcpyPeerAsync, or a device-local copy — no host landing zone).  Returns a
    new buffer; the source stays valid and still needs its own free()."""
    nb = lib().trpc_tpu_d2d(buf.handle, device)
    if nb == 0:
        raise IOError(f"d2d failed: {error()}")
    return DeviceBuffer(nb, len(buf))


class PoolExhausted(Exception):
    """alloc() against a pool whose block budget is spent — the caller
    sheds or preempts; the pool NEVER queues (admission control happens
    above the device plane, before any DMA is issued)."""


class DeviceBufPool:
    """Budgeted fixed-size-block allocator over the plane's DeviceBuffers
    (≙ the reference's rdma/block_pool.cpp: a hard block budget with
    every allocation charged against it, re-designed: blocks are device
    DeviceBuffers and migration is a d2d hop instead of an ibverbs
    MR hand-off).

    Hard accounting: every `alloc()` charges one block until `free()`;
    `migrate()` moves a block between devices without changing the
    charge (the source is freed as soon as the copy is enqueued).
    `assert_balanced()` proves nothing leaked — the serving plane calls
    it after every drain and the suite calls it after every cancel leg.

    Thread-safe: the ledger mutates under one lock; DMA waits happen
    outside it."""

    def __init__(self, block_bytes: int, max_blocks: int):
        if block_bytes <= 0 or max_blocks <= 0:
            raise ValueError("block_bytes and max_blocks must be positive")
        self.block_bytes = block_bytes
        self.max_blocks = max_blocks
        self._lock = threading.Lock()
        self._live: Dict[int, DeviceBuffer] = {}   # handle -> buffer
        self._views: Dict[int, Optional[str]] = {}  # device -> torch device
        self._allocs = 0
        self._frees = 0
        self._migrations = 0
        self._exhausted = 0

    # -- ledger -------------------------------------------------------------

    @property
    def used_blocks(self) -> int:
        with self._lock:
            return len(self._live)

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return self.max_blocks - len(self._live)

    def pool_stats(self) -> Dict[str, int]:
        with self._lock:
            return {"block_bytes": self.block_bytes,
                    "max_blocks": self.max_blocks,
                    "used_blocks": len(self._live),
                    "allocs": self._allocs, "frees": self._frees,
                    "migrations": self._migrations,
                    "exhausted": self._exhausted}

    def assert_balanced(self) -> None:
        """Every charged block was freed; raises with the leak count
        otherwise (the serving accounting proof rides on this)."""
        with self._lock:
            leaked = len(self._live)
        if leaked:
            raise AssertionError(
                f"DeviceBufPool leaked {leaked} block(s): "
                f"allocs={self._allocs} frees={self._frees}")

    # -- data path ----------------------------------------------------------

    def view_device(self, device: int) -> Optional[str]:
        """The torch device that views this pool's blocks on plane
        device `device` (:func:`torch_device`, asked once a device)."""
        with self._lock:
            if device in self._views:
                return self._views[device]
        where = torch_device(device)
        with self._lock:
            self._views[device] = where
        return where

    def alloc(self, data: bytes, device: int = 0) -> DeviceBuffer:
        """Charge one block and DMA `data` (at most block_bytes, padded
        to the block size so every block is pool-shaped) onto `device`.
        Raises PoolExhausted when the budget is spent — callers shed
        BEFORE this ever queues."""
        if len(data) > self.block_bytes:
            raise ValueError(
                f"block payload {len(data)} > block_bytes "
                f"{self.block_bytes}")
        pad = self.block_bytes - len(data)
        return self._charge(lambda: h2d(data + b"\x00" * pad, device))

    def alloc_zeros(self, device: int = 0) -> DeviceBuffer:
        """Charge one block and zero it on `device` (a device memset: no
        host bytes)."""
        return self._charge(lambda: fill(self.block_bytes, device))

    def alloc_copy(self, src, device: int = 0) -> DeviceBuffer:
        """Charge one block and fill it on `device` by one device copy of
        `src`, a contiguous tensor of block_bytes bytes on the pool's view
        of `device` (:meth:`view_device`), its writes complete; the caller
        keeps it until the block is ready."""
        if src.nbytes != self.block_bytes:
            raise ValueError(f"block source {src.nbytes} bytes != "
                             f"block_bytes {self.block_bytes}")
        return self._charge(lambda: fill(self.block_bytes, device, src))

    def _charge(self, make) -> DeviceBuffer:
        """Charge one block for the buffer `make()` returns; the charge
        is undone when it raises."""
        with self._lock:
            if len(self._live) >= self.max_blocks:
                self._exhausted += 1
                raise PoolExhausted(
                    f"block budget spent ({self.max_blocks} blocks)")
            self._allocs += 1
        try:
            buf = make()
        except Exception:
            with self._lock:
                self._allocs -= 1
            raise
        with self._lock:
            self._live[buf.handle] = buf
        return buf

    def migrate(self, buf: DeviceBuffer, device: int) -> DeviceBuffer:
        """Move a charged block to `device` over the d2d fabric; the
        charge transfers to the new buffer and the source is freed.  On
        d2d failure the source stays charged and valid."""
        with self._lock:
            if buf.handle not in self._live:
                raise KeyError("migrate() of a buffer not in this pool")
        nb = d2d(buf, device)
        with self._lock:
            del self._live[buf.handle]
            self._live[nb.handle] = nb
            self._migrations += 1
        buf.free()
        return nb

    def adopt(self, buf: DeviceBuffer) -> DeviceBuffer:
        """Charge an externally-created DeviceBuffer (e.g. a host-rail
        re-upload) against this pool's budget.  Raises PoolExhausted
        rather than over-committing; the buffer is NOT freed on refusal
        (it was never ours)."""
        return self._charge(lambda: buf)

    def release(self, buf: DeviceBuffer) -> None:
        """Un-charge a block WITHOUT freeing the underlying buffer —
        ownership leaves the pool (e.g. handed to stream.write_device,
        which consumes the buffer on success)."""
        with self._lock:
            if self._live.pop(buf.handle, None) is not None:
                self._frees += 1

    def free(self, buf: DeviceBuffer) -> None:
        """Return a block: idempotent, like DeviceBuffer.free itself."""
        with self._lock:
            if self._live.pop(buf.handle, None) is None:
                return
            self._frees += 1
        buf.free()

    def free_all(self) -> None:
        """Drop every outstanding block (teardown path)."""
        with self._lock:
            live = list(self._live.values())
            self._live.clear()
            self._frees += len(live)
        for b in live:
            b.free()
