"""Memcache binary-protocol client with batched pipelining (≙
src/brpc/memcache.h:890 MemcacheRequest packing multiple operations into
one round trip + policy/memcache_binary_protocol.cpp framing).

Speaks the standard memcached binary protocol (24-byte header, magic
0x80/0x81), so it works against stock memcached.  Batching follows the
protocol's quiet-op idiom: a MemcacheBatch queues quiet variants
(GETKQ/SETQ/DELETEQ/...) and terminates the pipeline with NOOP, so one
write + one read round-trips N operations (what the reference's
pipelined_count achieves over its channel).
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["MemcacheClient", "MemcacheBatch", "MemcacheError", "Status"]

_HDR = struct.Struct("!BBHBBHIIQ")  # magic op keylen extlen dtype status bodylen opaque cas
_REQ_MAGIC = 0x80
_RES_MAGIC = 0x81


class Op:
    GET = 0x00
    SET = 0x01
    ADD = 0x02
    REPLACE = 0x03
    DELETE = 0x04
    INCREMENT = 0x05
    DECREMENT = 0x06
    QUIT = 0x07
    FLUSH = 0x08
    GETQ = 0x09
    NOOP = 0x0A
    VERSION = 0x0B
    GETK = 0x0C
    GETKQ = 0x0D
    APPEND = 0x0E
    PREPEND = 0x0F
    SETQ = 0x11
    ADDQ = 0x12
    REPLACEQ = 0x13
    DELETEQ = 0x14
    INCREMENTQ = 0x15
    DECREMENTQ = 0x16
    TOUCH = 0x1C


class Status:
    OK = 0x0000
    KEY_NOT_FOUND = 0x0001
    KEY_EXISTS = 0x0002
    VALUE_TOO_LARGE = 0x0003
    INVALID_ARGUMENTS = 0x0004
    ITEM_NOT_STORED = 0x0005
    NON_NUMERIC = 0x0006
    UNKNOWN_COMMAND = 0x0081
    OUT_OF_MEMORY = 0x0082


class MemcacheError(Exception):
    def __init__(self, status: int, message: str = ""):
        super().__init__(message or f"memcache status 0x{status:04x}")
        self.status = status


def _pack(op: int, key: bytes = b"", extras: bytes = b"", value: bytes = b"",
          opaque: int = 0, cas: int = 0) -> bytes:
    body = len(extras) + len(key) + len(value)
    return _HDR.pack(_REQ_MAGIC, op, len(key), len(extras), 0, 0, body,
                     opaque, cas) + extras + key + value


def _key(k) -> bytes:
    return k.encode("utf-8") if isinstance(k, str) else bytes(k)


class _Response:
    __slots__ = ("op", "status", "key", "extras", "value", "opaque", "cas")

    def __init__(self, op, status, key, extras, value, opaque, cas):
        self.op = op
        self.status = status
        self.key = key
        self.extras = extras
        self.value = value
        self.opaque = opaque
        self.cas = cas


class MemcacheClient:
    """Synchronous binary-protocol client.  Single connection; calls are
    serialized by a lock (use one client per thread, or MemcacheBatch for
    throughput — matching the reference's channel semantics)."""

    def __init__(self, host: str, port: int, timeout_s: float = 5.0):
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    # -- single ops ---------------------------------------------------------

    def get(self, key) -> Optional[bytes]:
        """Value bytes, or None if the key is absent."""
        r = self._round_trip(_pack(Op.GET, _key(key)))
        if r.status == Status.KEY_NOT_FOUND:
            return None
        self._raise_if(r)
        return r.value

    def gets(self, key) -> Tuple[Optional[bytes], int]:
        """(value, cas) — cas feeds compare-and-swap set(..., cas=...)."""
        r = self._round_trip(_pack(Op.GET, _key(key)))
        if r.status == Status.KEY_NOT_FOUND:
            return None, 0
        self._raise_if(r)
        return r.value, r.cas

    def set(self, key, value: bytes, flags: int = 0, exptime: int = 0,
            cas: int = 0) -> int:
        """Store unconditionally (or CAS-guarded when cas != 0).  Returns
        the new cas."""
        return self._store(Op.SET, key, value, flags, exptime, cas)

    def add(self, key, value: bytes, flags: int = 0, exptime: int = 0) -> int:
        """Store only if absent (raises KEY_EXISTS otherwise)."""
        return self._store(Op.ADD, key, value, flags, exptime, 0)

    def replace(self, key, value: bytes, flags: int = 0,
                exptime: int = 0) -> int:
        """Store only if present."""
        return self._store(Op.REPLACE, key, value, flags, exptime, 0)

    def append(self, key, value: bytes) -> int:
        r = self._round_trip(_pack(Op.APPEND, _key(key), b"", value))
        self._raise_if(r)
        return r.cas

    def prepend(self, key, value: bytes) -> int:
        r = self._round_trip(_pack(Op.PREPEND, _key(key), b"", value))
        self._raise_if(r)
        return r.cas

    def delete(self, key) -> bool:
        """True if the key existed."""
        r = self._round_trip(_pack(Op.DELETE, _key(key)))
        if r.status == Status.KEY_NOT_FOUND:
            return False
        self._raise_if(r)
        return True

    def incr(self, key, delta: int = 1, initial: int = 0,
             exptime: int = 0) -> int:
        return self._arith(Op.INCREMENT, key, delta, initial, exptime)

    def decr(self, key, delta: int = 1, initial: int = 0,
             exptime: int = 0) -> int:
        return self._arith(Op.DECREMENT, key, delta, initial, exptime)

    def touch(self, key, exptime: int) -> bool:
        r = self._round_trip(
            _pack(Op.TOUCH, _key(key), struct.pack("!I", exptime)))
        if r.status == Status.KEY_NOT_FOUND:
            return False
        self._raise_if(r)
        return True

    def flush_all(self, delay: int = 0) -> None:
        r = self._round_trip(_pack(Op.FLUSH, b"", struct.pack("!I", delay)))
        self._raise_if(r)

    def version(self) -> str:
        r = self._round_trip(_pack(Op.VERSION))
        self._raise_if(r)
        return r.value.decode("ascii", "replace")

    # -- batched pipeline ---------------------------------------------------

    def batch(self) -> "MemcacheBatch":
        return MemcacheBatch(self)

    def multi_get(self, keys) -> Dict[bytes, bytes]:
        """One round trip for N keys via quiet GETKQ + NOOP.  Absent keys
        produce no reply (the binary-protocol contract); a key whose
        lookup FAILED (server error, not a miss) raises, so callers never
        mistake a failure for a cache miss."""
        keys = [_key(k) for k in keys]
        with self._lock:
            out = bytearray()
            for i, k in enumerate(keys):
                out += _pack(Op.GETKQ, k, opaque=i)
            out += _pack(Op.NOOP, opaque=len(keys))
            self._sock.sendall(out)
            found: Dict[bytes, bytes] = {}
            failed: List[Tuple[bytes, int]] = []
            while True:
                r = self._read_response()
                if r.op == Op.NOOP:
                    break
                if r.status == Status.OK:
                    found[r.key] = r.value
                elif r.status != Status.KEY_NOT_FOUND:
                    k = keys[r.opaque] if r.opaque < len(keys) else r.key
                    failed.append((k, r.status))
        if failed:
            raise MemcacheError(
                failed[0][1],
                f"multi_get: {len(failed)} key(s) failed, first "
                f"{failed[0][0]!r} status 0x{failed[0][1]:04x}")
        return found

    # -- internals ----------------------------------------------------------

    def _store(self, op, key, value, flags, exptime, cas) -> int:
        extras = struct.pack("!II", flags, exptime)
        r = self._round_trip(_pack(op, _key(key), extras, value, cas=cas))
        self._raise_if(r)
        return r.cas

    def _arith(self, op, key, delta, initial, exptime) -> int:
        extras = struct.pack("!QQI", delta, initial, exptime)
        r = self._round_trip(_pack(op, _key(key), extras))
        self._raise_if(r)
        return struct.unpack("!Q", r.value)[0]

    def _raise_if(self, r: _Response) -> None:
        if r.status != Status.OK:
            raise MemcacheError(
                r.status, r.value.decode("ascii", "replace") if r.value
                else "")

    def _round_trip(self, req: bytes) -> _Response:
        with self._lock:
            self._sock.sendall(req)
            return self._read_response()

    def _read_response(self) -> _Response:
        hdr = self._recv_exact(_HDR.size)
        magic, op, klen, elen, _dt, status, blen, opaque, cas = \
            _HDR.unpack(hdr)
        if magic != _RES_MAGIC:
            raise MemcacheError(Status.UNKNOWN_COMMAND,
                                f"bad response magic 0x{magic:02x}")
        body = self._recv_exact(blen) if blen else b""
        extras = body[:elen]
        key = body[elen:elen + klen]
        value = body[elen + klen:]
        return _Response(op, status, key, extras, value, opaque, cas)

    def _recv_exact(self, n: int) -> bytes:
        from brpc_tpu_torch.rpc._sockutil import recv_exact
        try:
            return recv_exact(self._sock, n)
        except ConnectionError:
            raise MemcacheError(Status.UNKNOWN_COMMAND,
                                "connection closed") from None

    def close(self) -> None:
        try:
            self._sock.sendall(_pack(Op.QUIT))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class MemcacheBatch:
    """Accumulates stores/deletes/gets, flushes them as one quiet
    pipeline (≙ MemcacheRequest's N-op batching, memcache.h:890).
    execute() returns {key: value} for the gets; store/delete errors
    surface as MemcacheError entries in .errors."""

    def __init__(self, client: MemcacheClient):
        self._c = client
        self._ops: List[bytes] = []
        self._keys: List[bytes] = []  # op index -> key, for .errors
        self.errors: List[Tuple[bytes, int]] = []  # (key, status)

    def _queue(self, op_bytes: bytes, key: bytes) -> "MemcacheBatch":
        self._ops.append(op_bytes)
        self._keys.append(key)
        return self

    def get(self, key) -> "MemcacheBatch":
        k = _key(key)
        return self._queue(_pack(Op.GETKQ, k, opaque=len(self._ops)), k)

    def set(self, key, value: bytes, flags: int = 0,
            exptime: int = 0) -> "MemcacheBatch":
        k = _key(key)
        return self._queue(
            _pack(Op.SETQ, k, struct.pack("!II", flags, exptime), value,
                  opaque=len(self._ops)), k)

    def delete(self, key) -> "MemcacheBatch":
        k = _key(key)
        return self._queue(_pack(Op.DELETEQ, k, opaque=len(self._ops)), k)

    def execute(self) -> Dict[bytes, bytes]:
        c = self._c
        with c._lock:
            out = bytearray()
            for op in self._ops:
                out += op
            out += _pack(Op.NOOP, opaque=len(self._ops))
            c._sock.sendall(out)
            found: Dict[bytes, bytes] = {}
            self.errors = []
            while True:
                r = c._read_response()
                if r.op == Op.NOOP:
                    break
                if r.status == Status.OK:
                    if r.key:
                        found[r.key] = r.value
                else:
                    # quiet stores/deletes only reply on error; error
                    # replies carry no key, so map back through the
                    # opaque each queued op was packed with
                    k = self._keys[r.opaque] \
                        if r.opaque < len(self._keys) else r.key
                    self.errors.append((k, r.status))
        self._ops = []
        self._keys = []
        return found
