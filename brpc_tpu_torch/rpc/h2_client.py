"""HTTP/2 client + gRPC client (≙ the client half of
policy/http2_rpc_protocol.cpp and grpc.h:208 semantics).

The connection (native h2.cc client section) multiplexes concurrent
calls over one socket with HPACK request encoding and send-side flow
control; gRPC layers its 5-byte message framing and grpc-status
trailers on top — so brpc_tpu_torch services exposed via add_grpc_service are
callable without grpcio.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from brpc_tpu_torch._native import lib
from brpc_tpu_torch.rpc import errors

__all__ = ["H2Response", "H2Channel", "H2Stream", "GrpcError",
           "GrpcChannel", "GrpcStream"]


@dataclass
class H2Response:
    status: int
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    trailers: Dict[str, str] = field(default_factory=dict)


def _parse_lines(blob: bytes) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for line in blob.decode("latin-1").splitlines():
        k, _, v = line.partition(": ")
        if k:
            out[k] = v
    return out


class H2Channel:
    """h2c (prior-knowledge) client connection.  Calls are thread-safe
    and multiplex concurrently on one socket."""

    def __init__(self, target: str, connect_timeout_ms: float = 1000.0,
                 tls: bool = False, tls_verify: bool = True,
                 tls_ca_file: Optional[str] = None):
        import socket as _socket
        host, _, port = target.rpartition(":")
        # the native side takes IPv4 literals only; resolve names here
        ip = _socket.gethostbyname(host or "127.0.0.1")
        rc = ctypes.c_int()
        if tls:
            self._handle = lib().trpc_h2_client_create_tls(
                ip.encode(), int(port), int(connect_timeout_ms * 1000),
                1 if tls_verify else 0,
                tls_ca_file.encode() if tls_ca_file else None,
                ctypes.byref(rc))
        else:
            self._handle = lib().trpc_h2_client_create(
                ip.encode(), int(port), int(connect_timeout_ms * 1000),
                ctypes.byref(rc))
        if not self._handle:
            raise errors.RpcError(rc.value, f"h2 connect to {target} failed")

    def request(self, method: str, path: str,
                headers: Optional[Dict[str, str]] = None,
                body: bytes = b"",
                timeout_ms: float = 10_000.0) -> H2Response:
        if self._handle is None:
            raise errors.RpcError(errors.EFAILEDSOCKET, "channel closed")
        L = lib()
        blob = None
        if headers:
            blob = "".join(f"{k}: {v}\r\n"
                           for k, v in headers.items()).encode()
        result = ctypes.c_void_p()
        rc = L.trpc_h2_client_call(
            self._handle, method.encode(), path.encode(), blob,
            body if body else None, len(body), int(timeout_ms * 1000),
            ctypes.byref(result))
        try:
            if rc != 0:
                raise errors.RpcError(rc, f"h2 call failed ({rc})")
            status = L.trpc_h2_result_status(result)
            p = ctypes.POINTER(ctypes.c_uint8)()
            n = L.trpc_h2_result_headers(result, ctypes.byref(p))
            hdrs = _parse_lines(ctypes.string_at(p, n) if n else b"")
            n = L.trpc_h2_result_body(result, ctypes.byref(p))
            rbody = ctypes.string_at(p, n) if n else b""
            n = L.trpc_h2_result_trailers(result, ctypes.byref(p))
            trls = _parse_lines(ctypes.string_at(p, n) if n else b"")
        finally:
            L.trpc_h2_result_destroy(result)
        return H2Response(status, hdrs, rbody, trls)

    def open_stream(self, method: str, path: str,
                    headers: Optional[Dict[str, str]] = None) -> "H2Stream":
        """Open a streaming request (HEADERS only): write body chunks
        incrementally, half-close, and read the response body as chunks
        while the server is still sending (≙ ProgressiveReader both
        ways on one h2 stream)."""
        if self._handle is None:
            raise errors.RpcError(errors.EFAILEDSOCKET, "channel closed")
        blob = None
        if headers:
            blob = "".join(f"{k}: {v}\r\n"
                           for k, v in headers.items()).encode()
        rc = ctypes.c_int()
        h = lib().trpc_h2_stream_open(self._handle, method.encode(),
                                      path.encode(), blob, ctypes.byref(rc))
        if not h:
            raise errors.RpcError(rc.value, "h2 stream open failed")
        return H2Stream(h)

    def get(self, path: str, **kw) -> H2Response:
        return self.request("GET", path, **kw)

    def post(self, path: str, body: bytes = b"", **kw) -> H2Response:
        return self.request("POST", path, body=body, **kw)

    def close(self) -> None:
        if self._handle is not None:
            lib().trpc_h2_client_destroy(self._handle)
            self._handle = None


class H2Stream:
    """One streaming h2 request: incremental body out, incremental body
    in (chunks arrive while the server still streams)."""

    def __init__(self, handle):
        self._h = handle

    def write(self, data: bytes, timeout_ms: float = 10_000.0) -> None:
        rc = lib().trpc_h2_stream_write(self._h, data, len(data),
                                        int(timeout_ms * 1000))
        if rc != 0:
            raise errors.RpcError(rc, f"h2 stream write failed ({rc})")

    def close_send(self) -> None:
        rc = lib().trpc_h2_stream_close_send(self._h)
        if rc != 0:
            raise errors.RpcError(rc, f"h2 stream half-close failed ({rc})")

    def read(self, timeout_ms: float = 10_000.0) -> Optional[bytes]:
        """Next response-body chunk; None at EOF (status/headers/trailers
        are final then)."""
        L = lib()
        p = ctypes.POINTER(ctypes.c_uint8)()
        n = L.trpc_h2_stream_read(self._h, int(timeout_ms * 1000),
                                  ctypes.byref(p))
        if n > 0:
            try:
                return ctypes.string_at(p, n)
            finally:
                L.trpc_h2_stream_chunk_free(p)
        if n == 0:
            return None
        raise errors.RpcError(int(n), f"h2 stream read failed ({n})")

    @property
    def status(self) -> int:
        return lib().trpc_h2_stream_status(self._h)

    def headers(self) -> Dict[str, str]:
        p = ctypes.POINTER(ctypes.c_uint8)()
        n = lib().trpc_h2_stream_headers(self._h, ctypes.byref(p))
        return _parse_lines(ctypes.string_at(p, n) if n else b"")

    def trailers(self) -> Dict[str, str]:
        p = ctypes.POINTER(ctypes.c_uint8)()
        n = lib().trpc_h2_stream_trailers(self._h, ctypes.byref(p))
        return _parse_lines(ctypes.string_at(p, n) if n else b"")

    def destroy(self) -> None:
        if self._h is not None:
            lib().trpc_h2_stream_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.destroy()


def _grpc_timeout_value(timeout_ms: float) -> str:
    """gRPC TimeoutValue is at most 8 digits: escalate the unit when
    milliseconds overflow (the spec's own coarsening rule)."""
    ms = max(int(timeout_ms), 1)
    if ms <= 99_999_999:
        return f"{ms}m"
    seconds = ms // 1000
    if seconds <= 99_999_999:
        return f"{seconds}S"
    return f"{min(seconds // 3600, 99_999_999)}H"


class GrpcError(Exception):
    def __init__(self, code: int, message: str = ""):
        super().__init__(f"grpc-status {code}: {message}")
        self.code = code
        self.message = message


class GrpcChannel:
    """gRPC unary calls over the framework's own h2 client (no grpcio):
    POST /<Service>/<Method>, content-type application/grpc, 5-byte
    length-prefixed messages, grpc-status in the trailers."""

    def __init__(self, target: str, **kw):
        self._h2 = H2Channel(target, **kw)

    def call(self, service: str, method: str, request: bytes,
             timeout_ms: float = 10_000.0) -> bytes:
        framed = b"\x00" + struct.pack("!I", len(request)) + request
        resp = self._h2.post(
            f"/{service}/{method}", body=framed,
            headers={"content-type": "application/grpc", "te": "trailers",
                     # deadline propagation (≙ grpc.cpp:208 both ways)
                     "grpc-timeout": _grpc_timeout_value(timeout_ms)},
            timeout_ms=timeout_ms)
        status_map = dict(resp.trailers)
        if "grpc-status" not in status_map:
            status_map.update(resp.headers)  # trailers-only responses
        code = int(status_map.get("grpc-status", "2"))
        if code != 0:
            raise GrpcError(code, status_map.get("grpc-message", ""))
        if len(resp.body) < 5:
            return b""
        compressed, mlen = resp.body[0], struct.unpack("!I",
                                                       resp.body[1:5])[0]
        if compressed:
            raise GrpcError(12, "compressed grpc frames unsupported")
        return resp.body[5:5 + mlen]

    def streaming_call(self, service: str, method: str,
                       timeout_ms: float = 10_000.0) -> "GrpcStream":
        """Open a streaming gRPC call (client/server/bidi): send_message
        incrementally, done_sending to half-close, recv_message while the
        server still streams (None = end; grpc-status then checked)."""
        st = self._h2.open_stream(
            "POST", f"/{service}/{method}",
            headers={"content-type": "application/grpc", "te": "trailers",
                     "grpc-timeout": _grpc_timeout_value(timeout_ms)})
        return GrpcStream(st, timeout_ms)

    def close(self) -> None:
        self._h2.close()


class GrpcStream:
    """gRPC message framing over one streaming h2 call."""

    def __init__(self, h2_stream: H2Stream, timeout_ms: float):
        self._st = h2_stream
        self._timeout_ms = timeout_ms
        self._buf = b""
        self._eof = False

    def send_message(self, message: bytes) -> None:
        framed = b"\x00" + struct.pack("!I", len(message)) + message
        self._st.write(framed, timeout_ms=self._timeout_ms)

    def done_sending(self) -> None:
        self._st.close_send()

    def recv_message(self) -> Optional[bytes]:
        """Next response message; None when the server finished (then
        grpc-status from the trailers is raised if nonzero)."""
        while True:
            if len(self._buf) >= 5:
                compressed, mlen = self._buf[0], struct.unpack(
                    "!I", self._buf[1:5])[0]
                if len(self._buf) >= 5 + mlen:
                    if compressed:
                        raise GrpcError(12,
                                        "compressed grpc frames unsupported")
                    msg = self._buf[5:5 + mlen]
                    self._buf = self._buf[5 + mlen:]
                    return msg
            if self._eof:
                if self._buf:
                    raise GrpcError(13, "truncated grpc frame at EOF")
                status_map = self._st.trailers() or self._st.headers()
                code = int(status_map.get("grpc-status", "2"))
                if code != 0:
                    raise GrpcError(code,
                                    status_map.get("grpc-message", ""))
                return None
            chunk = self._st.read(timeout_ms=self._timeout_ms)
            if chunk is None:
                self._eof = True
            else:
                self._buf += chunk

    def __iter__(self):
        while True:
            m = self.recv_message()
            if m is None:
                return
            yield m

    def destroy(self) -> None:
        self._st.destroy()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.destroy()
