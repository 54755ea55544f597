"""Mongo wire-protocol head: OP_MSG framing + minimal BSON (≙
policy/mongo_protocol.cpp:298 + mongo_head.h — the reference also stops
at protocol parsing/dispatch; neither implements a database).

Mongo messages cannot ride the shared-port sniffer (they begin with a
little-endian length whose first byte is arbitrary), so the server here
owns its port — matching how the reference dedicates a mongo port via
ServerOptions.mongo_service_adaptor.

Wire format (OP_MSG, opcode 2013):
    u32 messageLength | u32 requestID | u32 responseTo | u32 opCode
    u32 flagBits | section kind 0x00 | BSON document
BSON subset: double, string, embedded doc, array, bool, null, int32,
int64 — the types the command surface (hello/ping/find-like commands)
needs.
"""

from __future__ import annotations

import socket
import struct
import threading

from brpc_tpu_torch.rpc._sockutil import recv_exact
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["bson_encode", "bson_decode", "MongoService", "MongoClient",
           "MongoError"]

OP_MSG = 2013


class MongoError(Exception):
    pass


# ---------------------------------------------------------------------------
# BSON (subset)

def _enc_elem(out: bytearray, name: str, v: Any) -> None:
    key = name.encode("utf-8") + b"\x00"
    if isinstance(v, bool):  # before int: bool is an int subclass
        out += b"\x08" + key + (b"\x01" if v else b"\x00")
    elif isinstance(v, float):
        out += b"\x01" + key + struct.pack("<d", v)
    elif isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            out += b"\x10" + key + struct.pack("<i", v)
        else:
            out += b"\x12" + key + struct.pack("<q", v)
    elif isinstance(v, str):
        b = v.encode("utf-8") + b"\x00"
        out += b"\x02" + key + struct.pack("<i", len(b)) + b
    elif v is None:
        out += b"\x0a" + key
    elif isinstance(v, dict):
        out += b"\x03" + key + bson_encode(v)
    elif isinstance(v, (list, tuple)):
        doc = {str(i): x for i, x in enumerate(v)}
        out += b"\x04" + key + bson_encode(doc)
    else:
        raise MongoError(f"unsupported BSON value type {type(v).__name__}")


def bson_encode(doc: Dict[str, Any]) -> bytes:
    body = bytearray()
    for k, v in doc.items():
        _enc_elem(body, k, v)
    return struct.pack("<i", len(body) + 5) + bytes(body) + b"\x00"


def _dec_cstring(blob: bytes, off: int) -> Tuple[str, int]:
    end = blob.index(b"\x00", off)
    return blob[off:end].decode("utf-8"), end + 1


def bson_decode(blob: bytes, off: int = 0) -> Tuple[Dict[str, Any], int]:
    (total,) = struct.unpack_from("<i", blob, off)
    end = off + total
    i = off + 4
    out: Dict[str, Any] = {}
    while i < end - 1:
        t = blob[i]
        i += 1
        name, i = _dec_cstring(blob, i)
        if t == 0x01:
            (out[name],) = struct.unpack_from("<d", blob, i)
            i += 8
        elif t == 0x02:
            (n,) = struct.unpack_from("<i", blob, i)
            i += 4
            out[name] = blob[i:i + n - 1].decode("utf-8")
            i += n
        elif t in (0x03, 0x04):
            sub, j = bson_decode(blob, i)
            out[name] = list(sub.values()) if t == 0x04 else sub
            i = j
        elif t == 0x08:
            out[name] = blob[i] != 0
            i += 1
        elif t == 0x0A:
            out[name] = None
        elif t == 0x10:
            (out[name],) = struct.unpack_from("<i", blob, i)
            i += 4
        elif t == 0x12:
            (out[name],) = struct.unpack_from("<q", blob, i)
            i += 8
        else:
            raise MongoError(f"unsupported BSON type 0x{t:02x}")
    return out, end


# ---------------------------------------------------------------------------
# OP_MSG framing

def pack_op_msg(doc: Dict[str, Any], request_id: int,
                response_to: int = 0) -> bytes:
    body = struct.pack("<I", 0) + b"\x00" + bson_encode(doc)
    return struct.pack("<iiii", 16 + len(body), request_id, response_to,
                       OP_MSG) + body


MORE_TO_COME = 1 << 1  # OP_MSG flagBits: fire-and-forget, no reply


def parse_op_msg(frame: bytes) -> Tuple[int, int, Dict[str, Any]]:
    """frame = one whole wire message.  Returns (request_id, flags, doc)."""
    if len(frame) < 26:  # header + flags + kind + empty doc
        raise MongoError(f"frame too short ({len(frame)} bytes)")
    mlen, req_id, _resp_to, opcode = struct.unpack_from("<iiii", frame, 0)
    if mlen != len(frame):
        raise MongoError(f"length mismatch {mlen} != {len(frame)}")
    if opcode != OP_MSG:
        raise MongoError(f"unsupported opcode {opcode} (OP_MSG only)")
    (flags,) = struct.unpack_from("<I", frame, 16)
    kind = frame[20]
    if kind != 0:
        raise MongoError(f"unsupported section kind {kind}")
    try:
        doc, _ = bson_decode(frame, 21)
    except (struct.error, IndexError, ValueError) as e:
        raise MongoError(f"corrupt BSON: {e}") from None
    return req_id, flags, doc


# ---------------------------------------------------------------------------
# server / client heads

Handler = Callable[[Dict[str, Any]], Dict[str, Any]]


class MongoService:
    """Command dispatcher + its own listener (mongo cannot share the
    sniffed port — its frames have no magic).  Commands register by name
    (the first BSON key, per the OP_MSG convention); hello/ismaster/ping
    have defaults so stock drivers get through their handshake."""

    def __init__(self):
        self._commands: Dict[str, Handler] = {}
        self._srv: Optional[socket.socket] = None
        self._stop = False
        self.register("ping", lambda d: {"ok": 1})
        hello = {
            "ismaster": True, "isWritablePrimary": True,
            "maxBsonObjectSize": 16 * 1024 * 1024,
            "maxMessageSizeBytes": 48_000_000,
            "maxWireVersion": 17, "minWireVersion": 0, "ok": 1,
        }
        self.register("hello", lambda d: dict(hello))
        self.register("ismaster", lambda d: dict(hello))
        self.register("isMaster", lambda d: dict(hello))

    def register(self, command: str, handler: Handler) -> None:
        self._commands[command] = handler

    def dispatch(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        if not doc:
            return {"ok": 0, "errmsg": "empty command", "code": 22}
        cmd = next(iter(doc))
        h = self._commands.get(cmd)
        if h is None:
            return {"ok": 0, "errmsg": f"no such command: '{cmd}'",
                    "code": 59}
        try:
            return h(doc)
        except Exception as e:  # command bug → mongo-style error doc
            return {"ok": 0, "errmsg": repr(e), "code": 8}

    # -- listener -----------------------------------------------------------

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self.port

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            next_id = 1
            while True:
                hdr = _recv_exact(conn, 4)
                if hdr is None:
                    return
                (mlen,) = struct.unpack("<i", hdr)
                if not 16 <= mlen <= 48_000_000:
                    return  # corrupt framing: drop the connection
                rest = _recv_exact(conn, mlen - 4)
                if rest is None:
                    return
                req_id, flags, doc = parse_op_msg(hdr + rest)
                reply = self.dispatch(doc)
                if flags & MORE_TO_COME:
                    continue  # fire-and-forget: the contract is NO reply
                conn.sendall(pack_op_msg(reply, next_id, req_id))
                next_id += 1
        except Exception:
            pass  # corrupt peer: drop the connection, never the thread
        finally:
            conn.close()

    def stop(self):
        self._stop = True
        if self._srv is not None:
            self._srv.close()


class MongoClient:
    """OP_MSG command client (the head of a driver: handshake + runCommand)."""

    def __init__(self, host: str, port: int, timeout_s: float = 5.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._req = 0
        self._lock = threading.Lock()

    def command(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self._req += 1
            sent_id = self._req
            self._sock.sendall(pack_op_msg(doc, sent_id))
            hdr = recv_exact(self._sock, 4)
            (mlen,) = struct.unpack("<i", hdr)
            if not 16 <= mlen <= 48_000_000:
                raise MongoError(f"bad reply length {mlen}")
            rest = recv_exact(self._sock, mlen - 4)
        frame = hdr + rest
        (_mlen, _rid, resp_to, _op) = struct.unpack_from("<iiii", frame, 0)
        if resp_to != sent_id:
            # a desynced stream (e.g. after a timeout left a reply
            # unread) must fail loudly, not return a stale answer
            raise MongoError(
                f"responseTo {resp_to} does not match request {sent_id}")
        _rid2, _flags, reply = parse_op_msg(frame)
        return reply

    def hello(self) -> Dict[str, Any]:
        return self.command({"hello": 1})

    def ping(self) -> bool:
        return self.command({"ping": 1}).get("ok") == 1

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    """Server-loop variant: None on EOF (a vanished client is normal)."""
    try:
        return recv_exact(conn, n)
    except ConnectionError:
        return None
