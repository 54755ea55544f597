"""altpack — a second serialization bridge with CODE GENERATION, standing
in for the mcpack2pb capability (≙ mcpack2pb/generator.cpp:1424: a protoc
plugin emitting (de)serializers for a non-protobuf wire format, plus the
glue that lets services speak it on the shared port).

The reference's mcpack is a Baidu-internal TLV format; reproducing its
exact bytes has no value outside Baidu.  What IS the capability — and
what this module provides — is the pipeline:

    schema -> generated codec source -> compiled codec -> wire bridge

* :func:`generate_codec_source` is the "protoc plugin": it takes a
  message schema and EMITS PYTHON SOURCE for a standalone codec class
  (inspect it, check it in, or exec it — like generated .pb.cc files).
* :func:`compile_codec` executes that source and returns the class.
* :class:`AltpackProtocol` registers the wire format on a Server's shared
  port through the user-protocol registry (≙ RegisterProtocol,
  protocol.h:186) and transcodes frames to/from a typed service handler,
  exactly how mcpack2pb lets a protobuf service serve mcpack clients.

Wire format (little-endian):
    magic "APK1" | u32 body_len | body
    body = fields; field = u16 id | u8 kind | u32 len | payload
    kinds: 0 = zigzag varint int, 1 = bytes, 2 = utf-8 str,
           3 = double (8 bytes), 4 = repeated (concatenated sub-fields)
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

MAGIC = b"APK1"

_KINDS = {"int": 0, "bytes": 1, "str": 2, "float": 3}


def _codec_name(message: str) -> str:
    return "".join(p.capitalize() for p in message.split("_")) + "Codec"


def generate_codec_source(message: str,
                          fields: List[Tuple[int, str, str]]) -> str:
    """Emit Python source for a codec class (the codegen half of the
    bridge, ≙ the generator emitting Serializer/Parser pairs).  `fields`
    is [(field_id, name, type)] with type in int|bytes|str|float or
    'repeated <type>'."""
    lines = [
        "# Generated by brpc_tpu_torch.rpc.altpack — do not edit.",
        f"# message {message}: " + ", ".join(
            f"{fid}:{name}:{ftype}" for fid, name, ftype in fields),
        "import struct",
        "",
        f"class {_codec_name(message)}:",
        f"    MESSAGE = {message!r}",
        f"    FIELDS = {fields!r}",
        "",
        "    @staticmethod",
        "    def _zz(v):",
        "        return (v << 1) ^ (v >> 63)",
        "",
        "    @staticmethod",
        "    def _unzz(v):",
        "        return (v >> 1) ^ -(v & 1)",
        "",
        "    @classmethod",
        "    def _pack_one(cls, fid, kind, payload, out):",
        "        out.append(struct.pack('<HBI', fid, kind, len(payload)))",
        "        out.append(payload)",
        "",
        "    @classmethod",
        "    def pack(cls, msg):",
        "        out = []",
    ]
    for fid, name, ftype in fields:
        rep = ftype.startswith("repeated ")
        base = ftype.split()[-1]
        kind = _KINDS[base]
        if base == "int":
            enc = "struct.pack('<Q', cls._zz(v) & 0xFFFFFFFFFFFFFFFF)"
        elif base == "float":
            enc = "struct.pack('<d', v)"
        elif base == "str":
            enc = "v.encode('utf-8')"
        else:
            enc = "v"
        if rep:
            lines += [
                f"        for v in msg.get({name!r}, ()):",
                f"            cls._pack_one({fid}, {kind}, {enc}, out)",
            ]
        else:
            lines += [
                f"        if {name!r} in msg:",
                f"            v = msg[{name!r}]",
                f"            cls._pack_one({fid}, {kind}, {enc}, out)",
            ]
    lines += [
        "        return b''.join(out)",
        "",
        "    @classmethod",
        "    def unpack(cls, data):",
        "        msg = {}",
        "        i = 0",
        "        while i + 7 <= len(data):",
        "            fid, kind, n = struct.unpack_from('<HBI', data, i)",
        "            i += 7",
        "            payload = data[i:i + n]",
        "            if len(payload) != n:",
        "                raise ValueError('truncated altpack field')",
        "            i += n",
        "            cls._store(fid, kind, payload, msg)",
        "        if i != len(data):",
        "            raise ValueError('trailing altpack bytes')",
        "        return msg",
        "",
        "    @classmethod",
        "    def _store(cls, fid, kind, payload, msg):",
    ]
    first = True
    for fid, name, ftype in fields:
        rep = ftype.startswith("repeated ")
        base = ftype.split()[-1]
        if base == "int":
            dec = "cls._unzz(struct.unpack('<Q', payload)[0])"
        elif base == "float":
            dec = "struct.unpack('<d', payload)[0]"
        elif base == "str":
            dec = "payload.decode('utf-8')"
        else:
            dec = "payload"
        kw = "if" if first else "elif"
        first = False
        lines.append(f"        {kw} fid == {fid}:")
        if rep:
            lines.append(
                f"            msg.setdefault({name!r}, []).append({dec})")
        else:
            lines.append(f"            msg[{name!r}] = {dec}")
    lines += [
        "        # unknown fields are skipped (forward compatibility)",
        "",
    ]
    return "\n".join(lines)


def compile_codec(message: str, fields: List[Tuple[int, str, str]]):
    """Codegen + exec in one step (tests/tools); production setups write
    generate_codec_source() output to a file like any generated code."""
    src = generate_codec_source(message, fields)
    ns: Dict[str, object] = {}
    exec(compile(src, f"<altpack:{message}>", "exec"), ns)
    return ns[_codec_name(message)]


# --- the wire bridge (≙ mcpack2pb's InputMessenger glue) -------------------

def frame(body: bytes) -> bytes:
    return MAGIC + struct.pack("<I", len(body)) + body


def parse(buf: bytes) -> int:
    """User-protocol parse hook: full frame length, 0 = need more,
    -1 = not altpack."""
    if len(buf) < 4:
        return 0 if MAGIC.startswith(buf[:len(buf)]) else -1
    if buf[:4] != MAGIC:
        return -1
    if len(buf) < 8:
        return 0
    (n,) = struct.unpack_from("<I", buf, 4)
    if n > 64 << 20:
        return -1
    return 8 + n if len(buf) >= 8 + n else 0


class AltpackProtocol:
    """Serve altpack frames on a Server's shared port: requests decode
    through the request codec, the typed handler returns a response dict,
    and the reply is re-framed — a second serialization format living
    beside TRPC/HTTP/redis, which is mcpack2pb's whole trick."""

    def __init__(self, request_codec, response_codec, handler):
        self._req = request_codec
        self._resp = response_codec
        self._handler = handler

    def register_on(self, server, name: str = "altpack") -> None:
        def on_frame(blob: bytes) -> bytes:
            msg = self._req.unpack(blob[8:])
            reply = self._handler(msg)
            return frame(self._resp.pack(reply))

        server.register_protocol(name, MAGIC, parse, on_frame)


def call(host: str, port: int, request_codec, response_codec, msg: dict,
         timeout_s: float = 5.0) -> dict:
    """Minimal altpack client (one frame per connection round-trip)."""
    import socket

    with socket.create_connection((host, port), timeout=timeout_s) as s:
        s.sendall(frame(request_codec.pack(msg)))
        buf = b""
        while True:
            n = parse(buf)
            if n > 0 and len(buf) >= n:
                return response_codec.unpack(buf[8:n])
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError("peer closed mid-frame")
            buf += chunk
