"""altpack: the second serialization bridge with codegen standing in for
mcpack2pb's capability (≙ mcpack2pb/generator.cpp:1424 + its service
glue).  Real checks: the generator emits inspectable source, the codec
round-trips every type, and an altpack client talks to a brpc_tpu_torch server
on the SHARED port next to TRPC."""

import pytest

from brpc_tpu_torch.rpc import altpack
from brpc_tpu_torch.rpc.channel import Channel
from brpc_tpu_torch.rpc.server import Server

SCHEMA_REQ = [(1, "op", "str"), (2, "a", "int"), (3, "b", "int"),
              (4, "tags", "repeated str"), (5, "blob", "bytes"),
              (6, "scale", "float")]
SCHEMA_RESP = [(1, "result", "int"), (2, "echoed", "repeated str"),
               (3, "scaled", "float")]


def test_generator_emits_real_source():
    src = altpack.generate_codec_source("calc_request", SCHEMA_REQ)
    assert "class CalcRequestCodec" in src
    assert "Generated by brpc_tpu_torch.rpc.altpack" in src
    # the emitted source stands alone (like a generated .pb file)
    ns = {}
    exec(compile(src, "<gen>", "exec"), ns)
    codec = ns["CalcRequestCodec"]
    msg = {"op": "add", "a": -7, "b": 35, "tags": ["x", "y"],
           "blob": b"\x00\xff", "scale": 2.5}
    assert codec.unpack(codec.pack(msg)) == msg


def test_codec_skips_unknown_fields():
    codec = altpack.compile_codec("calc_request", SCHEMA_REQ)
    import struct
    extra = struct.pack("<HBI", 99, 1, 3) + b"xyz"  # unknown field 99
    data = codec.pack({"op": "noop"}) + extra
    assert codec.unpack(data) == {"op": "noop"}


def test_codec_rejects_truncation():
    codec = altpack.compile_codec("calc_request", SCHEMA_REQ)
    data = codec.pack({"op": "add", "a": 1})
    with pytest.raises(ValueError):
        codec.unpack(data[:-1])


def test_altpack_service_on_shared_port():
    req_codec = altpack.compile_codec("calc_request", SCHEMA_REQ)
    resp_codec = altpack.compile_codec("calc_response", SCHEMA_RESP)

    def handler(msg):
        assert msg["op"] == "add"
        return {"result": msg["a"] + msg["b"],
                "echoed": list(msg.get("tags", [])),
                "scaled": msg.get("scale", 1.0) * 2}

    srv = Server()
    srv.add_service("Echo", lambda cntl, req: req)
    altpack.AltpackProtocol(req_codec, resp_codec, handler).register_on(srv)
    srv.start("127.0.0.1:0")
    try:
        # the altpack client and a TRPC client share one port
        out = altpack.call("127.0.0.1", srv.port, req_codec, resp_codec,
                           {"op": "add", "a": 40, "b": 2,
                            "tags": ["t1", "t2"], "scale": 1.5})
        assert out == {"result": 42, "echoed": ["t1", "t2"], "scaled": 3.0}
        ch = Channel(f"127.0.0.1:{srv.port}")
        assert ch.call("Echo", b"trpc-too") == b"trpc-too"
        ch.close()
    finally:
        srv.destroy()
