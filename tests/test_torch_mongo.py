"""Mongo wire head (≙ policy/mongo_protocol.cpp:298 — protocol parsing
and command dispatch; neither we nor the reference implement a
database).  BSON is pinned with hand-computed byte vectors, the OP_MSG
path with a real server+client round trip."""

import struct

import pytest

from brpc_tpu_torch.rpc.mongo import (MongoClient, MongoError, MongoService,
                                bson_decode, bson_encode, pack_op_msg,
                                parse_op_msg)


class TestBson:
    def test_int32_vector(self):
        # {"a": 1}: len=12 | 0x10 'a' 00 | 01000000 | 00
        blob = bson_encode({"a": 1})
        assert blob == bytes.fromhex("0c000000") + b"\x10a\x00" + \
            struct.pack("<i", 1) + b"\x00"
        doc, off = bson_decode(blob)
        assert doc == {"a": 1} and off == len(blob)

    def test_string_vector(self):
        # {"s": "hi"}: 0x02 's' 00 | len 3 | "hi\0"
        blob = bson_encode({"s": "hi"})
        assert blob[4:5] == b"\x02"
        assert b"hi\x00" in blob
        assert bson_decode(blob)[0] == {"s": "hi"}

    def test_all_types_round_trip(self):
        doc = {"d": 2.5, "s": "héllo", "n": None, "b": True,
               "i32": 42, "i64": 1 << 40,
               "sub": {"x": 1}, "arr": [1, "two", {"three": 3}]}
        out, _ = bson_decode(bson_encode(doc))
        assert out == doc

    def test_nested_depth(self):
        doc = {"a": {"b": {"c": {"d": [1, 2, [3, 4]]}}}}
        assert bson_decode(bson_encode(doc))[0] == doc


class TestOpMsg:
    def test_frame_round_trip(self):
        frame = pack_op_msg({"ping": 1}, request_id=7)
        req_id, flags, doc = parse_op_msg(frame)
        assert req_id == 7 and flags == 0 and doc == {"ping": 1}
        # header fields: length, id, responseTo, opCode 2013
        mlen, rid, rto, op = struct.unpack_from("<iiii", frame)
        assert mlen == len(frame) and op == 2013

    def test_bad_opcode_rejected(self):
        frame = bytearray(pack_op_msg({"ping": 1}, 1))
        struct.pack_into("<i", frame, 12, 2004)  # legacy OP_QUERY
        with pytest.raises(MongoError):
            parse_op_msg(bytes(frame))


@pytest.fixture
def mongo_server():
    svc = MongoService()
    store = {}

    def insert(doc):
        for d in doc.get("documents", []):
            store[d["_id"]] = d
        return {"n": len(doc.get("documents", [])), "ok": 1}

    def find(doc):
        out = [store[k] for k in sorted(store)]
        return {"cursor": {"firstBatch": out, "id": 0}, "ok": 1}

    svc.register("insert", insert)
    svc.register("find", find)
    svc.start("127.0.0.1", 0)
    yield svc, store
    svc.stop()


class TestMongoEndToEnd:
    def test_handshake_and_ping(self, mongo_server):
        svc, _ = mongo_server
        c = MongoClient("127.0.0.1", svc.port)
        h = c.hello()
        assert h["ok"] == 1 and h["isWritablePrimary"] is True
        assert h["maxWireVersion"] >= 6  # OP_MSG era
        assert c.ping() is True
        c.close()

    def test_command_round_trip(self, mongo_server):
        svc, store = mongo_server
        c = MongoClient("127.0.0.1", svc.port)
        r = c.command({"insert": "things", "documents": [
            {"_id": 1, "name": "alpha"}, {"_id": 2, "name": "beta"}]})
        assert r == {"n": 2, "ok": 1}
        assert store[1]["name"] == "alpha"
        r = c.command({"find": "things"})
        names = [d["name"] for d in r["cursor"]["firstBatch"]]
        assert names == ["alpha", "beta"]
        c.close()

    def test_unknown_command_error_doc(self, mongo_server):
        svc, _ = mongo_server
        c = MongoClient("127.0.0.1", svc.port)
        r = c.command({"definitelyNot": 1})
        assert r["ok"] == 0 and r["code"] == 59
        assert "definitelyNot" in r["errmsg"]
        # connection survives the error
        assert c.ping()
        c.close()
