"""Memcache binary-protocol client conformance (≙ brpc
memcache_unittest run against memcached; no memcached in this image, so
the fixture is a spec-faithful in-process binary-protocol server —
including the quiet-op reply rules the batching relies on)."""

import socket
import struct
import threading
import time

import pytest

from brpc_tpu_torch.rpc.memcache import (MemcacheBatch, MemcacheClient,
                                   MemcacheError, Op, Status, _HDR,
                                   _REQ_MAGIC, _RES_MAGIC)


class MiniMemcached:
    """Enough of the memcached binary protocol to conformance-test the
    client: get/set/add/replace/delete/incr/decr/append/prepend/touch/
    version/flush/noop + quiet variants with their reply suppression."""

    def __init__(self):
        self.store = {}   # key -> [flags, value, cas]
        self.cas_counter = 0
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                hdr = self._recv_exact(conn, _HDR.size)
                if hdr is None:
                    return
                magic, op, klen, elen, _dt, _vb, blen, opaque, cas = \
                    _HDR.unpack(hdr)
                assert magic == _REQ_MAGIC
                body = self._recv_exact(conn, blen) if blen else b""
                if body is None and blen:
                    return
                extras = body[:elen]
                key = body[elen:elen + klen]
                value = body[elen + klen:]
                if op == Op.QUIT:
                    return
                resp = self._handle(op, key, extras, value, cas, opaque)
                if resp is not None:
                    conn.sendall(resp)
        except (ConnectionError, OSError, AssertionError):
            pass
        finally:
            conn.close()

    def _reply(self, op, status, opaque, key=b"", extras=b"", value=b"",
               cas=0):
        body = len(extras) + len(key) + len(value)
        return _HDR.pack(_RES_MAGIC, op, len(key), len(extras), 0, status,
                         body, opaque, cas) + extras + key + value

    def _handle(self, op, key, extras, value, cas, opaque):
        quiet = op in (Op.GETQ, Op.GETKQ, Op.SETQ, Op.ADDQ, Op.REPLACEQ,
                       Op.DELETEQ, Op.INCREMENTQ, Op.DECREMENTQ)
        base = {Op.GETQ: Op.GETQ, Op.GETKQ: Op.GETKQ, Op.SETQ: Op.SET,
                Op.ADDQ: Op.ADD, Op.REPLACEQ: Op.REPLACE,
                Op.DELETEQ: Op.DELETE, Op.INCREMENTQ: Op.INCREMENT,
                Op.DECREMENTQ: Op.DECREMENT}.get(op, op)

        if base in (Op.GET, Op.GETK, Op.GETQ, Op.GETKQ):
            ent = self.store.get(key)
            if ent is None:
                if quiet:
                    return None  # quiet get: silent miss
                return self._reply(op, Status.KEY_NOT_FOUND, opaque,
                                   value=b"Not found")
            flags, val, kcas = ent
            rkey = key if base in (Op.GETK, Op.GETKQ) else b""
            return self._reply(op, Status.OK, opaque, key=rkey,
                               extras=struct.pack("!I", flags), value=val,
                               cas=kcas)
        if base in (Op.SET, Op.ADD, Op.REPLACE):
            flags, _expt = struct.unpack("!II", extras)
            ent = self.store.get(key)
            if base == Op.ADD and ent is not None:
                return self._reply(op, Status.KEY_EXISTS, opaque,
                                   value=b"Data exists for key.")
            if base == Op.REPLACE and ent is None:
                return self._reply(op, Status.KEY_NOT_FOUND, opaque,
                                   value=b"Not found")
            if cas and (ent is None or ent[2] != cas):
                return self._reply(op, Status.KEY_EXISTS, opaque,
                                   value=b"Data exists for key.")
            self.cas_counter += 1
            self.store[key] = [flags, value, self.cas_counter]
            if quiet:
                return None
            return self._reply(op, Status.OK, opaque, cas=self.cas_counter)
        if base == Op.DELETE:
            if self.store.pop(key, None) is None:
                return self._reply(op, Status.KEY_NOT_FOUND, opaque,
                                   value=b"Not found")
            if quiet:
                return None
            return self._reply(op, Status.OK, opaque)
        if base in (Op.INCREMENT, Op.DECREMENT):
            delta, initial, expt = struct.unpack("!QQI", extras)
            ent = self.store.get(key)
            if ent is None:
                if expt == 0xFFFFFFFF:
                    return self._reply(op, Status.KEY_NOT_FOUND, opaque,
                                       value=b"Not found")
                cur = initial
            else:
                try:
                    cur = int(ent[1])
                except ValueError:
                    return self._reply(op, Status.NON_NUMERIC, opaque,
                                       value=b"Non-numeric value")
                cur = cur + delta if base == Op.INCREMENT else \
                    max(0, cur - delta)
            self.cas_counter += 1
            self.store[key] = [0, str(cur).encode(), self.cas_counter]
            if quiet:
                return None
            return self._reply(op, Status.OK, opaque,
                               value=struct.pack("!Q", cur),
                               cas=self.cas_counter)
        if base in (Op.APPEND, Op.PREPEND):
            ent = self.store.get(key)
            if ent is None:
                return self._reply(op, Status.ITEM_NOT_STORED, opaque,
                                   value=b"Not stored.")
            ent[1] = ent[1] + value if base == Op.APPEND else value + ent[1]
            self.cas_counter += 1
            ent[2] = self.cas_counter
            return self._reply(op, Status.OK, opaque, cas=self.cas_counter)
        if base == Op.TOUCH:
            if key not in self.store:
                return self._reply(op, Status.KEY_NOT_FOUND, opaque,
                                   value=b"Not found")
            return self._reply(op, Status.OK, opaque)
        if base == Op.FLUSH:
            self.store.clear()
            return self._reply(op, Status.OK, opaque)
        if base == Op.VERSION:
            return self._reply(op, Status.OK, opaque, value=b"1.6.0-mini")
        if base == Op.NOOP:
            return self._reply(op, Status.OK, opaque)
        return self._reply(op, Status.UNKNOWN_COMMAND, opaque,
                           value=b"Unknown command")

    @staticmethod
    def _recv_exact(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def close(self):
        self._stop = True
        self._srv.close()


@pytest.fixture
def memcached():
    srv = MiniMemcached()
    yield srv
    srv.close()


@pytest.fixture
def client(memcached):
    c = MemcacheClient("127.0.0.1", memcached.port)
    yield c
    c.close()


class TestMemcacheClient:
    def test_set_get(self, client):
        cas = client.set("k", b"v1", flags=7)
        assert cas > 0
        assert client.get("k") == b"v1"
        assert client.get("missing") is None

    def test_add_replace_semantics(self, client):
        client.add("a", b"1")
        with pytest.raises(MemcacheError) as ei:
            client.add("a", b"2")
        assert ei.value.status == Status.KEY_EXISTS
        client.replace("a", b"3")
        assert client.get("a") == b"3"
        with pytest.raises(MemcacheError) as ei:
            client.replace("nope", b"x")
        assert ei.value.status == Status.KEY_NOT_FOUND

    def test_cas_round_trip(self, client):
        client.set("c", b"orig")
        val, cas = client.gets("c")
        assert val == b"orig" and cas > 0
        client.set("c", b"new", cas=cas)  # matching cas succeeds
        _, cas2 = client.gets("c")
        with pytest.raises(MemcacheError) as ei:
            client.set("c", b"stale", cas=cas)  # stale cas rejected
        assert ei.value.status == Status.KEY_EXISTS
        assert client.get("c") == b"new"
        assert cas2 != cas

    def test_delete(self, client):
        client.set("d", b"x")
        assert client.delete("d") is True
        assert client.delete("d") is False
        assert client.get("d") is None

    def test_incr_decr(self, client):
        assert client.incr("n", 5, initial=10) == 10  # absent -> initial
        assert client.incr("n", 5) == 15
        assert client.decr("n", 3) == 12
        assert client.decr("n", 100) == 0  # clamps at zero

    def test_append_prepend(self, client):
        client.set("s", b"mid")
        client.append("s", b"-end")
        client.prepend("s", b"start-")
        assert client.get("s") == b"start-mid-end"

    def test_touch_version_flush(self, client):
        client.set("t", b"x")
        assert client.touch("t", 100) is True
        assert client.touch("gone", 100) is False
        assert "mini" in client.version()
        client.flush_all()
        assert client.get("t") is None

    def test_multi_get_one_round_trip(self, client):
        for i in range(20):
            client.set(f"m{i}", f"v{i}".encode())
        got = client.multi_get([f"m{i}" for i in range(20)] + ["absent"])
        assert got == {f"m{i}".encode(): f"v{i}".encode() for i in range(20)}

    def test_batch_pipeline(self, client):
        b = client.batch()
        for i in range(10):
            b.set(f"b{i}", f"x{i}".encode())
        b.execute()
        b2 = client.batch()
        for i in range(10):
            b2.get(f"b{i}")
        b2.get("missing")  # silent miss
        b2.delete("b0")
        got = b2.execute()
        assert got == {f"b{i}".encode(): f"x{i}".encode() for i in range(10)}
        assert client.get("b0") is None

    def test_batch_error_surfaced(self, client):
        b = client.batch()
        b.set("ok-key", b"v")
        b.delete("never-existed")
        b.execute()
        # error replies carry no key on the wire; attribution comes from
        # the opaque the batch packed into each op
        assert b.errors == [(b"never-existed", Status.KEY_NOT_FOUND)]

    def test_binary_values(self, client):
        blob = bytes(range(256)) * 40
        client.set("bin", blob)
        assert client.get("bin") == blob
