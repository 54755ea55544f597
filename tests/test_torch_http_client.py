"""The framework's own HTTP client (rpc/http_client.py over
native/src/rpc.cc http_client_call — ≙ brpc Channel with PROTOCOL_HTTP
plus ProgressiveReader).

Conformance: the client passes against the
framework's own server AND a stock HTTP server (python http.server); the
tools no longer import urllib for the data path.
"""

import http.server
import os
import threading

import pytest

from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.http import HttpResponse as SrvResp
from brpc_tpu_torch.rpc.http_client import HttpChannel
from brpc_tpu_torch.rpc.server import Server, ServerOptions

HERE = os.path.dirname(os.path.abspath(__file__))
CERT = os.path.join(HERE, "certs", "server.crt")
KEY = os.path.join(HERE, "certs", "server.key")


@pytest.fixture
def http_srv():
    srv = Server()
    srv.register_http("/hello",
                      lambda r: f"hi {r.query_params().get('n', '?')}")
    srv.register_http("/echo", lambda r: SrvResp.text(r.body.decode()))
    srv.register_http("/fail", lambda r: SrvResp.text("nope", 503))
    srv.start("127.0.0.1:0")
    yield srv
    srv.destroy()


class TestAgainstOwnServer:
    def test_get_post(self, http_srv):
        ch = HttpChannel(f"127.0.0.1:{http_srv.port}")
        r = ch.get("/hello?n=world")
        assert r.status == 200 and b"world" in r.body
        assert "content-length" in r.headers
        big = b"x" * 300_000
        r = ch.post("/echo", big)
        assert r.status == 200 and r.body == big
        r = ch.get("/fail")
        assert r.status == 503
        r = ch.get("/definitely-not-here")
        assert r.status == 404
        ch.close()

    def test_progressive_reader(self, http_srv):
        """stream= delivers the body as it arrives (≙ ProgressiveReader);
        the buffered body stays empty."""
        ch = HttpChannel(f"127.0.0.1:{http_srv.port}")
        chunks = []
        r = ch.get("/vars", stream=chunks.append)
        assert r.status == 200
        assert r.body == b""
        assert b"native_live_sockets" in b"".join(chunks)
        ch.close()

    def test_pipelined_shared_connection(self, http_srv):
        ch = HttpChannel(f"127.0.0.1:{http_srv.port}",
                         connection_type="single")
        oks = []
        lock = threading.Lock()

        def w(i):
            r = ch.get(f"/hello?n={i}")
            with lock:
                oks.append(r.status == 200 and str(i).encode() in r.body)

        ts = [threading.Thread(target=w, args=(i,)) for i in range(16)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert all(oks) and len(oks) == 16
        ch.close()

    def test_https(self):
        srv = Server(ServerOptions(tls_cert_file=CERT, tls_key_file=KEY))
        srv.register_http("/sec", lambda r: "secure")
        srv.start("127.0.0.1:0")
        try:
            ch = HttpChannel(f"127.0.0.1:{srv.port}", tls=True,
                             tls_ca=CERT)
            r = ch.get("/sec")
            assert r.status == 200 and r.body == b"secure"
            ch.close()
        finally:
            srv.destroy()

    def test_timeout_fails_connection_cleanly(self):
        srv = Server()
        gate = threading.Event()
        srv.register_http("/slow",
                          lambda r: (gate.wait(5), "late")[1])
        srv.start("127.0.0.1:0")
        try:
            ch = HttpChannel(f"127.0.0.1:{srv.port}")
            with pytest.raises(errors.RpcError):
                ch.get("/slow", timeout_ms=200)
            gate.set()
            # channel recovers on a fresh pooled connection
            r = ch.get("/slow")
            assert r.status == 200
            ch.close()
        finally:
            gate.set()
            srv.destroy()


class TestAgainstStockServer:
    @pytest.fixture
    def stock(self, tmp_path):
        (tmp_path / "f.txt").write_bytes(b"stock-server-file" * 100)
        handler = lambda *a, **k: http.server.SimpleHTTPRequestHandler(
            *a, directory=str(tmp_path), **k)
        httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        yield httpd.server_address[1]
        httpd.shutdown()

    def test_get_from_stock_server(self, stock):
        ch = HttpChannel(f"127.0.0.1:{stock}")
        r = ch.get("/f.txt")
        assert r.status == 200
        assert r.body == b"stock-server-file" * 100
        r = ch.get("/missing")
        assert r.status == 404
        ch.close()


class TestTools:
    def test_parallel_http_uses_framework_client(self, http_srv):
        import brpc_tpu_torch.tools.parallel_http as ph
        assert "urllib.request" not in open(ph.__file__).read().replace(
            "urlsplit", "")
        results = ph.fetch_all(
            [f"http://127.0.0.1:{http_srv.port}/hello?n={i}"
             for i in range(8)], concurrency=4)
        assert all(r.status == 200 for r in results), results

    def test_rpc_press_http_mode(self, http_srv):
        from brpc_tpu_torch.tools.rpc_press import press
        res = press(f"127.0.0.1:{http_srv.port}", "GET /hello",
                    b"", qps=0, concurrency=2, duration_s=0.5)
        assert res.calls > 10
        assert res.errors == 0
