"""Framework-native HTTP/2 + gRPC client (≙ the client half of
policy/http2_rpc_protocol.cpp; gRPC semantics of grpc.h:208) against the
framework's own h2 server — multiplexing, flow control, trailers."""

import threading

import pytest

from brpc_tpu_torch.rpc.h2_client import GrpcChannel, GrpcError, H2Channel
from brpc_tpu_torch.rpc.http import HttpResponse
from brpc_tpu_torch.rpc.server import Server
from brpc_tpu_torch.rpc import errors


@pytest.fixture
def h2_server():
    def fail(cntl, req):
        from brpc_tpu_torch.rpc.errors import RpcError
        raise RpcError(errors.EINTERNAL, "deliberate grpc failure")

    srv = Server()
    srv.add_echo_service()
    srv.register_http("/big", lambda req: HttpResponse(
        200, {"Content-Type": "application/octet-stream"},
        bytes(range(256)) * 8192))  # 2MB response
    srv.register_http("/echo_body", lambda req: req.body)
    srv.add_grpc_service("t.Svc", {
        "Echo": lambda cntl, req: req,
        "Fail": fail,
    })
    srv.start("127.0.0.1:0")
    yield srv
    srv.destroy()


class TestH2Client:
    def test_get(self, h2_server):
        c = H2Channel(f"127.0.0.1:{h2_server.port}")
        r = c.get("/health")
        assert r.status == 200 and r.body == b"OK\n"
        assert "content-type" in r.headers
        c.close()

    def test_multiplexed_calls_one_connection(self, h2_server):
        c = H2Channel(f"127.0.0.1:{h2_server.port}")
        results = {}

        def worker(i):
            body = f"payload-{i}".encode() * 100
            r = c.post("/echo_body", body=body)
            results[i] = (r.status, r.body == body)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert all(v == (200, True) for v in results.values()), results
        c.close()

    def test_large_response_flow_control(self, h2_server):
        c = H2Channel(f"127.0.0.1:{h2_server.port}")
        r = c.get("/big", timeout_ms=20000)
        assert r.status == 200
        assert r.body == bytes(range(256)) * 8192
        c.close()

    def test_large_request_body(self, h2_server):
        # bigger than the peer's 65535 default window: exercises the
        # client-side send flow control wait loop
        c = H2Channel(f"127.0.0.1:{h2_server.port}")
        body = b"q" * (1 << 20)
        r = c.post("/echo_body", body=body, timeout_ms=20000)
        assert r.status == 200 and r.body == body
        c.close()

    def test_404(self, h2_server):
        c = H2Channel(f"127.0.0.1:{h2_server.port}")
        assert c.get("/nope").status == 404
        c.close()

    def test_connect_refused(self):
        with pytest.raises(errors.RpcError):
            H2Channel("127.0.0.1:1")  # nothing listens there


class TestGrpcClient:
    def test_unary_echo(self, h2_server):
        g = GrpcChannel(f"127.0.0.1:{h2_server.port}")
        assert g.call("t.Svc", "Echo", b"hello grpc") == b"hello grpc"
        g.close()

    def test_error_status_in_trailers(self, h2_server):
        g = GrpcChannel(f"127.0.0.1:{h2_server.port}")
        with pytest.raises(GrpcError) as ei:
            g.call("t.Svc", "Fail", b"")
        assert ei.value.code != 0
        # channel still usable after an errored call
        assert g.call("t.Svc", "Echo", b"next") == b"next"
        g.close()

    def test_unknown_method(self, h2_server):
        g = GrpcChannel(f"127.0.0.1:{h2_server.port}")
        with pytest.raises(GrpcError):
            g.call("t.Svc", "Missing", b"")
        g.close()

    def test_sequential_calls_reuse_connection(self, h2_server):
        g = GrpcChannel(f"127.0.0.1:{h2_server.port}")
        for i in range(50):
            assert g.call("t.Svc", "Echo", f"m{i}".encode()) == \
                f"m{i}".encode()
        g.close()


class TestH2OverTls:
    def test_h2_and_grpc_over_tls(self):
        """The framework's own h2 client over TLS against its own TLS
        server (≙ gRPC-with-credentials; the native TLS engine wraps the
        frames transparently on both sides)."""
        import os
        from brpc_tpu_torch.rpc.server import ServerOptions
        certs = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests", "certs")
        srv = Server(ServerOptions(
            tls_cert_file=os.path.join(certs, "server.crt"),
            tls_key_file=os.path.join(certs, "server.key")))
        srv.add_echo_service()
        srv.register_http("/secret", lambda req: b"tls-h2-ok")
        srv.add_grpc_service("s.Tls", {"Echo": lambda cntl, req: req})
        srv.start("127.0.0.1:0")
        try:
            c = H2Channel(f"127.0.0.1:{srv.port}", tls=True,
                          tls_verify=False)
            r = c.get("/secret")
            assert r.status == 200 and r.body == b"tls-h2-ok"
            c.close()

            g = GrpcChannel(f"127.0.0.1:{srv.port}", tls=True,
                            tls_verify=False)
            assert g.call("s.Tls", "Echo", b"over-tls") == b"over-tls"
            # 1MB request+response: h2 flow control under TLS record
            # fragmentation in both directions
            big = b"t" * (1 << 20)
            assert g.call("s.Tls", "Echo", big, timeout_ms=30000) == big
            g.close()
        finally:
            srv.destroy()
