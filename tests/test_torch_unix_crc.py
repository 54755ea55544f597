"""Unix-domain listeners (§5.8 comm-backend breadth ≙ brpc unix-socket
EndPoints) + CRC-32C conformance against published test vectors."""

import os
import socket
import tempfile

import pytest

from brpc_tpu_torch.rpc.channel import Channel
from brpc_tpu_torch.rpc.server import Server
from brpc_tpu_torch.utils.checksum import crc32c, crc32c_hardware


@pytest.fixture
def unix_path():
    d = tempfile.mkdtemp(prefix="brpc_tpu_uds_")
    yield os.path.join(d, "rpc.sock")
    for f in os.listdir(d):
        try:
            os.unlink(os.path.join(d, f))
        except OSError:
            pass
    os.rmdir(d)


class TestUnixSockets:
    def test_trpc_over_unix(self, unix_path):
        srv = Server()
        srv.add_echo_service()
        srv.add_service("Upper", lambda cntl, req: req.upper())
        srv.start(f"unix:{unix_path}")
        try:
            assert os.path.exists(unix_path)
            ch = Channel(f"unix:{unix_path}")
            assert ch.call("Echo.echo", b"via-uds") == b"via-uds"
            assert ch.call("Upper", b"abc") == b"ABC"
            ch.close()
        finally:
            srv.destroy()
        assert not os.path.exists(unix_path)  # destroy unlinks the file

    def test_http_over_unix(self, unix_path):
        # the shared-port sniffer works identically on a unix listener
        srv = Server()
        srv.add_echo_service()
        srv.start(unix_path)  # bare path form
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(unix_path)
            s.sendall(b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n")
            data = b""
            while b"OK\n" not in data:
                chunk = s.recv(4096)
                if not chunk:
                    break
                data += chunk
            assert b"HTTP/1.1 200" in data
            s.close()
        finally:
            srv.destroy()

    def test_stale_socket_file_replaced(self, unix_path):
        # a leftover socket file from a crashed process must not block
        # the next start (server_start unlinks before bind)
        with open(unix_path, "w") as f:
            f.write("stale")
        srv = Server()
        srv.add_echo_service()
        srv.start(f"unix:{unix_path}")
        try:
            ch = Channel(f"unix:{unix_path}")
            assert ch.call("Echo.echo", b"x") == b"x"
            ch.close()
        finally:
            srv.destroy()


class TestCrc32c:
    def test_published_vectors(self):
        # RFC 3720 appendix B.4 / crc32c reference vectors
        assert crc32c(b"") == 0
        assert crc32c(b"a") == 0xC1D04330
        assert crc32c(b"123456789") == 0xE3069283
        assert crc32c(b"\x00" * 32) == 0x8A9136AA
        assert crc32c(b"\xff" * 32) == 0x62A8AB43

    def test_streaming_matches_one_shot(self):
        data = os.urandom(100000)
        whole = crc32c(data)
        running = 0
        for i in range(0, len(data), 7919):
            running = crc32c(data[i:i + 7919], running)
        assert running == whole

    def test_hardware_flag_is_bool(self):
        assert crc32c_hardware() in (True, False)


class TestUnixLiveness:
    def test_second_server_on_live_path_fails(self, unix_path):
        # unlike a stale file, a LIVE listener must produce EADDRINUSE —
        # the unconditional-unlink failure mode would silently steal the
        # path from the running server
        srv1 = Server()
        srv1.add_echo_service()
        srv1.start(f"unix:{unix_path}")
        try:
            srv2 = Server()
            srv2.add_echo_service()
            with pytest.raises(OSError):
                srv2.start(f"unix:{unix_path}")
            srv2.destroy()
            # first server unharmed
            ch = Channel(f"unix:{unix_path}")
            assert ch.call("Echo.echo", b"alive") == b"alive"
            ch.close()
        finally:
            srv1.destroy()

    def test_empty_unix_path_rejected(self):
        srv = Server()
        srv.add_echo_service()
        with pytest.raises(ValueError):
            srv.start("unix:")
        srv.destroy()
