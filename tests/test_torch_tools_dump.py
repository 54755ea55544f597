"""rpc_dump / recordio / tools — real in-process servers, real files
(≙ the reference testing rpc_dump via SampleIterator round-trips and
exercising tools against live servers), and the native
flight-recorder legs: C++ ring capture drained into the same segments,
v2-schema parity, the byte-for-byte replay cannon, and --speed overload
reproduction."""

import ctypes
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from brpc_tpu_torch._native import lib
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc import dump as dump_mod
from brpc_tpu_torch.rpc.dump import (RpcDumpContext, SampledRequest,
                               SampleIterator, drain_native)
from brpc_tpu_torch.rpc.server import Server, ServerOptions
from brpc_tpu_torch.utils import flags, recordio


@pytest.fixture
def server():
    srv = Server()
    srv.add_echo_service()
    srv.add_service("Upper", lambda cntl, req: req.upper())
    srv.start("127.0.0.1:0")
    yield srv
    srv.destroy()


def _native_counters():
    buf = ctypes.create_string_buffer(1 << 16)
    n = lib().trpc_native_metrics_dump(buf, len(buf))
    return dict((k, int(v)) for k, _, v in
                (ln.partition(" ")
                 for ln in buf.raw[:n].decode().splitlines()) if v)


@pytest.fixture
def native_dump_dir(tmp_path):
    """Arm the native flight recorder writing into tmp_path: fresh
    singleton drain context, rings drained of any leftovers, switch
    restored (off) and rings re-drained afterwards."""
    drain_native()  # clear leftovers from earlier tests in this process
    old_dir = flags.get_flag("rpc_dump_dir")
    flags.set_flag("rpc_dump_dir", str(tmp_path))
    old_ctx = dump_mod._native_ctx
    dump_mod._native_ctx = None
    lib().trpc_set_dump(1)
    lib().trpc_set_dump_budget(1 << 20)
    try:
        yield str(tmp_path)
    finally:
        lib().trpc_set_dump(0)
        drain_native()
        if dump_mod._native_ctx is not None:
            dump_mod._native_ctx.close()
        dump_mod._native_ctx = old_ctx
        flags.set_flag("rpc_dump_dir", old_dir)


class TestRecordio:
    def test_roundtrip(self, tmp_path):
        p = str(tmp_path / "r.rec")
        with recordio.RecordWriter(p) as w:
            for i in range(100):
                w.write(f"record-{i}".encode())
        got = list(recordio.read_records(p))
        assert got == [f"record-{i}".encode() for i in range(100)]

    def test_torn_tail_skipped(self, tmp_path):
        p = str(tmp_path / "r.rec")
        with recordio.RecordWriter(p) as w:
            w.write(b"good1")
            w.write(b"good2")
        with open(p, "ab") as f:
            f.write(b"TREC\xff\xff")  # torn header
        assert list(recordio.read_records(p)) == [b"good1", b"good2"]

    def test_corrupt_middle_resyncs(self, tmp_path):
        p = str(tmp_path / "r.rec")
        with recordio.RecordWriter(p) as w:
            w.write(b"a" * 50)
        size_one = os.path.getsize(p)
        with recordio.RecordWriter(p) as w:
            w.write(b"b" * 50)
        # corrupt a byte inside the first record's payload
        with open(p, "r+b") as f:
            f.seek(size_one - 10)
            f.write(b"\xff")
        got = list(recordio.read_records(p))
        assert got == [b"b" * 50]


class TestRpcDump:
    def test_sampled_request_roundtrip(self):
        s = SampledRequest("M.x", b"payload", b"att", 1)
        s2 = SampledRequest.deserialize(s.serialize())
        assert (s2.method, s2.payload, s2.attachment,
                s2.compress_type) == ("M.x", b"payload", b"att", 1)

    def test_v2_roundtrip_all_meta_fields(self):
        s = SampledRequest("M.y", b"wire-bytes", b"at", compress_type=1,
                           timestamp=1723.5, trace_id=0xabc, span_id=0xdef,
                           payload_codec=2, attach_codec=3,
                           stream_id=77, stream_frame_type=0)
        blob = s.serialize()
        assert blob[0] == dump_mod.SCHEMA_V2
        s2 = SampledRequest.deserialize(blob)
        assert (s2.trace_id, s2.span_id, s2.payload_codec, s2.attach_codec,
                s2.stream_id, s2.stream_frame_type) == (0xabc, 0xdef, 2, 3,
                                                        77, 0)
        assert (s2.payload, s2.attachment, s2.compress_type,
                s2.timestamp) == (b"wire-bytes", b"at", 1, 1723.5)

    def test_v1_blob_still_deserializes(self):
        # v1 records: no version byte, no codec/trace/stream
        # meta — old capture sets must keep replaying
        import json
        head = json.dumps({"method": "Old", "compress_type": 0,
                           "timestamp": 1.0, "payload_len": 3,
                           "attachment_len": 2}).encode()
        blob = b"%d\n%s%s%s" % (len(head), head, b"pay", b"at")
        s = SampledRequest.deserialize(blob)
        assert (s.method, s.payload, s.attachment) == ("Old", b"pay", b"at")
        assert (s.trace_id, s.payload_codec, s.stream_id,
                s.stream_frame_type) == (0, 0, 0, 0)
        with pytest.raises(ValueError):
            SampledRequest.deserialize(b"\x7fnot-a-sample")

    def test_dump_and_iterate(self, tmp_path):
        flags.set_flag("rpc_dump", True)
        try:
            ctx = RpcDumpContext(str(tmp_path))
            for i in range(10):
                assert ctx.sample(SampledRequest("Echo.echo",
                                                 f"req{i}".encode()))
            ctx.close()
            got = list(SampleIterator(str(tmp_path)))
            assert [g.payload for g in got] == \
                [f"req{i}".encode() for i in range(10)]
        finally:
            flags.set_flag("rpc_dump", False)

    def test_rotation(self, tmp_path):
        flags.set_flag("rpc_dump", True)
        old = flags.get_flag("rpc_dump_max_requests_in_one_file")
        flags.set_flag("rpc_dump_max_requests_in_one_file", 5)
        try:
            ctx = RpcDumpContext(str(tmp_path))
            for i in range(12):
                ctx.sample(SampledRequest("M", b"x"))
            ctx.close()
            files = [f for f in os.listdir(tmp_path)
                     if f.startswith("requests.")]
            assert len(files) == 3  # 5 + 5 + 2
            assert len(list(SampleIterator(str(tmp_path)))) == 12
        finally:
            flags.set_flag("rpc_dump_max_requests_in_one_file", old)
            flags.set_flag("rpc_dump", False)

    def test_iterator_resyncs_past_torn_tail(self, tmp_path):
        # a writer killed mid-record leaves a torn recordio tail; the
        # iterator must yield every complete sample and skip the wreck
        flags.set_flag("rpc_dump", True)
        try:
            ctx = RpcDumpContext(str(tmp_path))
            for i in range(6):
                assert ctx.sample(SampledRequest("T", f"p{i}".encode()))
            ctx.close()
        finally:
            flags.set_flag("rpc_dump", False)
        seg = sorted(f for f in os.listdir(tmp_path)
                     if f.startswith("requests."))[-1]
        with open(tmp_path / seg, "ab") as f:
            f.write(b"TREC\x99\x99\x99")  # torn header, no payload
        got = list(SampleIterator(str(tmp_path)))
        assert [g.payload for g in got] == \
            [f"p{i}".encode() for i in range(6)]

    def test_writer_sigkill_then_restart(self, tmp_path):
        # SIGKILL a dumping process mid-write, then resume capture in a
        # fresh process into the SAME dir: the survivors and the new
        # samples both iterate; nothing about the dead writer's last
        # segment wedges the set
        script = (
            "import sys, time\n"
            "from brpc_tpu_torch.rpc.dump import RpcDumpContext, SampledRequest\n"
            "from brpc_tpu_torch.utils import flags\n"
            "flags.set_flag('rpc_dump', True)\n"
            "ctx = RpcDumpContext(sys.argv[1])\n"
            "i = 0\n"
            "while True:\n"
            "    ctx.sample(SampledRequest('K', b'k%d' % i))\n"
            "    i += 1\n"
            "    if i == 4:\n"
            "        print('ready', flush=True)\n"
            "    time.sleep(0.01)\n")
        p = subprocess.Popen([sys.executable, "-c", script, str(tmp_path)],
                             stdout=subprocess.PIPE)
        try:
            assert p.stdout.readline().strip() == b"ready"
        finally:
            p.send_signal(signal.SIGKILL)
            p.wait(timeout=10)
        survivors = list(SampleIterator(str(tmp_path)))
        assert len(survivors) >= 4
        flags.set_flag("rpc_dump", True)
        try:
            ctx = RpcDumpContext(str(tmp_path))
            for i in range(3):
                assert ctx.sample(SampledRequest("R", b"resumed"))
            ctx.close()
        finally:
            flags.set_flag("rpc_dump", False)
        got = list(SampleIterator(str(tmp_path)))
        assert len(got) == len(survivors) + 3
        assert sum(1 for g in got if g.method == "R") == 3

    def test_server_dumps_live_requests(self, server, tmp_path):
        # turning the FLAG on arms the native flight recorder through
        # the validator, and the native plane (not the Python-path
        # sampler, which stands down while trpc_dump_active()) captures
        # the frame at the parse fiber — drain it into the segments
        drain_native()  # flush leftovers from earlier tests first
        old_dir = flags.get_flag("rpc_dump_dir")
        flags.set_flag("rpc_dump_dir", str(tmp_path))
        old_ctx, dump_mod._native_ctx = dump_mod._native_ctx, None
        flags.set_flag("rpc_dump", True)
        try:
            ch = Channel(f"127.0.0.1:{server.port}")
            ch.call("Upper", b"captured")
            ch.close()
            drain_native()
            samples = list(SampleIterator(str(tmp_path)))
            assert any(s.payload == b"captured" and s.method == "Upper"
                       for s in samples)
            # exactly once: the two capture planes must not both record
            # the same request into the segments
            assert sum(1 for s in samples if s.payload == b"captured"
                       and s.method == "Upper") == 1
        finally:
            flags.set_flag("rpc_dump", False)
            drain_native()
            if dump_mod._native_ctx is not None:
                dump_mod._native_ctx.close()
            dump_mod._native_ctx = old_ctx
            flags.set_flag("rpc_dump_dir", old_dir)


class TestNativeCapture:
    """The C++ flight recorder (native/src/dump.cc): parse-fiber capture
    drained through trpc_dump_drain into the SAME v2 segments the Python
    path writes — interchangeable to SampleIterator and the cannon."""

    def test_native_capture_to_segments(self, server, native_dump_dir):
        before = _native_counters()
        ch = Channel(f"127.0.0.1:{server.port}")
        for i in range(8):
            assert ch.call("Upper", b"captured-%d" % i) == b"CAPTURED-%d" % i
        ch.close()
        moved = drain_native()
        after = _native_counters()
        assert after["native_dump_captured"] - \
            before.get("native_dump_captured", 0) >= 8
        assert moved >= 8
        got = [s for s in SampleIterator(native_dump_dir)
               if s.method == "Upper"]
        assert len(got) >= 8
        # wire-form bytes: the un-decoded payload exactly as it arrived
        assert any(s.payload == b"captured-0" for s in got)
        assert all(s.timestamp > 0 for s in got)

    def test_capture_off_is_inert(self, server, native_dump_dir):
        lib().trpc_set_dump(0)
        before = _native_counters()
        ch = Channel(f"127.0.0.1:{server.port}")
        for _ in range(16):
            assert ch.call("Echo", b"quiet") == b"quiet"
        ch.close()
        after = _native_counters()
        # OFF is the bench-of-record posture: zero samples, zero drops —
        # the wire answer above already proves byte-identical behavior
        assert after.get("native_dump_captured", 0) == \
            before.get("native_dump_captured", 0)
        assert after.get("native_dump_dropped", 0) == \
            before.get("native_dump_dropped", 0)
        assert drain_native() == 0

    def test_captured_traffic_replays(self, server, native_dump_dir):
        from brpc_tpu_torch.tools.rpc_replay import replay
        ch = Channel(f"127.0.0.1:{server.port}")
        for i in range(5):
            ch.call("Upper", b"replayme-%d" % i)
        ch.close()
        assert drain_native() >= 5
        lib().trpc_set_dump(0)  # don't re-capture the replay itself
        res = replay(f"127.0.0.1:{server.port}", native_dump_dir,
                     speed=0.0, concurrency=2)
        assert res.samples >= 5
        assert res.calls == res.samples and res.errors == 0
        assert res.admitted == res.calls
        assert res.percentile(0.5) > 0

    def test_stream_session_capture_and_replay(self, native_dump_dir):
        from brpc_tpu_torch.tools.rpc_replay import replay_stream
        srv = Server()

        def pusher(cntl, req):
            st = cntl.accept_stream()

            def pump():
                try:
                    for i in range(5):
                        st.write(b"tok%d" % i)
                    st.close()
                except Exception:
                    pass

            threading.Thread(target=pump, daemon=True).start()
            return b"streaming"

        srv.add_service("Tokens", pusher)
        port = srv.start("127.0.0.1:0")
        # start() re-pushed the (off) rpc_dump flag state; re-arm the
        # native switch directly, as the fixture did
        lib().trpc_set_dump(1)
        try:
            ch = Channel(f"127.0.0.1:{port}")
            resp, st = ch.create_stream("Tokens", b"prompt")
            assert resp == b"streaming"
            toks = 0
            while st.read(timeout_s=10) is not None:
                toks += 1
            assert toks == 5
            st.destroy()
            ch.close()
            assert drain_native() >= 1
            opens = [s for s in SampleIterator(native_dump_dir)
                     if s.stream_id != 0 and s.stream_frame_type == 0]
            assert opens and opens[0].method == "Tokens"
            assert opens[0].payload == b"prompt"
            lib().trpc_set_dump(0)
            res = replay_stream(f"127.0.0.1:{port}", native_dump_dir,
                                loops=2, concurrency=2)
            assert res.sessions == len(opens) * 2
            assert res.completed == res.sessions and res.errors == 0
            assert res.tokens == 5 * res.sessions
            assert res.ttft_us and res.gap_us
        finally:
            srv.destroy()

    def test_replay_speed_drives_shedding(self, tmp_path):
        # the acceptance incident: a captured trickle replayed at high
        # speed must push the server's admission plane into ELIMIT sheds
        # (per-method cap), with admitted-only percentiles reported
        from brpc_tpu_torch.tools.rpc_replay import replay
        srv = Server(ServerOptions(method_max_concurrency={"Work": 1}))
        srv.add_service("Work", lambda cntl, req: (time.sleep(0.03),
                                                   b"done")[1])
        port = srv.start("127.0.0.1:0")
        try:
            ctx = RpcDumpContext(str(tmp_path))
            t0 = 1000.0
            for i in range(20):
                # synthetic capture: 10 rps trickle (timestamps control
                # the replay shape; write_blob keeps them verbatim)
                ctx.write_blob(SampledRequest(
                    "Work", b"w%d" % i, timestamp=t0 + i * 0.1).serialize())
            ctx.close()
            before = _native_counters()
            res = replay(f"127.0.0.1:{port}", str(tmp_path),
                         speed=50.0, loops=2, concurrency=8,
                         timeout_ms=5000.0)
            after = _native_counters()
            assert res.samples == 20 and res.calls == 40
            assert res.shed > 0, "speed-up never tripped the method cap"
            assert res.admitted > 0 and res.errors == 0
            assert res.percentile(0.99) >= res.percentile(0.5) > 0
            assert after["native_overload_rejects"] - \
                before.get("native_overload_rejects", 0) >= res.shed
            line = res.to_json_line()
            import json
            d = json.loads(line)
            assert d["metric"] == "rpc_replay" and d["shed"] == res.shed
            assert d["p50_us"] > 0 and d["speed"] == 50.0
        finally:
            srv.destroy()

    def test_replay_paces_to_captured_shape(self, server, tmp_path):
        # 20 samples captured 50ms apart replayed at 2x must take about
        # (19 * 50ms) / 2 ≈ 475ms — not flat-out, not the full second
        from brpc_tpu_torch.tools.rpc_replay import replay
        ctx = RpcDumpContext(str(tmp_path))
        for i in range(20):
            ctx.write_blob(SampledRequest(
                "Echo", b"p", timestamp=500.0 + i * 0.05).serialize())
        ctx.close()
        res = replay(f"127.0.0.1:{server.port}", str(tmp_path),
                     speed=2.0, concurrency=4)
        assert res.calls == 20 and res.errors == 0
        assert 0.3 <= res.wall_s <= 2.0

    def test_sched_seed_pairing(self, server, tmp_path):
        # --sched-seed arms the PR-6 replay seed before traffic and is
        # echoed in the result line (capture+seed = reproducible incident)
        from brpc_tpu_torch.tools.rpc_replay import replay
        old = flags.get_flag("sched_seed")
        ctx = RpcDumpContext(str(tmp_path))
        ctx.write_blob(SampledRequest("Echo", b"s").serialize())
        ctx.close()
        try:
            res = replay(f"127.0.0.1:{server.port}", str(tmp_path),
                         sched_seed=12345)
            assert res.errors == 0
            assert flags.get_flag("sched_seed") == 12345
            import json
            assert json.loads(res.to_json_line())["sched_seed"] == 12345
        finally:
            flags.set_flag("sched_seed", old)


class TestTools:
    def test_rpc_press(self, server):
        from brpc_tpu_torch.tools.rpc_press import press
        res = press(f"127.0.0.1:{server.port}", "Echo.echo", b"x" * 64,
                    qps=0, concurrency=2, duration_s=0.5)
        assert res.calls > 10 and res.errors == 0
        assert res.percentile(0.5) > 0

    def test_rpc_press_grpc_mode(self, server):
        # ≙ rpc_press pressing a gRPC service through the framework's own
        # h2 client (no grpcio)
        from brpc_tpu_torch.rpc.server import Server
        from brpc_tpu_torch.tools.rpc_press import press
        srv = Server()
        srv.add_grpc_service("press.Echo",
                             {"Hit": lambda cntl, req: req})
        srv.start("127.0.0.1:0")
        try:
            res = press(f"127.0.0.1:{srv.port}", "press.Echo/Hit", b"pp",
                        qps=0, concurrency=2, duration_s=0.5,
                        protocol="grpc")
            assert res.calls > 5 and res.errors == 0
        finally:
            srv.destroy()

    def test_rpc_press_paced(self, server):
        from brpc_tpu_torch.tools.rpc_press import press
        res = press(f"127.0.0.1:{server.port}", "Echo.echo", b"x",
                    qps=50, concurrency=2, duration_s=1.0)
        # paced run should land near the target, not at line rate
        assert 10 <= res.qps <= 120

    def test_rpc_replay(self, server, tmp_path):
        from brpc_tpu_torch.tools.rpc_replay import replay
        flags.set_flag("rpc_dump", True)
        try:
            ctx = RpcDumpContext(str(tmp_path))
            for i in range(5):
                ctx.sample(SampledRequest("Upper", f"r{i}".encode()))
            ctx.close()
        finally:
            flags.set_flag("rpc_dump", False)
        res = replay(f"127.0.0.1:{server.port}", str(tmp_path), loops=2)
        assert res.samples == 5 and res.calls == 10 and res.errors == 0

    def test_rpc_view_renders_dump(self, tmp_path, capsys):
        from brpc_tpu_torch.tools.rpc_view import view_dump
        ctx = RpcDumpContext(str(tmp_path))
        ctx.write_blob(SampledRequest("Render", b"xyz", b"at",
                                      compress_type=1, timestamp=1000.0,
                                      trace_id=0xbeef,
                                      payload_codec=2).serialize())
        ctx.write_blob(SampledRequest("Render", b"q", timestamp=1001.0,
                                      stream_id=9).serialize())
        ctx.close()
        assert view_dump(str(tmp_path)) == 2
        out = capsys.readouterr().out
        assert "Render" in out and "payload=3B" in out
        assert "attach=2B" in out and "compress=1" in out
        assert "000000000000beef" in out and "stream-open" in out
        assert "2 samples: Render=2" in out

    def test_rpc_view_proxies_portal(self, server):
        import urllib.request
        from brpc_tpu_torch.tools.rpc_view import make_proxy
        proxy = make_proxy(f"127.0.0.1:{server.port}")
        proxy.start("127.0.0.1:0")
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{proxy.port}/health", timeout=5).read()
            assert body == b"OK\n"
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{proxy.port}/vars?filter=fiber",
                timeout=5).read()
            assert b"fiber" in body
        finally:
            proxy.destroy()

    def test_parallel_http(self, server):
        from brpc_tpu_torch.tools.parallel_http import fetch_all
        base = f"http://127.0.0.1:{server.port}"
        urls = [f"{base}/health", f"{base}/version", f"{base}/nope"]
        results = fetch_all(urls, concurrency=3)
        statuses = {r.url.rsplit("/", 1)[1]: r.status for r in results}
        assert statuses["health"] == 200
        assert statuses["version"] == 200
        assert statuses["nope"] == 404
