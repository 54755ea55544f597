#!/usr/bin/env python
"""Benchmark of the PyTorch/CUDA port (bench.py on brpc_tpu_torch):
echo QPS over the native loopback transport, and its A/B arms.

Mirrors the reference's headline benchmark (docs/cn/benchmark.md:7 — echo
QPS on one machine, 1M-5M on 24 HT cores ⇒ ~41.7k QPS/core at the low end).
The whole hot path is native (native/src/rpc.cc run_echo_bench, compiled
into the port's core, brpc_tpu_torch._native.lib(), with the CUDA device
plane in place of the PJRT one): fibers, wait-free socket writes, TRPC
framing; Python only launches it.  Every flag keeps bench.py's meaning;
the arms that need a device or a mesh run on the port:

    --serving / --serving-arm rail,codec
        the continuous-batching engine over a world of ranks
        (entry.launch_world): on the cards one NCCL rank per card, with
        --device cpu 8 gloo ranks at dp2 x tp4 (bench.py:79), the
        leader's plane on the fake CUDA driver
    --codec-ab
        its allreduce legs run examples/param_server_allreduce_torch.py

    python bench_torch.py --serving-arm auto,none --brief --device cpu

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
vs_baseline = our QPS/core ÷ reference QPS/core (1M/24).  An arm that
fails is recorded as an error cell, never as a 0.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _analyzer_version() -> str:
    """Short content hash of the static-analyzer tree (tools/lint.py
    analyzer_version) — '?' if the tools are unimportable, never a
    bench failure."""
    try:
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tools"))
        from lint import analyzer_version
        return analyzer_version()
    except Exception:  # noqa: BLE001 — bench must not die on tooling
        return "?"


def _scaling_table(cores_avail: int) -> dict:
    """The 1/2/4/8-core table (≙ docs/cn/benchmark.md methodology: same
    binary, pinned to N cores).  Each point is a subprocess because CPU
    affinity must bind before the fiber workers spawn."""
    table = {}
    me = os.path.abspath(__file__)
    for n in (1, 2, 4, 8):
        if n > cores_avail:
            break
        try:
            out = subprocess.run(
                [sys.executable, me, "--cores", str(n), "--brief"],
                capture_output=True, text=True, timeout=120)
            line = out.stdout.strip().splitlines()[-1]
            table[str(n)] = json.loads(line)["value"]
        except Exception:
            table[str(n)] = None
    return table


def _serving_rank(mesh, rail: str, codec: str, duration_s: float) -> dict:
    """One rank of a serving-bench arm: the leader hosts the engine, its
    KV block plane and the Server, warms off the clock and presses the
    stream with rpc_press.press_stream; a follower replays the leader's
    device operations until the leader stops."""
    import torch.distributed as dist
    from brpc_tpu_torch import tpu_plane
    from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
    from brpc_tpu_torch.rpc.server import Server, ServerOptions
    from brpc_tpu_torch.serving import ServingEngine
    from brpc_tpu_torch.serving.engine import tiny_config
    from brpc_tpu_torch.serving.kv_cache import KvBlockPlane
    from brpc_tpu_torch.tools.rpc_press import press_stream

    dp = mesh.shape.get("dp", 1)
    n_slots = dp * -(-4 // dp)       # 4 slots, or the next multiple of dp
    if dist.get_rank() != 0:
        engine = ServingEngine(cfg=tiny_config(), mesh=mesh, n_slots=n_slots)
        engine.start()
        engine.stop()
        return {"ops": engine.dev.ops}
    plane = tpu_plane.init()
    engine = ServingEngine(
        cfg=tiny_config(), mesh=mesh,
        kv=KvBlockPlane(block_bytes=4096, n_blocks=48,
                        rail=rail, codec=codec),
        n_slots=n_slots, max_waiting=4)
    server = Server(ServerOptions(
        method_max_concurrency={"LLM.Generate": engine.method_cap}))
    engine.register(server)
    port = server.start("127.0.0.1:0")
    engine.start()
    addr = f"127.0.0.1:{port}"
    payload = json.dumps({"prompt_len": 12,
                          "max_new_tokens": 16}).encode()
    # warm OFF the clock (kernel builds, first launches, the world's
    # first collectives) so the timed TTFT/ITL measure serving
    ch = Channel(addr, ChannelOptions(timeout_ms=60000, max_retry=0))
    try:
        _, st = ch.create_stream("LLM.Generate", payload)
        while st.read(timeout_s=120) is not None:
            pass
        st.destroy()
    finally:
        ch.close()
    res = press_stream(addr, "LLM.Generate", payload,
                       concurrency=6, duration_s=duration_s)
    engine.stop()
    engine.assert_drained()          # raises on a block leak
    es = engine.stats()
    server.destroy()
    return {
        "metric": "serving_bench", "rail": rail, "codec": codec,
        "plane": plane, "duration_s": round(res.wall_s, 2),
        "streams": res.streams, "completed": res.completed,
        "shed": res.shed, "resets": res.resets, "errors": res.errors,
        "tokens": res.tokens,
        "tokens_per_s": round(res.tokens_per_s, 1),
        "ttft_p50_us": res._pct(res.ttft_us, .5),
        "ttft_p99_us": res._pct(res.ttft_us, .99),
        "gap_p50_us": res._pct(res.gap_us, .5),
        "gap_p99_us": res._pct(res.gap_us, .99),
        "gap_p999_us": res._pct(res.gap_us, .999),
        "rail_local": es["rail_local"], "rail_host": es["rail_host"],
        "kv_codec_bytes": es["kv_codec_bytes"],
        "preemptions": es["preemptions"],
        "balanced": True,
        "mesh": mesh.shape,
        "ops": engine.dev.ops,
    }


def _serving_arm(rail: str, codec: str, duration_s: float,
                 device: str) -> dict:
    """One serving-bench arm: ServingEngine + Server driven by
    rpc_press.press_stream, over a world of ranks (the port's mesh is a
    world of processes, not one process): on the cards one NCCL rank per
    card; with device "cpu" 8 gloo ranks at dp2 x tp4, as bench.py:79,
    the leader's plane on the fake CUDA driver."""
    import math

    import torch
    from brpc_tpu_torch import _native
    from brpc_tpu_torch.entry import launch_world
    from brpc_tpu_torch.serving.engine import tiny_config

    leader_env = {}
    if device == "cpu":
        n, axes = 8, {"dp": 2, "tp": 4}
        _native.build_core()
        leader_env["TRPC_CUDA_DRIVER"] = _native.build_fake_driver()
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device; pass --device cpu")
        tp = math.gcd(n, tiny_config().n_heads)
        axes = {"dp": n // tp, "tp": tp}
    ranks = launch_world(n, axes,
                         f"{os.path.abspath(__file__)}:_serving_rank",
                         (rail, codec, duration_s), device_type=device,
                         leader_env=leader_env)
    out = ranks[0]
    if any(r["ops"] != out["ops"] for r in ranks[1:]):
        raise RuntimeError(f"a follower missed the leader's operations: "
                           f"{[r['ops'] for r in ranks]}")
    out["device"] = device
    return out


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ctypes

    ap = argparse.ArgumentParser()
    ap.add_argument("--cores", type=int, default=0,
                    help="pin to N cores (affinity) and scale workers to N")
    ap.add_argument("--brief", action="store_true",
                    help="shorter probes (used by the scaling table)")
    ap.add_argument("--no-scaling", action="store_true",
                    help="skip the multi-core scaling table")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run the echo grid N times; per-row min/median/"
                         "max, and the JSON line reports the "
                         "MEDIAN sustained QPS with a [min, max] band")
    ap.add_argument("--attach-bytes", type=int, default=0,
                    help="run ONLY the large-attachment bench at this "
                         "size and print one JSON line")
    ap.add_argument("--attach-ab", action="store_true",
                    help="back-to-back writev vs SEND_ZC table at "
                         "512KB/1MB/4MB attachments (one subprocess per "
                         "arm: the rail's state is process-global)")
    ap.add_argument("--client-cork-ab", action="store_true",
                    help="back-to-back client-cork A/B at the echo grid's "
                         "concurrency-256 config (one subprocess per arm: "
                         "TRPC_CLIENT_CORK=0 vs 1, --repeat honored)")
    ap.add_argument("--telemetry-ab", action="store_true",
                    help="telemetry-overhead A/B: full echo "
                         "grid with TRPC_TELEMETRY=0 vs 1 (one subprocess "
                         "per arm — histogram writes + per-request clock "
                         "reads on vs off), --repeat honored; the bands "
                         "must overlap within the single-core noise")
    ap.add_argument("--codec-ab", action="store_true",
                    help="payload-codec A/B: attachment GB/s "
                         "sweep at 512KB/1MB/4MB per codec "
                         "(none/snappy/bf16/int8; one subprocess per arm "
                         "— TRPC_PAYLOAD_CODEC is resolved per process), "
                         "per-row min/median/max over --repeat runs, "
                         "plus the param-server allreduce example's "
                         "codec legs")
    ap.add_argument("--codec-skip-allreduce", action="store_true",
                    help="with --codec-ab: skip the (slow, 8-rank on the "
                         "CPU) allreduce legs and sweep attachments only")
    ap.add_argument("--serving", action="store_true",
                    help="LLM-serving bench: tokens/s + "
                         "admitted-only TTFT/ITL from rpc_press "
                         "--stream against the continuous-batching "
                         "engine, with the KV-migration rail/codec A/B "
                         "(auto-rail headline, then host-rail "
                         "none/bf16/int8; one subprocess per arm: the "
                         "device plane is process-global)")
    ap.add_argument("--serving-arm", default="",
                    help="internal: run ONE serving arm as "
                         "'rail,codec' and print its JSON line")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the serving arms and the allreduce legs "
                         "run: the cards, or the CPU (gloo ranks, the "
                         "fake CUDA driver)")
    args = ap.parse_args()

    if args.serving_arm:
        rail, codec = args.serving_arm.split(",")
        print(json.dumps(_serving_arm(rail, codec,
                                      4.0 if args.brief else 8.0,
                                      args.device)))
        return 0

    if args.serving:
        me = os.path.abspath(__file__)
        table = {}
        for rail, codec in (("auto", "none"), ("host", "none"),
                            ("host", "bf16"), ("host", "int8")):
            key = f"{rail}/{codec}"
            try:
                cmd = [sys.executable, me, "--serving-arm",
                       f"{rail},{codec}", "--device", args.device]
                if args.brief:
                    cmd.append("--brief")
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=600)
                if r.returncode != 0:
                    raise RuntimeError(f"arm rc={r.returncode}: "
                                       f"{r.stderr[-300:]}")
                table[key] = json.loads(r.stdout.strip().splitlines()[-1])
            except Exception as e:  # noqa: BLE001 — arm -> error cell
                table[key] = {"error": str(e)}
        head = table.get("auto/none", {})
        print(json.dumps({"metric": "serving_ab",
                          "value": head.get("tokens_per_s"),
                          "unit": "tokens/s", "table": table}))
        return 0

    if args.codec_ab:
        me = os.path.abspath(__file__)
        reps = max(1, args.repeat)
        codecs = ("none", "snappy", "bf16", "int8")
        table = {}
        for size in (512 << 10, 1 << 20, 4 << 20):
            row = {}
            for codec in codecs:
                env = dict(os.environ)
                env["TRPC_PAYLOAD_CODEC"] = codec
                samples, good, errs = [], None, []
                for _ in range(reps):
                    try:
                        r = subprocess.run(
                            [sys.executable, me, "--attach-bytes",
                             str(size)], capture_output=True, text=True,
                            timeout=180, env=env)
                        if r.returncode != 0:
                            # a failed arm must NOT contribute a 0.0
                            # sample that drags the band down silently
                            raise RuntimeError(
                                f"arm rc={r.returncode}: "
                                f"{r.stderr[-200:]}")
                        good = json.loads(
                            r.stdout.strip().splitlines()[-1])
                        samples.append(float(good["value"]))
                    except Exception as e:  # noqa: BLE001 — arm -> err
                        errs.append(str(e))
                if samples:
                    samples.sort()
                    good["gbps_band"] = {
                        "min": round(samples[0], 3),
                        "median": round(samples[len(samples) // 2], 3),
                        "max": round(samples[-1], 3)}
                    if errs:
                        good["failed_repeats"] = errs
                    row[codec] = good
                else:
                    row[codec] = {"error": "; ".join(errs) or "no runs"}
            table[str(size)] = row
        out = {"metric": "codec_ab", "repeat": reps, "table": table}
        if not args.codec_skip_allreduce:
            # allreduce shapes (the 25.56M-param ResNet example) per
            # codec: algbw + the asserted numeric error of the lossy leg
            ex = os.path.join(os.path.dirname(me), "examples",
                              "param_server_allreduce_torch.py")
            allreduce = {}
            for codec in ("none", "int8", "bf16"):
                try:
                    r = subprocess.run(
                        [sys.executable, ex, "--codec", codec,
                         "--device", args.device],
                        capture_output=True, text=True, timeout=600)
                    if r.returncode != 0:
                        raise RuntimeError(f"leg rc={r.returncode}: "
                                           f"{r.stderr[-300:]}")
                    j = json.loads(r.stdout.strip().splitlines()[-1])
                    allreduce[codec] = {
                        k: j.get(k) for k in
                        ("allreduce_algbw_gbps", "allreduce_busbw_gbps",
                         "codec_max_abs_err", "codec_err_bound")}
                except Exception as e:  # noqa: BLE001 — leg -> error
                    allreduce[codec] = {"error": str(e)}
            out["allreduce"] = allreduce
        print(json.dumps(out))
        return 0

    if args.telemetry_ab:
        me = os.path.abspath(__file__)
        table = {}
        for arm, extra in (("off", {"TRPC_TELEMETRY": "0"}),
                           ("on", {"TRPC_TELEMETRY": "1"})):
            env = dict(os.environ)
            env.update(extra)
            cmd = [sys.executable, me, "--no-scaling",
                   "--repeat", str(max(1, args.repeat))]
            if args.brief:
                cmd.append("--brief")
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=900, env=env)
                table[arm] = json.loads(r.stdout.strip().splitlines()[-1])
            except Exception as e:  # noqa: BLE001 — arm recorded null
                table[arm] = {"error": str(e)}
        print(json.dumps({"metric": "telemetry_ab", "table": table}))
        return 0

    if args.client_cork_ab:
        me = os.path.abspath(__file__)
        table = {}
        for arm, extra in (("uncorked", {"TRPC_CLIENT_CORK": "0"}),
                           ("corked", {"TRPC_CLIENT_CORK": "1"})):
            env = dict(os.environ)
            env.update(extra)
            cmd = [sys.executable, me, "--no-scaling",
                   "--repeat", str(max(1, args.repeat))]
            if args.brief:
                cmd.append("--brief")
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=900, env=env)
                table[arm] = json.loads(r.stdout.strip().splitlines()[-1])
            except Exception as e:  # noqa: BLE001 — arm recorded null
                table[arm] = {"error": str(e)}
        print(json.dumps({"metric": "client_cork_ab", "table": table}))
        return 0

    if args.attach_ab:
        me = os.path.abspath(__file__)
        table = {}
        for size in (512 << 10, 1 << 20, 4 << 20):
            row = {}
            for arm, extra in (("writev", {"BENCH_SENDZC": "0"}),
                               ("sendzc", {"BENCH_SENDZC": "1",
                                           "TRPC_SENDZC_FORCE": "1"})):
                env = dict(os.environ)
                env.update(extra)
                try:
                    r = subprocess.run(
                        [sys.executable, me, "--attach-bytes", str(size)],
                        capture_output=True, text=True, timeout=180,
                        env=env)
                    row[arm] = json.loads(
                        r.stdout.strip().splitlines()[-1])
                except Exception as e:  # noqa: BLE001 — arm recorded null
                    row[arm] = {"error": str(e)}
            table[str(size)] = row
        print(json.dumps({"metric": "attach_ab", "table": table}))
        return 0

    if args.cores > 0:
        # bind BEFORE the native init spawns fiber workers/dispatchers
        try:
            os.sched_setaffinity(0, set(range(args.cores)))
        except OSError:
            pass

    from brpc_tpu_torch._native import lib

    L = lib()
    ncpu = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else (os.cpu_count() or 1)
    workers = max(2, min(ncpu, 8))
    L.trpc_init(workers)

    # ring transport when the kernel grants it: multishot accept +
    # provided-buffer recv (falls back automatically when io_uring is
    # unavailable)
    use_ring = bool(L.trpc_io_uring_available())
    L.trpc_set_io_uring(1 if use_ring else 0)
    # egress arm override for the --attach-ab harness
    if os.environ.get("BENCH_SENDZC") == "0":
        L.trpc_set_sendzc(0)
    # ingress fast path A/B switch: TRPC_INLINE_DISPATCH=0 restores the
    # spawned dispatch path (fiber per request, per-response flushes)
    inline_on = os.environ.get("TRPC_INLINE_DISPATCH") != "0"
    L.trpc_set_inline_dispatch(1 if inline_on else 0)
    # client egress fast path A/B switch: TRPC_CLIENT_CORK=0 restores
    # plain per-request writes (no doorbell window on channel_call)
    cork_on = os.environ.get("TRPC_CLIENT_CORK") != "0"
    L.trpc_set_client_cork(1 if cork_on else 0)

    # in-process echo server with the native echo handler (no Python in
    # the hot path), then the native multi-fiber client loop against it
    srv = L.trpc_server_create()
    L.trpc_server_add_echo(srv)
    if L.trpc_server_start(srv, b"127.0.0.1", 0) != 0:
        print(json.dumps({"metric": "echo_qps", "value": 0.0,
                          "unit": "qps", "vs_baseline": 0.0,
                          "error": "server start failed"}))
        return 1
    port = L.trpc_server_port(srv)

    out = (ctypes.c_double * 9)()

    def run(nconn: int, conc: int, secs: float):
        rc = L.trpc_run_echo_bench(b"127.0.0.1", port, nconn, conc,
                                   16, 0, secs, out)
        if rc != 0:
            return None
        return out[0], out[1], out[3]  # qps, p50, p99

    def native_counter(name: str) -> int:
        buf = ctypes.create_string_buffer(1 << 16)
        n = L.trpc_native_metrics_dump(buf, len(buf))
        for line in buf.raw[:n].decode().splitlines():
            if line.startswith(name + " "):
                return int(line.split()[1])
        return 0

    def egress_label() -> str:
        if not use_ring:
            return "writev (epoll transport)"
        if not L.trpc_sendzc_available():
            return "writev (kernel lacks SEND_ZC)"
        if os.environ.get("BENCH_SENDZC") == "0":
            return "writev (rail disabled for A/B)"
        if not L.trpc_sendzc_active():
            return "writev (rail flagged off)"
        if native_counter("native_uring_sendzc_copied") > 0 and \
                os.environ.get("TRPC_SENDZC_FORCE") != "1":
            return ("sendzc->writev (notifications reported kernel "
                    "copies on this route)")
        return "sendzc"

    codec_names = {0: "none", 1: "snappy", 2: "bf16", 3: "int8"}

    if args.attach_bytes > 0:
        # single large-attachment run for the A/B harness: EFFECTIVE GB/s
        # (plain payload bytes moved per second — with a codec on, the
        # wire carries fewer) + which egress rail the bytes took + the
        # codec rail's own accounting (encoder-side bytes in/out = the
        # wire saving)
        rc = L.trpc_run_echo_bench(b"127.0.0.1", port, 2, 16, 16,
                                   args.attach_bytes, 2.0, out)
        print(json.dumps({
            "metric": "attach_gbps",
            "value": round(out[8], 3) if rc == 0 else 0.0,
            "qps": round(out[0], 1) if rc == 0 else 0.0,
            "attach_bytes": args.attach_bytes,
            "egress": egress_label(),
            "payload_codec": codec_names.get(
                int(L.trpc_payload_codec()), "?"),
            "codec_encodes": native_counter("native_codec_encodes"),
            "codec_decodes": native_counter("native_codec_decodes"),
            "codec_bytes_in": native_counter("native_codec_bytes_in"),
            "codec_bytes_out": native_counter("native_codec_bytes_out"),
            "sendzc_submitted": native_counter(
                "native_uring_sendzc_submitted"),
            "sendzc_copied": native_counter("native_uring_sendzc_copied"),
            "sendzc_fixed": native_counter("native_uring_sendzc_fixed"),
            "analyzer": _analyzer_version(),
        }))
        return 0 if rc == 0 else 1

    # batching amortizes syscalls, and the multi-connection configs can
    # win even on one core (deeper aggregate pipelining), so probe them
    # unconditionally and let the measurements decide.  --repeat N walks
    # the whole grid N times: single-core hosts swing between runs, so
    # one sample per row is noise — the row stats and the reported
    # median make the band explicit.
    grid = [(1, 64), (1, 128), (2, 128), (4, 256), (8, 256)]
    probe_s, sustain_s = (0.5, 1.5) if args.brief else (1.0, 3.0)
    reps = max(1, args.repeat)
    rows = {}  # "NxC" -> [probe qps...]
    for _ in range(reps):
        for nconn, conc in grid:
            r = run(nconn, conc, probe_s)
            if r is not None:
                rows.setdefault(f"{nconn}x{conc}", []).append(r[0])
    if not rows:
        print(json.dumps({"metric": "echo_qps", "value": 0.0,
                          "unit": "qps", "vs_baseline": 0.0,
                          "error": "bench failed"}))
        return 1

    def _stats(vals):
        s = sorted(vals)
        return {"min": round(s[0], 1), "median": round(s[len(s) // 2], 1),
                "max": round(s[-1], 1)}

    row_stats = {k: _stats(v) for k, v in rows.items()}
    best_key = max(row_stats, key=lambda k: row_stats[k]["median"])
    nconn, conc = (int(x) for x in best_key.split("x"))
    # sustained runs at the winning config: report the MEDIAN with the
    # observed [min, max] band
    sustained = []
    for _ in range(reps):
        r = run(nconn, conc, sustain_s)
        if r is not None:
            sustained.append(r)
    if not sustained:
        sustained = [(row_stats[best_key]["median"], 0.0, 0.0)]
    sustained.sort(key=lambda r: r[0])
    qps, p50, p99 = sustained[len(sustained) // 2]
    band = [round(sustained[0][0], 1), round(sustained[-1][0], 1)]
    # unloaded latency: a single synchronous caller (a no-queueing
    # number)
    lat = run(1, 1, 0.5 if args.brief else 1.5)

    # large-payload egress: GB/s with a 1MB attachment per call — the
    # path the zero-copy rail (SEND_ZC + registered landing zones) was
    # built for.  `egress` records which rail the bytes actually took.
    large = None
    if not args.brief:
        attach = 1 << 20
        rc = L.trpc_run_echo_bench(b"127.0.0.1", port, 2, 16, 16, attach,
                                   2.0, out)
        if rc == 0 and out[0] > 0:
            large = {"gbps": round(out[8], 3), "qps": round(out[0], 1),
                     "attach_bytes": attach}
    egress = egress_label()

    ref_qps_per_core = 1_000_000 / 24.0  # docs/cn/benchmark.md:7 low end
    cores_used = min(ncpu, workers)  # bench engages `workers` cores at most
    vs = (qps / cores_used) / ref_qps_per_core
    result = {
        "metric": "echo_qps",
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(vs, 3),
        "p50_us": round(p50, 1),
        "p99_us": round(p99, 1),
        "unloaded_p50_us": round(lat[1], 1) if lat else None,
        "unloaded_p99_us": round(lat[2], 1) if lat else None,
        "nconn": nconn,
        "concurrency": conc,
        "cores": ncpu,
        "transport": "io_uring" if use_ring else "epoll",
        "egress": egress,
        "repeat": reps,
        "band": band,
        "inline_dispatch": "on" if bool(
            L.trpc_inline_dispatch_active()) else "off",
        "inline_hits": native_counter("native_inline_dispatch_hits"),
        "inline_fallbacks": native_counter(
            "native_inline_dispatch_fallbacks"),
        "cork_responses_per_flush": native_counter(
            "native_batch_cork_responses_per_flush"),
        # hot-path telemetry: SERVER-side percentiles from the
        # native histograms beside the client-measured numbers above —
        # inline_echo is what the server saw for the same requests
        # (client_unary is issue->completion including the wait)
        "telemetry": "on" if bool(L.trpc_telemetry_active()) else "off",
        "server_p50_us": native_counter(
            "native_latency_inline_echo_p50_us"),
        "server_p99_us": native_counter(
            "native_latency_inline_echo_p99_us"),
        "server_p999_us": native_counter(
            "native_latency_inline_echo_p999_us"),
        "server_hist_count": native_counter(
            "native_latency_inline_echo_count"),
        "client_hist_p99_us": native_counter(
            "native_latency_client_unary_p99_us"),
        "client_cork": "on" if bool(L.trpc_client_cork_active()) else "off",
        "client_cork_windows": native_counter("native_client_cork_windows"),
        "client_inline_completes": native_counter(
            "native_client_inline_completes"),
        # runtime sharding: bench-of-record runs record the
        # active shard count (TRPC_SHARDS, boot-frozen); per-shard
        # accept/dispatch/inline/cork counters prove the partitioning —
        # on a sharded run the work must actually spread
        "shards": int(L.trpc_shard_count()),
        "cross_shard_hops": int(L.trpc_cross_shard_hops()),
        "per_shard": {
            str(k): {
                "accepts": native_counter(f"native_shard{k}_accepts"),
                "dispatches": native_counter(
                    f"native_shard{k}_dispatches"),
                "inline_hits": native_counter(
                    f"native_shard{k}_inline_hits"),
                "cork_flushes": native_counter(
                    f"native_shard{k}_cork_flushes"),
                "ring_cqes": native_counter(
                    f"native_shard{k}_ring_cqes"),
            }
            for k in range(int(L.trpc_shard_count()))
        },
        # overload-control plane: bench-of-record runs with
        # the plane OFF (rejects must stay 0 — a bench that shed load
        # would report admitted-only throughput as headline QPS); the
        # rpc_press --ramp cannon owns the overload numbers
        "overload": "on" if bool(L.trpc_overload_active()) else "off",
        "overload_admits": native_counter("native_overload_admits"),
        "overload_rejects": native_counter("native_overload_rejects"),
        # flight recorder: bench-of-record runs capture OFF
        # (samples/drops must stay 0 — capture overhead belongs to an
        # A/B of its own, not the headline QPS)
        "capture": "on" if bool(L.trpc_dump_active()) else "off",
        "capture_samples": native_counter("native_dump_captured"),
        "capture_drops": native_counter("native_dump_dropped"),
        # payload-codec rail: bench-of-record runs none; the
        # --codec-ab harness flips TRPC_PAYLOAD_CODEC per subprocess arm
        "payload_codec": codec_names.get(int(L.trpc_payload_codec()), "?"),
        "codec_encodes": native_counter("native_codec_encodes"),
        "codec_decodes": native_counter("native_codec_decodes"),
        "codec_bytes_in": native_counter("native_codec_bytes_in"),
        "codec_bytes_out": native_counter("native_codec_bytes_out"),
        # schedule perturbation MUST be off (0) for bench-of-record: a
        # nonzero seed means the run measured the fuzzing mode, not the
        # runtime
        "sched_seed": int(L.trpc_sched_seed()),
        # content hash of tools/lint.py + tools/analyze/* +
        # the manifests: a result names the analyzed tree
        "analyzer": _analyzer_version(),
    }
    if reps > 1:
        result["rows"] = row_stats
    if large is not None:
        result["large_gbps"] = large["gbps"]
        result["large_attach_bytes"] = large["attach_bytes"]
        result["large_qps"] = large["qps"]
        result["sendzc_submitted"] = native_counter(
            "native_uring_sendzc_submitted")
        result["sendzc_copied"] = native_counter(
            "native_uring_sendzc_copied")
    if ncpu >= 2 and not args.brief and args.cores == 0 \
            and not args.no_scaling:
        # multi-core host: emit the per-core scaling table automatically
        # (each point re-runs this script pinned to N cores); a 1-core
        # host degrades to exactly the single-line behavior above
        L.trpc_server_stop(srv)
        result["scaling_qps_by_cores"] = _scaling_table(ncpu)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
