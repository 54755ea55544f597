"""rpc_press — load generator (≙ reference tools/rpc_press: target QPS,
concurrency, latency bvars printed by an info thread,
rpc_press_impl.{h,cpp}).

    python -m brpc_tpu_torch.tools.rpc_press -s 127.0.0.1:8000 -m Echo.echo \
        -d 'hello' -q 10000 -c 8 -t 10

Overload-control cannon: ``--ramp lo:hi:steps`` sweeps the
offered concurrency across ``steps`` levels and reports, per step,
admitted-vs-shed counts and ADMITTED-ONLY latency percentiles in the
``--json`` line — the acceptance harness for the native overload plane
(shed = server answered TRPC_ELIMIT without executing).  The ramp is
open-loop per level: every caller thread keeps its next request queued
regardless of how the server answered the last one, so offered load does
not back off when the server sheds.

Token cannon: ``--stream`` opens ``-c`` open-loop concurrent
streams against a serving method (one message = one token) and reports
per-stream TTFT / inter-token-gap p50/p99/p999 — admitted-only, with
ELIMIT handshakes counted as shed and mid-stream RSTs (eviction/
preemption) as resets.  The LLM serving bench's client side.

Connection cannon: ``--connections N --hot M`` holds N idle
connections against the server while M hot callers keep echoing, through
three legs — ramp (open the N), churn (steady close/reopen), reconnect
storm (drop and re-dial every idle connection at once).  The ``--json``
line reports hot-subset p50/p99/p999 PER LEG beside the open/failed/
shed/reconnect counts: the acceptance harness for the million-connection
ingress work (per-shard timer wheel + memory diet + accept pacing) —
idle-connection bookkeeping must not bend the hot path's tail.
"""

from __future__ import annotations

import argparse
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class PressResult:
    calls: int = 0
    errors: int = 0
    shed: int = 0   # server-side ELIMIT rejects (never executed)
    wall_s: float = 0.0
    qps: float = 0.0
    # admitted-only latencies: a shed answer is the overload plane
    # working, not a serving latency — mixing them in would let a fast
    # reject path mask a collapsing admitted path
    latencies_us: List[int] = field(default_factory=list)

    @property
    def admitted(self) -> int:
        return self.calls - self.errors - self.shed

    def percentile(self, p: float) -> float:
        if not self.latencies_us:
            return 0.0
        s = sorted(self.latencies_us)
        return s[min(len(s) - 1, int(p * len(s)))]

    def summary(self) -> str:
        return (f"calls={self.calls} admitted={self.admitted} "
                f"shed={self.shed} errors={self.errors} "
                f"qps={self.qps:.0f} "
                f"p50={self.percentile(.5):.0f}us "
                f"p90={self.percentile(.9):.0f}us "
                f"p99={self.percentile(.99):.0f}us "
                f"p999={self.percentile(.999):.0f}us")

    def step_dict(self, concurrency: int = 0) -> dict:
        """One ramp step's machine-readable block (admitted-only
        percentiles beside the admitted/shed split)."""
        d = {
            "calls": self.calls,
            "admitted": self.admitted,
            "shed": self.shed,
            "errors": self.errors,
            "wall_s": round(self.wall_s, 3),
            "qps": round(self.qps, 1),
            "p50_us": self.percentile(.5),
            "p90_us": self.percentile(.9),
            "p99_us": self.percentile(.99),
            "p999_us": self.percentile(.999),
        }
        if concurrency:
            d["concurrency"] = concurrency
        return d

    def to_json_line(self) -> str:
        """One machine-readable JSON line (the overload-control harness
        of ROADMAP item 2 diff-checks these across pressure levels)."""
        import json
        return json.dumps({"metric": "rpc_press", **self.step_dict()})


@dataclass
class StreamPressResult:
    """--stream token-cannon tallies.  TTFT / inter-token-gap
    percentiles are ADMITTED-ONLY (streams that produced >= 1 token):
    a shed handshake is the overload plane working, not a serving
    latency."""
    streams: int = 0      # create_stream attempts
    completed: int = 0    # streams that reached clean EOF
    shed: int = 0         # ELIMIT handshakes (never admitted)
    resets: int = 0       # mid-stream RST (eviction/preemption surface)
    errors: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    ttft_us: List[int] = field(default_factory=list)
    gap_us: List[int] = field(default_factory=list)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s > 0 else 0.0

    @staticmethod
    def _pct(xs: List[int], p: float) -> float:
        if not xs:
            return 0.0
        s = sorted(xs)
        return s[min(len(s) - 1, int(p * len(s)))]

    def summary(self) -> str:
        return (f"streams={self.streams} completed={self.completed} "
                f"shed={self.shed} resets={self.resets} "
                f"errors={self.errors} tokens={self.tokens} "
                f"tok/s={self.tokens_per_s:.0f} "
                f"ttft_p50={self._pct(self.ttft_us, .5):.0f}us "
                f"ttft_p99={self._pct(self.ttft_us, .99):.0f}us "
                f"gap_p50={self._pct(self.gap_us, .5):.0f}us "
                f"gap_p99={self._pct(self.gap_us, .99):.0f}us "
                f"gap_p999={self._pct(self.gap_us, .999):.0f}us")

    def to_json_line(self) -> str:
        import json
        return json.dumps({
            "metric": "rpc_press_stream",
            "streams": self.streams,
            "completed": self.completed,
            "shed": self.shed,
            "resets": self.resets,
            "errors": self.errors,
            "tokens": self.tokens,
            "wall_s": round(self.wall_s, 3),
            "tokens_per_s": round(self.tokens_per_s, 1),
            "ttft_p50_us": self._pct(self.ttft_us, .5),
            "ttft_p99_us": self._pct(self.ttft_us, .99),
            "ttft_p999_us": self._pct(self.ttft_us, .999),
            "gap_p50_us": self._pct(self.gap_us, .5),
            "gap_p99_us": self._pct(self.gap_us, .99),
            "gap_p999_us": self._pct(self.gap_us, .999),
        })


def press_stream(server: str, method: str, payload: bytes,
                 concurrency: int = 4, duration_s: float = 5.0,
                 timeout_ms: float = 30000.0,
                 read_timeout_s: float = 60.0) -> StreamPressResult:
    """The serving bench's client side: `concurrency` open-loop workers
    each repeatedly open a stream on `method` and drain tokens to EOF,
    recording per-stream TTFT (handshake issue -> first token) and
    inter-token gaps.  ELIMIT handshakes count as shed and the worker
    immediately re-offers — offered load does not back off when the
    server sheds (same open-loop posture as press())."""
    from brpc_tpu_torch.rpc import errors
    from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
    from brpc_tpu_torch.rpc.stream import StreamReset, StreamTimeout

    res = StreamPressResult()
    lock = threading.Lock()
    stop = threading.Event()

    def worker():
        ch = Channel(server, ChannelOptions(timeout_ms=timeout_ms,
                                            max_retry=0))
        ttft, gaps = [], []
        streams = completed = shed = resets = errs = tokens = 0
        while not stop.is_set():
            streams += 1
            t0 = time.monotonic_ns()
            try:
                _, st = ch.create_stream(method, payload)
            except errors.RpcError as e:
                if e.code == errors.ELIMIT:
                    shed += 1
                else:
                    errs += 1
                continue
            n, last = 0, 0
            try:
                while True:
                    msg = st.read(timeout_s=read_timeout_s)
                    if msg is None:
                        completed += 1
                        break
                    now = time.monotonic_ns()
                    if n == 0:
                        ttft.append((now - t0) // 1000)
                    else:
                        gaps.append((now - last) // 1000)
                    n, last = n + 1, now
                    tokens += 1
            except StreamReset:
                resets += 1   # evicted/preempted mid-stream: shed surface
            except StreamTimeout:
                errs += 1
            except Exception:
                errs += 1
            st.destroy()
        ch.close()
        with lock:
            res.streams += streams
            res.completed += completed
            res.shed += shed
            res.resets += resets
            res.errors += errs
            res.tokens += tokens
            res.ttft_us.extend(ttft)
            res.gap_us.extend(gaps)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=read_timeout_s + timeout_ms / 1000 + 1)
    res.wall_s = time.monotonic() - t0
    return res


@dataclass
class ConnCannonResult:
    """--connections tallies.  Hot-subset latencies are kept PER LEG so
    the acceptance check can diff the storm leg's p99 against the ramp
    leg's — a flat tail across reconnect storms is the point."""
    connections: int = 0
    hot: int = 0
    opened: int = 0      # successful idle dials (initial + re-dials)
    failed: int = 0      # dials refused / timed out
    sheds: int = 0       # idle conns found dead at sweep time (server
    #                      closed them unused: accept-shed / eviction)
    reconnects: int = 0  # churn + storm re-dials
    storms: int = 0
    ramp_s: float = 0.0  # wall time to open the first N
    wall_s: float = 0.0
    calls: int = 0
    errors: int = 0
    leg_lat_us: dict = field(default_factory=dict)  # leg -> [us]

    @staticmethod
    def _pct(xs: List[int], p: float) -> float:
        if not xs:
            return 0.0
        s = sorted(xs)
        return s[min(len(s) - 1, int(p * len(s)))]

    def leg_dicts(self) -> List[dict]:
        out = []
        for leg in ("ramp", "churn", "storm"):
            xs = self.leg_lat_us.get(leg, [])
            out.append({"leg": leg, "calls": len(xs),
                        "p50_us": self._pct(xs, .5),
                        "p99_us": self._pct(xs, .99),
                        "p999_us": self._pct(xs, .999)})
        return out

    def summary(self) -> str:
        lines = [f"connections={self.connections} hot={self.hot} "
                 f"opened={self.opened} failed={self.failed} "
                 f"sheds={self.sheds} reconnects={self.reconnects} "
                 f"storms={self.storms} ramp_s={self.ramp_s:.2f} "
                 f"calls={self.calls} errors={self.errors}"]
        for d in self.leg_dicts():
            lines.append(f"  {d['leg']}: calls={d['calls']} "
                         f"p50={d['p50_us']:.0f}us "
                         f"p99={d['p99_us']:.0f}us "
                         f"p999={d['p999_us']:.0f}us")
        return "\n".join(lines)

    def to_json_line(self) -> str:
        import json
        return json.dumps({
            "metric": "rpc_press_connections",
            "connections": self.connections, "hot": self.hot,
            "opened": self.opened, "failed": self.failed,
            "sheds": self.sheds, "reconnects": self.reconnects,
            "storms": self.storms, "ramp_s": round(self.ramp_s, 3),
            "wall_s": round(self.wall_s, 3),
            "calls": self.calls, "errors": self.errors,
            "legs": self.leg_dicts(),
        })


def press_connections(server: str, method: str, payload: bytes,
                      connections: int = 1000, hot: int = 4,
                      duration_s: float = 5.0, churn_per_s: float = 50.0,
                      storms: int = 1,
                      timeout_ms: float = 5000.0) -> ConnCannonResult:
    """The million-connection ingress harness: `connections` idle raw
    sockets dialed and HELD (they never speak — first-byte-lazy parse
    state, idle-kick diet, and the timer wheel all get exercised server
    side), while `hot` caller threads echo continuously.  Legs:

    - ramp:  dial the N idle connections as fast as the server admits,
             then dwell `duration_s` under steady hot traffic.
    - churn: close+re-dial `churn_per_s` random idle connections per
             second for `duration_s`.
    - storm: `storms` rounds of dropping EVERY idle connection at once
             and re-dialing the full set (the accept-storm leg).

    Hot-subset latencies are recorded under the leg active at call time.
    A dial the server refuses (or a held connection found dead at sweep
    time — the overload plane closing unused fds) counts toward
    failed/sheds; the cannon re-dials and keeps going."""
    import errno as _errno
    import random
    import socket as _socket

    from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions

    res = ConnCannonResult(connections=connections, hot=hot,
                           storms=storms)
    for leg in ("ramp", "churn", "storm"):
        res.leg_lat_us[leg] = []
    lock = threading.Lock()
    stop = threading.Event()
    leg_now = ["ramp"]  # single writer (main thread), racy read is fine

    def hot_worker():
        ch = Channel(server, ChannelOptions(timeout_ms=timeout_ms,
                                            max_retry=0))
        local: dict = {"ramp": [], "churn": [], "storm": []}
        calls = errs = 0
        while not stop.is_set():
            leg = leg_now[0]
            t0 = time.monotonic_ns()
            try:
                ch.call(method, payload)
                local[leg].append((time.monotonic_ns() - t0) // 1000)
            except Exception:
                errs += 1
            calls += 1
        ch.close()
        with lock:
            res.calls += calls
            res.errors += errs
            for leg, xs in local.items():
                res.leg_lat_us[leg].extend(xs)

    host, _, port_s = server.rpartition(":")
    addr = (host, int(port_s))

    def dial() -> Optional[_socket.socket]:
        try:
            c = _socket.create_connection(addr, timeout=timeout_ms / 1000)
            c.setblocking(False)
            res.opened += 1
            return c
        except OSError:
            res.failed += 1
            return None

    def sweep_dead(conns: List[_socket.socket]) -> List[_socket.socket]:
        """Drop held connections the server has closed under us (accept
        shed / idle eviction read as EOF or reset on a silent socket)."""
        live = []
        for c in conns:
            try:
                if c.recv(1) == b"":
                    res.sheds += 1
                    c.close()
                    continue
            except OSError as e:
                if e.errno in (_errno.EAGAIN, _errno.EWOULDBLOCK):
                    live.append(c)
                    continue
                res.sheds += 1
                c.close()
                continue
            live.append(c)  # server spoke first (unexpected): keep it
        return live

    threads = [threading.Thread(target=hot_worker, daemon=True)
               for _ in range(hot)]
    t_start = time.monotonic()
    for t in threads:
        t.start()

    # --- ramp ---
    idle: List[_socket.socket] = []
    t0 = time.monotonic()
    for _ in range(connections):
        c = dial()
        if c is not None:
            idle.append(c)
    res.ramp_s = time.monotonic() - t0
    time.sleep(duration_s)

    # --- churn ---
    leg_now[0] = "churn"
    interval = 1.0 / churn_per_s if churn_per_s > 0 else duration_s
    t_end = time.monotonic() + duration_s
    while time.monotonic() < t_end:
        if idle:
            k = random.randrange(len(idle))
            idle[k].close()
            c = dial()
            if c is not None:
                idle[k] = c
                res.reconnects += 1
            else:
                idle.pop(k)
        time.sleep(interval)

    # --- reconnect storms ---
    leg_now[0] = "storm"
    for _ in range(storms):
        idle = sweep_dead(idle)
        want = len(idle)
        for c in idle:
            c.close()
        idle = []
        for _ in range(want):
            c = dial()
            if c is not None:
                idle.append(c)
                res.reconnects += 1
        time.sleep(max(duration_s / max(storms, 1), 0.2))

    stop.set()
    for t in threads:
        t.join(timeout=timeout_ms / 1000 + 1)
    idle = sweep_dead(idle)
    for c in idle:
        c.close()
    res.wall_s = time.monotonic() - t_start
    return res


def press(server: str, method: str, payload: bytes, qps: float = 0.0,
          concurrency: int = 4, duration_s: float = 5.0,
          attachment: bytes = b"",
          timeout_ms: float = 1000.0, protocol: str = "trpc") -> PressResult:
    """Drive `method` at `qps` (0 = as fast as possible) with `concurrency`
    caller threads for `duration_s`.

    protocol: "trpc" (default), "h2" (method = "VERB /path" over the
    native HTTP/2 client) or "grpc" (method = "Service/Method", payload =
    serialized request).  For HTTP/1.1, a method starting with "GET " /
    "POST " etc. is an HTTP target ("GET /health") driven through the
    framework's own client (≙ rpc_press's multi-protocol support)."""
    from brpc_tpu_torch.rpc import errors
    from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
    from brpc_tpu_torch.rpc.http_client import HttpChannel

    http_verb = None
    http_target = "/"
    if method.startswith(("GET ", "POST ", "PUT ", "DELETE ", "HEAD ")):
        http_verb, _, http_target = method.partition(" ")

    res = PressResult()
    lock = threading.Lock()
    stop = threading.Event()
    # per-thread QPS share via interval pacing (≙ rpc_press -qps)
    interval = concurrency / qps if qps > 0 else 0.0

    def worker():
        if protocol == "h2":
            from brpc_tpu_torch.rpc.h2_client import H2Channel
            h2 = H2Channel(server)
            verb, _, target = method.partition(" ")
            if not target:
                verb, target = "GET", method

            def call_once():
                r = h2.request(verb, target, body=payload,
                               timeout_ms=timeout_ms)
                if r.status >= 400:
                    raise RuntimeError(f"h2 {r.status}")

            closer = h2.close
        elif protocol == "grpc":
            from brpc_tpu_torch.rpc.h2_client import GrpcChannel
            g = GrpcChannel(server)
            service, _, meth = method.rpartition("/")

            def call_once():
                g.call(service, meth, payload, timeout_ms=timeout_ms)

            closer = g.close
        elif http_verb is not None:
            hch = HttpChannel(server)

            def call_once():
                r = hch.request(http_verb, http_target, body=payload,
                                timeout_ms=timeout_ms)
                if r.status >= 400:
                    raise RuntimeError(f"http {r.status}")

            closer = hch.close
        else:
            ch = Channel(server, ChannelOptions(timeout_ms=timeout_ms,
                                                max_retry=0))

            def call_once():
                ch.call(method, payload, attachment)

            closer = ch.close
        local_lat, local_calls, local_errs, local_shed = [], 0, 0, 0
        next_at = time.monotonic()
        while not stop.is_set():
            if interval > 0:
                now = time.monotonic()
                if now < next_at:
                    time.sleep(min(next_at - now, 0.05))
                    continue
                next_at += interval
            t0 = time.monotonic_ns()
            try:
                call_once()
                local_lat.append((time.monotonic_ns() - t0) // 1000)
            except errors.RpcError as e:
                if e.code == errors.ELIMIT:
                    local_shed += 1  # shed, never executed — not an error
                else:
                    local_errs += 1
            except Exception:
                local_errs += 1
            local_calls += 1
        closer()
        with lock:
            res.calls += local_calls
            res.errors += local_errs
            res.shed += local_shed
            res.latencies_us.extend(local_lat)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=timeout_ms / 1000 + 1)
    res.wall_s = time.monotonic() - t0
    res.qps = res.calls / res.wall_s if res.wall_s > 0 else 0.0
    return res


def parse_ramp(spec: str) -> List[int]:
    """'lo:hi:steps' -> the concurrency level per step (inclusive,
    linearly spaced, deduplicated ascending)."""
    parts = spec.split(":")
    if len(parts) != 3:
        raise ValueError(f"--ramp wants lo:hi:steps, got {spec!r}")
    lo, hi, steps = int(parts[0]), int(parts[1]), int(parts[2])
    if lo < 1 or hi < lo or steps < 1:
        raise ValueError(f"--ramp wants 1 <= lo <= hi, steps >= 1 "
                         f"(got {spec!r})")
    if steps == 1:
        return [hi]
    levels = []
    for i in range(steps):
        c = lo + round(i * (hi - lo) / (steps - 1))
        if not levels or c > levels[-1]:
            levels.append(c)
    return levels


def ramp(server: str, method: str, payload: bytes, spec: str,
         step_s: float, qps: float = 0.0, attachment: bytes = b"",
         timeout_ms: float = 1000.0, protocol: str = "trpc") -> List[dict]:
    """The overload cannon: one open-loop press() per concurrency level,
    each step_s long, reporting admitted/shed + admitted-only
    percentiles per step."""
    out = []
    for level in parse_ramp(spec):
        r = press(server, method, payload, qps=qps, concurrency=level,
                  duration_s=step_s, attachment=attachment,
                  timeout_ms=timeout_ms, protocol=protocol)
        out.append(r.step_dict(concurrency=level))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="rpc_press load generator")
    ap.add_argument("-s", "--server", required=True, help="ip:port")
    ap.add_argument("-m", "--method", default="Echo.echo")
    ap.add_argument("-d", "--data", default="", help="request payload")
    ap.add_argument("-f", "--file", help="read payload from file")
    ap.add_argument("-q", "--qps", type=float, default=0.0,
                    help="target qps (0 = unlimited)")
    ap.add_argument("-c", "--concurrency", type=int, default=4)
    ap.add_argument("-p", "--protocol", default="trpc",
                    choices=["trpc", "h2", "grpc"],
                    help="wire protocol (HTTP/1.1 via 'GET /path' methods)")
    ap.add_argument("-t", "--time", type=float, default=5.0,
                    help="duration seconds (per step with --ramp)")
    ap.add_argument("--stream", action="store_true",
                    help="token-cannon mode: -c open-loop concurrent "
                         "streams on -m, draining tokens to EOF; "
                         "reports per-stream TTFT and inter-token-gap "
                         "p50/p99/p999 (admitted-only) plus tokens/s")
    ap.add_argument("--read-timeout", type=float, default=60.0,
                    help="--stream per-read budget seconds")
    ap.add_argument("--connections", type=int, default=0,
                    help="connection-cannon mode: hold N idle "
                         "connections through ramp/churn/reconnect-storm "
                         "legs while --hot callers keep echoing; "
                         "reports hot-subset p50/p99/p999 per leg")
    ap.add_argument("--hot", type=int, default=4,
                    help="--connections hot-subset caller threads")
    ap.add_argument("--churn", type=float, default=50.0,
                    help="--connections churn leg: idle close+re-dials "
                         "per second")
    ap.add_argument("--storms", type=int, default=1,
                    help="--connections reconnect-storm rounds")
    ap.add_argument("--ramp", metavar="lo:hi:steps",
                    help="open-loop concurrency ramp: one -t second "
                         "step per level; reports admitted-vs-shed and "
                         "admitted-only p50/p99/p999 per step (the "
                         "overload-control cannon)")
    ap.add_argument("--json", action="store_true",
                    help="print ONE JSON summary line (qps + "
                         "admitted/shed + p50/p90/p99/p999; with "
                         "--ramp, a per-step array) instead of text")
    args = ap.parse_args(argv)
    payload = (open(args.file, "rb").read() if args.file
               else args.data.encode())
    if args.connections > 0:
        res = press_connections(args.server, args.method, payload,
                                connections=args.connections,
                                hot=args.hot, duration_s=args.time,
                                churn_per_s=args.churn,
                                storms=args.storms)
        print(res.to_json_line() if args.json else res.summary())
        return 1 if res.errors and not res.calls - res.errors else 0
    if args.stream:
        res = press_stream(args.server, args.method, payload,
                           concurrency=args.concurrency,
                           duration_s=args.time,
                           read_timeout_s=args.read_timeout)
        print(res.to_json_line() if args.json else res.summary())
        return 1 if res.errors and not res.tokens else 0
    if args.ramp:
        import json
        steps = ramp(args.server, args.method, payload, args.ramp,
                     args.time, qps=args.qps, protocol=args.protocol)
        if args.json:
            print(json.dumps({"metric": "rpc_press_ramp",
                              "method": args.method, "steps": steps}))
        else:
            for st in steps:
                print(f"c={st['concurrency']} qps={st['qps']:.0f} "
                      f"admitted={st['admitted']} shed={st['shed']} "
                      f"errors={st['errors']} p50={st['p50_us']:.0f}us "
                      f"p99={st['p99_us']:.0f}us "
                      f"p999={st['p999_us']:.0f}us")
        return 0
    res = press(args.server, args.method, payload, args.qps,
                args.concurrency, args.time, protocol=args.protocol)
    print(res.to_json_line() if args.json else res.summary())
    return 1 if res.errors and not res.calls - res.errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
