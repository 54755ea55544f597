"""rpc_replay — the flight-recorder replay cannon: drive captured
rpc_dump segments against a live server, byte-for-byte, at a chosen
speed (≙ reference tools/rpc_replay over SampleIterator, rpc_dump.h:81).

    python -m brpc_tpu_torch.tools.rpc_replay -s 127.0.0.1:8000 \
        --dir ./rpc_dump --speed 10 -c 8 --json

Replay posture (the rpc_press discipline):

- Byte-for-byte: each sample's payload/attachment are re-sent in their
  captured WIRE form — still codec-encoded (meta tags 16/17) and/or
  compressed (tag 6) — through ``Channel.call_raw``, which skips the
  client-side encode and stamps the captured tags verbatim.
- ``--speed N`` replays the capture at N× its original rate: inter-
  request gaps come from the captured timestamps, divided by N
  (``--qps`` overrides with a fixed rate; neither = as fast as possible).
- Open-loop: workers never back off when the server sheds — a replayed
  incident must offer the load the incident offered.  ELIMIT answers
  count as shed, and latency percentiles are ADMITTED-ONLY.
- ``--stream`` replays captured token-stream sessions (stream-open
  samples) end-to-end: each session re-opens its stream and drains
  tokens to EOF, reporting TTFT / inter-token-gap percentiles.
- ``--sched-seed S`` arms the PR-6 schedule-replay seed first: a
  captured segment + seed is a deterministic incident reproduction.
"""

from __future__ import annotations

import argparse
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ReplayResult:
    """Replay tallies — shed/admitted split and admitted-only
    percentiles, exactly the rpc_press accounting (a shed answer is the
    overload plane working, not a serving latency)."""
    samples: int = 0     # replayable unary samples in the set
    skipped: int = 0     # non-unary records (stream frames, REDIS, ...)
    calls: int = 0
    errors: int = 0
    shed: int = 0        # server-side ELIMIT rejects (never executed)
    behind: int = 0      # sends issued past their due time (cannon lag)
    wall_s: float = 0.0
    speed: float = 1.0
    sched_seed: Optional[int] = None
    latencies_us: List[int] = field(default_factory=list)

    @property
    def admitted(self) -> int:
        return self.calls - self.errors - self.shed

    @property
    def qps(self) -> float:
        return self.calls / self.wall_s if self.wall_s > 0 else 0.0

    def percentile(self, p: float) -> float:
        if not self.latencies_us:
            return 0.0
        s = sorted(self.latencies_us)
        return s[min(len(s) - 1, int(p * len(s)))]

    def summary(self) -> str:
        return (f"samples={self.samples} skipped={self.skipped} "
                f"calls={self.calls} admitted={self.admitted} "
                f"shed={self.shed} errors={self.errors} "
                f"qps={self.qps:.0f} "
                f"p50={self.percentile(.5):.0f}us "
                f"p99={self.percentile(.99):.0f}us "
                f"p999={self.percentile(.999):.0f}us")

    def to_json_line(self) -> str:
        import json
        d = {
            "metric": "rpc_replay",
            "samples": self.samples,
            "skipped": self.skipped,
            "calls": self.calls,
            "admitted": self.admitted,
            "shed": self.shed,
            "errors": self.errors,
            "behind": self.behind,
            "wall_s": round(self.wall_s, 3),
            "qps": round(self.qps, 1),
            "speed": self.speed,
            "p50_us": self.percentile(.5),
            "p99_us": self.percentile(.99),
            "p999_us": self.percentile(.999),
        }
        if self.sched_seed is not None:
            d["sched_seed"] = self.sched_seed
        return json.dumps(d)


@dataclass
class StreamReplayResult:
    """--stream tallies: captured token sessions replayed to EOF
    (TTFT/gap percentiles admitted-only, the rpc_press --stream shape)."""
    sessions: int = 0
    completed: int = 0
    shed: int = 0
    resets: int = 0
    errors: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    sched_seed: Optional[int] = None
    ttft_us: List[int] = field(default_factory=list)
    gap_us: List[int] = field(default_factory=list)

    @staticmethod
    def _pct(xs: List[int], p: float) -> float:
        if not xs:
            return 0.0
        s = sorted(xs)
        return s[min(len(s) - 1, int(p * len(s)))]

    def summary(self) -> str:
        return (f"sessions={self.sessions} completed={self.completed} "
                f"shed={self.shed} resets={self.resets} "
                f"errors={self.errors} tokens={self.tokens} "
                f"ttft_p50={self._pct(self.ttft_us, .5):.0f}us "
                f"gap_p50={self._pct(self.gap_us, .5):.0f}us "
                f"gap_p99={self._pct(self.gap_us, .99):.0f}us")

    def to_json_line(self) -> str:
        import json
        d = {
            "metric": "rpc_replay_stream",
            "sessions": self.sessions,
            "completed": self.completed,
            "shed": self.shed,
            "resets": self.resets,
            "errors": self.errors,
            "tokens": self.tokens,
            "wall_s": round(self.wall_s, 3),
            "ttft_p50_us": self._pct(self.ttft_us, .5),
            "ttft_p99_us": self._pct(self.ttft_us, .99),
            "gap_p50_us": self._pct(self.gap_us, .5),
            "gap_p99_us": self._pct(self.gap_us, .99),
            "gap_p999_us": self._pct(self.gap_us, .999),
        }
        if self.sched_seed is not None:
            d["sched_seed"] = self.sched_seed
        return json.dumps(d)


def _arm_sched_seed(seed: Optional[int]) -> None:
    """PR-6 pairing: push the schedule-perturbation seed before traffic
    so the replayed segment runs under the captured interleaving draw."""
    if seed is None:
        return
    from brpc_tpu_torch.utils import flags
    flags.set_flag("sched_seed", int(seed))


def _load_unary(dump_dir: str):
    """Split a capture set into replayable unary samples (timestamp-
    ordered) and a skipped count.  Stream-internal frames replay through
    --stream; REDIS records are RESP blobs a TRPC channel can't carry."""
    from brpc_tpu_torch.rpc.dump import SampleIterator
    unary, skipped = [], 0
    for s in SampleIterator(dump_dir):
        if s.stream_frame_type != 0 or s.stream_id != 0 \
                or s.method == "REDIS" or not s.method:
            skipped += 1
            continue
        unary.append(s)
    unary.sort(key=lambda s: s.timestamp)
    return unary, skipped


def replay(server: str, dump_dir: str, speed: float = 1.0,
           qps: float = 0.0, loops: int = 1, concurrency: int = 4,
           timeout_ms: float = 1000.0,
           sched_seed: Optional[int] = None) -> ReplayResult:
    """Replay every captured unary sample `loops` times.  Pacing: the
    captured inter-request gaps divided by `speed` (the incident's own
    shape, sped up), or a fixed `qps`, or flat-out when neither is set.
    Open-loop across `concurrency` workers: a worker whose sample is due
    sends it regardless of how the server answered the last one."""
    from brpc_tpu_torch.rpc import errors
    from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions

    _arm_sched_seed(sched_seed)
    samples, skipped = _load_unary(dump_dir)
    res = ReplayResult(samples=len(samples), skipped=skipped,
                       speed=speed, sched_seed=sched_seed)
    if not samples:
        return res

    # due[i]: seconds after replay start at which shot i fires.  The
    # captured timestamps carry the incident's burst structure; --speed
    # compresses it.  A zero-gap capture (or --qps) degrades to uniform
    # pacing; speed/qps both unset = every shot due immediately.
    n_total = len(samples) * max(loops, 1)
    t_base = samples[0].timestamp
    due = [0.0] * n_total
    span = (samples[-1].timestamp - t_base) if len(samples) > 1 else 0.0
    for k in range(n_total):
        i = k % len(samples)
        lap = k // len(samples)
        if qps > 0:
            due[k] = k / qps
        elif speed > 0:
            off = samples[i].timestamp - t_base
            due[k] = (off + lap * span) / speed
        else:
            due[k] = 0.0

    lock = threading.Lock()
    next_idx = [0]
    t0 = time.monotonic()

    def worker():
        ch = Channel(server, ChannelOptions(timeout_ms=timeout_ms,
                                            max_retry=0))
        lat, calls, errs, shed, behind = [], 0, 0, 0, 0
        while True:
            with lock:
                k = next_idx[0]
                if k >= n_total:
                    break
                next_idx[0] += 1
            s = samples[k % len(samples)]
            at = t0 + due[k]
            now = time.monotonic()
            if now < at:
                time.sleep(at - now)
            elif due[k] > 0:
                behind += 1  # lagging the capture's shape: still send
            t1 = time.monotonic_ns()
            try:
                ch.call_raw(s.method, s.payload, s.attachment,
                            timeout_ms=timeout_ms,
                            compress_type=s.compress_type,
                            payload_codec=s.payload_codec,
                            attach_codec=s.attach_codec)
                lat.append((time.monotonic_ns() - t1) // 1000)
            except errors.RpcError as e:
                if e.code == errors.ELIMIT:
                    shed += 1  # the overload plane working, not an error
                else:
                    errs += 1
            except Exception:
                errs += 1
            calls += 1
        ch.close()
        with lock:
            res.calls += calls
            res.errors += errs
            res.shed += shed
            res.behind += behind
            res.latencies_us.extend(lat)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(concurrency, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    res.wall_s = time.monotonic() - t0
    return res


def replay_stream(server: str, dump_dir: str, loops: int = 1,
                  concurrency: int = 2, timeout_ms: float = 30000.0,
                  read_timeout_s: float = 60.0,
                  sched_seed: Optional[int] = None) -> StreamReplayResult:
    """Replay captured token-stream sessions end-to-end: every captured
    stream-OPEN sample (a request frame carrying a stream id) re-issues
    its handshake and drains tokens to EOF — the serving-workload half
    of the cannon (data/close frames ride the re-opened stream; the
    captured ones are session-internal and are not re-sent)."""
    from brpc_tpu_torch.rpc import errors
    from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
    from brpc_tpu_torch.rpc.dump import SampleIterator
    from brpc_tpu_torch.rpc.stream import StreamReset, StreamTimeout

    _arm_sched_seed(sched_seed)
    opens = [s for s in SampleIterator(dump_dir)
             if s.stream_id != 0 and s.stream_frame_type == 0
             and s.method and s.method != "REDIS"]
    opens.sort(key=lambda s: s.timestamp)
    res = StreamReplayResult(sched_seed=sched_seed)
    if not opens:
        return res

    sessions = [opens[k % len(opens)]
                for k in range(len(opens) * max(loops, 1))]
    lock = threading.Lock()
    next_idx = [0]
    t_start = time.monotonic()

    def worker():
        ch = Channel(server, ChannelOptions(timeout_ms=timeout_ms,
                                            max_retry=0))
        ttft, gaps = [], []
        ses = completed = shed = resets = errs = tokens = 0
        while True:
            with lock:
                k = next_idx[0]
                if k >= len(sessions):
                    break
                next_idx[0] += 1
            s = sessions[k]
            ses += 1
            t0 = time.monotonic_ns()
            try:
                _, st = ch.create_stream(s.method, s.payload, s.attachment)
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
                resets += 1
            except StreamTimeout:
                errs += 1
            except Exception:
                errs += 1
            st.destroy()
        ch.close()
        with lock:
            res.sessions += ses
            res.completed += completed
            res.shed += shed
            res.resets += resets
            res.errors += errs
            res.tokens += tokens
            res.ttft_us.extend(ttft)
            res.gap_us.extend(gaps)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(concurrency, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    res.wall_s = time.monotonic() - t_start
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="replay captured rpc_dump segments byte-for-byte")
    ap.add_argument("-s", "--server", required=True, help="ip:port")
    ap.add_argument("--dir", default="./rpc_dump", help="dump directory")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="replay at N x the captured rate (gaps from the "
                         "captured timestamps, divided by N; 0 = flat out)")
    ap.add_argument("-q", "--qps", type=float, default=0.0,
                    help="fixed-rate override (ignores captured gaps)")
    ap.add_argument("--loop", type=int, default=1,
                    help="times to replay the whole set")
    ap.add_argument("-c", "--concurrency", type=int, default=4,
                    help="open-loop worker threads")
    ap.add_argument("--timeout-ms", type=float, default=1000.0)
    ap.add_argument("--stream", action="store_true",
                    help="replay captured token-stream sessions to EOF "
                         "(TTFT / inter-token-gap percentiles)")
    ap.add_argument("--read-timeout", type=float, default=60.0,
                    help="--stream per-read budget seconds")
    ap.add_argument("--sched-seed", type=int, default=None,
                    help="arm TRPC_SCHED_SEED schedule replay before "
                         "traffic (deterministic incident reproduction)")
    ap.add_argument("--json", action="store_true",
                    help="print ONE machine-readable JSON line")
    args = ap.parse_args(argv)
    if args.stream:
        sres = replay_stream(args.server, args.dir, loops=args.loop,
                             concurrency=args.concurrency,
                             read_timeout_s=args.read_timeout,
                             sched_seed=args.sched_seed)
        print(sres.to_json_line() if args.json else sres.summary())
        return 1 if sres.errors and not sres.tokens else 0
    res = replay(args.server, args.dir, speed=args.speed, qps=args.qps,
                 loops=args.loop, concurrency=args.concurrency,
                 timeout_ms=args.timeout_ms, sched_seed=args.sched_seed)
    print(res.to_json_line() if args.json else res.summary())
    return 1 if res.errors and not res.admitted else 0


if __name__ == "__main__":
    raise SystemExit(main())
