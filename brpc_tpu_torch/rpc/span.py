"""rpcz — sampled per-RPC spans (≙ the reference Span, span.h:47: created
per RPC client-side in Channel::CallMethod (channel.cpp:467-485) and
server-side in ProcessRpcRequest; free-text Annotate (span.h:80); sampling
throttled by bvar::Collector, collector.h:41 COLLECTOR_SAMPLING_BASE;
browsed through the /rpcz builtin service, builtin/rpcz_service.cpp).

TPU build differences: spans live in an in-process ring, and — when
``rpcz_persist_dir`` names a directory — finished spans additionally
spill to disk through the shared Collector (metrics/collector.py, the
≙ bvar::Collector background service) into length-prefixed recordio
files (utils/recordio.py) with size-based rotation, a time-keyed index
(index.txt: file min_ts max_ts count) and age-based expiry — the
capability of the reference persisting spans to leveldb with
span_db.cpp's time-indexed browsing (≙ span.cpp:476-494,672:
ForkAndSaveTo + the leveldb SpanDB).  ``/rpcz?time=<epoch>`` reads back
from disk, so sampled spans survive a process restart.  Sampling is a
plain token bucket refilled per second.  Span creation is off unless the
``enable_rpcz`` flag is on (≙ --enable_rpcz).
"""

from __future__ import annotations

import itertools
import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

from brpc_tpu_torch.utils import flags
from brpc_tpu_torch.utils import recordio

def _push_rpcz(value) -> bool:
    """Flag validator doubling as the native push: the C++ span rings
    (native/src/metrics.h rpcz_*) capture fast-path spans only while the
    native half of the switch is on."""
    from brpc_tpu_torch._native import lib
    lib().trpc_set_rpcz(1 if value else 0)
    return True


def _push_rpcz_budget(value) -> bool:
    if value < 0:
        return False
    from brpc_tpu_torch._native import lib
    lib().trpc_set_rpcz_budget(int(value))
    return True


def _resize_ring(value) -> bool:
    """Flag validator doubling as the resize: a new ring size takes
    effect at once, keeping the newest spans that fit."""
    if value < 0:
        return False
    _store.resize(int(value))
    return True


flags.define_bool("enable_rpcz", False, "collect rpcz spans",
                  validator=_push_rpcz)
flags.define_int32("rpcz_max_samples_per_second", 16384,
                   "span sampling budget (≙ COLLECTOR_SAMPLING_BASE); "
                   "shared by the Python spans and the native span rings",
                   validator=_push_rpcz_budget)
flags.define_int32("rpcz_keep_spans", 10000, "ring size of kept spans",
                   validator=_resize_ring)
flags.define_string("rpcz_persist_dir", "",
                    "directory for rpcz span spill files (recordio, "
                    "rotated + time-indexed + expired); empty = spans "
                    "live only in the in-memory ring (≙ the reference "
                    "persisting spans via SpanDB/leveldb)")
flags.define_int32("rpcz_persist_rotate_bytes", 1 << 20,
                   "rotate the active span spill file past this size "
                   "(each rotation adds a time-keyed index entry)")
flags.define_int32("rpcz_persist_expiry_s", 24 * 3600,
                   "delete span spill files whose newest span is older "
                   "than this (checked at rotation and at read time; "
                   "≙ the reference's --span_keeping_seconds)")

_id_gen = itertools.count(random.getrandbits(48) << 8)
_tls = threading.local()


def _new_id() -> int:
    return next(_id_gen)


@dataclass
class Span:
    trace_id: int
    span_id: int
    parent_span_id: int = 0
    kind: str = "server"            # "server" | "client" | "local"
    method: str = ""
    remote_side: str = ""
    start_ts: float = 0.0           # wall clock (display, spill index)
    latency_us: int = 0
    error_code: int = 0
    annotations: List[str] = field(default_factory=list)
    # time.monotonic_ns(), i.e. CLOCK_MONOTONIC: the clock a profiler
    # slice's host anchor is read on, so a span can be placed on the
    # slice's device timeline; 0 where the span predates them
    start_ns: int = 0
    end_ns: int = 0

    def annotate(self, text: str) -> None:
        """≙ TRACEPRINTF (traceprintf.h): free text with a timestamp."""
        dt_us = int((time.time() - self.start_ts) * 1e6)
        self.annotations.append(f"+{dt_us}us {text}")

    def describe(self) -> dict:
        return {
            "trace_id": f"{self.trace_id:x}",
            "span_id": f"{self.span_id:x}",
            "parent_span_id": f"{self.parent_span_id:x}",
            "kind": self.kind,
            "method": self.method,
            "remote_side": self.remote_side,
            "start": time.strftime("%Y-%m-%d %H:%M:%S",
                                   time.localtime(self.start_ts)),
            "latency_us": self.latency_us,
            "error_code": self.error_code,
            "annotations": self.annotations,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
        }


class _Store:
    """Ring of finished spans + per-second sampling budget
    (the budget is the shared Collector primitive, ≙ bvar::Collector)."""

    def __init__(self):
        from brpc_tpu_torch.metrics.collector import PerSecondBudget
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(flags.get_flag(
            "rpcz_keep_spans")))
        self._budget = PerSecondBudget("rpcz_max_samples_per_second")

    def try_sample(self) -> bool:
        return self._budget.try_take()

    def add(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)

    def resize(self, n: int) -> None:
        with self._lock:
            self._ring = deque(self._ring, maxlen=n)

    def recent(self, n: int, trace_id: Optional[int]) -> List[Span]:
        with self._lock:
            items = list(self._ring)
        if trace_id is not None:
            items = [s for s in items if s.trace_id == trace_id]
        return items[-n:][::-1]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_store = _Store()


# --- disk spill (≙ span.cpp:476-494,672: spans forked to the collector
# and persisted; browsed back by time) --------------------------------------


def _span_to_payload(s: Span) -> bytes:
    return json.dumps({
        "trace_id": s.trace_id, "span_id": s.span_id,
        "parent_span_id": s.parent_span_id, "kind": s.kind,
        "method": s.method, "remote_side": s.remote_side,
        "start_ts": s.start_ts, "latency_us": s.latency_us,
        "error_code": s.error_code, "annotations": s.annotations,
        "start_ns": s.start_ns, "end_ns": s.end_ns,
    }).encode()


def _span_from_payload(payload: bytes) -> Optional[Span]:
    try:
        d = json.loads(payload.decode())
        return Span(trace_id=int(d["trace_id"]), span_id=int(d["span_id"]),
                    parent_span_id=int(d.get("parent_span_id", 0)),
                    kind=d.get("kind", "server"),
                    method=d.get("method", ""),
                    remote_side=d.get("remote_side", ""),
                    start_ts=float(d.get("start_ts", 0.0)),
                    latency_us=int(d.get("latency_us", 0)),
                    error_code=int(d.get("error_code", 0)),
                    annotations=list(d.get("annotations", [])),
                    start_ns=int(d.get("start_ns", 0)),
                    end_ns=int(d.get("end_ns", 0)))
    except (ValueError, KeyError, TypeError):
        return None  # torn/foreign record: recordio already resynced


class _Persister:
    """Span spill files under ``rpcz_persist_dir``:

        spans-<ms>.rio   rotated recordio segments (utils/recordio.py)
        index.txt        one line per SEALED segment: name min max count

    Writes arrive on the Collector thread only (on_collected); reads
    (read_persisted) take the same lock, flush the active segment and
    scan index entries whose [min_ts, max_ts] window is relevant — the
    time-keyed lookup that makes /rpcz?time= skip cold segments."""

    def __init__(self):
        self._lock = threading.Lock()
        self._writer: Optional[recordio.RecordWriter] = None
        self._path = ""        # active segment (not yet in the index)
        self._min_ts = 0.0
        self._max_ts = 0.0
        self._count = 0
        self._seq = 0          # disambiguates same-millisecond rotations

    def _dir(self) -> str:
        d = str(flags.get_flag("rpcz_persist_dir") or "")
        # normalized: a trailing slash must not defeat the active-segment
        # dir comparison in write() (it would seal+reopen per span)
        return os.path.normpath(d) if d else ""

    def _index_path(self, d: str) -> str:
        return os.path.join(d, "index.txt")

    def _open_locked(self, d: str, first_ts: float) -> None:
        os.makedirs(d, exist_ok=True)
        self._seq += 1
        name = f"spans-{int(first_ts * 1000)}-{os.getpid()}-{self._seq}.rio"
        self._path = os.path.join(d, name)
        self._writer = recordio.RecordWriter(self._path)
        self._min_ts = first_ts
        self._max_ts = first_ts
        self._count = 0

    def _seal_locked(self, d: str) -> None:
        if self._writer is None:
            return
        self._writer.close()
        with open(self._index_path(d), "a", encoding="utf-8") as f:
            f.write(f"{os.path.basename(self._path)} {self._min_ts:.6f} "
                    f"{self._max_ts:.6f} {self._count}\n")
        self._writer = None
        self._path = ""

    def _expire_locked(self, d: str) -> None:
        """Drop sealed segments whose newest span aged out; rewrite the
        index without them."""
        idx = self._index_path(d)
        if not os.path.exists(idx):
            return
        horizon = time.time() - int(flags.get_flag("rpcz_persist_expiry_s"))
        keep, dropped = [], []
        with open(idx, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) != 4:
                    continue
                if float(parts[2]) >= horizon:
                    keep.append(line)
                else:
                    dropped.append(parts[0])
        if not dropped:
            return
        for name in dropped:
            try:
                os.unlink(os.path.join(d, name))
            except OSError:
                pass
        tmp = idx + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.writelines(keep)
        os.replace(tmp, idx)  # atomic: readers never see a half index

    def write(self, s: Span) -> None:
        d = self._dir()
        if not d:
            return
        with self._lock:
            if self._writer is not None and \
                    not self._path.startswith(d + os.sep):
                self._seal_locked(os.path.dirname(self._path))  # dir moved
            if self._writer is None:
                self._open_locked(d, s.start_ts)
            self._writer.write(_span_to_payload(s))
            self._min_ts = min(self._min_ts, s.start_ts)
            self._max_ts = max(self._max_ts, s.start_ts)
            self._count += 1
            if self._writer.tell() >= int(
                    flags.get_flag("rpcz_persist_rotate_bytes")):
                self._seal_locked(d)
                self._expire_locked(d)

    def read(self, at_ts: float, limit: int) -> List[Span]:
        """Spans with start_ts <= at_ts, newest first, from disk — the
        restart-surviving read path behind /rpcz?time=."""
        d = self._dir()
        if not d or not os.path.isdir(d):
            return []
        with self._lock:
            if self._writer is not None:
                self._writer.flush()  # the active segment is readable
            active = self._path
            self._expire_locked(d)
            candidates: List[str] = []
            sealed: set = set()  # EVERY indexed name, kept or time-skipped
            idx = self._index_path(d)
            if os.path.exists(idx):
                with open(idx, encoding="utf-8") as f:
                    for line in f:
                        parts = line.split()
                        if len(parts) != 4:
                            continue
                        sealed.add(parts[0])
                        # time-keyed skip: a segment strictly newer than
                        # the asked time can hold no matching span
                        if float(parts[1]) <= at_ts:
                            candidates.append(os.path.join(d, parts[0]))
            if active and self._min_ts <= at_ts:
                candidates.append(active)
            # crash recovery: an unsealed segment from a previous process
            # has no index entry — scan for orphans.  Exclusion must use
            # the FULL sealed set: a time-skipped sealed segment is not
            # an orphan, and re-adding it here would defeat the
            # time-keyed pruning (reading every cold segment anyway).
            for name in sorted(os.listdir(d)):
                if name.startswith("spans-") and name.endswith(".rio") \
                        and name not in sealed and \
                        os.path.join(d, name) != active:
                    candidates.append(os.path.join(d, name))
            candidates = list(dict.fromkeys(candidates))
        out: List[Span] = []
        for path in candidates:
            try:
                for payload in recordio.read_records(path):
                    s = _span_from_payload(payload)
                    if s is not None and s.start_ts <= at_ts:
                        out.append(s)
            except OSError:
                continue  # expired between listing and reading
        out.sort(key=lambda s: s.start_ts, reverse=True)
        return out[:limit]


_persister = _Persister()


class _SpanSample:
    """Collected adapter: the hot path pays one Collector submit; the
    recordio write happens on the collector thread (≙ bvar::Collected)."""

    def __init__(self, span: Span):
        self._span = span

    def on_collected(self) -> None:
        _persister.write(self._span)


def persisting() -> bool:
    return bool(flags.get_flag("rpcz_persist_dir"))


# --- native fast-path spans (native/src/metrics.h span rings) ---------------
# Inline-dispatched requests never enter Python, so their sampled spans
# live in per-shard native rings; drain_native() pulls them into the SAME
# store/persistence the Python spans use — /rpcz shows one merged view,
# and the recordio spill rides the shared Collector unchanged.

# presentation (kind, method label) per native family id (metrics.h
# TelemetryFamily); a family added natively falls back to its capi name
# with kind "server" instead of a blind "native" label
_NATIVE_FAMILY_VIEW = {
    0: ("server", "Echo (native inline)"),
    1: ("server", "HbmEcho (native)"),
    2: ("server", "redis_cache (native)"),
    3: ("server", "usercode (native)"),
    4: ("client", "client (native unary)"),
    5: ("client", "fanout (native group)"),
}


def _family_view(fam: int):
    view = _NATIVE_FAMILY_VIEW.get(fam)
    if view is not None:
        return view
    try:
        from brpc_tpu_torch._native import lib
        return ("server",
                lib().trpc_telemetry_family_name(fam).decode() +
                " (native)")
    except Exception:
        return ("server", "native")


_drain_lock = threading.Lock()


def drain_native() -> int:
    """Move captured native spans into the span store (returns how many).
    Called on every /rpcz read and recent_spans() — reads happen at human
    frequency; the native side is lock-free for its writers."""
    if not enabled():
        return 0
    try:
        import ctypes
        from brpc_tpu_torch._native import lib
    except Exception:
        return 0  # native core unavailable (exotic import contexts)
    moved = 0
    # rebase CLOCK_MONOTONIC capture stamps onto the wall clock once per
    # drain (both sides read the same kernel clocks on Linux)
    offset = time.time() - time.monotonic()
    with _drain_lock:
        buf = ctypes.create_string_buffer(1 << 20)
        while True:
            n = lib().trpc_rpcz_drain(buf, len(buf))
            if n == 0:
                break
            for line in buf.raw[:n].decode("utf-8", "replace").splitlines():
                parts = line.split("\t")
                if len(parts) < 8:
                    continue
                try:
                    fam = int(parts[3])
                    kind, method = _family_view(fam)
                    start_ns = int(parts[6])
                    s = Span(
                        trace_id=int(parts[0]), span_id=int(parts[1]),
                        parent_span_id=int(parts[2]),
                        kind=kind, method=method,
                        start_ts=start_ns / 1e9 + offset,
                        latency_us=int(parts[7]),
                        error_code=int(parts[4]),
                        annotations=[a for a in parts[8].split("|") if a],
                        start_ns=start_ns,
                        end_ns=start_ns + int(parts[7]) * 1000)
                except (ValueError, IndexError):
                    continue
                s.remote_side = f"shard{parts[5]}"
                _store.add(s)
                if persisting():
                    from brpc_tpu_torch.metrics.collector import global_collector
                    global_collector().submit(_SpanSample(s))
                moved += 1
            if n < len(buf) - 256:
                break  # the rings are drained (not a buffer-full stop)
    return moved


def read_persisted(at_ts: Optional[float] = None,
                   limit: int = 100) -> List[Span]:
    """Disk read-back for /rpcz?time= (spans survive restarts)."""
    return _persister.read(at_ts if at_ts is not None else time.time(),
                           limit)


def enabled() -> bool:
    return bool(flags.get_flag("enable_rpcz"))


def start_span(kind: str, method: str, trace_id: int = 0,
               parent_span_id: int = 0) -> Optional[Span]:
    """Create a sampled span, or None (disabled / over budget).
    A zero trace_id starts a new trace (≙ Span::CreateServerSpan with no
    inherited ids)."""
    if not enabled() or not _store.try_sample():
        return None
    s = Span(trace_id=trace_id or _new_id(), span_id=_new_id(),
             parent_span_id=parent_span_id, kind=kind, method=method,
             start_ts=time.time(), start_ns=time.monotonic_ns())
    return s


def record(parent: Optional[Span], method: str, start_ns: int, end_ns: int,
           children=(), error_code: int = 0) -> Optional[Span]:
    """Keep a finished span of work inside this process, timed by the
    caller's own ``time.monotonic_ns()`` stamps, under a sampled `parent`,
    with its `children` as (method, start_ns, end_ns[, children]); None
    without a parent.  A child draws nothing from the sampling budget, so
    a trace is kept whole or not at all."""
    if parent is None:
        return None
    s = Span(trace_id=parent.trace_id, span_id=_new_id(),
             parent_span_id=parent.span_id, kind="local", method=method,
             start_ts=start_ns / 1e9 + (time.time() - time.monotonic()),
             start_ns=start_ns)
    for child in children:
        record(s, *child)
    finish_span(s, error_code, end_ns)
    return s


def finish_span(span: Optional[Span], error_code: int = 0,
                end_ns: Optional[int] = None) -> None:
    """Close `span` now, or at `end_ns` (``time.monotonic_ns()``), and
    keep it."""
    if span is None:
        return
    span.end_ns = time.monotonic_ns() if end_ns is None else end_ns
    span.latency_us = (span.end_ns - span.start_ns) // 1000
    span.error_code = error_code
    _store.add(span)
    if persisting():
        # spill through the shared Collector (rate-limited background
        # service): the RPC path pays one budget check + deque append,
        # the recordio write runs on the collector thread
        from brpc_tpu_torch.metrics.collector import global_collector
        global_collector().submit(_SpanSample(span))


def set_current(span: Optional[Span]) -> None:
    """TLS parent for annotate() (≙ tls_parent, span.h:115)."""
    _tls.span = span


def current() -> Optional[Span]:
    return getattr(_tls, "span", None)


def annotate(text: str) -> None:
    """≙ TRACEPRINTF into the current span; no-op when unsampled."""
    s = current()
    if s is not None:
        s.annotate(text)


def recent_spans(n: int = 100, trace_id: Optional[int] = None) -> List[Span]:
    drain_native()  # fast-path spans surface beside the Python ones
    return _store.recent(n, trace_id)


def clear() -> None:
    _store.clear()
