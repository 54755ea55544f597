"""Combo channels — fan-out/merge, partitioned, and selective composition
(≙ reference ParallelChannel parallel_channel.h:94-216, PartitionChannel /
DynamicPartitionChannel partition_channel.h:46-136, SelectiveChannel
selective_channel.h:52-72 — re-designed: the host side keeps the
CallMapper/ResponseMerger/fail_limit vocabulary, and the same vocabulary
lowers to ONE XLA collective over a mesh axis when the member set is a TPU
mesh axis instead of N host RPCs, per SURVEY.md §2.9's lowering table).

Host-side classes (heterogeneous members over TCP/DCN):
    ParallelChannel   — scatter/broadcast to all sub-channels, merge
    PartitionChannel  — shard one logical request across "i/n"-tagged
                        partitions from a naming service
    DynamicPartitionChannel — several partitioning schemes live at once,
                        traffic weighted by scheme capacity
    SelectiveChannel  — LB across sub-channels, failover between them

Mesh lowering (member set == a mesh axis):
    MeshParallelChannel  — merge IS the collective: psum/pmax/concat ride
                           ICI (all_reduce / all_gather)
    MeshPartitionChannel — partitioned request = sharded array; gather or
                           reduce-scatter is the merge
"""

from __future__ import annotations

import random
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from brpc_tpu_torch.cluster.naming import (ServerNode, Watcher,
                                     acquire_naming_watcher)
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.controller import Controller

# --- call mapping / response merging (≙ parallel_channel.h:94,127) ---------


@dataclass
class SubCall:
    """What one sub-channel should be asked (≙ reference SubCall: method +
    request + flags)."""
    method: str
    payload: bytes
    attachment: bytes = b""


SKIP = None  # a CallMapper may return SKIP to leave a sub-channel out


class CallMapper:
    """Maps the logical call onto each sub-channel
    (≙ CallMapper::Map(channel_index, method, request), return SKIP to
    skip).  Default: broadcast the same request to every member."""

    def map(self, channel_index: int, nchannels: int, method: str,
            payload: bytes, attachment: bytes) -> Optional[SubCall]:
        return SubCall(method, payload, attachment)


class ResponseMerger:
    """Merges sub-responses into the final response
    (≙ ResponseMerger::Merge).  `results` has one slot per sub-channel:
    bytes on success, None on failure or SKIP.  Default: in-order concat
    of successes."""

    def merge(self, results: List[Optional[bytes]]) -> bytes:
        return b"".join(r for r in results if r is not None)


class FirstResponseMerger(ResponseMerger):
    """First successful response wins (broadcast-race semantics)."""

    def merge(self, results: List[Optional[bytes]]) -> bytes:
        for r in results:
            if r is not None:
                return r
        return b""


# --- ParallelChannel -------------------------------------------------------


class ParallelChannel:
    """Fan a call out to every sub-channel concurrently and merge
    (≙ brpc::ParallelChannel, parallel_channel.h:185; fail_limit :168).

    fail_limit=None means every mapped sub-call must succeed (the
    reference's default); fail_limit=k tolerates up to k failures.
    """

    def __init__(self, response_merger: Optional[ResponseMerger] = None,
                 fail_limit: Optional[int] = None,
                 timeout_ms: float = 1000.0):
        self._subs: List[Tuple[object, CallMapper]] = []
        self._merger = response_merger or ResponseMerger()
        self.fail_limit = fail_limit
        self.timeout_ms = timeout_ms
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()

    def add_channel(self, channel, call_mapper: Optional[CallMapper] = None):
        """`channel` is anything with .call(method, payload, attachment=,
        cntl=) — an rpc.Channel, another combo channel, ... (the reference
        nests combo channels the same way)."""
        self._subs.append((channel, call_mapper or CallMapper()))

    def channel_count(self) -> int:
        return len(self._subs)

    def _submit_all(self, fn, arg_tuples):
        """Grow-and-submit atomically: submissions happen under the lock,
        so a pool replaced by a concurrent grower can be shut down right
        away — nobody can be submitting to it (shutdown(wait=False) lets
        already-submitted work finish on the old pool's threads)."""
        with self._lock:
            want = max(4, 2 * len(self._subs))
            if self._pool is None or self._pool._max_workers < want:
                old = self._pool
                self._pool = ThreadPoolExecutor(
                    max_workers=want,
                    thread_name_prefix="parallel_channel")
                if old is not None:
                    old.shutdown(wait=False)
            return [self._pool.submit(fn, *args) for args in arg_tuples]

    def close(self):
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def _native_fanout_attempt(self, pending, results, cntl,
                               fail_codes) -> bool:
        """Serialize-once fast path: when every mapped member is a plain
        rpc.Channel with a direct native sub-channel and the mapper
        broadcast identical SubCalls, issue the whole group through ONE
        native channel_fanout_call — the request body is serialized once
        and shared as refcounted IOBuf blocks across all N frames
        (native_fanout_shared_serializations counts exactly 1 per group),
        and sub-responses are completed by the arriving parse fibers
        instead of trampolining through a pool thread per sub-response.
        Returns False when the group is not eligible (heterogeneous
        members, per-member payloads, cluster/compressed channels) — the
        caller then takes the thread-pool path.  Failed members are left
        as None in `results` with their native error code recorded in
        `fail_codes[i]`, so the caller can apply each channel's OWN retry
        policy before re-issuing anything."""
        if not pending:
            return True
        from brpc_tpu_torch.rpc.channel import Channel as _RpcChannel
        from brpc_tpu_torch.rpc.channel import native_fanout
        first_sc = pending[0][1]
        subs = []
        for i, sc in pending:
            ch = self._subs[i][0]
            if (not isinstance(ch, _RpcChannel) or ch._cluster is not None
                    or ch._sub is None
                    or ch.options.request_compress_type
                    # backup-request hedging lives in Channel.call's
                    # _backup_race — a member that asked for it must not
                    # silently lose the hedge to the native wave
                    or ch.options.backup_request_ms is not None
                    or cntl.backup_request_ms is not None):
                return False
            if (sc.method != first_sc.method
                    or sc.payload != first_sc.payload
                    or sc.attachment != first_sc.attachment):
                return False  # not a broadcast: nothing to share
            # the fast path bypasses Channel.call, so time-boxed
            # credentials must rotate HERE too (no-op without an
            # authenticator) — a fanout-only workload otherwise starts
            # failing EAUTH at max_skew_s
            ch._maybe_refresh_credential()
            subs.append(ch._sub)
        timeout_ms = (cntl.timeout_ms if cntl.timeout_ms is not None
                      else self.timeout_ms)
        # observability parity with Channel.call: one rpcz span per
        # sub-call, the class-wide client LatencyRecorder, and the tpu://
        # transport-settled announcement — the fast path must not make
        # the metrics the parity docs key on silently vanish
        import time as _t
        from brpc_tpu_torch.rpc import span as span_mod
        sps = [span_mod.start_span("client", first_sc.method)
               for _ in pending]
        t0 = _t.monotonic_ns()
        try:
            outs = native_fanout(subs, first_sc.method.encode(),
                                 first_sc.payload, first_sc.attachment,
                                 int(timeout_ms * 1000))
        except Exception:
            for sp in sps:
                if sp is not None:
                    span_mod.finish_span(sp, errors.EINTERNAL)
            return False  # e.g. a member closed mid-call: slow path
        lat_us = (_t.monotonic_ns() - t0) // 1000
        any_ok = False
        for k, ((i, _), (code, text, data, _att)) in enumerate(
                zip(pending, outs)):
            if sps[k] is not None:
                span_mod.finish_span(sps[k], code)
            if code == 0:
                results[i] = data
                any_ok = True
                self._subs[i][0]._check_transport_settled()
            else:
                fail_codes[i] = (code, text)
        # the native API times the GROUP, not each member: record that
        # wall-clock ONCE (recording it per member would weight every
        # sample at the slowest member's latency and inflate the
        # class-wide rpc_client percentiles N-fold)
        if any_ok and _RpcChannel._latency is not None:
            _RpcChannel._latency.record(lat_us)
        return True

    def call(self, method: str, payload: bytes = b"",
             attachment: bytes = b"",
             cntl: Optional[Controller] = None) -> bytes:
        cntl = cntl or Controller()
        n = len(self._subs)
        if n == 0:
            raise errors.RpcError(errors.ENOSERVICE, "no sub-channels")
        mapped: List[Optional[SubCall]] = [
            mapper.map(i, n, method, payload, attachment)
            for i, (_, mapper) in enumerate(self._subs)]
        results: List[Optional[bytes]] = [None] * n
        first_err: List[Optional[errors.RpcError]] = [None]

        import time as _t
        start = _t.monotonic()
        total_ms = (cntl.timeout_ms if cntl.timeout_ms is not None
                    else self.timeout_ms)

        def one(i: int, sub_call: SubCall, max_retry=None,
                timeout_ms=None):
            ch, _ = self._subs[i]
            sub_cntl = Controller()
            sub_cntl.timeout_ms = (total_ms if timeout_ms is None
                                   else timeout_ms)
            sub_cntl.max_retry = max_retry  # None = the channel's own
            try:
                results[i] = ch.call(sub_call.method, sub_call.payload,
                                     attachment=sub_call.attachment,
                                     cntl=sub_cntl)
            except errors.RpcError as e:
                if first_err[0] is None:
                    first_err[0] = e

        pending = [(i, sc) for i, sc in enumerate(mapped) if sc is not None]
        fail_codes: Dict[int, Tuple[int, str]] = {}
        if self._native_fanout_attempt(pending, results, cntl, fail_codes):
            # happy path done natively.  The unhappy tail re-runs through
            # the per-sub path ONLY where that channel's own retry policy
            # says the error is retriable — re-issuing a timed-out
            # non-idempotent call would execute it twice (the default
            # policy deliberately excludes ERPCTIMEDOUT, channel.py).
            from brpc_tpu_torch.rpc.channel import _default_retry
            retriable = []
            for i, sc in pending:
                if results[i] is not None:
                    continue
                code, text = fail_codes.get(i, (errors.EINTERNAL, ""))
                ch = self._subs[i][0]
                policy = (getattr(ch, "options", None)
                          and ch.options.retry_policy) or _default_retry
                # the native wave spent attempt #1 AND part of the clock:
                # the fallback gets the REMAINING attempt budget and the
                # REMAINING deadline, so a max_retry=0 channel executes
                # exactly once and the group never exceeds its timeout
                budget = (cntl.max_retry if cntl.max_retry is not None
                          else ch.options.max_retry)
                left_ms = total_ms - (_t.monotonic() - start) * 1e3
                probe = Controller()
                probe.error_code, probe.error_text = code, text
                if budget > 0 and left_ms > 1.0 and policy.do_retry(probe):
                    retriable.append((i, sc, budget - 1, left_ms))
                elif first_err[0] is None:
                    first_err[0] = errors.RpcError(code, text)
            pending = retriable
        if pending:
            futures = self._submit_all(one, pending)
            for f in futures:
                f.result()
        mapped_n = sum(1 for sc in mapped if sc is not None)
        ok_n = sum(1 for i, sc in enumerate(mapped)
                   if sc is not None and results[i] is not None)
        failures = mapped_n - ok_n
        limit = self.fail_limit if self.fail_limit is not None else 0
        if failures > limit:
            err = first_err[0] or errors.RpcError(errors.EINTERNAL)
            cntl.set_failed(err.code, err.text)
            raise errors.RpcError(
                err.code, f"{failures}/{mapped_n} sub-calls failed "
                          f"(fail_limit={limit}): {err.text}")
        return self._merger.merge(results)


# --- PartitionChannel ------------------------------------------------------


class PartitionParser:
    """Parses a naming tag into (partition_index, partition_count), or None
    if the tag is not a partition of this channel (≙ reference
    PartitionParser::ParseFromTag, partition_channel.h:46).  Default tag
    grammar: "i/n" e.g. "0/4"."""

    def parse(self, tag: str) -> Optional[Tuple[int, int]]:
        try:
            i, n = tag.split("/", 1)
            i, n = int(i), int(n)
        except ValueError:
            return None
        if n <= 0 or not 0 <= i < n:
            return None
        return i, n


class PartitionChannel:
    """Shards one logical request across the partitions of a cluster
    (≙ brpc::PartitionChannel, partition_channel.h:75).  Members come from
    a naming service whose tags carry "i/n"; each partition index becomes
    one sub-cluster (its own LB over the replicas of that partition), and
    a call fans out to ALL n partitions through the CallMapper/Merger
    machinery.  `partition_count` pins n; nodes of other schemes are
    ignored (DynamicPartitionChannel handles mixed schemes)."""

    def __init__(self, naming_url: str, partition_count: int,
                 call_mapper: Optional[CallMapper] = None,
                 response_merger: Optional[ResponseMerger] = None,
                 fail_limit: Optional[int] = None,
                 load_balancer: str = "rr",
                 timeout_ms: float = 1000.0):
        from brpc_tpu_torch.rpc.channel import Channel  # cycle: parallel ↔ rpc
        self._Channel = Channel
        self.partition_count = partition_count
        self._parser = PartitionParser()
        self._mapper = call_mapper or CallMapper()
        self._merger = response_merger or ResponseMerger()
        self.fail_limit = fail_limit
        self.load_balancer = load_balancer
        self.timeout_ms = timeout_ms
        self._lock = threading.Lock()
        self._members: Dict[int, List[ServerNode]] = {}
        self._parts: Dict[int, object] = {}  # index -> rpc.Channel
        self._pc: Optional[ParallelChannel] = None  # persistent fan-out
        self._watcher = _PartitionWatcher(self)
        self._ns = acquire_naming_watcher(naming_url, self._watcher)
        self._ns.wait_first_resolve()
        self._rebuild(self._ns.nodes())

    # membership → per-partition list:// channels ---------------------------

    def _rebuild(self, nodes: Sequence[ServerNode]) -> None:
        groups: Dict[int, List[ServerNode]] = {}
        for node in nodes:
            parsed = self._parser.parse(node.tag)
            if parsed is None or parsed[1] != self.partition_count:
                continue
            groups.setdefault(parsed[0], []).append(node)
        old_pc = None
        with self._lock:
            old = self._members
            self._members = groups
            stale = [i for i in self._parts
                     if groups.get(i) != old.get(i)]
            for i in stale:
                ch = self._parts.pop(i)
                ch.close()
            if stale or groups.keys() != old.keys():
                old_pc, self._pc = self._pc, None  # fan-out set changed
        if old_pc is not None:
            old_pc.close()

    def _get_pc(self) -> "ParallelChannel":
        """The persistent fan-out channel: one member per logical partition
        (a dead placeholder where the partition has no servers, so the
        merger always sees `partition_count` positional slots and a missing
        partition counts against the SAME fail_limit as a failed RPC)."""
        with self._lock:
            if self._pc is not None:
                return self._pc
            pc = ParallelChannel(self._merger, self.fail_limit,
                                 self.timeout_ms)
            n = self.partition_count
            for i in range(n):
                ch = self._parts.get(i)
                if ch is None:
                    members = self._members.get(i, [])
                    if members:
                        url = "list://" + ",".join(
                            str(m.endpoint) for m in members)
                        ch = self._parts[i] = self._Channel(
                            url, load_balancer=self.load_balancer,
                            timeout_ms=self.timeout_ms)
                pc.add_channel(ch if ch is not None else _DeadChannel(i),
                               _FixedIndexMapper(self._mapper, i, n))
            self._pc = pc
            return pc

    def partitions_ready(self) -> int:
        with self._lock:
            return sum(1 for i in range(self.partition_count)
                       if self._members.get(i))

    # call ------------------------------------------------------------------

    def call(self, method: str, payload: bytes = b"",
             attachment: bytes = b"",
             cntl: Optional[Controller] = None) -> bytes:
        return self._get_pc().call(method, payload, attachment, cntl)

    def close(self):
        self._ns.remove_watcher(self._watcher)
        with self._lock:
            parts, self._parts = self._parts, {}
            pc, self._pc = self._pc, None
        for ch in parts.values():
            ch.close()
        if pc is not None:
            pc.close()


class _DeadChannel:
    """Placeholder member for a partition with no resolved servers — every
    call fails with ENOSERVICE so the missing partition spends the shared
    fail_limit budget exactly like a failed RPC."""

    def __init__(self, index: int):
        self._index = index

    def call(self, method, payload=b"", attachment=b"", cntl=None):
        raise errors.RpcError(errors.ENOSERVICE,
                              f"partition {self._index} has no servers")


class _FixedIndexMapper(CallMapper):
    """Adapts the user's mapper so partition i keeps its logical index even
    though the ParallelChannel underneath renumbers its members."""

    def __init__(self, inner: CallMapper, index: int, count: int):
        self._inner = inner
        self._index = index
        self._count = count

    def map(self, channel_index, nchannels, method, payload, attachment):
        return self._inner.map(self._index, self._count, method, payload,
                               attachment)


class _PartitionWatcher(Watcher):
    def __init__(self, owner: PartitionChannel):
        self._owner = owner

    def on_servers(self, added, removed, all_nodes):
        self._owner._rebuild(all_nodes)


class DynamicPartitionChannel:
    """Several partitioning schemes coexist; traffic is weighted by each
    scheme's capacity so migrations (2-way → 4-way) drain the old scheme
    gradually (≙ brpc::DynamicPartitionChannel, partition_channel.h:136,
    docs: dynamic_partition_echo example).  Capacity of scheme n = the
    number of complete replica sets it can serve ≈ min over partitions of
    the replica count (0 while incomplete)."""

    def __init__(self, naming_url: str,
                 call_mapper: Optional[CallMapper] = None,
                 response_merger: Optional[ResponseMerger] = None,
                 fail_limit: Optional[int] = None,
                 load_balancer: str = "rr",
                 timeout_ms: float = 1000.0):
        self._naming_url = naming_url
        self._mapper = call_mapper
        self._merger = response_merger
        self._fail_limit = fail_limit
        self._lb = load_balancer
        self._timeout_ms = timeout_ms
        self._lock = threading.Lock()
        self._schemes: Dict[int, PartitionChannel] = {}
        self._watcher = _DynWatcher(self)
        self._ns = acquire_naming_watcher(naming_url, self._watcher)
        self._ns.wait_first_resolve()
        self._sync_schemes(self._ns.nodes())

    def _sync_schemes(self, nodes: Sequence[ServerNode]) -> None:
        parser = PartitionParser()
        counts = set()
        for node in nodes:
            parsed = parser.parse(node.tag)
            if parsed is not None:
                counts.add(parsed[1])
        with self._lock:
            for n in counts:
                if n not in self._schemes:
                    self._schemes[n] = PartitionChannel(
                        self._naming_url, n, self._mapper, self._merger,
                        self._fail_limit, self._lb, self._timeout_ms)
            for n in list(self._schemes):
                if n not in counts:
                    self._schemes.pop(n).close()

    def scheme_capacities(self) -> Dict[int, int]:
        """scheme → complete replica sets (min replicas across partitions)."""
        with self._lock:
            schemes = dict(self._schemes)
        caps = {}
        for n, pc in schemes.items():
            with pc._lock:
                replicas = [len(pc._members.get(i, []))
                            for i in range(n)]
            caps[n] = min(replicas) if replicas and all(replicas) else 0
        return caps

    def call(self, method: str, payload: bytes = b"",
             attachment: bytes = b"",
             cntl: Optional[Controller] = None) -> bytes:
        caps = self.scheme_capacities()
        total = sum(caps.values())
        if total == 0:
            raise errors.RpcError(errors.ENOSERVICE,
                                  "no complete partitioning scheme")
        # weighted pick by capacity (≙ dynpart LB weighting by scheme size)
        r = random.uniform(0, total)
        acc = 0.0
        chosen = None
        for n, cap in sorted(caps.items()):
            acc += cap
            if r <= acc and cap > 0:
                chosen = n
                break
        if chosen is None:
            chosen = max((cap, n) for n, cap in caps.items())[1]
        with self._lock:
            pc = self._schemes.get(chosen)
        if pc is None:
            # naming update removed the scheme between snapshot and lookup
            raise errors.RpcError(
                errors.ENOSERVICE,
                f"partitioning scheme {chosen} disappeared during call")
        return pc.call(method, payload, attachment, cntl)

    def close(self):
        self._ns.remove_watcher(self._watcher)
        with self._lock:
            schemes, self._schemes = self._schemes, {}
        for pc in schemes.values():
            pc.close()


class _DynWatcher(Watcher):
    def __init__(self, owner: DynamicPartitionChannel):
        self._owner = owner

    def on_servers(self, added, removed, all_nodes):
        self._owner._sync_schemes(all_nodes)


# --- SelectiveChannel ------------------------------------------------------


class SelectiveChannel:
    """Load-balances whole calls across heterogeneous sub-channels and
    fails over between them (≙ brpc::SelectiveChannel,
    selective_channel.h:52: each sub-channel is one LB unit; a failed
    attempt moves to another unit).  Sub-channels can themselves be combo
    channels — slice-level failover in the TPU mapping (SURVEY §2.9)."""

    def __init__(self, max_retry: int = 1, isolation_s: float = 5.0):
        self._subs: List[object] = []
        self._bad_until: List[float] = []
        self._rr = 0
        self._lock = threading.Lock()
        self.max_retry = max_retry
        self.isolation_s = isolation_s

    def add_channel(self, channel) -> int:
        with self._lock:
            self._subs.append(channel)
            self._bad_until.append(0.0)
            return len(self._subs) - 1

    def channel_count(self) -> int:
        return len(self._subs)

    def _pick(self, excluded: set) -> Optional[int]:
        import time as _t
        now = _t.monotonic()
        with self._lock:
            n = len(self._subs)
            for off in range(n):
                i = (self._rr + off) % n
                if i in excluded:
                    continue
                if self._bad_until[i] <= now:
                    self._rr = i + 1
                    return i
            # all isolated/excluded: least-recently-bad non-excluded
            candidates = [i for i in range(n) if i not in excluded]
            if not candidates:
                return None
            return min(candidates, key=lambda i: self._bad_until[i])

    def call(self, method: str, payload: bytes = b"",
             attachment: bytes = b"",
             cntl: Optional[Controller] = None) -> bytes:
        import time as _t
        cntl = cntl or Controller()
        if not self._subs:
            raise errors.RpcError(errors.ENOSERVICE, "no sub-channels")
        excluded: set = set()
        last: Optional[errors.RpcError] = None
        for _ in range(self.max_retry + 1):
            i = self._pick(excluded)
            if i is None:
                break
            try:
                out = self._subs[i].call(method, payload,
                                         attachment=attachment, cntl=cntl)
                with self._lock:
                    self._bad_until[i] = 0.0
                return out
            except errors.RpcError as e:
                last = e
                excluded.add(i)
                with self._lock:
                    self._bad_until[i] = _t.monotonic() + self.isolation_s
        raise last or errors.RpcError(errors.ENOSERVICE,
                                      "all sub-channels failed")


# --- mesh lowering (SURVEY §2.9: fan-out+merge = ONE XLA collective) -------


class MeshParallelChannel:
    """ParallelChannel whose member set IS a mesh axis: the request is the
    per-chip shard, the "RPC fan-out + ResponseMerger" pair is a single
    XLA collective riding ICI (reference lowering table, SURVEY §2.9:
    "AllGather/AllReduce fan-out+merge over ICI; merger = XLA reduction
    op").  merger: "add"/"max"/"min" → all_reduce; "concat" → all_gather.

    `codec` ("none"/"int8"/"bf16", parallel/quantize.py) runs the reduce
    leg lossy-but-bounded: each worker's shard is quantized with the
    native payload-codec formats (codec.h) and the merge DEQUANTIZES-
    THEN-REDUCES — the EQuARX-style quantized allreduce (arXiv
    2506.17615) on this rail.  int8's per-worker bound is
    max|block|/127; the n-way sum's bound is the per-worker bounds
    added (quantize.int8_error_bound).
    """

    def __init__(self, mesh, axis: str, merger: str = "add",
                 codec: str = "none"):
        from brpc_tpu_torch.parallel import collectives, quantize
        self._c = collectives
        self._q = quantize
        self.mesh = mesh
        self.axis = axis
        if merger not in ("add", "max", "min", "concat"):
            raise ValueError(f"unknown merger {merger!r}")
        if codec not in ("none", "int8", "bf16"):
            raise ValueError(f"unknown codec {codec!r}")
        if codec != "none" and merger != "add":
            # the documented error bounds are ADDITIVE (per-worker
            # bounds summed); they say nothing about max/min/concat —
            # refuse rather than hand out an unbounded lossy merge
            raise ValueError(
                f"codec {codec!r} applies to merger='add' only (the "
                f"quantize.int8_error_bound contract is additive)")
        self.merger = merger
        self.codec = codec

    def channel_count(self) -> int:
        return self.mesh.shape[self.axis]

    def call_tensor(self, x):
        """The whole ParallelChannel.call, compiled: scatter is implicit in
        the sharding, merge is the collective (dequantize-then-reduce
        when a codec is set)."""
        if self.codec != "none":
            x = self._q.fake_quant(x, self.codec)
        if self.merger == "concat":
            return self._c.all_gather(self.mesh, self.axis, x)
        return self._c.all_reduce(self.mesh, self.axis, x, op=self.merger)


class MeshPartitionChannel:
    """PartitionChannel on a mesh axis: the logical request is an array
    sharded over the axis (partition i holds shard i); "merge" is either
    gathering every partition's answer (all_gather) or reducing partial
    answers while re-sharding (reduce_scatter) — the parameter-server
    allreduce of BASELINE.json's north star is call_reduce_scatter over
    the gradient."""

    def __init__(self, mesh, axis: str):
        from brpc_tpu_torch.parallel import collectives
        self._c = collectives
        self.mesh = mesh
        self.axis = axis

    def partition_count(self) -> int:
        return self.mesh.shape[self.axis]

    def call_gather(self, x):
        return self._c.all_gather(self.mesh, self.axis, x)

    def call_reduce_scatter(self, x):
        return self._c.reduce_scatter(self.mesh, self.axis, x)

    def call_all_to_all(self, x):
        return self._c.all_to_all(self.mesh, self.axis, x)
