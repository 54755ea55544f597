"""Serving front-end — stream-RPC ingress, one decode-loop thread, and
the eviction paths that keep the KV accounting exact.  Port of
brpc_tpu/serving/engine.py on PyTorch, eager (no jit, no torch.compile):
the model runs on an explicit device (``cuda`` unless the caller asks
for ``cpu``), each decode step launches the hand-written
``ops.decode_attention`` kernel once per layer and each prefill the
``ops.causal_attention`` forward once per layer.  The wire format (f32
K/V through DeviceBufPool blocks and back) and the block accounting are
the reference's.  Where the plane's blocks are memory the engine's device
views (``KvBlockPlane.device_route``: one card, or the fake driver's host
memory and ``cpu``) the route stays on the device: the wire is packed
there, each block filled by one device copy and read back through a view
of it; otherwise it crosses as host bytes, as the reference's does.

On one card (no mesh) the decode step's work between its attention
launches replays CUDA graphs (``decode.StepGraphs``: n_layers + 1 of
them, split at each layer's ``decode_attention``, which is still
launched from Python), and so does the admit's prefill
(``decode.PrefillGraphs``: a set of n_layers + 1 for each padded length
128, 256, ... up to ``max_len``; the prompt takes the smallest that
holds it and the causal kernel runs between the graphs at the prompt's
own length, so the padding rows, which only row-wise work touches,
reach no valid row).  The same holds for the lfm2 family (gated short
convolutions, grouped-query attention, routed experts): its cache holds
the attention layers' K/V at the KV heads beside each conv layer's
state, its graphs split at the attention layers (7 segments at
LFM2-8B-A1B's 6), its padded prefill rows and a step's inactive slots
route to no expert, and the engine holds its product weights, experts
included, and its tied head in the products' dtype, cast once when it
is built.  The engine's ``Lockstep`` owns the cache and holds both,
captured when the ``Lockstep`` is built, before any
traffic, so the captures land in set-up; ``stats()`` counts the steps
that replayed them (``step_graphed``), the installed admits whose
prefill did (``prefill_graphed``, beside ``prefills``) and the graph
sets captured (``step_captures``, ``prefill_captures``).  On the CPU
and over a mesh every operation is launched from Python
(``decode.decode_step``, ``decode.prefill``).

Over a mesh (``mesh=``, the reference's dp/tp layout) one engine runs on
every rank of the world, each on its shards of the model and of the
decode cache, and the device operations go through
:mod:`~brpc_tpu_torch.serving.lockstep`: rank 0 LEADS (the scheduler,
the KV block plane, the handlers and ``tpu_plane`` live there alone, and
its decode loop broadcasts each prefill, install, step and reset before
it runs it), every other rank FOLLOWS (``start()`` runs a loop that
replays them; ``stop()`` returns when the leader's ``stop()`` has
drained).  The leader's accounting, ``stats()`` and wire are the
one-device engine's.  Without a mesh the engine is one device's.

Request wire format (method "LLM.Generate", payload JSON):

    {"prompt": [token ids...], "max_new_tokens": 8}
    {"prompt_len": 12, "max_new_tokens": 8}      # deterministic prompt

The handler accepts the call's stream, then submits to the scheduler —
which sheds with ELIMIT before any prefill compute or DMA (the
overload-control posture; the native per-method concurrency cap is the first gate in
front of this, see `method_cap`).  Each generated token rides the stream
as 4 little-endian bytes; a clean close is end-of-generation, an RST
carries the eviction/cancel code.

Where the work happens the leader counts its time, on
``time.monotonic_ns()``, in microseconds that ``stats()`` reports:
``queue_wait_us`` (the scheduler's), ``prefill_us`` (the prefill to its
device work done), ``kv_route_us`` (``KV_ROUTE``, to the install
returned) and ``kv_route_bytes`` (the route's four copies of the wire:
packed, into the blocks, back from them, into the decode cache) of every
admit that reaches the install (``conv_state_bytes``: the conv state's
share of the f32 wire an admit routes, lfm2), and a step's
``step_issue_us`` (to its last launch), ``step_sync_us`` (its ``.cpu()``)
and ``emit_us`` (the token writes, grown blocks and retirements).  The
KV plane's own ``kv_host_bytes`` and ``kv_device_fills`` join
``stats()``, and for a model with routed experts its counters
(``moe_assignments`` [MoE layers][held experts] and ``moe_dropped``,
summed on the device over every step and prefill, padded rows and
inactive slots excluded; reading them waits for the device).  With
``enable_rpcz`` on the same stamps become rpcz spans: a sampled Generate
call's server span gets ``queue``, ``admit`` (``prefill``, ``kv_route``
and its six) and ``first_token``; a sampled step is a trace of its own,
``LLM.decode_step`` with ``issue``, ``sync`` and ``emit`` (a ``grow`` for
each block grown).

Every exit path — finish, preemption, slow-consumer timeout, stream RST,
RPC cancel, client socket death — funnels through `_end()`, which frees
the sequence's KV blocks exactly once; `assert_drained()` +
`tpu_plane.stats()["live_buffers"]` is the accounting proof the suite
pins.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from brpc_tpu_torch.models import decode as D
from brpc_tpu_torch.models import lfm2
from brpc_tpu_torch.models.transformer import ModelConfig
from brpc_tpu_torch.models import transformer
from brpc_tpu_torch.parallel.mesh import Mesh
from brpc_tpu_torch.rpc import errors, span
from brpc_tpu_torch.rpc.stream import StreamClosed, StreamReset, StreamTimeout
from brpc_tpu_torch.serving import scheduler as S
from brpc_tpu_torch.serving.kv_cache import KvBlockPlane
from brpc_tpu_torch.serving.lockstep import Lockstep
from brpc_tpu_torch.utils import flags

flags.define_int32(
    "serving_slots",
    int(os.environ.get("TRPC_SERVING_SLOTS", "4")),
    "decode-batch slot count (engine.py)",
    reloadable=False)
flags.define_int32(
    "serving_write_timeout_ms",
    int(os.environ.get("TRPC_SERVING_WRITE_TIMEOUT_MS", "2000")),
    "per-token stream write budget; a consumer slower than this is "
    "evicted (shed, not queued — engine.py)")

TOKEN_FMT = "<I"  # one generated token = 4 LE bytes on the stream
# an admit's KV route, one span each, in order
KV_ROUTE = ("kv_to_bytes", "seq_alloc", "seq_migrate", "seq_fetch",
            "kv_from_bytes", "install")


def tiny_config(**over) -> ModelConfig:
    """The serving acceptance model: small enough that the CPU prefills
    + decodes in test time, on one device or over a gloo world of 8 at
    dp2 x tp4 (its 4 heads split 4 ways, its slots 2), big enough that
    K/V spans multiple pool blocks per sequence."""
    kw = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_seq=64, n_experts=0, dtype=torch.float32)
    kw.update(over)
    return ModelConfig(**kw)


def _engine_device(device, mesh: Optional[Mesh]) -> torch.device:
    """`device` (default cuda) without a mesh; the mesh's device with
    one, which a `device` that names another contradicts."""
    if mesh is None:
        return transformer.resolve_device("cuda" if device is None
                                          else device)
    dev = mesh.device
    if device is not None:
        asked = torch.device(device)
        if asked.type != dev.type or asked.index not in (None, dev.index):
            raise ValueError(f"device={asked} conflicts with the mesh's "
                             f"device {dev}")
    return dev


class ServingEngine:
    """Continuous-batching LLM server core.  One instance per process;
    `register()` it on a Server, `start()` the decode loop.  Over a mesh
    every rank builds one with the same arguments (a follower gets no
    `kv`), only the leader's is registered on a Server."""

    def __init__(self, cfg: Optional[ModelConfig] = None,
                 params: Optional[transformer.TransformerLM] = None,
                 mesh: Optional[Mesh] = None,
                 n_slots: Optional[int] = None,
                 max_len: Optional[int] = None,
                 kv: Optional[KvBlockPlane] = None,
                 max_waiting: Optional[int] = None, seed: int = 0,
                 device=None):
        self.cfg = cfg or tiny_config()
        self.mesh = mesh
        self.device = _engine_device(device, mesh)
        if params is None:
            params = transformer.init(torch.Generator().manual_seed(seed),
                                      self.cfg, self.device, mesh)
        self.params = params.to(self.device)
        if self.cfg.family == "lfm2":
            lfm2.hold_products(self.params, self.cfg)
        self.n_slots = n_slots or flags.get_flag("serving_slots")
        self.max_len = max_len or self.cfg.max_seq
        self.dev = Lockstep(self.params, self.cfg, self.n_slots,
                            self.max_len, self.device, mesh)
        self.leader = self.dev.leader
        if self.leader:
            self.kv = kv or KvBlockPlane()
            self.sched = S.Scheduler(self.n_slots, self.kv,
                                     D.kv_bytes_per_token(self.cfg),
                                     max_waiting=max_waiting,
                                     bytes_per_seq=D.conv_state_bytes(
                                         self.cfg))
        elif kv is not None:
            raise ValueError(self._follows("the KV block plane"))
        self._seq_ids = iter(range(1, 1 << 62))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._failure: Optional[BaseException] = None
        self._lock = threading.Lock()
        # counters
        self.tokens_out = 0
        self.prefills = 0
        self.prefill_graphed = 0    # of the prefills, those replayed
        self.steps = 0
        self.preemptions = 0
        self.rails = {"local": 0, "host": 0, "none": 0}
        self.prefill_us = 0
        self.kv_route_us = 0
        self.kv_route_bytes = 0
        self.conv_state_bytes = 0
        self.step_issue_us = 0
        self.step_sync_us = 0
        self.emit_us = 0
        # the grown blocks' spans while a sampled trace emits, else None
        self._grows: Optional[list] = None

    @property
    def cache(self) -> Dict[str, torch.Tensor]:
        """This rank's decode cache (its shard over a mesh)."""
        return self.dev.cache

    def _follows(self, what: str) -> str:
        return (f"rank {self.dev.rank} follows: {what} lives on the leader "
                f"(rank 0) alone")

    def _leader_only(self, what: str) -> None:
        if not self.leader:
            raise RuntimeError(self._follows(what))

    # -- ingress (handler threads) ------------------------------------------

    @property
    def method_cap(self) -> int:
        """Recommended ServerOptions.method_max_concurrency for the
        Generate method: what the scheduler could even hold.  The native
        cap sheds the rest with ELIMIT on the parse fiber — before the
        request ever reaches Python (the first gate)."""
        self._leader_only("the scheduler")
        return self.n_slots + self.sched.max_waiting + 1

    def register(self, server, method: str = "LLM.Generate") -> None:
        self._leader_only("the Generate handler")
        server.add_service(method, self.handle)

    def handle(self, cntl, req: bytes):
        """The Generate handler: parse, accept the stream, submit."""
        self._leader_only("the Generate handler")
        try:
            body = json.loads(req.decode() or "{}")
            prompt = body.get("prompt")
            if prompt is None:
                plen = int(body.get("prompt_len", 8))
                prompt = [1 + (i % (self.cfg.vocab - 1))
                          for i in range(plen)]
            prompt = [int(t) % self.cfg.vocab for t in prompt]
            max_new = int(body.get("max_new_tokens", 8))
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            raise errors.RpcError(errors.EREQUEST, f"bad request: {e}")
        if not prompt or max_new < 1:
            raise errors.RpcError(errors.EREQUEST,
                                  "prompt and max_new_tokens required")
        if len(prompt) + max_new > self.max_len:
            raise errors.RpcError(
                errors.EREQUEST,
                f"prompt+max_new_tokens {len(prompt) + max_new} > "
                f"cache max_len {self.max_len}")
        st = cntl.accept_stream()
        if st is None:
            raise errors.RpcError(errors.EREQUEST,
                                  "Generate wants an attached stream")
        seq = S.Sequence(seq_id=next(self._seq_ids), prompt=prompt,
                         max_new_tokens=max_new, stream=st, cntl=cntl,
                         span=span.current())
        try:
            self.sched.submit(seq)   # sheds ELIMIT before device work
        except errors.RpcError:
            st.rst(errors.ELIMIT)
            st.destroy()
            raise
        return json.dumps({"seq": seq.seq_id,
                           "prompt_len": len(prompt)}).encode()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """The leader's (or one device's) decode loop; on a follower the
        loop that replays the leader's device operations."""
        body = self._loop if self.leader else self.dev.follow
        self._thread = threading.Thread(target=self._guard, args=(body,),
                                        name="serving-decode", daemon=True)
        self._thread.start()

    def _guard(self, body) -> None:
        try:
            body()
        except Exception as e:   # re-raised by stop()
            self._failure = e

    def stop(self, drain_timeout_s: float = 10.0) -> None:
        """Stop the loop and drain: every live or queued sequence is
        evicted and its blocks freed; then the followers are released.
        On a follower: wait for the leader's stop.  Raises when the loop
        failed; on a world larger than one at once, with no drain and no
        further broadcast, since the followers wait inside the failed
        operation's collectives (the world's launcher stops them)."""
        if not self.leader:
            if self._thread is not None:
                self._thread.join()
            if self._failure is not None:
                raise RuntimeError("the follower loop failed") \
                    from self._failure
            return
        self._stop.set()
        self.sched.work.set()
        if self._thread is not None:
            self._thread.join(drain_timeout_s)
            if self._thread.is_alive() and self.dev.world > 1:
                # its collectives would interleave with the drain's
                raise RuntimeError("the decode loop did not stop within "
                                   f"{drain_timeout_s} s")
        if self._failure is not None and self.dev.world > 1:
            raise RuntimeError("the decode loop failed") from self._failure
        for seq in self.sched.drain_waiting():
            self._end(seq, S.EVICTED, "server stopping",
                      rst_code=errors.ESTOP)
        for seq in self.sched.running():
            self._end(seq, S.EVICTED, "server stopping",
                      rst_code=errors.ESTOP)
        self.kv.free_all()
        self.dev.stop()
        if self._failure is not None:
            raise RuntimeError("the decode loop failed") from self._failure

    def assert_drained(self) -> None:
        self._leader_only("the KV block plane")
        self.kv.assert_balanced()

    def stats(self) -> Dict[str, int]:
        self._leader_only("the scheduler")
        d = {
            "tokens_out": self.tokens_out,
            "prefills": self.prefills,
            "steps": self.steps,
            "preemptions": self.preemptions,
            "rail_local": self.rails["local"],
            "rail_host": self.rails["host"],
            "rail_none": self.rails["none"],
            "queue_wait_us": self.sched.queue_wait_us,
            "prefill_us": self.prefill_us,
            "kv_route_us": self.kv_route_us,
            "kv_route_bytes": self.kv_route_bytes,
            "conv_state_bytes": self.conv_state_bytes,
            "step_issue_us": self.step_issue_us,
            "step_sync_us": self.step_sync_us,
            "emit_us": self.emit_us,
            "step_graphed": self.dev.ops["step_graphed"],
            "step_captures": self.dev.ops["step_captures"],
            "prefill_graphed": self.prefill_graphed,
            "prefill_captures": self.dev.ops["prefill_captures"],
            "submitted": self.sched.submitted,
            "admitted": self.sched.admitted,
            "shed_queue": self.sched.shed_queue,
            "shed_budget": self.sched.shed_budget,
            "shed": self.sched.shed_queue + self.sched.shed_budget,
            "finished": self.sched.finished,
            "evicted": self.sched.evicted,
            "canceled": self.sched.canceled,
            "waiting": self.sched.waiting_depth(),
            "running": len(self.sched.running()),
        }
        d.update(self.kv.stats())
        if self.cfg.n_experts > 0:
            d.update(self.params.stats())
        return d

    # -- decode loop --------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            did = False
            # prefill/decode interleave: at most ONE admission per step,
            # so running streams keep their inter-token cadence while
            # the waiting room drains
            seq = self.sched.pop_admittable()
            if seq is not None:
                self._admit(seq)
                did = True
            batch = [s for s in self.sched.running()
                     if s.state == S.RUNNING]
            if batch:
                self._decode_batch(batch)
                did = True
            if not did:
                self.sched.work.wait(0.02)
                self.sched.work.clear()

    def _admit(self, seq: S.Sequence) -> None:
        """Prefill one admitted sequence: compute K/V, charge blocks,
        migrate prefill→decode device, install, emit the first token."""
        parent = seq.span
        span.record(parent, "queue", seq.submit_ns, seq.admit_ns)
        if seq.cntl is not None and seq.cntl.is_canceled():
            self._end(seq, S.CANCELED, "canceled before prefill")
            return
        clock = time.monotonic_ns
        plen = seq.prompt_len
        t_admit = clock()
        logits, k, v, *conv = self.dev.prefill(seq.prompt)
        p0, p1 = self.dev.prefill_ns
        route = [clock()]           # KV_ROUTE's boundaries
        kvb = D.kv_to_bytes(k[:, 0], v[:, 0],
                            self.device if self.kv.device_route(self.device)
                            else None, *(c[:, 0] for c in conv))
        route.append(clock())
        try:
            self.kv.seq_alloc(seq.seq_id, kvb)
            route.append(clock())
            rail = self.kv.seq_migrate(seq.seq_id)
            route.append(clock())
        except Exception as e:  # PoolExhausted or a plane fault
            self.kv.seq_free(seq.seq_id)
            self._end(seq, S.EVICTED, f"prefill shed: {e}",
                      rst_code=errors.ELIMIT)
            span.record(parent, "admit", t_admit, clock(),
                        [("prefill", p0, p1)], errors.ELIMIT)
            return
        self.rails[rail] = self.rails.get(rail, 0) + 1
        fetched = self.kv.seq_fetch(seq.seq_id)
        route.append(clock())
        k2, v2, *conv2 = D.kv_from_bytes(fetched, self.cfg, plen)
        route.append(clock())
        self.dev.install(seq.slot, k2, v2, plen, *conv2)
        route.append(clock())
        self.prefills += 1
        self.prefill_graphed += self.dev.prefill_replayed
        self.prefill_us += (p1 - p0) // 1000
        self.kv_route_us += (route[-1] - route[0]) // 1000
        conv_bytes = sum(c.nbytes for c in conv2)
        self.kv_route_bytes += (2 * len(kvb) + len(fetched) + k2.nbytes
                                + v2.nbytes + conv_bytes)
        self.conv_state_bytes += conv_bytes
        if parent is not None:
            span.record(parent, "admit", t_admit, route[-1], [
                ("prefill", p0, p1),
                ("kv_route", route[0], route[-1],
                 list(zip(KV_ROUTE, route, route[1:])))])
            self._grows = []
        first = int(torch.argmax(logits[0]))
        if self._emit(seq, first) and seq.generated >= seq.max_new_tokens:
            self._end(seq, S.FINISHED, "max_new_tokens")
        if parent is not None:
            span.record(parent, "first_token", route[-1], clock(),
                        self._grows)
            self._grows = None

    def _decode_batch(self, batch) -> None:
        root = span.start_span("local", "LLM.decode_step")
        tokens = np.zeros((self.n_slots,), np.int32)
        active = np.zeros((self.n_slots,), bool)
        for s in batch:
            tokens[s.slot] = s.last_token
            active[s.slot] = True
        nxt = self.dev.step(tokens, active)
        t0, t1, t2 = self.dev.step_ns
        self.steps += 1
        self.step_issue_us += (t1 - t0) // 1000
        self.step_sync_us += (t2 - t1) // 1000
        if root is not None:
            self._grows = []
        e0 = time.monotonic_ns()
        for s in batch:
            if s.state != S.RUNNING:
                continue  # evicted by a preemption earlier in this pass
            if s.cntl is not None and s.cntl.is_canceled():
                # the RPC cancel already RST the accepted stream
                # natively; our job is only the block accounting
                self._end(s, S.CANCELED, "rpc canceled", rst=False)
                continue
            if self._emit(s, int(nxt[s.slot])) and \
                    s.generated >= s.max_new_tokens:
                self._end(s, S.FINISHED, "max_new_tokens")
        e1 = time.monotonic_ns()
        self.emit_us += (e1 - e0) // 1000
        if root is not None:
            root.annotate(f"batch {len(batch)}")
            for child in (("issue", t0, t1), ("sync", t1, t2),
                          ("emit", e0, e1, self._grows)):
                span.record(root, *child)
            self._grows = None
            span.finish_span(root, end_ns=e1)

    def _emit(self, seq: S.Sequence, token: int) -> bool:
        """Send one token and keep the block charge covering the
        sequence's total length; False when the sequence ended here."""
        try:
            seq.stream.write(struct.pack(TOKEN_FMT, token),
                             timeout_s=flags.get_flag(
                                 "serving_write_timeout_ms") / 1e3)
        except StreamReset:
            self._end(seq, S.CANCELED, "stream reset by peer", rst=False)
            return False
        except StreamClosed:
            self._end(seq, S.CANCELED, "peer gone", rst=False)
            return False
        except StreamTimeout:
            self._end(seq, S.EVICTED, "slow consumer",
                      rst_code=errors.ELIMIT)
            return False
        except errors.RpcError:
            self._end(seq, S.CANCELED, "connection failed", rst=False)
            return False
        seq.generated += 1
        seq.last_token = token
        self.tokens_out += 1
        return self._grow(seq)

    def _grow(self, seq: S.Sequence) -> bool:
        """Charge blocks for the sequence's grown K/V; preempt-by-
        eviction (youngest first) when the pool runs dry."""
        needed = self.kv.blocks_needed(self.sched.seq_bytes(seq.total_len))
        while self.kv.seq_blocks(seq.seq_id) < needed:
            t = time.monotonic_ns()
            try:
                self.kv.seq_grow(seq.seq_id)
                if self._grows is not None:
                    self._grows.append(("grow", t, time.monotonic_ns()))
            except Exception:  # PoolExhausted
                victim = self.sched.preempt_victim()
                if victim is None:
                    victim = seq
                self.preemptions += 1
                self._end(victim, S.EVICTED, "preempted: KV pool dry",
                          rst_code=errors.ELIMIT)
                if victim is seq:
                    return False
        return True

    def _end(self, seq: S.Sequence, state: str, reason: str,
             rst: bool = True, rst_code: int = errors.ECANCELED) -> None:
        """The single retirement path: slot back, blocks freed exactly
        once, stream closed (clean for FINISHED, RST otherwise)."""
        self.sched.release(seq, state, reason)
        if seq.slot >= 0:
            self.dev.reset(seq.slot)
        self.kv.seq_free(seq.seq_id)
        try:
            if state == S.FINISHED:
                seq.stream.close()
            elif rst:
                seq.stream.rst(rst_code)
        except Exception:
            pass  # the peer may already be gone; accounting is done
