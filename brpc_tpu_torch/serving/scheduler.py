"""Continuous-batching scheduler — admit/evict per decode step against
the KV block budget (≙ the overload posture of overload.h applied to a
serving loop: shed with ELIMIT BEFORE any device work, never queue past
budget; the decode-slot churn itself is the vLLM-style continuous batch,
which the reference's §2.9 combo channels have no analogue for — see the
PARITY.md ruling).

Admission is optimistic about decode growth: a sequence is charged its
PROMPT blocks up front and grows block-by-block as it decodes, so the
pool can overcommit — exactly the pressure `preempt_victim()` resolves
by evicting the youngest running sequence when `seq_grow` hits
PoolExhausted.  The two shed reasons stay distinct in the counters:

    shed_queue   the waiting room is full (serving_max_waiting)
    shed_budget  prompt blocks + the waiting room's commitments exceed
                 the pool budget
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.serving.kv_cache import KvBlockPlane
from brpc_tpu_torch.utils import flags

flags.define_int32(
    "serving_max_waiting",
    int(os.environ.get("TRPC_SERVING_MAX_WAITING", "4")),
    "continuous-batching waiting-room depth; admission sheds ELIMIT "
    "beyond it (scheduler.py)",
    reloadable=False)

# sequence states
WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"
EVICTED = "evicted"      # preempted or shed mid-decode (ELIMIT surface)
CANCELED = "canceled"    # client RST / RPC cancel / dead socket


@dataclass
class Sequence:
    """One generation request, from admission to drained blocks."""
    seq_id: int
    prompt: List[int]
    max_new_tokens: int
    stream: object = None          # rpc.stream.Stream (server half)
    cntl: object = None            # rpc.controller.Controller
    state: str = WAITING
    slot: int = -1
    generated: int = 0
    last_token: int = 0
    submit_ns: int = field(default_factory=time.monotonic_ns)
    admit_ns: int = 0
    end_reason: str = ""
    span: object = None            # the Generate call's sampled rpc.span.Span

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + self.generated


class Scheduler:
    """Slots + waiting room over one KvBlockPlane.  submit() runs on
    handler threads; everything else on the engine's decode loop."""

    def __init__(self, n_slots: int, kv: KvBlockPlane,
                 bytes_per_token: int,
                 max_waiting: Optional[int] = None,
                 bytes_per_seq: int = 0):
        self.n_slots = n_slots
        self.kv = kv
        self.bytes_per_token = bytes_per_token
        # a sequence's state beside its per-token K/V (lfm2's conv state)
        self.bytes_per_seq = bytes_per_seq
        self.max_waiting = (max_waiting if max_waiting is not None
                            else flags.get_flag("serving_max_waiting"))
        self._lock = threading.Lock()
        self._slots: List[Optional[Sequence]] = [None] * n_slots
        self._waiting: deque = deque()
        self.work = threading.Event()
        # counters (engine.stats() merges these)
        self.submitted = 0
        self.admitted = 0
        self.shed_queue = 0
        self.shed_budget = 0
        self.finished = 0
        self.evicted = 0
        self.canceled = 0
        self.queue_wait_us = 0     # submit -> admit, summed over admits

    # -- admission (handler threads) ----------------------------------------

    def seq_bytes(self, length: int) -> int:
        """Wire bytes of a sequence of `length` tokens."""
        return length * self.bytes_per_token + self.bytes_per_seq

    def prompt_blocks(self, seq: Sequence) -> int:
        return self.kv.blocks_needed(self.seq_bytes(seq.prompt_len))

    def submit(self, seq: Sequence) -> None:
        """Admit into the waiting room or shed with ELIMIT — decided
        here, before any prefill compute or DMA happens."""
        with self._lock:
            self.submitted += 1
            if len(self._waiting) >= self.max_waiting:
                self.shed_queue += 1
                raise errors.RpcError(
                    errors.ELIMIT,
                    f"serving waiting room full "
                    f"({self.max_waiting} sequences)")
            need = self.prompt_blocks(seq)
            committed = sum(self.prompt_blocks(s) for s in self._waiting)
            if self.kv.used_blocks + committed + need > self.kv.n_blocks:
                self.shed_budget += 1
                raise errors.RpcError(
                    errors.ELIMIT,
                    f"KV block budget exhausted "
                    f"(need {need}, used {self.kv.used_blocks}, "
                    f"committed {committed} of {self.kv.n_blocks})")
            self._waiting.append(seq)
        self.work.set()

    # -- decode-loop side ---------------------------------------------------

    def pop_admittable(self) -> Optional[Sequence]:
        """Next waiting sequence IF a slot is free (the caller prefills
        it; the slot is reserved before the lock drops)."""
        with self._lock:
            if not self._waiting:
                return None
            try:
                slot = self._slots.index(None)
            except ValueError:
                return None
            seq = self._waiting.popleft()
            seq.slot = slot
            seq.state = RUNNING
            seq.admit_ns = time.monotonic_ns()
            self._slots[slot] = seq
            self.admitted += 1
            self.queue_wait_us += (seq.admit_ns - seq.submit_ns) // 1000
            return seq

    def running(self) -> List[Sequence]:
        with self._lock:
            return [s for s in self._slots if s is not None]

    def waiting_depth(self) -> int:
        with self._lock:
            return len(self._waiting)

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._waiting) or \
                any(s is not None for s in self._slots)

    def preempt_victim(self) -> Optional[Sequence]:
        """Youngest running sequence — the one whose eviction wastes the
        least completed work (last admitted, LIFO preemption)."""
        with self._lock:
            live = [s for s in self._slots if s is not None]
            if not live:
                return None
            return max(live, key=lambda s: s.admit_ns)

    def release(self, seq: Sequence, state: str, reason: str = "") -> None:
        """Retire a sequence from its slot (finish/evict/cancel).  Block
        freeing is the engine's job (it owns the order vs stream close);
        this just flips the state machine and the counters."""
        with self._lock:
            if 0 <= seq.slot < self.n_slots and \
                    self._slots[seq.slot] is seq:
                self._slots[seq.slot] = None
            if seq.state in (FINISHED, EVICTED, CANCELED):
                return  # already retired (racing cancel vs finish)
            seq.state = state
            seq.end_reason = reason
            if state == FINISHED:
                self.finished += 1
            elif state == EVICTED:
                self.evicted += 1
            elif state == CANCELED:
                self.canceled += 1
        self.work.set()

    def drain_waiting(self) -> List[Sequence]:
        """Teardown: pull everything still queued."""
        with self._lock:
            out = list(self._waiting)
            self._waiting.clear()
            return out
