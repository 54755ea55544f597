"""The device half of a ServingEngine over a mesh: one leader, followers
in lockstep.

The reference's engine is one controller over a global array
(brpc_tpu/serving/engine.py:73-92: the jitted step and prefill take the
mesh).  Here a rank is a process.  Rank 0 of the world is the LEADER: it
alone runs the scheduler, the KV block plane, the server's handlers and
``tpu_plane``.  Every other rank is a FOLLOWER that holds its shards of
the model and of the decode cache (models/decode.py, ``mesh=``) and
replays the leader's device operations in the same order, so that every
rank reaches the same collectives.

Each operation the leader's decode loop runs is first broadcast over
the world: a fixed header of HEADER int64 values (op, slot, length,
payload elements), then the payload in its op's dtype:

    PREFILL  -, prompt length; the prompt tokens (int64)
    INSTALL  slot, length; the fetched K/V, k then v [L, S, H, hd] in
             the wire dtype (decode.KV_WIRE_DTYPE, f32); the gpt2 family
             alone, since the lfm2 family serves on one device
    STEP     -; tokens then the active mask of every slot (int64 [2N])
    RESET    slot; -
    STOP     -; -  (the followers' loops return)

A STEP ends with an all-gather over dp of each dp group's greedy tokens:
N ints a step, not N x vocab logits.  A world of one broadcasts nothing,
and a mesh whose axes are all of size one runs no collective, so it
runs the one-device engine's arithmetic.

On one CUDA device without a mesh the step and the prefill replay CUDA
graphs (``decode.StepGraphs``, ``decode.PrefillGraphs``), captured when
the ``Lockstep`` is built; the prefill's pads the prompt to the next of
its lengths (128, 256, ... up to ``max_len``) and runs the causal kernel
at the prompt's own length between its graphs, which keeps the valid
rows exact.  Over a mesh
(followers too) and on the CPU both run eagerly (``decode.prefill``,
``decode.decode_step``).

Only the leader's decode-loop thread (and, after it has joined, the
thread that stops the engine) and each follower's loop thread call a
collective; handler threads never do.  On NCCL that is one thread a
process at a time, on its stream.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from brpc_tpu_torch.models import decode as D
from brpc_tpu_torch.models.transformer import ModelConfig, TransformerLM
from brpc_tpu_torch.parallel import collectives, sharding
from brpc_tpu_torch.parallel.mesh import Mesh

PREFILL, INSTALL, STEP, RESET, STOP = 1, 2, 3, 4, 5
HEADER = 4
_PAYLOAD_DTYPE = {PREFILL: torch.int64, INSTALL: torch.float32,
                  STEP: torch.int64}


def world_rank() -> Tuple[int, int]:
    """(world size, this rank): (1, 0) without a process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


class Lockstep:
    """The model and this rank's cache, and the four device operations
    of serving.  On the leader each operation is broadcast and then run;
    a follower runs them as :meth:`follow` receives them.  Without a mesh
    it is the one-device engine's device half and broadcasts nothing; on
    a card it holds the cache's ``decode.StepGraphs`` (``graphs``), which
    run its steps, and a ``decode.PrefillGraphs`` (``prefill_graphs``),
    which runs every prompt of up to ``max_len`` tokens."""

    def __init__(self, params: TransformerLM, cfg: ModelConfig,
                 n_slots: int, max_len: int, device: torch.device,
                 mesh: Optional[Mesh] = None):
        self.params, self.cfg, self.mesh = params, cfg, mesh
        self.device = device
        self.world, self.rank = world_rank() if mesh is not None else (1, 0)
        self.cache = D.init_cache(cfg, n_slots, max_len, device, mesh)
        # on one card the step and the prefill replay CUDA graphs,
        # captured now, before traffic; over a mesh and on the CPU they
        # run eagerly
        card = device.type == "cuda" and mesh is None
        self.graphs = D.StepGraphs(params, self.cache, cfg) if card else None
        self.prefill_graphs = (D.PrefillGraphs(params, cfg, max_len)
                               if card else None)
        # the operations run; of the steps and of the prefills those that
        # replayed CUDA graphs (``step_graphed``, ``prefill_graphed``) and
        # the graph sets captured (``step_captures``, ``prefill_captures``):
        # the StepGraphs' and PrefillGraphs' counts
        self.ops: Dict[str, int] = {"prefill": 0, "install": 0, "step": 0,
                                    "reset": 0, "step_graphed": 0,
                                    "step_captures": 0, "prefill_graphed": 0,
                                    "prefill_captures": 0}
        self._count_graphs()
        # whether the last prefill replayed the PrefillGraphs
        self.prefill_replayed = False
        # time.monotonic_ns() stamps of the last prefill (entry, its device
        # work done) and step (entry, the last launch returned, the tokens
        # on the host), for the engine's counters and spans
        self.prefill_ns: Tuple[int, int] = (0, 0)
        self.step_ns: Tuple[int, int, int] = (0, 0, 0)
        self._done = (torch.cuda.Event() if device.type == "cuda" and
                      self.leader else None)

    def _count_graphs(self) -> None:
        if self.graphs is not None:
            self.ops["step_captures"] = self.graphs.captures
            self.ops["step_graphed"] = self.graphs.steps
        if self.prefill_graphs is not None:
            self.ops["prefill_captures"] = self.prefill_graphs.captures
            self.ops["prefill_graphed"] = self.prefill_graphs.prefills

    @property
    def leader(self) -> bool:
        return self.rank == 0

    # -- the wire -------------------------------------------------------

    def _send(self, op: int, slot: int = 0, length: int = 0,
              payload: Optional[torch.Tensor] = None) -> None:
        if self.world == 1 or not self.leader:
            return
        n = 0 if payload is None else payload.numel()
        header = torch.tensor([op, slot, length, n], dtype=torch.int64,
                              device=self.device)
        dist.broadcast(header, src=0)
        if n:
            dist.broadcast(payload.contiguous(), src=0)

    def _recv(self) -> Tuple[int, int, int, Optional[torch.Tensor]]:
        header = torch.empty(HEADER, dtype=torch.int64, device=self.device)
        dist.broadcast(header, src=0)
        op, slot, length, n = header.tolist()
        payload = None
        if n:
            payload = torch.empty(n, dtype=_PAYLOAD_DTYPE[op],
                                  device=self.device)
            dist.broadcast(payload, src=0)
        return op, slot, length, payload

    # -- the operations (the leader calls these; follow() replays them) --

    def prefill(self, prompt) -> Tuple:
        """(last-position logits [1, vocab], global k, v [L, 1, S, H, hd],
        and for the lfm2 family its conv state [conv layers, 1, width - 1,
        D]) of one prompt: replayed by ``prefill_graphs`` where it holds
        the prompt (the state then views valid until the next prefill),
        else ``decode.prefill``.  On a CUDA leader it returns once the
        prefill's device work is done (the K/V's copy to the host waited
        for it anyway), so ``prefill_ns`` holds the device time too."""
        t0 = time.monotonic_ns()
        toks = torch.as_tensor(prompt, dtype=torch.int64,
                               device=self.device).reshape(-1)
        self._send(PREFILL, length=toks.numel(), payload=toks)
        self.ops["prefill"] += 1
        graphs = self.prefill_graphs
        self.prefill_replayed = (graphs is not None
                                 and toks.numel() <= graphs.max_len)
        if self.prefill_replayed:
            out = graphs.run(toks)
            self._count_graphs()
        else:
            out = D.prefill(self.params, toks[None], self.cfg, self.mesh)
        if self._done is not None:
            self._done.record(torch.cuda.current_stream(self.device))
            self._done.synchronize()
        self.prefill_ns = (t0, time.monotonic_ns())
        return out

    def install(self, slot: int, k, v, length: int, conv=None) -> None:
        """Install a sequence's global K/V [L, S, H, hd] (as the KV plane
        hands it back: f32 tensors on the device, or host arrays), and an
        lfm2 sequence's conv state, into `slot`."""
        if self.world > 1 and self.leader:
            kv = torch.stack([D._tensor(x).to(self.device, torch.float32)
                              for x in (k, v)])
            self._send(INSTALL, slot, length, kv)
            k, v = kv[0], kv[1]
        self.ops["install"] += 1
        D.install(self.cache, slot, k, v, length, self.mesh, conv)

    def step(self, tokens, active) -> np.ndarray:
        """One decode step of every slot: the greedy next token of each
        [N] (global; meaningful for the active slots)."""
        t0 = time.monotonic_ns()
        both = torch.stack([torch.as_tensor(tokens, dtype=torch.int64),
                            torch.as_tensor(active, dtype=torch.int64)]
                           ).to(self.device)
        self._send(STEP, payload=both)
        self.ops["step"] += 1
        if self.graphs is not None:
            logits = self.graphs.run(both[0], both[1].bool())
        else:
            logits, self.cache = D.decode_step(self.params, self.cache,
                                               both[0], both[1].bool(),
                                               self.cfg, self.mesh)
        nxt = torch.argmax(logits, dim=-1)
        if self.mesh is not None and sharding.axis_size(self.mesh, "dp") > 1:
            nxt = collectives.all_gather(self.mesh, "dp", nxt)
        t1 = time.monotonic_ns()
        out = nxt.cpu().numpy()     # waits for the step's device work
        self.step_ns = (t0, t1, time.monotonic_ns())
        # counted as the step returns, beside the engine's own count of it
        self._count_graphs()
        return out

    def reset(self, slot: int) -> None:
        self._send(RESET, slot)
        self.ops["reset"] += 1
        D.reset_slot(self.cache, slot, self.mesh)

    def stop(self) -> None:
        """The leader's last word: every follower's loop returns."""
        self._send(STOP)

    def follow(self) -> None:
        """A follower's loop: replay the leader's operations until STOP."""
        if self.leader:
            raise RuntimeError("rank 0 leads; follow() is for the others")
        while True:
            op, slot, length, payload = self._recv()
            if op == STOP:
                return
            if op == PREFILL:
                self.prefill(payload)
            elif op == INSTALL:
                cfg = self.cfg
                kv = payload.view(2, cfg.n_layers, -1, cfg.n_heads,
                                  cfg.head_dim)
                self.install(slot, kv[0], kv[1], length)
            elif op == STEP:
                self.step(payload[:payload.numel() // 2],
                          payload[payload.numel() // 2:])
            elif op == RESET:
                self.reset(slot)
            else:
                raise RuntimeError(f"unknown lockstep op {op}")
