"""KV-cache block plane — sequences' K/V as budgeted device-plane blocks
(≙ the reference's rdma/block_pool.cpp block budget, re-designed: blocks
are HBM DeviceBuffers, migration is a PJRT d2d hop, and fabric-lib's
point-to-point KV rail — PAPERS.md arXiv 2510.27656 — is the template
for keeping KV transfer distinct from the collective plane).

Lifecycle of one sequence:

    seq_alloc(id, kv)         prefill K/V chunked into blocks on the
                              PREFILL device, charged against the pool
                              budget — PoolExhausted here means the
                              batcher must shed or preempt.  Host bytes
                              are uploaded (h2d); a device tensor fills
                              each block by one device copy (no host
                              bytes), where device_route() says the
                              engine's device views the blocks
    seq_migrate(id)           blocks hop to the DECODE device:
                                local rail — tpu_d2d per block, no host
                                  landing (both ends share one PJRT
                                  client; stats()["d2d_transfers"] is the
                                  proof counter)
                                host rail — d2h → optional bf16/int8
                                  codec on the landing bytes → h2d
                                  (non-shared-PJRT fallback per the
                                  PARITY ruling; the codec mirrors
                                  parallel/quantize.py wire formats)
    seq_grow(id)              one more block, zeroed on the device, as
                              decode crosses a block boundary (the
                              preemption trigger)
    seq_fetch(id)             the migrated K/V, for models/decode.install():
                              host bytes after a host seq_alloc, else one
                              tensor on the engine's device gathered from
                              views of the blocks
    seq_free(id)              EVERY block back to the pool — finish,
                              eviction, and cancel all end here;
                              idempotent, and assert_balanced() proves
                              nothing leaked

``stats()`` counts ``kv_host_bytes`` (what the blocks took from or gave
to the host: uploads, fetches and the host rail) and ``kv_device_fills``
(blocks filled on the device, by the route or by a grow).  Torch's
stream and the plane's stream hand the blocks over in order: torch's
work is waited for once before the plane's copies read its tensor
(seq_alloc), the plane's copies are waited for before torch reads a
block, and torch's reads once before a block can go back to the pool
(seq_fetch).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch.utils import flags

flags.define_int32(
    "serving_block_bytes",
    int(os.environ.get("TRPC_SERVING_BLOCK_BYTES", "4096")),
    "KV-cache block size in bytes (serving/kv_cache.py)",
    reloadable=False)
flags.define_int32(
    "serving_kv_blocks",
    int(os.environ.get("TRPC_SERVING_KV_BLOCKS", "64")),
    "KV-cache pool budget in blocks; admission sheds beyond it",
    reloadable=False)
flags.define_string(
    "serving_kv_rail",
    os.environ.get("TRPC_SERVING_KV_RAIL", "auto"),
    "prefill->decode KV migration rail: auto|local|host "
    "(auto = local d2d when the plane is up, else host)",
    validator=lambda v: v in ("auto", "local", "host"))
flags.define_string(
    "serving_kv_codec",
    os.environ.get("TRPC_SERVING_KV_CODEC", "none"),
    "codec applied to host-rail KV migration bytes: none|bf16|int8 "
    "(the local d2d rail is device-native and rides uncoded)",
    validator=lambda v: v in ("none", "bf16", "int8"))


@dataclass
class _SeqBlocks:
    nbytes: int                                  # real payload bytes
    blocks: List[tpu_plane.DeviceBuffer] = field(default_factory=list)
    device: int = 0                              # where the blocks live
    migrated: bool = False
    on_device: bool = False                      # filled from a tensor


def _device_name(device) -> str:
    """`device` as a torch device string with its index (cuda's current
    device where it names none)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _settle(device: torch.device) -> None:
    """Wait for torch's queued work on `device`: what it wrote is final
    before the plane's stream reads it, and what it read is done before
    the plane may write there again."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class KvBlockPlane:
    """Per-sequence block tables over one DeviceBufPool.  Thread-safe:
    the decode loop migrates/grows while handler threads cancel."""

    def __init__(self, block_bytes: Optional[int] = None,
                 n_blocks: Optional[int] = None,
                 prefill_device: int = 0,
                 decode_device: Optional[int] = None,
                 rail: Optional[str] = None,
                 codec: Optional[str] = None):
        self.block_bytes = block_bytes or flags.get_flag(
            "serving_block_bytes")
        self.n_blocks = n_blocks or flags.get_flag("serving_kv_blocks")
        self.prefill_device = prefill_device
        if decode_device is None:
            decode_device = 1 if (tpu_plane.available()
                                  and tpu_plane.device_count() > 1) else 0
        self.decode_device = decode_device
        self.rail = rail or flags.get_flag("serving_kv_rail")
        self.codec = codec or flags.get_flag("serving_kv_codec")
        self.pool = tpu_plane.DeviceBufPool(self.block_bytes, self.n_blocks)
        self._lock = threading.Lock()
        self._seqs: Dict[int, _SeqBlocks] = {}
        self._migrations_local = 0
        self._migrations_host = 0
        self._codec_bytes = 0
        self._grown = 0
        self._freed_seqs = 0
        self._host_bytes = 0
        self._device_fills = 0

    # -- sizing -------------------------------------------------------------

    def blocks_needed(self, nbytes: int) -> int:
        return max(1, -(-nbytes // self.block_bytes))

    @property
    def free_blocks(self) -> int:
        return self.pool.free_blocks

    @property
    def used_blocks(self) -> int:
        return self.pool.used_blocks

    def live_seqs(self) -> int:
        with self._lock:
            return len(self._seqs)

    def device_route(self, device) -> bool:
        """Whether the K/V of an engine on torch device `device` can go
        through the blocks on the device: the blocks of the prefill and
        of the decode device are memory that `device` views (plane device
        i and ``cuda:i`` on a card; the fake driver's host memory and
        ``cpu``)."""
        want = _device_name(device)
        return all(self.pool.view_device(d) == want
                   for d in (self.prefill_device, self.decode_device))

    # -- sequence lifecycle -------------------------------------------------

    def seq_alloc(self, seq_id: int, kv) -> int:
        """Chunk a sequence's prefill K/V into blocks on the prefill
        device: host ``bytes`` uploaded block by block, or a flat uint8
        tensor on a device that :meth:`device_route` accepts, each block
        one device copy of its slice (the last zero-padded).
        All-or-nothing: a failure mid-sequence returns the blocks already
        charged before re-raising."""
        with self._lock:
            if seq_id in self._seqs:
                raise KeyError(f"seq {seq_id} already has a block table")
        on_device = isinstance(kv, torch.Tensor)
        if on_device and (kv.dtype != torch.uint8 or kv.dim() != 1
                          or not self.device_route(kv.device)):
            raise ValueError(f"a device K/V is a flat uint8 tensor on a "
                             f"device that views the plane's blocks, not "
                             f"{kv.dtype} {tuple(kv.shape)} on {kv.device}")
        table = _SeqBlocks(nbytes=len(kv), device=self.prefill_device,
                           on_device=on_device)
        try:
            if on_device:
                self._fill_blocks(table, kv)
            else:
                for off in range(0, max(len(kv), 1), self.block_bytes):
                    table.blocks.append(self.pool.alloc(
                        kv[off:off + self.block_bytes],
                        self.prefill_device))
                with self._lock:
                    self._host_bytes += len(table.blocks) * self.block_bytes
        except Exception:
            for b in table.blocks:
                self.pool.free(b)
            raise
        with self._lock:
            self._seqs[seq_id] = table
        return len(table.blocks)

    def _fill_blocks(self, table: _SeqBlocks, kv: torch.Tensor) -> None:
        """Charge `table`'s blocks, each filled by one device copy of a
        block-sized slice of `kv` (the last from a zero-padded copy of
        the tail); returns once every copy is done, so `kv` may go."""
        bb = self.block_bytes
        whole = kv.numel() // bb
        srcs = [kv[i * bb:(i + 1) * bb] for i in range(whole)]
        if kv.numel() % bb or not srcs:
            last = torch.zeros(bb, dtype=torch.uint8, device=kv.device)
            last[:kv.numel() - whole * bb] = kv[whole * bb:]
            srcs.append(last)
        _settle(kv.device)
        try:
            for src in srcs:
                table.blocks.append(self.pool.alloc_copy(src, table.device))
                with self._lock:
                    self._device_fills += 1
        finally:
            for b in table.blocks:  # their copies read kv and last
                b.wait()

    def seq_migrate(self, seq_id: int) -> str:
        """Move the sequence's blocks prefill→decode device; returns the
        rail taken ("local"/"host"/"none" when devices coincide)."""
        with self._lock:
            table = self._seqs[seq_id]
        if table.migrated or self.decode_device == table.device:
            table.migrated = True
            return "none"
        use_local = (self.rail == "local"
                     or (self.rail == "auto" and tpu_plane.available()))
        # in-place per-block replacement: a mid-migration failure leaves
        # every charged block reachable from the table, so seq_free still
        # returns all of them
        if use_local:
            for i, b in enumerate(table.blocks):
                table.blocks[i] = self.pool.migrate(b, self.decode_device)
            with self._lock:
                self._migrations_local += len(table.blocks)
        else:
            for i, b in enumerate(table.blocks):
                b.wait()
                data = self._transcode(b.to_host())
                with self._lock:
                    self._host_bytes += len(data) + self.block_bytes
                # free-then-alloc so a full pool can still land the hop
                # (alloc-first would deadlock at the budget edge); on an
                # alloc failure the engine sheds the sequence and
                # seq_free skips the already-freed source (idempotent)
                self.pool.free(b)
                table.blocks[i] = self.pool.alloc(data, self.decode_device)
            with self._lock:
                self._migrations_host += len(table.blocks)
        table.device = self.decode_device
        table.migrated = True
        return "local" if use_local else "host"

    def seq_grow(self, seq_id: int) -> int:
        """Charge one more block (decode crossed a block boundary),
        zeroed on the decode device.  PoolExhausted propagates — the
        batcher preempts on it."""
        blk = self.pool.alloc_zeros(self.decode_device)
        with self._lock:
            table = self._seqs[seq_id]
            table.blocks.append(blk)
            self._grown += 1
            self._device_fills += 1
        return len(table.blocks)

    def seq_blocks(self, seq_id: int) -> int:
        """Blocks currently charged to the sequence (0 if unknown)."""
        with self._lock:
            table = self._seqs.get(seq_id)
            return len(table.blocks) if table else 0

    def seq_fetch(self, seq_id: int):
        """The migrated K/V (feeds decode.install): host bytes after a
        host seq_alloc; after a device one, a uint8 tensor on the view of
        the decode device, copied from views of the blocks (the reads
        done before it returns, so that the blocks may go back to the
        pool)."""
        with self._lock:
            table = self._seqs[seq_id]
        blocks = table.blocks[:self.blocks_needed(table.nbytes)]
        if table.on_device:
            where = self.pool.view_device(table.device)
            bb = self.block_bytes
            out = torch.cat([b.view(where)[:table.nbytes - i * bb]
                             for i, b in enumerate(blocks)])
            _settle(out.device)
            return out
        out = []
        for b in blocks:
            b.wait()
            out.append(b.to_host())
        with self._lock:
            self._host_bytes += len(blocks) * self.block_bytes
        return b"".join(out)[:table.nbytes]

    def seq_free(self, seq_id: int) -> int:
        """Return every block of the sequence; idempotent (finish,
        evict, and cancel can race — first caller wins)."""
        with self._lock:
            table = self._seqs.pop(seq_id, None)
            if table is None:
                return 0
            self._freed_seqs += 1
        for b in table.blocks:
            self.pool.free(b)
        return len(table.blocks)

    def free_all(self) -> None:
        with self._lock:
            ids = list(self._seqs)
        for sid in ids:
            self.seq_free(sid)

    # -- accounting ---------------------------------------------------------

    def assert_balanced(self) -> None:
        """No live sequences and no charged blocks — the accounting
        proof after a drain."""
        with self._lock:
            live = len(self._seqs)
        if live:
            raise AssertionError(f"{live} sequence table(s) still live")
        self.pool.assert_balanced()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            d = {"kv_live_seqs": len(self._seqs),
                 "kv_migrations_local": self._migrations_local,
                 "kv_migrations_host": self._migrations_host,
                 "kv_codec_bytes": self._codec_bytes,
                 "kv_grown_blocks": self._grown,
                 "kv_freed_seqs": self._freed_seqs,
                 "kv_host_bytes": self._host_bytes,
                 "kv_device_fills": self._device_fills}
        d.update({f"kv_pool_{k}": v
                  for k, v in self.pool.pool_stats().items()})
        return d

    # -- host-rail codec ----------------------------------------------------

    def _transcode(self, data: bytes) -> bytes:
        """bf16/int8 quantize→dequantize pass on host-rail landing bytes
        (same per-block formats as the wire codec; lossy but bounded —
        parallel/quantize.py)."""
        if self.codec in ("", "none"):
            return data
        import numpy as np
        from brpc_tpu_torch.parallel import quantize
        n = len(data) // 4 * 4
        if n == 0:
            return data
        arr = np.frombuffer(data[:n], np.float32)
        out = np.asarray(quantize.fake_quant(arr, self.codec),
                         np.float32).tobytes()
        with self._lock:
            self._codec_bytes += n
        return out + data[n:]
