"""Collectives over a mesh axis on torch.distributed (port of
brpc_tpu/parallel/collectives.py): the data plane ParallelChannel and
PartitionChannel lower onto (NCCL between cards, gloo between CPU
processes).

The reference's verbs are single-controller: a global array goes in and
a global array comes out.  Here every rank runs the verb on ITS shard
and gets ITS part back; put together over the axis, the parts are the
reference's global output.  The signatures stay ``(mesh, axis, x, ...)``
so the combo channels (channels.py, a copy of the reference's) call them
unchanged.  With n the axis size and i this rank's index on it:

  all_reduce       x -> the reduction (add/max/min) of the n shards
  all_gather       x -> the n shards concatenated on dim 0 (tiled) or
                   stacked on a new dim 0
  reduce_scatter   x [n*k, ...] -> slice i of the n shards' sum, [k, ...]
  ring_permute     x -> the shard of member (i - shift) % n (member i
                   sends to i + shift)
  all_to_all       x [S/n, D, ...] -> [S, D/n, ...]: dim 1 split n ways,
                   chunk j sent to member j, received chunks stacked on
                   dim 0 in member order

`bus_bandwidth_gbps` keeps the reference's formula, algbw * 2*(n-1)/n
(the ring all-reduce moves 2*(n-1)/n bytes per byte reduced), so it is 0
on an axis of one.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

_OPS = {"add": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _renamed(new: str, old: str):
    """torch 2.13 renamed two verbs; an older torch has the old name."""
    return getattr(dist, new, None) or getattr(dist, old)


def _shard(x) -> torch.Tensor:
    return torch.as_tensor(x).contiguous()


def all_reduce(mesh, axis: str, x, op: str = "add"):
    """The reduction over one mesh axis of every member's shard.

    ≙ ParallelChannel broadcast + ResponseMerger when the merger is a
    reduction (reference parallel_channel.h:127).
    """
    y = _shard(x).clone()
    dist.all_reduce(y, op=_OPS[op], group=mesh.group(axis))
    return y


def all_gather(mesh, axis: str, x, *, tiled: bool = True):
    """Every member's shard, on every member: concatenated on dim 0
    (tiled) or stacked on a new dim 0."""
    x = _shard(x)
    n = mesh.shape[axis]
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    _renamed("all_gather_single", "all_gather_into_tensor")(
        out, x, group=mesh.group(axis))
    return out if tiled else out.view((n,) + x.shape)


def reduce_scatter(mesh, axis: str, x):
    """Reduce over the axis, leave each member 1/n of dim 0."""
    x = _shard(x)
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) is not divisible by the "
                         f"axis size {n}")
    out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
    _renamed("reduce_scatter_single", "reduce_scatter_tensor")(
        out, x, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return out


def ring_permute(mesh, axis: str, x, shift: int = 1):
    """One ring step — the building block of ring attention and pipeline
    stage handoff.  An all-to-all whose only non-empty split goes to
    (i + shift) % n: the same call on gloo and NCCL at any n, one
    included (no send to oneself)."""
    x = _shard(x)
    group = mesh.group(axis)
    n = mesh.shape[axis]
    i = dist.get_rank(group)
    send = [0] * n
    recv = [0] * n
    send[(i + shift) % n] = x.numel()
    recv[(i - shift) % n] = x.numel()
    out = torch.empty_like(x)
    dist.all_to_all_single(out.view(-1), x.view(-1), recv, send,
                           group=group)
    return out


def all_to_all(mesh, axis: str, x):
    """The Ulysses sequence-parallel verb: reshard from dim0-sharded to
    dim1-sharded (gather sequence, scatter heads).  Put together, the
    members' outputs hold the same global value as their inputs."""
    x = _shard(x)
    n = mesh.shape[axis]
    if x.dim() < 2 or x.shape[1] % n:
        raise ValueError(f"all_to_all splits dim 1 of a 2D+ shard n={n} "
                         f"ways, got shape {tuple(x.shape)}")
    rows, cols = x.shape[0], x.shape[1] // n
    chunks = x.reshape(rows, n, cols, *x.shape[2:]).movedim(1, 0)
    chunks = chunks.contiguous()        # chunk j, dim 0, goes to member j
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=mesh.group(axis))
    return out.reshape(n * rows, cols, *x.shape[2:])


def bus_bandwidth_gbps(mesh, axis: str,
                       mbytes_per_shard: float = 64.0,
                       iters: int = 10,
                       dtype=torch.bfloat16) -> float:
    """Measure all-reduce bus bandwidth over a mesh axis.

    busbw = algbw * 2*(n-1)/n  (ring allreduce moves 2*(n-1)/n bytes per
    byte reduced).
    """
    n = mesh.shape[axis]
    group = mesh.group(axis)
    elems = int(mbytes_per_shard * 1e6 / dtype.itemsize)
    y = torch.ones(elems, dtype=dtype, device=mesh.device)

    def sync():
        if y.is_cuda:
            torch.cuda.synchronize(y.device)

    dist.all_reduce(y, group=group)     # warm: connect and allocate
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        dist.all_reduce(y, group=group)
    sync()
    dt = time.perf_counter() - t0
    algbw = mbytes_per_shard * 1e6 * iters / dt / 1e9
    return algbw * 2 * (n - 1) / n
