"""Explicit per-rank shards: what XLA does for the reference behind its
sharding constraints (``transformer._cs``, ``NamedSharding``), written
out for one rank of a :class:`~brpc_tpu_torch.parallel.mesh.Mesh`.

A spec is the reference's ``PartitionSpec`` as a tuple: per array dim an
axis name, a tuple of names (the first the major one), or None.  Axes the
mesh does not define drop to replicated (``mesh.prune_spec``), so one spec
tree serves every layout.

* :func:`local_slice` — this rank's shard of a global array;
* :func:`gather_global` — the inverse, a collective every rank reaches;
* the conjugate autograd ops, over one axis or a tuple of axes:

  ============  =====================  ======================
  op            forward                backward
  ============  =====================  ======================
  copy_to       identity               all-reduce (sum)
  reduce_from   all-reduce (sum)       identity
  gather_seq    all-gather on a dim    reduce-scatter
  a2a           all-to-all             the inverse all-to-all
  ============  =====================  ======================

The rule: a replicated tensor that enters a computation sharded over an
axis goes through ``copy_to(axis)``, and a partial sum over that axis
leaves through ``reduce_from(axis)``.  (``torch.distributed.nn``'s
``all_reduce`` is not ``reduce_from``: its backward all-reduces the
gradient again, so a row-parallel output built on it would scale every
upstream gradient by the axis size.)

A sum over a tuple of axes is one all-reduce per axis in turn: the
groups of a mesh are per axis, and a sum over (a, b) is the sum over b
of the sums over a.  A collective over an axis of one member is the
identity and is not issued, so a mesh of ones runs the one-device
arithmetic with no collective at all.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from brpc_tpu_torch.parallel import collectives
from brpc_tpu_torch.parallel.mesh import Mesh, prune_spec

Axes = Union[str, Sequence[str]]


def _axes(mesh: Mesh, axes: Axes) -> Tuple[str, ...]:
    """The named axes the mesh defines with more than one member, in the
    given order."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in names if mesh.shape.get(a, 1) > 1)


def coords(mesh: Mesh) -> dict:
    """{axis: this rank's index on it} (rank 0 without a process group)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    where = np.argwhere(mesh.ranks == rank)
    if len(where) != 1:
        raise ValueError(f"rank {rank} is not in the mesh {mesh.shape}")
    return dict(zip(mesh.axis_names, (int(i) for i in where[0])))


def axis_index(mesh: Mesh, axes: Axes) -> int:
    """This rank's index over `axes` (row-major: the first the major)."""
    at = coords(mesh)
    idx = 0
    for a in _axes(mesh, axes):
        idx = idx * mesh.shape[a] + at[a]
    return idx


def axis_size(mesh: Mesh, axes: Axes) -> int:
    return math.prod(mesh.shape[a] for a in _axes(mesh, axes))


def local_shape(shape: Sequence[int], spec: tuple, mesh: Mesh) -> tuple:
    """The shape of one rank's shard of a global `shape`."""
    out = []
    for n, axes in zip(shape, _padded(spec, len(shape), mesh)):
        parts = axis_size(mesh, axes) if axes else 1
        if n % parts:
            raise ValueError(f"dim of {n} does not split {parts} ways over "
                             f"{axes} (global shape {tuple(shape)})")
        out.append(n // parts)
    return tuple(out)


def _padded(spec: tuple, ndim: int, mesh: Mesh) -> list:
    spec = prune_spec(tuple(spec), mesh)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} names more dims than {ndim}")
    return list(spec) + [None] * (ndim - len(spec))


def local_slice(x, spec: tuple, mesh: Mesh):
    """This rank's shard of the global array x (numpy or torch): along
    each dim the spec names, the block at this rank's index over its
    axes."""
    index = []
    for k, axes in zip(local_shape(x.shape, spec, mesh),
                       _padded(spec, x.ndim, mesh)):
        i = axis_index(mesh, axes) if axes else 0
        index.append(slice(i * k, (i + 1) * k))
    return x[tuple(index)]


def _gather_dim(mesh: Mesh, axis: str, x: torch.Tensor,
                dim: int) -> torch.Tensor:
    """All-gather over one axis, concatenated on `dim` in axis order."""
    out = collectives.all_gather(mesh, axis, x.movedim(dim, 0).contiguous())
    return out.movedim(0, dim).contiguous()


def gather_global(local: torch.Tensor, spec: tuple,
                  mesh: Mesh) -> torch.Tensor:
    """The global array from every rank's shard (the inverse of
    :func:`local_slice`): a collective that every rank reaches, and every
    rank gets the whole array."""
    x = local.detach()
    for dim, axes in enumerate(_padded(spec, local.dim(), mesh)):
        names = _axes(mesh, axes) if axes else ()
        for a in reversed(names):     # the minor axis first
            x = _gather_dim(mesh, a, x, dim)
    return x


def summed(mesh: Mesh, axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """x summed over `axes`: ``collectives.all_reduce`` over each axis in
    turn (x itself when no axis has more than one member)."""
    for a in _axes(mesh, axes):
        x = collectives.all_reduce(mesh, a, x)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return summed(ctx.mesh, ctx.axes, g), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return summed(mesh, axes, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather_dim(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        part = collectives.reduce_scatter(
            ctx.mesh, ctx.axis, g.movedim(ctx.dim, 0).contiguous())
        return part.movedim(0, ctx.dim).contiguous(), None, None, None


def _all_to_all(mesh: Mesh, axis: str, x: torch.Tensor, split: int,
                concat: int) -> torch.Tensor:
    """Dim `split` cut n ways, chunk j sent to member j; the chunks
    received from members 0..n-1 concatenated on dim `concat`:
    ``collectives.all_to_all`` (which splits dim 1 and concatenates on
    dim 0) with the two dims moved there and back."""
    y = collectives.all_to_all(mesh, axis, x.movedim((concat, split), (0, 1)))
    return y.movedim((0, 1), (concat, split)).contiguous()


class _A2A(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat):
        ctx.mesh, ctx.axis, ctx.split, ctx.concat = mesh, axis, split, concat
        return _all_to_all(mesh, axis, x, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(ctx.mesh, ctx.axis, g.contiguous(), ctx.concat,
                            ctx.split), None, None, None, None)


def copy_to(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Identity forward, sum over `axes` backward: a replicated tensor
    entering a computation sharded over them."""
    axes = _axes(mesh, axes)
    return _CopyTo.apply(x, mesh, axes) if axes else x


def reduce_from(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Sum over `axes` forward, identity backward: a partial sum leaving
    a computation sharded over them."""
    axes = _axes(mesh, axes)
    return _ReduceFrom.apply(x, mesh, axes) if axes else x


def gather_seq(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 1) -> torch.Tensor:
    """All-gather over `axis` on `dim` forward, reduce-scatter backward."""
    if not _axes(mesh, axis):
        return x
    return _GatherSeq.apply(x, mesh, axis, dim)


def a2a(x: torch.Tensor, mesh: Mesh, axis: str, split: int,
        concat: int) -> torch.Tensor:
    """All-to-all over `axis` (dim `split` scattered, dim `concat`
    gathered) forward, the inverse all-to-all backward."""
    if not _axes(mesh, axis):
        return x
    return _A2A.apply(x, mesh, axis, split, concat)
