"""Device mesh construction on torch.distributed (port of
brpc_tpu/parallel/mesh.py).

The reference factors a device list into the named axes of a
``jax.sharding.Mesh``; here a "device" is a rank of the default process
group (one process per card), and :class:`Mesh` keeps the same factoring
over an array of ranks:

  dp — data parallel (batch dim; gradient all-reduce)
  sp — sequence/context parallel (long-context activations)
  tp — tensor parallel (heads / ffn-hidden; layer-internal collectives)
  ep — expert parallel (MoE experts)
  pp — pipeline parallel (layer stages; ring permute between stages)

Axis order is outer->inner = slowest->fastest-varying over the rank list,
so ``tp`` (the chattiest axis) lands on neighbouring ranks, which on one
host are neighbouring NVLink peers.

Building a mesh is pure factoring and needs no process group.  Its
``torch.distributed.device_mesh.DeviceMesh`` (one process group per axis)
is built at the first collective (:meth:`Mesh.group`), which every rank
of the world must reach, as with any collective.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")


def prune_spec(spec: tuple, mesh: "Mesh") -> tuple:
    """Drop spec axes the mesh doesn't define (-> replicated), so one spec
    tree serves every mesh layout (a (dp, sp) mesh simply replicates
    tp/ep dimensions).  A spec is the reference's PartitionSpec as a
    tuple: per array dim an axis name, a tuple of names, or None."""
    def _ok(a):
        names = a if isinstance(a, tuple) else (a,)
        return all(n in mesh.shape for n in names)

    return tuple(a if (a is None or _ok(a)) else None for a in spec)


class Mesh:
    """Named axes over an array of ranks, the counterpart of
    ``jax.sharding.Mesh``: ``shape`` is an ordered ``{axis: size}``,
    ``axis_names`` a tuple, ``ranks`` the rank array."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 device_type: str):
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.device_type = device_type
        self._device_mesh = None
        self._lock = threading.Lock()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def device(self) -> torch.device:
        """Where this rank's tensors live: on cards, one process a card,
        rank r's card is r modulo the cards the process sees (as
        DeviceMesh assumes).  Not the calling thread's current device,
        which other driver-API code on the thread (the device plane sets
        a device's context current) can move."""
        if self.device_type == "cuda":
            rank = dist.get_rank() if dist.is_initialized() else 0
            return torch.device("cuda", rank % torch.cuda.device_count())
        return torch.device(self.device_type)

    def device_mesh(self):
        """The DeviceMesh over the default process group, built at first
        use (a collective: every rank must call it)."""
        with self._lock:
            if self._device_mesh is None:
                self._device_mesh = self._build()
            return self._device_mesh

    def _build(self):
        from torch.distributed.device_mesh import DeviceMesh
        if not dist.is_initialized():
            raise RuntimeError("a mesh's collectives need "
                               "torch.distributed.init_process_group first")
        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"mesh {self.shape} has {self.size} ranks, the "
                             f"process group {world}")
        for i, name in enumerate(self.axis_names):
            # a process group orders its members by global rank, and the
            # collectives read a member's group rank as its axis index
            steps = np.diff(np.moveaxis(self.ranks, i, -1), axis=-1)
            if (steps <= 0).any():
                raise ValueError(f"ranks must increase along axis {name!r}")
        return DeviceMesh(self.device_type, torch.as_tensor(self.ranks),
                          mesh_dim_names=self.axis_names)

    def group(self, axis: str):
        """This rank's process group along `axis`."""
        return self.device_mesh().get_group(axis)


def _resolve_device_type(device_type: str) -> str:
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device_type 'cuda' requested but no CUDA device is available; "
            "pass device_type='cpu' to run on the CPU")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh runs on cuda or cpu, not {device_type!r}")
    return device_type


def _world_ranks() -> list:
    return list(range(dist.get_world_size() if dist.is_initialized() else 1))


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence[int]] = None,
              device_type: str = "cuda") -> Mesh:
    """Build a Mesh from {axis_name: size} over `devices` (ranks; default
    every rank of the default process group, or rank 0 without one).

    Sizes must multiply to the rank count; a single axis may be -1 to
    absorb the remainder (like a reshape).  The canonical parallelism axes
    (AXIS_ORDER) are laid out slowest-to-fastest in that order — tp stays
    innermost so its collectives (the chattiest) ride neighbouring ranks.
    Custom axes (e.g. a combo-channel fan-out group) go OUTERMOST, in
    insertion order, so they never break that adjacency; their names must
    be >=3 chars (every canonical name is 2, so 2-char unknowns are almost
    certainly typos of a canonical axis).
    """
    device_type = _resolve_device_type(device_type)
    devs = list(devices if devices is not None else _world_ranks())
    custom = [a for a in axes if a not in AXIS_ORDER]
    bad = [a for a in custom if len(a) < 3]
    if bad:
        raise ValueError(f"unknown 2-char axes {bad} look like typos of "
                         f"the canonical axes {AXIS_ORDER}; custom axis "
                         f"names must be >=3 chars")
    names = custom + [a for a in AXIS_ORDER if a in axes]
    sizes = [axes[a] for a in names]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if len(devs) % known:
            raise ValueError(
                f"{len(devs)} devices not divisible by {known}")
        sizes[sizes.index(-1)] = len(devs) // known
    if math.prod(sizes) != len(devs):
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} wants {math.prod(sizes)} "
            f"devices, have {len(devs)}")
    arr = np.asarray(devs, dtype=np.int64).reshape(sizes)
    return Mesh(arr, names, device_type)


def auto_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp", "sp", "tp"),
              device_type: str = "cuda") -> Mesh:
    """Factor n ranks (default: the world) into the given axes; tp gets a
    factor first, then dp, ep, sp, pp (ep outranks sp so expert
    parallelism is never silently degenerate).

    8 ranks over (dp, ep, sp, tp) -> tp=2, dp=2, ep=2, sp=1;
    8 over (dp, sp, tp) -> all 2; 4 over (dp, tp) -> tp=2, dp=2; prime
    counts degrade gracefully (leftover axes get size 1).
    """
    n = n_devices if n_devices is not None else len(_world_ranks())
    priority = [a for a in ("tp", "dp", "ep", "sp", "pp") if a in axis_names]
    priority += [a for a in axis_names if a not in priority]
    sizes = dict.fromkeys(axis_names, 1)
    i = 0
    for p in sorted(_primes(n), reverse=True):
        sizes[priority[i % len(priority)]] *= p
        i += 1
    return make_mesh(sizes, devices=range(n), device_type=device_type)


def _primes(n: int) -> list:
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape.get(name, 1)
