"""TrainState checkpoint/restore — port of brpc_tpu/models/checkpoint.py.

Format: the reference's, so a checkpoint moves between the two packages.
One .npz per checkpoint; every leaf of the reference's ``TrainState``
tree is stored under its tree path ("params/blocks/wq",
"opt_state/0/mu/...", "opt_state/0/count", "step"), on the host
(``weights.train_state_to_flat``).  Restore rebuilds a state like the
caller's template (its config, device and AdamW settings) from the
stored leaves and fails loudly on a missing one.

Atomic as the reference: written to a temp file, fsynced, renamed over
the old checkpoint, and the directory fsynced, so a crash mid-save never
corrupts the previous checkpoint.

Over a mesh the file holds the global leaves, so it moves between mesh
layouts as the reference's does (checkpoint.py:64-83): ``save`` gathers
every leaf to rank 0, rank 0 writes, and a broadcast of its byte count
ends the call as a barrier would;
``restore`` slices each stored leaf to the template's mesh and rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from brpc_tpu_torch import weights


def save(path: str, state) -> int:
    """Write the full state to `path` (.npz).  Returns bytes written.  On
    a mesh every rank of the world calls it (it gathers), rank 0 writes,
    and every rank returns rank 0's byte count."""
    arrays = weights.train_state_to_flat(state)
    mesh = state.params.mesh
    if mesh is None or not dist.is_initialized():
        _write(path, arrays)
        return os.path.getsize(path)
    nbytes = torch.zeros(1, dtype=torch.int64, device=mesh.device)
    if dist.get_rank() == 0:
        _write(path, arrays)
        nbytes.fill_(os.path.getsize(path))
    # the barrier as well: no rank returns before the file is in place
    dist.broadcast(nbytes, src=0)
    return int(nbytes.item())


def _write(path: str, arrays) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())  # data durable before the rename
    os.replace(tmp, path)
    # rename durable too: fsync the containing directory
    dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                  os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def restore(path: str, template):
    """A new TrainState with `template`'s config, device, mesh and
    optimizer settings and the leaves stored at `path` (each cut to this
    rank's shard on a mesh); ``KeyError`` names the first leaf of the
    template that the file lacks."""
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    model = template.params
    for key in weights.state_keys(model):
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
    return weights.train_state_from_jax(
        stored, model.cfg, lr=template.opt_state.defaults["lr"],
        device=model.embed.device, mesh=model.mesh)
