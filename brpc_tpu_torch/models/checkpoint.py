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
"""

from __future__ import annotations

import os

import numpy as np

from brpc_tpu_torch import weights


def save(path: str, state) -> int:
    """Write the full state to `path` (.npz).  Returns bytes written."""
    arrays = weights.train_state_to_flat(state)
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
    return os.path.getsize(path)


def restore(path: str, template):
    """A new TrainState with `template`'s config, device and optimizer
    settings and the leaves stored at `path`; ``KeyError`` names the
    first leaf of the template that the file lacks."""
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    model = template.params
    for key in weights.state_keys(model):
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
    return weights.train_state_from_jax(
        stored, model.cfg, lr=template.opt_state.defaults["lr"],
        device=model.embed.device)
