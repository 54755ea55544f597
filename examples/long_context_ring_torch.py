"""long_context_ring on the PyTorch/CUDA port (examples/long_context_ring.py
on brpc_tpu_torch): a long-context forward with ring attention, the
sequence sharded over sp, K/V blocks rotating around the sp ring, O(S/n)
memory a rank (parallel/ring_attention.py).

    python examples/long_context_ring_torch.py --device cpu  # 8 gloo ranks
    python examples/long_context_ring_torch.py               # the cards

The reference's model, ModelConfig(vocab=256, d_model=64, n_heads=4,
n_layers=2, d_ff=128, max_seq=4096, attn_impl="ring", dtype=f32), over
S = 4096 zero tokens, batch 2, on a world of ranks
(``entry.launch_world``): on the CPU 8 gloo processes at dp2 x sp2 x tp2,
as the reference's 8-device mesh; on the cards one NCCL rank per card,
tp, then sp, then dp given 2 each as the cards allow (1 card: all 1;
4 cards: dp1 x sp2 x tp2).  With sp > 1 each layer's attention is the
ring: the f32 fold kernel (ring_fold_fwd_f32_kernel at head dim 16) on a
card.  With sp = 1 the model takes its one-block path, as the
reference's does: the causal attention kernel (causal_fwd_f32_kernel).

Weights: --weights names an .npz of the reference's parameter tree
(``init(jax.random.key(0), cfg)``, leaves keyed "embed", "blocks/wq",
...), carried over by ``weights.params_from_jax``; without it the
example draws its own from seed 0 with ``transformer.init`` (the
reference's distribution, not its bits).  --out saves the global logits
[2, 4096, 256] (gathered over dp and sp) as .npy.

The last stdout line is one JSON object."""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np                                           # noqa: E402
import torch                                                 # noqa: E402
import torch.distributed as dist                             # noqa: E402

from brpc_tpu_torch import weights                           # noqa: E402
from brpc_tpu_torch.entry import launch_world                # noqa: E402
from brpc_tpu_torch.models import ModelConfig, apply, init   # noqa: E402
from brpc_tpu_torch.ops.causal_attention import (          # noqa: E402
    causal_attention_forward)
from brpc_tpu_torch.ops.ring_fold import ring_fold_forward   # noqa: E402
from brpc_tpu_torch.parallel import sharding                 # noqa: E402

SEQ = 4096            # 2048 a rank at sp 2: K/V never whole on a rank
BATCH = 2
SEED = 0              # of the weights drawn when none are given
CFG = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_seq=SEQ, attn_impl="ring", dtype=torch.float32)


def forward(mesh, weights_path, out_path):
    """One rank's forward; the global logits' shape, finiteness and the
    attention kernels this rank launched."""
    cfg = ModelConfig(**CFG)
    dev = mesh.device
    if weights_path:
        with np.load(weights_path) as npz:
            model = weights.params_from_jax(dict(npz), cfg, dev, mesh)
    else:
        model = init(torch.Generator().manual_seed(SEED), cfg, dev, mesh)
    tokens = sharding.local_slice(torch.zeros((BATCH, SEQ),
                                              dtype=torch.int32),
                                  ("dp", None), mesh).to(dev)
    wrappers = (ring_fold_forward, causal_attention_forward)
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = apply(model, tokens, cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    full = sharding.gather_global(logits, ("dp", "sp", None), mesh)
    if out_path and dist.get_rank() == 0:
        np.save(out_path, full.cpu().numpy())
    out = {
        "metric": "long_context_ring",
        "mesh": mesh.shape,
        "seq": SEQ,
        "logits_shape": list(full.shape),
        "finite": bool(torch.isfinite(full).all()),
        "logits_abs_max": float(full.abs().max()),
        "forward_s": seconds,
        "launches": launches,
        "weights": "reference npz" if weights_path else f"seed {SEED}",
    }
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
    return out


def card_axes(n: int) -> dict:
    axes = {"dp": 1, "sp": 1, "tp": 1}
    for a in ("tp", "sp", "dp"):
        if n % 2 == 0:
            axes[a], n = 2, n // 2
    return axes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: 8 gloo ranks at dp2 x sp2 x tp2; cuda: one "
                         "rank per card")
    ap.add_argument("--weights", default="",
                    help=".npz of the reference's parameter tree")
    ap.add_argument("--out", default="", help="save the logits (.npy)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        n, axes = 8, {"dp": 2, "sp": 2, "tp": 2}
    else:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            raise SystemExit("no CUDA device; pass --device cpu")
        n = next(c for c in (8, 4, 2, 1) if c <= cards)
        axes = card_axes(n)
    paths = [os.path.abspath(p) if p else "" for p in (args.weights,
                                                         args.out)]
    ranks = launch_world(n, axes,
                         f"{os.path.abspath(__file__)}:forward",
                         paths, device_type=args.device)
    out = ranks[0]
    out["launches_all_ranks"] = {
        k: sum(r["launches"][k] for r in ranks) for k in out["launches"]}
    print(f"ring-attention forward: seq={SEQ} over sp={axes['sp']} -> "
          f"logits {tuple(out['logits_shape'])}", flush=True)
    print(json.dumps(out))
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
