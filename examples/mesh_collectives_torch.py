"""mesh_collectives on the PyTorch/CUDA port (examples/mesh_collectives.py
on brpc_tpu_torch): combo channels lowered to collectives.  When the
member set is a mesh axis, ParallelChannel's fan-out + merge IS one
collective (SURVEY.md §2.9): no per-member RPCs.

    python examples/mesh_collectives_torch.py --device cpu  # 8 gloo ranks
    python examples/mesh_collectives_torch.py               # the cards

A world of ranks (``entry.launch_world``): on the CPU 8 gloo processes
at {"dp": 2, "tp": 4}, as the reference's 8-device mesh; on the cards one
NCCL rank per card, tp the largest of 4, 2, 1 that divides the cards and
dp the rest (one card: {"dp": 1, "tp": 1}).  The reference's arrays are
global and sharded over tp on dim 0; here each rank holds its shard and
gets its part back, and the JSON reports the global values the parts
make:

    * MeshParallelChannel(merger="add") over tp: x = ones((8, 8)), every
      entry summed over the tp members (= tp)
    * MeshPartitionChannel over tp: the all_gather merge of x, and the
      reduce_scatter merge of ones((16, 8))
    * bus_bandwidth_gbps over tp at 8 MB a shard.  Its formula,
      algbw * 2(n-1)/n, is 0 over one member: the JSON then says so.

The last stdout line is one JSON object."""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch                                                 # noqa: E402
import torch.distributed as dist                             # noqa: E402

from brpc_tpu_torch.entry import launch_world                # noqa: E402
from brpc_tpu_torch.parallel.channels import (               # noqa: E402
    MeshParallelChannel, MeshPartitionChannel)
from brpc_tpu_torch.parallel.collectives import bus_bandwidth_gbps  # noqa: E402

X_ROWS = 8            # the reference's x: ones((8, 8)), dim 0 over tp
RS_ROWS = 16          # its reduce_scatter input: ones((16, 8))
COLS = 8
PROBE_MB = 8


def collectives(mesh):
    """One rank: every merge over tp, each checked against its closed
    form; the global shapes and values they make."""
    tp = mesh.shape["tp"]
    dev = mesh.device
    x = torch.ones((X_ROWS // tp, COLS), device=dev)    # this rank's shard
    merged = MeshParallelChannel(mesh, "tp", merger="add").call_tensor(x)
    assert torch.equal(merged, torch.full_like(x, tp)), merged
    part = MeshPartitionChannel(mesh, "tp")
    gathered = part.call_gather(x)
    assert torch.equal(gathered, torch.ones((X_ROWS, COLS), device=dev))
    rs = part.call_reduce_scatter(
        torch.ones((RS_ROWS // tp, COLS), device=dev))
    assert torch.equal(rs, torch.full((RS_ROWS // tp // tp, COLS),
                                      float(tp), device=dev)), rs
    busbw = bus_bandwidth_gbps(mesh, "tp", mbytes_per_shard=PROBE_MB)
    out = {
        "metric": "mesh_collectives",
        "mesh": mesh.shape,
        "backend": dist.get_backend(),
        "allreduce_value": merged[0, 0].item(),
        "allreduce_shape": [X_ROWS, COLS],
        "gather_shape": list(gathered.shape),
        "reduce_scatter_shape": [rs.shape[0] * tp, COLS],
        "reduce_scatter_local_shape": list(rs.shape),
        "busbw_gbps": busbw,
        "busbw_mbytes_per_shard": PROBE_MB,
    }
    if tp == 1:
        out["busbw_note"] = ("one member on tp: 2(n-1)/n = 0, no byte "
                             "crosses a link")
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
    return out


def card_axes(n: int) -> dict:
    tp = next(t for t in (4, 2, 1) if n % t == 0)
    return {"dp": n // tp, "tp": tp}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: 8 gloo ranks at dp2 x tp4; cuda: one rank "
                         "per card")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        n, axes = 8, {"dp": 2, "tp": 4}
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise SystemExit("no CUDA device; pass --device cpu")
        axes = card_axes(n)
    ranks = launch_world(n, axes,
                         f"{os.path.abspath(__file__)}:collectives",
                         device_type=args.device)
    out = ranks[0]
    # every rank made the same global values
    assert all({k: r[k] for k in r if k != "busbw_gbps"} ==
               {k: out[k] for k in out if k != "busbw_gbps"}
               for r in ranks), ranks
    print(f"mesh: {out['mesh']} over {out['backend']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
