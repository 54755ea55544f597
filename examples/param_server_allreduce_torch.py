"""Parameter-server gradient allreduce on the PyTorch/CUDA port
(examples/param_server_allreduce.py on brpc_tpu_torch): each data-
parallel worker holds its gradient for ResNet-50's real parameter set
(its layer shapes, 25,557,032 values, uncut) and the ParallelChannel
fan-out + "add" ResponseMerger is one all_reduce over the dp axis
(parallel_channel.h:185 retargeted at the mesh, SURVEY §2.9).

    python examples/param_server_allreduce_torch.py --device cpu [--codec int8]
    python examples/param_server_allreduce_torch.py [--codec int8]  # cards

A world of ranks (``entry.launch_world``), all on one dp axis: on the CPU
8 gloo processes, as the reference's 8-device mesh; on the cards one NCCL
rank per card.  Worker i holds ONE flat f32 row, (arange(P) % 97) * (i+1)
(the reference stacks the n rows into one (n, P) array), so the merge is
checkable: with no codec it must equal (arange(P) % 97) * n(n+1)/2
exactly (every value is an integer below 2^24).  With --codec int8|bf16
each worker's row passes the codec before the sum (dequantize-then-
reduce; on a card the int8 pass is the kernel csrc/quant_codec.cu), and
the error must be > 0 and within the workers' bounds added.

Prints one JSON line with the reference's keys: the measured gradient
allreduce rate (algbw, and busbw = algbw * 2(n-1)/n, 0 over one member)
and the bus-bandwidth probe."""

import argparse
import json
import math
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch                                                 # noqa: E402
import torch.distributed as dist                             # noqa: E402

from brpc_tpu_torch.entry import launch_world                # noqa: E402
from brpc_tpu_torch.parallel import quantize                 # noqa: E402
from brpc_tpu_torch.parallel.channels import MeshParallelChannel  # noqa: E402
from brpc_tpu_torch.parallel.collectives import bus_bandwidth_gbps  # noqa: E402

CHUNK = 1 << 22       # values a check compares at once
ITERS = 3             # timed merges, as the reference's run()


def resnet50_param_shapes():
    """The actual ResNet-50 parameter shapes (conv/BN/fc), ~25.5M params
    — a 'real-sized param set', not a synthetic blob."""
    shapes = [("conv1", (7, 7, 3, 64)), ("bn1_scale", (64,)),
              ("bn1_bias", (64,))]
    in_ch = 64
    stage_planes = [(64, 3), (128, 4), (256, 6), (512, 3)]
    for s, (planes, blocks) in enumerate(stage_planes):
        out_ch = planes * 4
        for b in range(blocks):
            pfx = f"layer{s + 1}.{b}"
            shapes += [
                (f"{pfx}.conv1", (1, 1, in_ch, planes)),
                (f"{pfx}.bn1_scale", (planes,)),
                (f"{pfx}.bn1_bias", (planes,)),
                (f"{pfx}.conv2", (3, 3, planes, planes)),
                (f"{pfx}.bn2_scale", (planes,)),
                (f"{pfx}.bn2_bias", (planes,)),
                (f"{pfx}.conv3", (1, 1, planes, out_ch)),
                (f"{pfx}.bn3_scale", (out_ch,)),
                (f"{pfx}.bn3_bias", (out_ch,)),
            ]
            if b == 0:
                shapes += [(f"{pfx}.downsample", (1, 1, in_ch, out_ch)),
                           (f"{pfx}.bn_ds_scale", (out_ch,)),
                           (f"{pfx}.bn_ds_bias", (out_ch,))]
            in_ch = out_ch
    shapes += [("fc_w", (2048, 1000)), ("fc_b", (1000,))]
    return shapes


def _pattern(lo: int, hi: int, device) -> torch.Tensor:
    """(arange(P) % 97)[lo:hi] in f32."""
    return (torch.arange(lo, hi, dtype=torch.int32, device=device)
            % 97).float()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def worker(mesh, codec: str):
    """One dp worker: merge, check, time; the reference's JSON keys."""
    dev = mesh.device
    n = mesh.shape["dp"]
    i = dist.get_rank(mesh.group("dp"))
    ch = MeshParallelChannel(mesh, "dp", merger="add", codec=codec)
    nparams = sum(math.prod(s) for _, s in resnet50_param_shapes())
    grad_bytes = nparams * 4
    row = torch.empty(nparams, device=dev)
    for lo in range(0, nparams, CHUNK):
        hi = min(nparams, lo + CHUNK)
        row[lo:hi] = _pattern(lo, hi, dev).mul_(i + 1)

    merged = ch.call_tensor(row)
    total = n * (n + 1) // 2
    codec_err = codec_bound = None
    if codec == "none":
        for lo in range(0, nparams, CHUNK):
            hi = min(nparams, lo + CHUNK)
            assert torch.equal(merged[lo:hi], _pattern(lo, hi, dev) * total), \
                f"merged values [{lo}, {hi}) differ from the dense sum"
    else:
        # the n-way sum's bound is the workers' one-pass bounds added
        mine = quantize.int8_error_bound(row) if codec == "int8" else \
            float(row.abs().max()) * 2.0 ** -8
        bound = torch.tensor([mine], dtype=torch.float64, device=dev)
        dist.all_reduce(bound, group=mesh.group("dp"))
        codec_bound = float(bound)
        codec_err = max(
            float((merged[lo:lo + CHUNK] - _pattern(
                lo, min(nparams, lo + CHUNK), dev) * total).abs().max())
            for lo in range(0, nparams, CHUNK))
        assert codec_err <= codec_bound, (
            f"{codec} allreduce error {codec_err} exceeds the bound "
            f"{codec_bound}")
        assert codec_err > 0.0, f"{codec} codec did not engage"
    del merged

    ch.call_tensor(row)               # warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = ch.call_tensor(row)
    _sync(dev)
    dt = time.perf_counter() - t0
    del out
    algbw = grad_bytes * ITERS / dt / 1e9
    busbw = algbw * 2 * (n - 1) / n
    result = {
        "workload": "param_server_allreduce",
        "params": nparams,
        "grad_mbytes": round(grad_bytes / 1e6, 1),
        "devices": n,
        "platform": dev.type,
        "numeric_check": "ok",
        "codec": codec,
        "codec_max_abs_err": codec_err,
        "codec_err_bound": codec_bound,
        "allreduce_algbw_gbps": round(algbw, 3),
        "allreduce_busbw_gbps": round(busbw, 3),
        "probe_busbw_gbps": round(
            bus_bandwidth_gbps(mesh, "dp", mbytes_per_shard=2.0, iters=3), 3),
        "peak_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024,
    }
    if dev.type == "cuda":
        result["device_name"] = torch.cuda.get_device_name(dev)
        result["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--codec", default="none",
                    choices=("none", "int8", "bf16"),
                    help="run the reduce leg through the quantizing "
                         "payload codec (lossy, asserted within its "
                         "documented bound)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: 8 gloo ranks; cuda: one rank per card")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        n = 8
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise SystemExit("no CUDA device; pass --device cpu")
    ranks = launch_world(n, {"dp": n},
                         f"{os.path.abspath(__file__)}:worker",
                         (args.codec,), device_type=args.device)
    out = ranks[0]
    out["peak_rss_mb_all_ranks"] = sum(r["peak_rss_mb"] for r in ranks)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
