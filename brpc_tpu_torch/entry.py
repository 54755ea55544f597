"""Driver entry points of the port (port of __graft_entry__.py).

entry()              — the forward step of the flagship LM on one device.
dryrun_multichip(n)  — the full training step over an n-rank mesh with
                       real dp/ep/sp/tp shards: one sharded MoE step, a
                       checkpoint saved and restored mid-run, one more
                       step, then a ring-attention step over a (dp, sp)
                       mesh.

The reference is one controller over n devices, and falls back to n
virtual CPU devices when fewer chips are present.  Here a rank is a
process: ``dryrun_multichip(n)`` starts n of them and waits for them.
``device_type="cuda"`` runs one process per card on NCCL and raises when
fewer than n cards are present; the CPU is asked for explicitly with
``device_type="cpu"``: n processes on gloo.  Each rank prints the
reference's summary line, prefixed with its backend.

    python -m brpc_tpu_torch.entry dryrun --n 8 --device-type cpu
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import subprocess
import sys
import tempfile
from typing import List

import torch
import torch.distributed as dist

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RANK_TIMEOUT_S = 600.0     # how long dryrun_multichip waits for a rank


def _tiny_cfg(moe: bool):
    from brpc_tpu_torch.models import ModelConfig
    return ModelConfig(
        vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq=64, n_experts=4 if moe else 0, moe_every=2)


def entry(device="cuda"):
    """(fn, example_args): the forward pass on one device."""
    from brpc_tpu_torch.models import apply, init
    cfg = _tiny_cfg(moe=False)
    params = init(torch.Generator().manual_seed(0), cfg, device)
    tokens = torch.zeros((2, 32), dtype=torch.int32, device=device)

    def fwd(params, tokens):
        return apply(params, tokens, cfg)

    return fwd, (params, tokens)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device_type: str = "cuda"
                     ) -> List[str]:
    """Run the sharded train step, a checkpoint round trip and the ring
    pass on n ranks (one process each); returns and prints the ranks'
    summary lines.  Raises if a rank fails."""
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) needs {n_devices} CUDA "
                f"devices, found {have}; pass device_type='cpu' to run "
                f"{n_devices} gloo processes on the CPU")
    elif device_type != "cpu":
        raise ValueError(f"device_type is cuda or cpu, not {device_type!r}")
    env = dict(os.environ,
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                               ""))
    if device_type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    with tempfile.TemporaryDirectory() as workdir:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "brpc_tpu_torch.entry", "rank",
             "--n", str(n_devices), "--rank", str(r), "--port", str(port),
             "--device-type", device_type, "--workdir", workdir],
            env=env, cwd=_REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(n_devices)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=_RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [f"rank {r} exit {p.returncode}:\n{out[-3000:]}"
              for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    lines = [ln for out in outs for ln in out.splitlines()
             if ": dryrun_multichip(" in ln]
    for ln in lines:
        print(ln, flush=True)
    return lines


def _dp_shard(tokens: torch.Tensor, mesh) -> torch.Tensor:
    from brpc_tpu_torch.parallel import sharding
    return sharding.local_slice(tokens, ("dp", None), mesh).to(mesh.device)


def _dryrun(n_devices: int, device_type: str, workdir: str) -> str:
    """One rank's part of dryrun_multichip (__graft_entry__.py:49-148)."""
    from brpc_tpu_torch.models import (ModelConfig, TrainState, checkpoint,
                                       init, make_train_step)
    from brpc_tpu_torch.parallel import auto_mesh

    def fresh(cfg, mesh, seed):
        tx, step = make_train_step(cfg, mesh, device=device_type)
        params = init(torch.Generator().manual_seed(seed), cfg, mesh.device,
                      mesh)
        return step, TrainState(params, tx(params),
                                torch.zeros((), dtype=torch.int32))

    mesh = auto_mesh(n_devices, ("dp", "ep", "sp", "tp"), device_type)
    ep = mesh.shape.get("ep", 1)
    dp, sp = mesh.shape.get("dp", 1), mesh.shape.get("sp", 1)
    cfg = ModelConfig(
        vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq=64, n_experts=max(2 * ep, 4), moe_every=2,
        attn_impl="ring" if sp > 1 else "gather")
    step, state = fresh(cfg, mesh, 0)
    # S+1 tokens, S sp-divisible; each rank takes its dp shard
    tokens = _dp_shard(torch.zeros((max(2, 2 * dp), max(16 * sp, 32) + 1),
                                   dtype=torch.int32), mesh)
    state, loss = step(state, tokens)
    loss = loss.item()
    assert loss == loss and loss > 0, f"bad loss {loss}"

    # checkpoint/restore mid-run, then one more step from the restored state
    ckpt = os.path.join(workdir, "state.npz")
    checkpoint.save(ckpt, state)
    restored = checkpoint.restore(ckpt, state)
    assert int(restored.step) == int(state.step)
    restored, loss2 = step(restored, tokens)
    restored_loss = loss2.item()
    assert restored_loss == restored_loss and restored_loss > 0
    assert int(restored.step) == 2

    # the ring-attention (sp) long-context path on its own mesh
    sp_mesh = auto_mesh(n_devices, ("dp", "sp"), device_type)
    sp_n = sp_mesh.shape.get("sp", 1)
    ring_loss = math.nan
    if sp_n > 1:
        ring_cfg = ModelConfig(
            vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=16 * sp_n, n_experts=0, moe_every=2, attn_impl="ring")
        ring_step, rstate = fresh(ring_cfg, sp_mesh, 1)
        rtokens = _dp_shard(torch.zeros(
            (max(2, 2 * sp_mesh.shape.get("dp", 1)), 16 * sp_n + 1),
            dtype=torch.int32), sp_mesh)
        _, rl = ring_step(rstate, rtokens)
        ring_loss = rl.item()
        assert ring_loss == ring_loss and ring_loss > 0
    return (f"dryrun_multichip({n_devices}): mesh={mesh.shape} "
            f"loss={loss:.4f} restored_step_loss={restored_loss:.4f} "
            f"ring_mesh={sp_mesh.shape} ring_loss={ring_loss:.4f} ok")


def _rank_main(args) -> None:
    cuda = args.device_type == "cuda"
    backend = "nccl" if cuda else "gloo"
    kw = {}
    if cuda:
        torch.cuda.set_device(args.rank)
        kw["device_id"] = torch.device("cuda", args.rank)
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{args.port}",
                            rank=args.rank, world_size=args.n, **kw)
    try:
        line = _dryrun(args.n, args.device_type, args.workdir)
    finally:
        dist.destroy_process_group()
    print(f"{backend}: {line}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m brpc_tpu_torch.entry")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dry = sub.add_parser("dryrun", help="dryrun_multichip on n ranks")
    dry.add_argument("--n", type=int, default=8)
    dry.add_argument("--device-type", default="cuda")
    rank = sub.add_parser("rank", help="one rank of dryrun_multichip")
    rank.add_argument("--n", type=int, required=True)
    rank.add_argument("--rank", type=int, required=True)
    rank.add_argument("--port", type=int, required=True)
    rank.add_argument("--device-type", required=True)
    rank.add_argument("--workdir", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "rank":
        _rank_main(args)
    else:
        dryrun_multichip(args.n, args.device_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
