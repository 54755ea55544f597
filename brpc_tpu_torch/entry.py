"""Driver entry points of the port (port of __graft_entry__.py).

entry()              — the forward step of the flagship LM on one device.
dryrun_multichip(n)  — the full training step over an n-rank mesh with
                       real dp/ep/sp/tp shards: one sharded MoE step, a
                       checkpoint saved and restored mid-run, one more
                       step, then a ring-attention step over a (dp, sp)
                       mesh.
launch_world(n, axes, "file.py:function")
                     — a world of n ranks (a serving world: a leader
                       engine and its followers), each running
                       target(mesh, *args) on its mesh; returns what each
                       rank's call returned.

The reference is one controller over n devices, and falls back to n
virtual CPU devices when fewer chips are present.  Here a rank is a
process: ``launch_world`` starts n of them and waits for them, and
``dryrun_multichip(n)`` is one such world.  ``device_type="cuda"`` runs
one process per card on NCCL and raises when fewer than n cards are
present; the CPU is asked for explicitly with ``device_type="cpu"``: n
processes on gloo.  ``launch_world`` gives rank 0 alone ``leader_env``
(on the CPU the fake CUDA driver, ``TRPC_CUDA_DRIVER``, which only the
leader's ``tpu_plane`` binds) and stops every rank when one fails.  The
dryrun prints each rank's copy of the reference's summary line, prefixed
with its backend.

    python -m brpc_tpu_torch.entry dryrun --n 8 --device-type cpu
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RANK_TIMEOUT_S = 600.0     # how long launch_world waits for its world


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
    pass on n ranks (one launch_world); returns and prints the ranks'
    summary lines.  Raises if a rank fails."""
    from brpc_tpu_torch.parallel import auto_mesh
    _check_world(n_devices, device_type, "dryrun_multichip")
    axes = auto_mesh(n_devices, ("dp", "ep", "sp", "tp"), device_type).shape
    with tempfile.TemporaryDirectory() as workdir:
        lines = launch_world(n_devices, axes,
                             "brpc_tpu_torch/entry.py:_dryrun",
                             (device_type, workdir), device_type)
    for ln in lines:
        print(ln, flush=True)
    return lines


def _check_world(n: int, device_type: str, what: str) -> None:
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"{what}({n}) needs {n} CUDA devices, found {have}; pass "
                f"device_type='cpu' to run {n} gloo processes on the CPU")
    elif device_type != "cpu":
        raise ValueError(f"device_type is cuda or cpu, not {device_type!r}")


def _rank_env(device_type: str) -> Dict[str, str]:
    env = dict(os.environ,
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                               ""))
    if device_type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    return env


def launch_world(n: int, axes: Dict[str, int], target: str,
                 args: Sequence[Any] = (), device_type: str = "cuda",
                 leader_env: Optional[Dict[str, str]] = None) -> List[Any]:
    """Run ``target(mesh, *args)`` on a world of n ranks, one process
    each (NCCL on cards, gloo on the CPU with ``device_type="cpu"``), the
    mesh ``make_mesh(axes)`` over the world.  `target` is
    ``"path/to/file.py:function"`` (relative to the repository or
    absolute); `args` and the return values are JSON.  Rank 0 alone
    gets `leader_env`, and no other rank inherits ``TRPC_CUDA_DRIVER``.  Returns the ranks' return
    values in rank order; raises with the ranks' output tails if one
    fails (the others are stopped) or the world outlasts
    ``_RANK_TIMEOUT_S``."""
    _check_world(n, device_type, "launch_world")
    base = _rank_env(device_type)
    port = _free_port()
    with tempfile.TemporaryDirectory() as workdir:
        procs, logs = [], []
        try:
            for r in range(n):
                env = dict(base)
                if r == 0:
                    env.update(leader_env or {})
                else:
                    env.pop("TRPC_CUDA_DRIVER", None)
                log = open(os.path.join(workdir, f"rank{r}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "brpc_tpu_torch.entry", "world",
                     "--n", str(n), "--rank", str(r), "--port", str(port),
                     "--device-type", device_type,
                     "--axes", json.dumps(axes), "--target", target,
                     "--args", json.dumps(list(args)),
                     "--out", os.path.join(workdir, f"rank{r}.json")],
                    env=env, cwd=_REPO, stdout=log,
                    stderr=subprocess.STDOUT))
            deadline = time.monotonic() + _RANK_TIMEOUT_S
            while any(p.poll() is None for p in procs):
                if any(p.returncode for p in procs) or \
                        time.monotonic() > deadline:
                    break       # a rank failed: its peers would wait
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            tails = []
            for log in logs:
                log.seek(0)
                tails.append(log.read()[-3000:])
                log.close()
        failed = [f"rank {r} exit {p.returncode}:\n{tail}"
                  for r, (p, tail) in enumerate(zip(procs, tails))
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        out = []
        for r in range(n):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out


def _load_target(target: str):
    path, _, name = target.rpartition(":")
    spec = importlib.util.spec_from_file_location(
        "_world_target", os.path.join(_REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, name)


def _dp_shard(tokens: torch.Tensor, mesh) -> torch.Tensor:
    from brpc_tpu_torch.parallel import sharding
    return sharding.local_slice(tokens, ("dp", None), mesh).to(mesh.device)


def _dryrun(mesh, device_type: str, workdir: str) -> str:
    """One rank's part of dryrun_multichip (__graft_entry__.py:49-148) on
    `mesh`, the world over (dp, ep, sp, tp); its summary line."""
    from brpc_tpu_torch.models import (ModelConfig, TrainState, checkpoint,
                                       init, make_train_step)
    from brpc_tpu_torch.parallel import auto_mesh

    def fresh(cfg, mesh, seed):
        tx, step = make_train_step(cfg, mesh, device=device_type)
        params = init(torch.Generator().manual_seed(seed), cfg, mesh.device,
                      mesh)
        return step, TrainState(params, tx(params),
                                torch.zeros((), dtype=torch.int32))

    n_devices = mesh.size
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
    return (f"{dist.get_backend()}: "
            f"dryrun_multichip({n_devices}): mesh={mesh.shape} "
            f"loss={loss:.4f} restored_step_loss={restored_loss:.4f} "
            f"ring_mesh={sp_mesh.shape} ring_loss={ring_loss:.4f} ok")


def _init_rank(args) -> None:
    """Join the world as rank args.rank."""
    cuda = args.device_type == "cuda"
    backend = "nccl" if cuda else "gloo"
    kw = {}
    if cuda:
        torch.cuda.set_device(args.rank)
        kw["device_id"] = torch.device("cuda", args.rank)
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{args.port}",
                            rank=args.rank, world_size=args.n, **kw)


def _die_with_parent() -> None:
    """SIGKILL this rank when its launcher dies (Linux prctl
    PR_SET_PDEATHSIG), so that a killed launcher leaves no rank behind
    holding a card or a collective."""
    import ctypes
    import signal
    launcher = os.getppid()
    ctypes.CDLL(None).prctl(1, int(signal.SIGKILL))
    if os.getppid() != launcher:     # it died before the prctl
        os._exit(1)


def _world_main(args) -> None:
    from brpc_tpu_torch.parallel import make_mesh
    _die_with_parent()
    _init_rank(args)
    try:
        mesh = make_mesh(json.loads(args.axes), device_type=args.device_type)
        result = _load_target(args.target)(mesh, *json.loads(args.args))
    finally:
        dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(result, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m brpc_tpu_torch.entry")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dry = sub.add_parser("dryrun", help="dryrun_multichip on n ranks")
    dry.add_argument("--n", type=int, default=8)
    dry.add_argument("--device-type", default="cuda")
    world = sub.add_parser("world", help="one rank of launch_world")
    for flag in ("--n", "--rank", "--port"):
        world.add_argument(flag, type=int, required=True)
    for flag in ("--device-type", "--axes", "--target", "--args", "--out"):
        world.add_argument(flag, required=True)
    args = ap.parse_args(argv)
    if args.cmd == "world":
        _world_main(args)
    else:
        dryrun_multichip(args.n, args.device_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
