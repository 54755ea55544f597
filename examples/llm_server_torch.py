"""LLM serving flagship on the PyTorch/CUDA port (examples/llm_server.py
on brpc_tpu_torch): continuous batching + KV block plane + token
streaming, served over a mesh by a leader engine and its followers.

    python examples/llm_server_torch.py --device cpu   # 8 gloo ranks
    python examples/llm_server_torch.py                # the cards

A world of ranks (``entry.launch_world``) serves ``tiny_config()``: on the
CPU 8 gloo processes at {"dp": 2, "tp": 4}, the leader's plane on the
fake CUDA driver; on the cards one NCCL rank per card (one H100: a world
of one, {"dp": 1, "tp": 1}).  Rank 0 leads: it hosts the TRPC server, the
scheduler and the KV block plane and broadcasts every prefill, install,
decode step and reset; the other ranks replay them on their dp/tp
shards.  Against the leader:

    * N_CLIENTS concurrent clients stream full generations (retrying
      ELIMIT sheds like real clients, so every one of them finishes)
    * one client cancels MID-STREAM (an RST after two tokens) — the
      engine evicts the sequence and frees its blocks
    * a no-retry burst offered beyond the block budget is SHED with
      ELIMIT (never queued) by the scheduler + the native per-method cap
    * prefill->decode KV migration rides the plane's local d2d rail where
      the plane has two devices (the fake driver does; one card takes the
      host rail)

The last stdout line is a JSON proof block tests/test_torch_examples.py
asserts on (balanced accounting, sheds, the cancel, the rails)."""

import argparse
import json
import math
import os
import struct
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch                                                 # noqa: E402
import torch.distributed as dist                             # noqa: E402

from brpc_tpu_torch import _native, tpu_plane                # noqa: E402
from brpc_tpu_torch.entry import launch_world                # noqa: E402
from brpc_tpu_torch.rpc import errors                        # noqa: E402
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions  # noqa: E402
from brpc_tpu_torch.rpc.server import Server, ServerOptions  # noqa: E402
from brpc_tpu_torch.serving import ServingEngine             # noqa: E402
from brpc_tpu_torch.serving.engine import TOKEN_FMT, tiny_config  # noqa: E402
from brpc_tpu_torch.serving.kv_cache import KvBlockPlane     # noqa: E402

N_CLIENTS = 8      # full-generation streamers (the acceptance floor)
N_BURST = 12       # no-retry offered load beyond the budget (shed bait)
MAX_NEW = 8
N_BLOCKS = 48


def _pct(xs, p):
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(p * len(s)))]


def _slots(mesh) -> int:
    """4 decode slots, or the fewest multiple of the dp size above."""
    dp = mesh.shape.get("dp", 1)
    return dp * -(-4 // dp)


def serve(mesh):
    """One rank of the serving world: the leader serves the clients and
    returns the proof; a follower replays the leader's device operations
    until the leader stops."""
    n_slots = _slots(mesh)
    if dist.get_rank() != 0:
        engine = ServingEngine(cfg=tiny_config(), mesh=mesh, n_slots=n_slots)
        engine.start()
        engine.stop()
        return {"ops": engine.dev.ops}
    plane_up = tpu_plane.init()
    stats0 = tpu_plane.stats() if plane_up else {}
    engine = ServingEngine(cfg=tiny_config(), mesh=mesh, n_slots=n_slots,
                           kv=KvBlockPlane(block_bytes=4096,
                                           n_blocks=N_BLOCKS),
                           max_waiting=4)
    server = Server(ServerOptions(
        # the native gate in front of the scheduler: anything past what
        # the batcher could even hold sheds on the parse fiber
        method_max_concurrency={"LLM.Generate": engine.method_cap}))
    engine.register(server)
    port = server.start("127.0.0.1:0")
    engine.start()
    addr = f"127.0.0.1:{port}"
    print(f"serving on {addr} (mesh={mesh.shape}, "
          f"plane={'up' if plane_up else 'DOWN'}, slots={n_slots}, "
          f"blocks={N_BLOCKS})", flush=True)

    lock = threading.Lock()
    out = {"streamed": 0, "tokens": 0, "shed": 0, "errors": 0,
           "cancel_reset": 0, "ttft_ms": [], "gap_ms": []}

    def generate(i, retry=True):
        """One full-generation client; retries sheds so it always
        finishes (the burst clients don't)."""
        ch = Channel(addr, ChannelOptions(timeout_ms=60000, max_retry=0))
        req = json.dumps({"prompt_len": 10 + i % 4,
                          "max_new_tokens": MAX_NEW}).encode()
        try:
            while True:
                t0 = time.monotonic()
                try:
                    _, st = ch.create_stream("LLM.Generate", req)
                    break
                except errors.RpcError as e:
                    if e.code != errors.ELIMIT or not retry:
                        with lock:
                            out["shed" if e.code == errors.ELIMIT
                                else "errors"] += 1
                        return
                    with lock:
                        out["shed"] += 1
                    time.sleep(0.1)
            n, last = 0, None
            while True:
                msg = st.read(timeout_s=120)
                if msg is None:
                    break
                now = time.monotonic()
                tok = struct.unpack(TOKEN_FMT, msg)[0]
                assert tok < 128, tok
                with lock:
                    out["tokens"] += 1
                    if n == 0:
                        out["ttft_ms"].append((now - t0) * 1e3)
                    else:
                        out["gap_ms"].append((now - last) * 1e3)
                n, last = n + 1, now
            st.destroy()
            with lock:
                out["streamed"] += 1 if n == MAX_NEW else 0
        finally:
            ch.close()

    def cancel_client():
        """Reads two tokens, then RSTs the stream mid-decode (the wire
        form every cancel takes once the handshake response is out): the
        engine must evict the sequence and free its blocks."""
        ch = Channel(addr, ChannelOptions(timeout_ms=60000, max_retry=0))
        try:
            while True:
                try:
                    _, st = ch.create_stream(
                        "LLM.Generate",
                        json.dumps({"prompt_len": 12,
                                    "max_new_tokens": 32}).encode())
                    break
                except errors.RpcError as e:
                    if e.code != errors.ELIMIT:
                        raise
                    time.sleep(0.1)
            for _ in range(2):
                st.read(timeout_s=120)
            st.rst(errors.ECANCELED)
            with lock:
                out["cancel_reset"] += 1
            st.destroy()
        finally:
            ch.close()

    threads = [threading.Thread(target=generate, args=(i,))
               for i in range(N_CLIENTS)]
    threads.append(threading.Thread(target=cancel_client))
    for t in threads:
        t.start()
        time.sleep(0.02)
    # wait until the batch is hot, then offer a no-retry burst the
    # budget cannot hold — the plane must SHED it, not queue it
    deadline = time.monotonic() + 60
    while engine.stats()["running"] < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    burst = [threading.Thread(target=generate, args=(100 + i, False))
             for i in range(N_BURST)]
    for t in burst:
        t.start()
    for t in threads + burst:
        t.join(180)
        assert not t.is_alive(), "a client did not finish"
    # the decode loop notices the mid-stream RST on its next write to
    # that sequence; wait for the eviction to land before draining
    deadline = time.monotonic() + 60
    while engine.stats()["canceled"] < 1 and time.monotonic() < deadline:
        time.sleep(0.05)

    engine.stop()
    engine.assert_drained()
    es = engine.stats()
    stats1 = tpu_plane.stats() if plane_up else {}
    d2d = stats1.get("d2d_transfers", 0) - stats0.get("d2d_transfers", 0)
    server.destroy()
    return {
        "metric": "llm_server",
        "engine": {k: v for k, v in es.items() if v},
        "mesh": mesh.shape,
        "clients": N_CLIENTS,
        "streamed": out["streamed"],
        "tokens": out["tokens"],
        "tokens_out": es["tokens_out"],
        "shed_client": out["shed"],
        "shed_server": es["shed"],
        "canceled": es["canceled"],
        "cancel_reset": out["cancel_reset"],
        "finished": es["finished"],
        "rail_local": es["rail_local"],
        "rail_host": es["rail_host"],
        "d2d_delta": d2d,
        "plane": plane_up,
        "live_buffers_end": stats1.get("live_buffers", 0),
        "balanced": True,  # assert_drained() above would have thrown
        "ops": engine.dev.ops,
        "ttft_ms_p50": round(_pct(out["ttft_ms"], .5), 1),
        "ttft_ms_p99": round(_pct(out["ttft_ms"], .99), 1),
        "itl_ms_p50": round(_pct(out["gap_ms"], .5), 1),
        "itl_ms_p99": round(_pct(out["gap_ms"], .99), 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: 8 gloo ranks at dp2 x tp4 on the fake "
                         "CUDA driver; cuda: one rank per card")
    args = ap.parse_args(argv)
    leader_env = {}
    if args.device == "cpu":
        n, axes = 8, {"dp": 2, "tp": 4}
        _native.build_core()
        leader_env["TRPC_CUDA_DRIVER"] = _native.build_fake_driver()
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise SystemExit("no CUDA device; pass --device cpu")
        tp = math.gcd(n, tiny_config().n_heads)
        axes = {"dp": n // tp, "tp": tp}
    ranks = launch_world(n, axes, f"{os.path.abspath(__file__)}:serve",
                         device_type=args.device, leader_env=leader_env)
    proof = ranks[0]
    assert all(r["ops"] == proof["ops"] for r in ranks[1:]), ranks
    print(f"engine: {json.dumps(proof.pop('engine'))}")
    print(json.dumps(proof))


if __name__ == "__main__":
    main()
