"""The serving driver: the port's ServingEngine on a Server, streams of
``LLM.Generate`` from the load generator's child process.

Set-up: the weights from the seed on the device, the engine with the
configuration's slots, waiting room and KV blocks, the server on
loopback, the clients started; set-up ends once every slot is taken
(the ramp of the closed loop, so the window opens on a full batch).
The window: ``seconds`` of the clients' stamps.  With a trace the
benchmark's spans wrap the engine's step, prefill and token writes and
its admits' KV route and install, and once the window has closed, with
the clients still sending, one profiler slice covers the mix's
``trace_steps`` decode steps with at least ``trace_admits`` admits in
them.  Afterwards: the engine is stopped, its state freed,
and a sample of the finished streams is scored by the plain reference.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List

from perfbench import harness, traffic
from perfbench.profiling import Patches, Slice, Spans, summarize, warm_up
from perfbench.weights import make_weights

RAMP_TIMEOUT_S = 300.0
SLICE_TIMEOUT_S = 60.0
CHILD_TIMEOUT_S = 180.0
POLL_S = 0.02
MEMORY_POLL_S = 1.0
LOADGEN = os.path.join(harness.HERE, "loadgen.py")


def _engine(ctx, cfg, model):
    from brpc_tpu_torch.rpc.server import Server, ServerOptions
    from brpc_tpu_torch.serving import ServingEngine
    from brpc_tpu_torch.serving.kv_cache import KvBlockPlane
    e = ctx.config["engine"]
    engine = ServingEngine(
        cfg=cfg, params=model, n_slots=e["n_slots"], max_len=e["max_len"],
        kv=KvBlockPlane(block_bytes=e["kv_block_bytes"],
                        n_blocks=e["kv_blocks"], decode_device=0),
        max_waiting=e["max_waiting"], device=ctx.device)
    server = Server(ServerOptions(
        method_max_concurrency={"LLM.Generate": engine.method_cap}))
    engine.register(server)
    port = server.start("127.0.0.1:0")
    engine.start()
    return engine, server, f"127.0.0.1:{port}"


def _instrument(engine, mix, patches: Patches, spans: Spans,
                rec: Dict) -> None:
    """Host spans around the calls into the engine's layers (the KV
    route's for ``kv_route_ms_per_admit``, the step's for
    ``decode_step_ms``; with prefill, the token writes and the blocks
    they grow, they name the slice's idle gaps), the calls' shapes for
    the rooflines (kept while ``rec["slicing"]``), and the profiler
    slice, which the decode loop's own thread opens at the start of a
    step once ``rec["slice"]["want"]`` is set and closes after the step
    that completes the mix's steps and admits."""
    from brpc_tpu_torch.models import decode as D
    from brpc_tpu_torch.models import transformer as T
    for name in ("kv_to_bytes", "kv_from_bytes"):
        patches.set(D, name, spans.timed(name, getattr(D, name)))
    for name in ("seq_alloc", "seq_migrate", "seq_fetch"):
        patches.set(engine.kv, name, spans.timed(name,
                                                 getattr(engine.kv, name)))
    patches.set(engine.dev, "install", spans.timed("install",
                                                   engine.dev.install))
    patches.set(engine.dev, "step", spans.timed("step", engine.dev.step))
    patches.set(engine.dev, "prefill", spans.timed("prefill",
                                                   engine.dev.prefill))
    patches.set(engine.kv, "seq_grow", spans.timed("seq_grow",
                                                   engine.kv.seq_grow))
    patches.set(engine, "_emit", spans.timed("emit", engine._emit))
    batches = rec["decode_batches"]
    inner_batch = engine._decode_batch

    sl = rec["slice"]

    def decode_batch(batch):
        if sl["want"] and sl["prof"] is None:
            sl["prof"] = Slice(engine.device)
            sl["prof"].__enter__()
            sl["steps"], sl["admits0"] = 0, engine.prefills
            rec["slicing"] = True
        # the contexts the step attends over, read before it advances
        batches.append((time.monotonic(), len(batch),
                        sum(s.total_len for s in batch)))
        out = inner_batch(batch)
        if rec["slicing"]:
            sl["steps"] += 1
            if sl["steps"] >= mix["trace_steps"] and \
                    engine.prefills - sl["admits0"] >= mix["trace_admits"]:
                rec["slicing"] = False
                sl["prof"].__exit__(None, None, None)
                sl["done"].set()
        return out
    patches.set(engine, "_decode_batch", decode_batch)
    admits = rec["admits"]
    inner_admit = engine._admit

    def admit(seq):
        admits.append((time.monotonic(), seq.prompt_len))
        return inner_admit(seq)
    patches.set(engine, "_admit", admit)
    calls = rec["calls"]
    inner_attn = D.decode_attention

    def decode_attention(q, k_new, v_new, k_cache_l, v_cache_l, p):
        if rec["slicing"]:
            calls["decode_attention"].append(
                (tuple(q.shape), q.element_size(), p.clone()))
        return inner_attn(q, k_new, v_new, k_cache_l, v_cache_l, p)
    patches.set(D, "decode_attention", decode_attention)
    inner_causal = T.causal_attention

    def causal_attention(q, k, v):
        if rec["slicing"]:
            calls["causal_fwd"].append((tuple(q.shape), q.element_size()))
        return inner_causal(q, k, v)
    patches.set(T, "causal_attention", causal_attention)


def _start_clients(ctx, addr, vocab):
    env = dict(os.environ)
    env.pop("TRPC_CUDA_DRIVER", None)   # a pure TCP client
    child = subprocess.Popen([sys.executable, LOADGEN], stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, text=True, env=env,
                             cwd=harness.REPO)
    child.stdin.write(json.dumps({"addr": addr, "mix": ctx.mix,
                                  "seed": ctx.seed, "vocab": vocab}) + "\n")
    child.stdin.flush()
    line = child.stdout.readline()
    if line.strip() != "started":
        child.kill()
        child.wait()
        raise RuntimeError(f"the load generator did not start: {line!r}")
    return child


def _stop_clients(child) -> None:
    """Tell the clients to send no more; the caller then stops the
    engine and the server, which end the open streams."""
    child.stdin.write("stop\n")
    child.stdin.flush()
    line = child.stdout.readline()
    if line.strip() != "ack":
        raise RuntimeError(f"the load generator did not stop: {line!r}")


def _collect(child) -> List[Dict]:
    try:
        out, _ = child.communicate(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        raise RuntimeError("the load generator did not end")
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    if not lines:
        raise RuntimeError(f"the load generator gave no result "
                           f"(exit {child.returncode})")
    body = json.loads(lines[-1][len("RESULT "):])
    if body["alive"]:
        raise RuntimeError(f"{body['alive']} clients did not end")
    return body["requests"]


def _wait_full(engine, n_full):
    deadline = time.monotonic() + RAMP_TIMEOUT_S
    while True:
        st = engine.stats()
        if st["admitted"] >= n_full and st["running"] >= n_full:
            return
        if time.monotonic() > deadline:
            raise RuntimeError(f"the batch did not fill in "
                               f"{RAMP_TIMEOUT_S} s: {st}")
        time.sleep(POLL_S)


def run(ctx) -> Dict:
    import torch
    from brpc_tpu_torch import _native, tpu_plane
    from brpc_tpu_torch.models import transformer as T

    m, e, mix, dev = (ctx.config["model"], ctx.config["engine"], ctx.mix,
                      ctx.device)
    if dev.type == "cuda":
        _native.build_core()
        _native.build_kernels()
    if not tpu_plane.init():
        raise RuntimeError(f"the device plane is down: {tpu_plane.error()}")
    cfg = harness.model_config(m)
    model = T.TransformerLM(cfg, device="meta")
    model.load_state_dict(make_weights(m, ctx.seed, dev), assign=True)
    engine, server, addr = _engine(ctx, cfg, model)
    patches, spans = Patches(), Spans()
    rec = {"decode_batches": [], "admits": [], "slicing": False,
           "calls": {"decode_attention": [], "causal_fwd": []},
           "slice": {"want": False, "prof": None,
                     "done": threading.Event()}}
    child, prof = None, None
    try:
        if ctx.trace:
            _instrument(engine, mix, patches, spans, rec)
            warm_up(dev)
        child = _start_clients(ctx, addr, m["vocab"])
        n_full = min(e["n_slots"], mix["clients"])
        _wait_full(engine, n_full)
        mem = harness.memory_used(dev)
        t0 = time.monotonic()
        setup_s = t0 - ctx.t_start
        s0 = engine.stats()
        t_end, next_poll = t0 + ctx.seconds, t0
        while True:
            now = time.monotonic()
            if now >= t_end:
                break
            if now >= next_poll:
                mem = max(mem, harness.memory_used(dev))
                next_poll = now + MEMORY_POLL_S
            time.sleep(min(POLL_S, t_end - now))
        t1 = time.monotonic()
        s1 = engine.stats()
        mem = max(mem, harness.memory_used(dev))
        if ctx.trace:       # after the window, the clients still sending
            rec["slice"]["want"] = True
            if not rec["slice"]["done"].wait(SLICE_TIMEOUT_S):
                raise RuntimeError("the profiler slice did not close")
        prof = rec["slice"]["prof"]
        _stop_clients(child)
        engine.stop()
        server.destroy()
        requests = _collect(child)
        child = None
    finally:
        patches.undo()
        if child is not None:
            child.kill()
            child.wait()
    print(json.dumps({"engine_stats": {"window_start": s0,
                                       "window_end": s1},
                      "sheds": sum(r["sheds"] for r in requests)}),
          flush=True)
    n_slots = engine.n_slots
    del engine, server, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    record = _record(ctx, requests, t0, t1, setup_s, s0, s1, n_slots, mem)
    record.update(spans=spans.within(t0, t1),
                  decode_batches=[b for b in rec["decode_batches"]
                                  if t0 <= b[0] <= t1],
                  admits=[a for a in rec["admits"] if t0 <= a[0] <= t1])
    summary = summarize(prof, spans.named()) if prof is not None else None
    if summary is not None:     # the slice's pace beside the window's
        inside = [b - a for a, b in spans.by_name["step"]
                  if prof.anchor <= a <= prof.closed]
        window = record["spans"]["step"]
        ctx.log(f"a decode step: {sum(inside) / len(inside) * 1e3:.2f} ms "
                f"in the slice, {sum(window) / len(window) * 1e3:.2f} ms "
                f"in the window")
        record["profile"] = dict(
            summary, calls={
                "decode_attention": [(shape, elt, p.tolist()) for shape, elt,
                                     p in rec["calls"]["decode_attention"]],
                "causal_fwd": rec["calls"]["causal_fwd"]})
        record["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        record["breakdown"] = summary["breakdown"]
    record["checks"] = _judge(ctx, requests, t1, record)
    return record


def end_time(r: Dict) -> float:
    """When a request ended: its last token, or its send if none came."""
    return r["stamps"][-1] if r["stamps"] else r["t_send"]


def _record(ctx, requests, t0, t1, setup_s, s0, s1, n_slots, mem) -> Dict:
    ended = [r for r in requests
             if r["end"] != "stopped" and t0 <= end_time(r) <= t1]
    # an error, or a refusal (ELIMIT) before the request was let in: the
    # waiting room holds every client, so none may be shed
    failed = [r for r in ended if r["end"] != "eof" or r["sheds"]]
    return {
        "setup_s": setup_s, "t0": t0, "t1": t1, "window_s": t1 - t0,
        "requests": requests, "stats0": s0, "stats1": s1,
        "n_slots": n_slots, "model": ctx.config["model"],
        "attempted": len(ended), "failed": len(failed),
        "device": harness.device_info(ctx.device, mem)}


def _judge(ctx, requests, t1, record) -> Dict:
    """The served tokens of a sample of the finished streams, scored by
    the plain reference teacher-forced on each prompt and its tokens:
    the widest gap by which a served token's logit lies below the
    reference's best at its position."""
    from perfbench.reference import gpt2
    m, mix, lim = ctx.config["model"], ctx.mix, ctx.limits
    finished = [r for r in requests if r["end"] == "eof"
                and r["stamps"] and r["stamps"][-1] <= t1]
    sound = [r for r in finished
             if len(r["tokens"]) == r["max_new_tokens"]
             and all(0 <= t < m["vocab"] for t in r["tokens"])]
    short = len(finished) - len(sound)
    sample = traffic.check_sample(ctx.seed, sound, mix["check_requests"])
    w = make_weights(m, ctx.seed, ctx.device)
    widest = 0.0 if sample else float("inf")
    control = 0.0
    for r in sample:
        prompt = traffic.prompt_tokens(ctx.seed, r["index"], r["prompt_len"],
                                       m["vocab"])
        widest = max(widest, max(gpt2.served_gaps(w, m, prompt,
                                                  r["tokens"])))
        if ctx.calibrate:
            control = max(control, max(gpt2.served_gaps(
                w, m, prompt, r["tokens"], control=True)))
    record["sample"] = {"requests": len(sample),
                        "tokens": sum(len(r["tokens"]) for r in sample)}
    if ctx.calibrate:
        record["calibration"] = {"program": {"widest_gap": widest},
                                 "control": {"widest_gap": control}}
    ctx.log(f"checked {len(sample)} streams, "
            f"{record['sample']['tokens']} served tokens")
    return {"widest_gap": {"value": widest, "limit": lim["widest_gap"]},
            "wrong_length_streams": {"value": short, "limit": 0}}
