"""The serving driver of the lfm2 family (gated short convolutions,
grouped-query attention, routed experts): ``serve``'s run on an lfm2
configuration.

What differs from ``serve``:

* the model's ``ModelConfig`` is the configuration's whole "model" group
  (``train_moe.model_config``) and its weights ``weights_lfm2``'s (f32
  from the seed; the engine holds the product weights in bf16);
* the engine's routed-expert counters (``moe_assignments``, in
  ``engine.stats()`` at the window's ends) feed ``moe_load_max.serve``,
  and inside the profiler slice each step's and each prefill's own
  counts are kept (``record["moe"]["slice_calls"]``, [call][layer]
  [expert]) for ``moe_expert_roofline.serve``;
* the host's CPU seconds over the window, of the load generator's
  process and of this one, are logged and kept (``record["host_cpu"]``),
  to tell whether the clients pace the cell;
* ``correct`` scores 16 finished streams teacher-forced through the
  plain reference (``reference/lfm2_served.py``, one sequence at a
  time, after the program's state is freed) and holds two means of
  their gaps, over every served token (``mean_gap``) and over the
  tokens whose step reads the installed conv state (``handoff_gap``);
  it compares the engine's dropped assignments (``dropped_assignments``,
  limit 0) too.

A program that cannot serve the family fails at the first step, before
any build.
"""

from __future__ import annotations

import os
import time
from typing import Dict

from perfbench import harness, traffic
from perfbench.drivers import serve
from perfbench.drivers.train_moe import model_config
from perfbench.profiling import Patches
from perfbench.weights_lfm2 import make_weights


def _grown(a, b):
    return [[y - x for x, y in zip(ra, rb)] for ra, rb in zip(a, b)]


def _cpu_s(pid=None) -> float:
    """User + system CPU seconds of process `pid` (this one if None)."""
    if pid is None:
        t = os.times()
        return t.user + t.system
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def run(ctx) -> Dict:
    from brpc_tpu_torch.models import decode as D
    cfg = model_config(ctx.config["model"])
    D.init_cache(cfg, 1, 1, "meta")
    slice_calls, cpu = [], {}
    serve_instrument = serve._instrument
    start_clients, wait_full = serve._start_clients, serve._wait_full
    stop_clients = serve._stop_clients

    def instrument(engine, mix, patches, spans, rec):
        """serve's, and each step's and prefill's counts in the slice."""
        serve_instrument(engine, mix, patches, spans, rec)
        last = {}

        def counted(fn):
            def wrapper(*args, **kwargs):
                if not rec["slicing"]:
                    return fn(*args, **kwargs)
                before = last.get("counts") or \
                    engine.params.stats()["moe_assignments"]
                out = fn(*args, **kwargs)
                last["counts"] = engine.params.stats()["moe_assignments"]
                slice_calls.append(_grown(before, last["counts"]))
                return out
            return wrapper
        for name in ("step", "prefill"):
            patches.set(engine.dev, name, counted(getattr(engine.dev, name)))

    def clients(*args):
        child = start_clients(*args)
        cpu["pid"] = child.pid
        return child

    def full(engine, n_full):
        wait_full(engine, n_full)
        cpu["t0"] = (time.monotonic(), _cpu_s(cpu["pid"]), _cpu_s())

    def stop(child):
        cpu["t1"] = (time.monotonic(), _cpu_s(cpu["pid"]), _cpu_s())
        stop_clients(child)

    def judge(ctx, requests, t1, record):
        (a, la, ea), (b, lb, eb) = cpu["t0"], cpu["t1"]
        record["host_cpu"] = {"wall_s": b - a, "loadgen_cpu_s": lb - la,
                              "engine_cpu_s": eb - ea}
        ctx.log(f"host CPU over the window: {record['host_cpu']}")
        record["moe"] = {"slice_calls": slice_calls}
        return _judge(ctx, requests, t1, record)

    patches = Patches()
    patches.set(harness, "model_config", model_config)
    for name, fn in (("make_weights", make_weights),
                     ("_instrument", instrument), ("_start_clients", clients),
                     ("_wait_full", full), ("_stop_clients", stop),
                     ("_judge", judge)):
        patches.set(serve, name, fn)
    try:
        return serve.run(ctx)
    finally:
        patches.undo()


def _judge(ctx, requests, t1, record) -> Dict:
    """The gaps of ``serve._judge``'s sample through the lfm2 reference,
    one stream at a time, held as two means
    (``lfm2_served.gap_numbers``), and the engine's dropped assignments."""
    from perfbench.reference import lfm2_served
    m, mix, lim = ctx.config["model"], ctx.mix, ctx.limits
    finished = [r for r in requests if r["end"] == "eof"
                and r["stamps"] and r["stamps"][-1] <= t1]
    sound = [r for r in finished
             if len(r["tokens"]) == r["max_new_tokens"]
             and all(0 <= t < m["vocab"] for t in r["tokens"])]
    short = len(finished) - len(sound)
    sample = traffic.check_sample(ctx.seed, sound, mix["check_requests"])
    w = make_weights(m, ctx.seed, ctx.device)
    gaps, control = [], []
    for r in sample:
        prompt = traffic.prompt_tokens(ctx.seed, r["index"], r["prompt_len"],
                                       m["vocab"])
        gaps.append(lfm2_served.served_gaps(w, m, prompt, r["tokens"]))
        if ctx.calibrate:
            control.append(lfm2_served.served_gaps(w, m, prompt, r["tokens"],
                                                   control=True))
    del w
    nums = lfm2_served.gap_numbers(gaps, m["conv_width"])
    record["sample"] = {"requests": len(sample),
                        "tokens": sum(len(r["tokens"]) for r in sample)}
    if ctx.calibrate:
        record["calibration"] = {
            "program": nums,
            "control": lfm2_served.gap_numbers(control, m["conv_width"])}
    ctx.log(f"checked {len(sample)} streams, "
            f"{record['sample']['tokens']} served tokens")
    dropped = record["stats1"].get("moe_dropped", float("inf"))
    checks = {n: {"value": v, "limit": lim[n]} for n, v in nums.items()}
    return {**checks,
            "wrong_length_streams": {"value": short, "limit": 0},
            "dropped_assignments": {"value": float(dropped), "limit": 0.0}}
