"""The training driver: the port's ``train.make_train_step`` on fresh
random token batches, back to back with no per-step sync.

Set-up builds one state (the model from the seed's weights and its
AdamW) and drives it through the mix's ``checked_steps`` through the
window's own call and feed; their losses, the first gradient (from the
optimizer's first moment after one step) and each leaf's change are
kept for the check.  The window then takes steps until ``seconds`` have
passed and ends in ``torch.cuda.synchronize()``.  With a trace one
profiler slice right after the window covers the mix's ``trace_steps``
further steps.
Afterwards the state is freed and the plain reference follows the
checked steps from the same weights and batches.
"""

from __future__ import annotations

import gc
import json
import math
import time
from typing import Dict, List

from perfbench import harness
from perfbench.profiling import Slice, summarize
from perfbench.weights import make_weights, token_generator

GRAD_FLOOR = 1e-3   # a leaf whose reference gradient norm is under this
#                     share of the median leaf's moves by round-off alone


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> Dict:
    import torch
    from brpc_tpu_torch import _native
    from brpc_tpu_torch.models import train
    from brpc_tpu_torch.models import transformer as T

    m, mix, dev = ctx.config["model"], ctx.mix, ctx.device
    if dev.type == "cuda":
        _native.build_kernels()
    cfg = harness.model_config(m)
    model = T.TransformerLM(cfg, device="meta")
    model.load_state_dict(make_weights(m, ctx.seed, dev), assign=True)
    tx, step = train.make_train_step(cfg, lr=mix["lr"], device=dev)
    state = train.TrainState(model, tx(model),
                             torch.zeros((), dtype=torch.int32))
    gen = token_generator(ctx.seed, dev)
    B, S1 = mix["batch"], mix["seq"]

    def feed():
        return torch.randint(0, m["vocab"], (B, S1), generator=gen,
                             device=dev)

    # the checked steps, through the window's own call and feed
    names = {id(p): n for n, p in model.named_parameters()}
    losses, grad1 = [], {}
    for t in range(mix["checked_steps"]):
        state, loss = step(state, feed())
        losses.append(loss)
        if t == 0:
            opt = state.opt_state
            b1 = opt.param_groups[0]["betas"][0]
            # a parameter the step left out has no first moment; norms on
            # the device (the host's f32 norm of 1e8 values loses 2%), the
            # first gradient itself to the host for the reference's check
            g1 = {names[id(p)]: (opt.state[p]["exp_avg"] / (1 - b1)
                                 if "exp_avg" in opt.state.get(p, {})
                                 else torch.zeros_like(p))
                  for p in model.parameters()}
            grad1 = {n: g.norm() for n, g in g1.items()}
            vecs = {n: g.to("cpu") for n, g in g1.items()}
            del g1
    start = make_weights(m, ctx.seed, dev)
    change = {n: (p.detach() - start[n]).norm()
              for n, p in model.named_parameters()}
    del start
    program = {"losses": [float(x) for x in losses],
               "grad1": {n: float(v) for n, v in grad1.items()},
               "change": {n: float(v) for n, v in change.items()},
               "grad1_vec": vecs}
    mem = harness.memory_used(dev)

    # the window
    t0 = time.monotonic()
    setup_s = t0 - ctx.t_start
    t_end, steps, window_losses, prof = t0 + ctx.seconds, 0, [], None
    while time.monotonic() < t_end:
        state, loss = step(state, feed())
        window_losses.append(loss)
        steps += 1
    _sync(dev)
    t1 = time.monotonic()
    mem = max(mem, harness.memory_used(dev))
    if ctx.trace:
        # right after the window, on the same state: the profiler's own
        # cost stays out of the window's rate
        with Slice(dev) as prof:
            for _ in range(mix["trace_steps"]):
                state, loss = step(state, feed())
                window_losses.append(loss)
        if prof.closed is not None:     # the slice's pace beside the window's
            ms = (prof.closed - prof.anchor) / mix["trace_steps"] * 1e3
            ctx.log(f"a step: {ms:.2f} ms in the slice, "
                    f"{(t1 - t0) / max(steps, 1) * 1e3:.2f} ms in the window")
    bad = int((~torch.isfinite(torch.stack(window_losses))).sum()) \
        if window_losses else 0
    del state, model, tx, step, window_losses, losses, grad1, change, loss
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    record = {
        "setup_s": setup_s, "t0": t0, "t1": t1, "window_s": t1 - t0,
        "steps": steps, "batch": B, "seq": S1, "model": m,
        "attempted": steps, "failed": bad,
        "device": harness.device_info(dev, mem)}
    summary = summarize(prof) if prof is not None else None
    if summary is not None:
        record["profile"] = summary
        record["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        record["breakdown"] = summary["breakdown"]
    record["checks"] = _judge(ctx, program, record)
    print(json.dumps({"reference": record["reference"]}), flush=True)
    return record


def reference_batches(ctx) -> List:
    """The checked steps' batches, drawn again from the seed."""
    import torch
    m, mix = ctx.config["model"], ctx.mix
    gen = token_generator(ctx.seed, ctx.device)
    return [torch.randint(0, m["vocab"], (mix["batch"], mix["seq"]),
                          generator=gen, device=ctx.device)
            for _ in range(mix["checked_steps"])]


def reference(ctx, **kw) -> Dict:
    """The plain reference's checked steps from the seed's weights."""
    from perfbench.reference import gpt2
    m = ctx.config["model"]
    return gpt2.train_steps(make_weights(m, ctx.seed, ctx.device),
                            reference_batches(ctx), m, ctx.mix,
                            rows=ctx.mix["ref_rows"], **kw)


def gaps(got: Dict, ref: Dict, diff: Dict[str, float]) -> Dict[str, float]:
    """The numbers compared: the worst step's relative loss gap, and by
    the worst leaf the gap between the two sides' norms of the first
    gradient and of the change, and the norm of the two first gradients'
    difference (`diff`, by leaf), each over the reference's norm of that
    leaf or of the median leaf, whichever is larger.  Leaves whose
    reference gradient is under GRAD_FLOOR of the median leaf's are left
    out.  The norm gaps are blind to unbiased rounding noise, which
    averages out over millions of elements and the batch's tokens;
    ``grad_diff`` sees it (PERF.md, the pretrain cell's limits)."""
    loss = _worst(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                      ref["losses"]))
    g_med = _median(ref["grad1"].values())
    held = [n for n, g in ref["grad1"].items() if g >= GRAD_FLOOR * g_med]
    out = {"loss_gap": loss}
    for key, name in (("grad1", "grad_gap"), ("change", "change_gap")):
        med = _median(ref[key][n] for n in held)
        out[name] = _worst(abs(got[key][n] - ref[key][n])
                           / max(ref[key][n], med) for n in held)
    med = _median(ref["grad1"][n] for n in held)
    out["grad_diff"] = _worst(diff[n] / max(ref["grad1"][n], med)
                              for n in held)
    return out


def _worst(xs) -> float:
    """The largest reading; infinite where one is not a number."""
    xs = list(xs)
    return max(xs) if all(math.isfinite(x) for x in xs) else float("inf")


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    return (xs[n // 2] + xs[(n - 1) // 2]) / 2


def _judge(ctx, program: Dict, record: Dict) -> Dict:
    ref = reference(ctx, against=program.pop("grad1_vec"),
                    keep_grad1=ctx.calibrate)
    got = gaps(program, ref, ref["grad1_diff"])
    record["reference"] = {"losses": ref["losses"],
                           "program_losses": program["losses"]}
    if ctx.calibrate:
        vecs = ref.pop("grad1_vec")
        fp8 = reference(ctx, fp8=True, against=vecs)
        half = reference(ctx, keep_rows=ctx.mix["batch"] // 2, against=vecs)
        sides = (("program", program), ("reference", ref), ("control", fp8),
                 ("half_batch", half))
        record["calibration"] = {
            "program": got, "control": gaps(fp8, ref, fp8["grad1_diff"]),
            "half_batch": gaps(half, ref, half["grad1_diff"]),
            "leaves": {side: {k: r[k] for k in ("losses", "grad1", "change",
                                                "grad1_diff") if k in r}
                       for side, r in sides}}
    # the numbers the limits file holds are compared; loss_gap is read and
    # printed but has no limit (PERF.md: no reading above it separates)
    record["reference"]["loss_gap"] = got["loss_gap"]
    lim = ctx.limits
    return {k: {"value": v, "limit": lim[k]} for k, v in got.items()
            if k in lim}
