"""The training driver of the routed-MoE configurations (the lfm2 block
family): the port's ``train.make_train_step`` on fresh random token
batches, back to back with no per-step sync, as ``train``'s.

What differs from ``train``: the model's ``ModelConfig`` is the
configuration's whole "model" group; the weights are
``weights_lfm2``'s; the plain reference is ``reference/lfm2_moe.py``;
and the held experts' assignment counters (``model.stats()``, summed on
the device) are read at the window's ends and at the profiler slice's,
into ``record["moe"]``.  The checked steps, the window, the slice and
the numbers compared (``train.gaps``) are ``train``'s.
"""

from __future__ import annotations

import gc
import json
import time
from typing import Dict

from perfbench import harness
from perfbench.drivers.train import _sync, gaps, reference_batches
from perfbench.profiling import Slice, summarize
from perfbench.weights import token_generator
from perfbench.weights_lfm2 import make_weights


def model_config(m: Dict):
    """The port's ModelConfig of an lfm2 configuration's "model" group
    (a parent without the family fails here, before any build)."""
    import torch
    from brpc_tpu_torch.models.transformer import ModelConfig
    keys = ("vocab", "d_model", "n_heads", "n_layers", "d_ff", "max_seq",
            "n_experts", "moe_topk", "family", "n_kv_heads",
            "n_dense_layers", "d_expert", "experts_held", "expert_first",
            "routed_scale", "norm_eps", "rope_theta", "conv_width")
    return ModelConfig(layer_kinds=tuple(m["layer_kinds"]),
                       dtype=getattr(torch, m["dtype"]),
                       **{k: m[k] for k in keys})


def _diff(a: Dict, b: Dict) -> Dict:
    """The counters' growth from `a` to `b`."""
    return {"assignments": [[y - x for x, y in zip(ra, rb)] for ra, rb in
                            zip(a["moe_assignments"],
                                b["moe_assignments"])],
            "dropped": b["moe_dropped"] - a["moe_dropped"]}


def run(ctx) -> Dict:
    import torch
    from brpc_tpu_torch import _native
    from brpc_tpu_torch.models import train
    from brpc_tpu_torch.models import transformer as T

    m, mix, dev = ctx.config["model"], ctx.mix, ctx.device
    cfg = model_config(m)
    if dev.type == "cuda":
        _native.build_kernels()
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
    losses = []
    for t in range(mix["checked_steps"]):
        state, loss = step(state, feed())
        losses.append(loss)
        if t == 0:
            opt = state.opt_state
            b1 = opt.param_groups[0]["betas"][0]
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

    # the window, with the counters read at its ends (each read waits for
    # the device, outside the window)
    c0 = model.stats()
    t0 = time.monotonic()
    setup_s = t0 - ctx.t_start
    t_end, steps, window_losses, prof = t0 + ctx.seconds, 0, [], None
    while time.monotonic() < t_end:
        state, loss = step(state, feed())
        window_losses.append(loss)
        steps += 1
    _sync(dev)
    t1 = time.monotonic()
    c1 = model.stats()
    mem = max(mem, harness.memory_used(dev))
    moe = {"window": _diff(c0, c1), "held": cfg.held,
           "total_dropped": c1["moe_dropped"]}
    if ctx.trace:
        with Slice(dev) as prof:
            for _ in range(mix["trace_steps"]):
                state, loss = step(state, feed())
                window_losses.append(loss)
        moe["slice"] = _diff(c1, model.stats())
        if prof.closed is not None:
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
        "steps": steps, "batch": B, "seq": S1, "model": m, "moe": moe,
        "trace_steps": mix["trace_steps"],
        "attempted": steps, "failed": bad,
        "device": harness.device_info(dev, mem)}
    summary = summarize(prof) if prof is not None else None
    if summary is not None:
        record["profile"] = summary
        record["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        record["breakdown"] = summary["breakdown"]
    record["checks"] = _judge(ctx, program, record)
    print(json.dumps({"reference": record["reference"],
                      "moe_window": moe["window"]}), flush=True)
    return record


def reference(ctx, **kw) -> Dict:
    """The plain reference's checked steps from the seed's weights."""
    from perfbench.reference import lfm2_moe
    m = ctx.config["model"]
    return lfm2_moe.train_steps(make_weights(m, ctx.seed, ctx.device),
                                reference_batches(ctx), m, ctx.mix,
                                rows=ctx.mix["ref_rows"], **kw)


def _judge(ctx, program: Dict, record: Dict) -> Dict:
    """``train``'s numbers against this reference; a dropped assignment
    (the layer is dropless) is compared too."""
    ref = reference(ctx, against=program.pop("grad1_vec"),
                    keep_grad1=ctx.calibrate)
    got = gaps(program, ref, ref["grad1_diff"])
    record["reference"] = {"losses": ref["losses"],
                           "program_losses": program["losses"],
                           "loss_gap": got["loss_gap"]}
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
    lim = ctx.limits
    out = {k: {"value": v, "limit": lim[k]} for k, v in got.items()
           if k in lim}
    out["dropped_assignments"] = {
        "value": float(record["moe"]["total_dropped"]), "limit": 0.0}
    return out
