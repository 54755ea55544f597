"""Whole runs of both cells on the CPU at tiny sizes, past the harness's
look for a card: a sound run comes out correct and reads its metrics;
each fault the cell can have, planted in the program underneath, makes
``correct`` come out false.  (The cells run on one chip: there is no
exchange between chips to leave out.)"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import tiny

DRIVE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import tiny
from perfbench import harness
cell, fault, trace = sys.argv[2], sys.argv[3], sys.argv[4] == "1"
if fault == "token":        # every served token altered where it is made
    from brpc_tpu_torch.serving.lockstep import Lockstep
    inner = Lockstep.step
    def step(self, tokens, active):
        return (inner(self, tokens, active) + 1) % self.cfg.vocab
    Lockstep.step = step
elif fault == "stale":      # a decode step that leaves the cache's state
    from brpc_tpu_torch.models import decode as D
    inner = D.decode_step
    def decode_step(model, cache, tokens, active, cfg, mesh=None):
        pos = cache["pos"].clone()
        logits, cache = inner(model, cache, tokens, active, cfg, mesh)
        cache["pos"].copy_(pos)
        return logits, cache
    D.decode_step = decode_step
elif fault == "half_slots":  # half of the batch's slots left out of a step
    from brpc_tpu_torch.serving.lockstep import Lockstep
    inner = Lockstep.step
    def step(self, tokens, active):
        active = list(active)
        active[len(active) // 2:] = [False] * (len(active) - len(active) // 2)
        return inner(self, tokens, active)
    Lockstep.step = step
elif fault in ("unchanged", "half"):
    from brpc_tpu_torch.models import train
    make = train.make_train_step
    def make_faulty(cfg, mesh=None, lr=1e-3, device="cuda"):
        tx, step = make(cfg, mesh, lr, device)
        def unchanged(state, tokens):   # the state comes back as it was
            return state, train.loss_fn(state.params, tokens, cfg).detach()
        def half(state, tokens):        # the mean over half of the rows
            return step(state, tokens[: tokens.shape[0] // 2])
        return tx, {"unchanged": unchanged, "half": half}[fault]
    train.make_train_step = make_faulty
ctx = tiny.context(cell, trace=trace)
record = harness.execute(ctx)
line = harness.result_line(harness.load_benchmark(), cell, trace, record)
print(json.dumps(line))
"""


def _drive(cell, fault="none", trace=False):
    from brpc_tpu_torch import _native
    env = dict(os.environ, TRPC_CUDA_DRIVER=_native.build_fake_driver())
    r = subprocess.run([sys.executable, "-c", DRIVE, tiny.HERE, cell, fault,
                        "1" if trace else "0"], capture_output=True,
                       text=True, timeout=300, env=env, cwd=tiny.REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_chat_cell_runs_correct_on_the_cpu(trace):
    line = _drive("gpt2-large.chat", trace=trace)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    want = ({"ttft_p95_ms.serve", "itl_p95_ms.serve", "decode_step_ms",
             "batch_occupancy", "kv_route_ms_per_admit", "serve_mfu"}
            if trace else {"serve_tokens_per_s", "setup_s"})
    assert want <= set(line["metrics"]), line["metrics"]


@pytest.mark.parametrize("fault", ["token", "stale", "half_slots"])
def test_chat_cell_with_a_faulty_step_is_not_correct(fault):
    line = _drive("gpt2-large.chat", fault=fault)
    assert line["correct"] is False, line["checks"]
    checks = line["checks"]
    assert checks["widest_gap"]["value"] > checks["widest_gap"]["limit"]


@pytest.mark.parametrize("trace", [False, True])
def test_pretrain_cell_runs_correct_on_the_cpu(trace):
    line = _drive("gpt2-medium.pretrain", trace=trace)
    assert line["correct"] is True, line["checks"]
    want = ({"train_mfu"} if trace else {"train_tokens_per_s", "setup_s"})
    assert want <= set(line["metrics"]), line["metrics"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_pretrain_cell_with_a_faulty_step_is_not_correct(fault):
    line = _drive("gpt2-medium.pretrain", fault=fault)
    assert line["correct"] is False, line["checks"]
