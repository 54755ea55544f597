"""The lfm2 pretraining cell and the docqa serving cell: the ``train_moe``
driver on a tiny lfm2 model on the port's CPU path (sound, and with a
planted fault), the three MoE readers on hand-made records, the
configuration file against its own model group, and the docqa mix,
limits and ``serve_short`` ramp."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import tiny
from perfbench import harness

BENCH = harness.load_benchmark()
DOCQA = "gpt2-large.docqa"
MODEL = dict(family="lfm2", vocab=128, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=4, layer_kinds=["conv", "conv", "attn", "conv"],
             n_dense_layers=1, d_ff=96, d_expert=32, n_experts=8,
             experts_held=4, expert_first=0, moe_topk=2, routed_scale=1.0,
             norm_eps=1e-5, rope_theta=1e6, conv_width=3,
             max_seq=32, dtype="float32", param_dtype="float32")

DRIVE = r"""
import copy, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import tiny
from perfbench import harness
fault, trace, model = sys.argv[2], sys.argv[3] == "1", json.loads(sys.argv[4])
if fault == "half":             # the mean over half of each batch's rows
    from brpc_tpu_torch.models import train
    make = train.make_train_step
    def make_faulty(cfg, mesh=None, lr=1e-3, device="cuda"):
        tx, step = make(cfg, mesh, lr, device)
        return tx, lambda state, tokens: step(state,
                                              tokens[: tokens.shape[0] // 2])
    train.make_train_step = make_faulty
cell = "lfm2-8b-a1b.pretrain8k"
found = copy.deepcopy(harness.find_cell(harness.load_benchmark(), cell))
found["config"]["model"] = model
found["mix"].update(batch=4, seq=17, checked_steps=3, ref_rows=2,
                    trace_steps=2)
ctx = harness.Context(found, 7, 2.0, trace, torch.device("cpu"),
                      time.monotonic(), log=lambda msg: None)
record = harness.execute(ctx)
print(json.dumps(harness.result_line(harness.load_benchmark(), cell, trace,
                                     record)))
"""


def _drive(fault="none", trace=False):
    r = subprocess.run([sys.executable, "-c", DRIVE, tiny.HERE, fault,
                        "1" if trace else "0", json.dumps(MODEL)],
                       capture_output=True, text=True, timeout=300,
                       cwd=tiny.REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_the_lfm2_cell_runs_correct_on_the_cpu(trace):
    line = _drive(trace=trace)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["checks"]["dropped_assignments"]["value"] == 0
    want = ({"train_mfu.moe", "moe_load_max.train"} if trace
            else {"train_tokens_per_s", "setup_s"})
    assert want <= set(line["metrics"]), line["metrics"]
    # the CPU slice records no device operation: no kernel to read
    assert "moe_expert_roofline.train" not in line["metrics"]


def test_the_lfm2_cell_with_half_a_batch_is_not_correct():
    line = _drive(fault="half")
    assert line["correct"] is False, line["checks"]


def _reader(name):
    return harness.reader(name).read


def _record(**over):
    m = json.load(open(os.path.join(
        tiny.REPO, "perfbench/configs/lfm2-8b-a1b.json")))["model"]
    rec = {"model": m, "batch": 3, "seq": 8193, "steps": 10,
           "window_s": 5.0, "trace_steps": 2,
           "moe": {"window": {"assignments": [[3072] * 8] * 10,
                              "dropped": 0}}}
    rec.update(over)
    return rec


def test_train_mfu_moe_reads_the_window_and_none_without_counters():
    from perfbench import roofline_moe
    read = _reader("train_mfu.moe")
    rec = _record()
    flops = 10 * roofline_moe.train_step_flops(rec["model"], 3, 8192,
                                               3072 * 8 * 10 / 10)
    assert read(rec) == pytest.approx(100 * flops / 5.0 / 989e12)
    assert 0 < read(rec) < 100
    assert read({"steps": 1}) is None
    assert read(_record(moe={})) is None
    assert read(_record(moe={"window": {"assignments": [],
                                        "dropped": 0}})) is None


def test_load_max_is_the_worst_layers_peak_over_its_mean():
    read = _reader("moe_load_max.train")
    rec = _record()
    assert read(rec) == pytest.approx(1.0)
    rec["moe"]["window"]["assignments"] = [[1, 1, 1, 1], [4, 0, 0, 0]]
    assert read(rec) == pytest.approx(4.0)
    rec["moe"]["window"]["assignments"] = [[0, 0], [0, 0]]
    assert read(rec) is None
    assert read({}) is None


def test_expert_roofline_reads_the_grouped_kernels_of_the_slice():
    from perfbench import roofline_moe
    read = _reader("moe_expert_roofline.train")
    sl = {"assignments": [[3072] * 8] * 10, "dropped": 0}
    name = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_"
            "for_sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShape")
    prof = {"intervals": [[name, 0.0, 40000.0], ["nvjet_gemm", 0.0, 9e9]]}
    rec = _record(profile=prof)
    rec["moe"]["slice"] = sl
    bound = roofline_moe.expert_products_bound_s(rec["model"],
                                                 sl["assignments"], 2)
    assert read(rec) == pytest.approx(100 * bound / 0.04)
    assert bound == pytest.approx(10 * 9 * 2 * max(
        2 * 12288 * 2048 * 1792 / 989e12,
        2 * (8 * 2048 * 1792 + 12288 * (2048 + 1792)) / 3.35e12))
    assert read(_record(profile=prof)) is None             # no counters
    rec["profile"] = {"intervals": [["nvjet_gemm", 0.0, 1.0]]}
    assert read(rec) is None                               # no kernel
    rec.pop("profile")
    assert read(rec) is None                               # no slice


def test_the_training_attention_and_idle_readers_read_the_lfm2_record():
    """causal_attention_roofline.train and device_idle_share.train, listed
    for this cell too, read its record: the causal kernels' bounds at B 3,
    S 8192 and 32 heads of 64 in bf16, the slice's idle share."""
    from perfbench import roofline
    roof = _reader("causal_attention_roofline.train")
    idle = _reader("device_idle_share.train")
    prof = {"intervals": [["void causal_fwd_sm90<64>(CUtensorMap_st)", 0.0,
                           1000.0],
                          ["void causal_dq_sm90<64>(CUtensorMap_st)", 1000.0,
                           3000.0],
                          ["nvjet_gemm", 0.0, 9e9]],
            "busy_s": 1.0, "window_s": 1.25}
    rec = _record(profile=prof)
    bounds = roofline.attention_bounds(3, 8192, 32, 64,
                                       *roofline.PRODUCTS["bfloat16"])
    assert roof(rec) == pytest.approx(
        100 * (bounds["fwd"][0] + bounds["bwd_dq"][0]) / 3.0)
    assert idle(rec) == pytest.approx(20.0)
    assert roof(_record()) is None and idle(_record()) is None


def test_the_configuration_states_its_cut():
    cfg = json.load(open(os.path.join(tiny.REPO,
                                      "perfbench/configs/lfm2-8b-a1b.json")))
    entry = {c["name"]: c for c in BENCH["configs"]}["lfm2-8b-a1b"]
    assert cfg["reduced"] == entry["reduced"]
    for key in cfg["reduced"]:
        assert cfg[key] != cfg["published"][key]
    m = cfg["model"]
    kinds = {"conv": "conv", "full_attention": "attn"}
    assert m["layer_kinds"] == [kinds[k] for k in
                                cfg["layer_types"][:cfg["num_hidden_layers"]]]
    assert (m["d_model"], m["d_ff"], m["d_expert"], m["vocab"]) == (
        cfg["hidden_size"], cfg["intermediate_size"],
        cfg["moe_intermediate_size"], cfg["vocab_size"])
    assert (m["n_heads"], m["n_kv_heads"], m["moe_topk"]) == (
        cfg["num_attention_heads"], cfg["num_key_value_heads"],
        cfg["num_experts_per_tok"])
    assert m["experts_held"] == cfg["num_experts"]
    assert m["n_experts"] == cfg["published"]["num_experts"]
    assert m["n_dense_layers"] == cfg["num_dense_layers"]
    assert m["conv_width"] == cfg["conv_L_cache"]


def test_docqa_mix_and_limits_are_found_and_loaded():
    found = harness.find_cell(BENCH, DOCQA)
    mix = found["mix"]
    assert found["config"]["name"] == "gpt2-large"
    assert mix["driver"] == "serve_short" and mix["clients"] == 48
    assert mix["prompt_len"] == {"dist": "uniform", "min": 640, "max": 960}
    assert mix["output_len"] == {"dist": "uniform", "min": 16, "max": 64}
    assert mix["max_total"] == 1024 and mix["check_requests"] == 16
    assert set(found["limits"]) == {"widest_gap"}
    from perfbench import traffic
    reqs = traffic.serve_requests(mix)
    assert all(640 <= r["prompt_len"] <= 960 and
               16 <= r["max_new_tokens"] <= 64 for r in reqs)
    names = [m["name"] for m in harness.metrics_of(BENCH, DOCQA, False)]
    assert names == ["serve_tokens_per_s", "setup_s"]


class _Engine:
    """stats() of an engine whose admits grow and whose running batch
    never reaches the clients."""

    def __init__(self):
        self.admitted = 0

    def stats(self):
        self.admitted += 1
        return {"admitted": self.admitted, "running": 40}


def test_serve_short_ends_the_ramp_on_admits_and_restores_serve(monkeypatch):
    from perfbench.drivers import serve, serve_short
    monkeypatch.setattr(serve, "POLL_S", 0.0)
    seen = {}

    def fake_run(ctx):
        engine = _Engine()
        serve._wait_full(engine, 48)
        seen["admitted"] = engine.admitted
        return {"ok": True}
    monkeypatch.setattr(serve, "run", fake_run)
    original = serve._wait_full
    assert serve_short.run(None) == {"ok": True}
    assert seen["admitted"] == 48
    assert serve._wait_full is original
