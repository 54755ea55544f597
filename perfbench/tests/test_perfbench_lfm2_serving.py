"""The lfm2 serving cell (``lfm2-8b-a1b-full.longchat``): its configuration
against the published config.json's keys, its mix, its three readers on
hand-made records, the serving roofline's FLOPs and bytes by hand at one
shape, and the ``serve_lfm2`` driver at a tiny size on the port's CPU
path (sound, and with a conv state left stale on install, a planted
fault)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import tiny
from perfbench import harness, roofline_moe_serve, traffic

BENCH = harness.load_benchmark()
CELL = "lfm2-8b-a1b-full.longchat"
# the cell's vocabulary, so that a served token's gap has the cell's range
# (a logit's best over 65,536 rows, about 4.3; over 128 it is about 2.5)
MODEL = dict(family="lfm2", vocab=65536, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=4, layer_kinds=["conv", "conv", "attn", "conv"],
             n_dense_layers=1, d_ff=96, d_expert=32, n_experts=8,
             experts_held=8, expert_first=0, moe_topk=2, routed_scale=1.0,
             norm_eps=1e-5, rope_theta=1e6, conv_width=3,
             max_seq=64, dtype="float32", param_dtype="float32")
ENGINE = {"n_slots": 4, "max_len": 64, "max_waiting": 6,
          "kv_block_tokens": 16, "kv_block_bytes": 4096, "kv_blocks": 64}
MIX = {"pool": 1024, "clients": 6, "max_total": 64, "check_requests": 12,
       "trace_steps": 4, "trace_admits": 1,
       "prompt_len": {"dist": "lognormal", "median": 8, "sigma": 0.6,
                      "min": 1, "max": 24},
       "output_len": {"dist": "lognormal", "median": 8, "sigma": 0.5,
                      "min": 4, "max": 24}}
# LFM2-8B-A1B's published config.json (huggingface.co/LiquidAI/LFM2-8B-A1B)
PUBLISHED = {
    "conv_L_cache": 3, "conv_bias": False, "hidden_size": 2048,
    "intermediate_size": 7168, "max_position_embeddings": 128000,
    "model_type": "lfm2_moe", "moe_intermediate_size": 1792,
    "norm_eps": 1e-05, "norm_topk_prob": True, "num_attention_heads": 32,
    "num_dense_layers": 2, "num_experts": 32, "num_experts_per_tok": 4,
    "num_hidden_layers": 24, "num_key_value_heads": 8, "rope_theta": 1000000,
    "routed_scaling_factor": 1, "use_expert_bias": True, "vocab_size": 65536}
ATTN = (2, 6, 10, 14, 18, 21)

DRIVE = r"""
import copy, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import tiny
from perfbench import harness
fault, trace = sys.argv[2], sys.argv[3] == "1"
model, engine, mix = (json.loads(a) for a in sys.argv[4:7])
if fault == "stale":      # install leaves the slot's last conv state
    from brpc_tpu_torch.models import decode as D
    inner = D.install
    def install(cache, slot, k, v, length, mesh=None, conv=None):
        kept = cache["conv"][:, slot].clone()
        inner(cache, slot, k, v, length, mesh, conv)
        cache["conv"][:, slot].copy_(kept)
        return cache
    D.install = install
cell = "lfm2-8b-a1b-full.longchat"
found = copy.deepcopy(harness.find_cell(harness.load_benchmark(), cell))
found["config"]["model"], found["config"]["engine"] = model, engine
found["mix"].update(mix)
ctx = harness.Context(found, 7, 2.0, trace, torch.device("cpu"),
                      time.monotonic(), log=lambda msg: None)
record = harness.execute(ctx)
print(json.dumps(harness.result_line(harness.load_benchmark(), cell, trace,
                                     record)))
"""


def _drive(fault="none", trace=False):
    from brpc_tpu_torch import _native
    env = dict(os.environ, TRPC_CUDA_DRIVER=_native.build_fake_driver())
    r = subprocess.run([sys.executable, "-c", DRIVE, tiny.HERE, fault,
                        "1" if trace else "0", json.dumps(MODEL),
                        json.dumps(ENGINE), json.dumps(MIX)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=tiny.REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_on_the_cpu(trace):
    line = _drive(trace=trace)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"mean_gap", "handoff_gap",
                                   "wrong_length_streams",
                                   "dropped_assignments"}
    want = ({"ttft_p95_ms.serve", "itl_p95_ms.serve", "decode_graph_share",
             "prefill_graph_share", "moe_load_max.serve"} if trace
            else {"serve_tokens_per_s", "setup_s"})
    assert want <= set(line["metrics"]), line["metrics"]
    if trace:       # the CPU runs no graph and its slice no kernel
        assert line["metrics"]["decode_graph_share"]["value"] == 0
        assert "moe_expert_roofline.serve" not in line["metrics"]


def test_a_stale_conv_state_on_install_is_not_correct():
    line = _drive(fault="stale")
    assert line["correct"] is False, line["checks"]
    c = line["checks"]["handoff_gap"]
    assert c["value"] > c["limit"]


def test_the_gap_numbers_by_hand():
    from perfbench.reference import lfm2_served
    got = lfm2_served.gap_numbers([[0.0, 1.0, 2.0, 3.0], [4.0, 0.0, 5.0]], 3)
    assert got == {"mean_gap": 15.0 / 7, "handoff_gap": 8.0 / 4}
    assert lfm2_served.gap_numbers([], 3) == {"mean_gap": float("inf"),
                                              "handoff_gap": float("inf")}


def test_the_control_takes_an_expert_with_no_row():
    """The fp8 control routes a sequence of one token to 4 of 8 experts:
    the others' operands are empty, and the reference's ``fp8_round``
    stays as it was after the call."""
    import torch
    from perfbench.reference import gpt2, lfm2_moe, lfm2_served
    from perfbench.weights_lfm2 import make_weights
    m = dict(MODEL, vocab=256)
    w = make_weights(m, 3, torch.device("cpu"))
    gaps = lfm2_served.served_gaps(w, m, [5], [7], control=True)
    assert len(gaps) == 1 and gaps[0] >= 0
    assert lfm2_moe.fp8_round is gpt2.fp8_round


def test_the_configuration_is_the_published_model_whole():
    found = harness.find_cell(BENCH, CELL)
    cfg, entry = found["config"], {c["name"]: c
                                   for c in BENCH["configs"]}[
        "lfm2-8b-a1b-full"]
    assert cfg["reduced"] == entry["reduced"] == []
    for key, value in PUBLISHED.items():
        assert cfg[key] == value, key
    assert [i for i, t in enumerate(cfg["layer_types"])
            if t == "full_attention"] == list(ATTN)
    m = cfg["model"]
    kinds = {"conv": "conv", "full_attention": "attn"}
    assert m["layer_kinds"] == [kinds[t] for t in cfg["layer_types"]]
    assert (m["n_layers"], m["d_model"], m["d_ff"], m["d_expert"],
            m["vocab"], m["n_heads"], m["n_kv_heads"], m["moe_topk"],
            m["n_dense_layers"], m["conv_width"]) == (
        24, 2048, 7168, 1792, 65536, 32, 8, 4, 2, 3)
    assert m["n_experts"] == m["experts_held"] == 32
    assert m["expert_first"] == 0 and m["dtype"] == "bfloat16"
    e = cfg["engine"]
    # a 16-token block of the f32 wire: 2 x 6 layers x 8 heads x 64 x 4 B
    assert e["kv_block_bytes"] == 16 * 2 * 6 * 8 * 64 * 4 == 393216
    # every slot's longest sequence and its conv state block
    assert e["kv_blocks"] == e["n_slots"] * (e["max_len"] // 16 + 1)
    assert (e["n_slots"], e["max_len"]) == (128, 8192)


def test_the_mix_is_the_cells_traffic():
    mix = harness.find_cell(BENCH, CELL)["mix"]
    assert mix["driver"] == "serve_lfm2" and mix["clients"] == 160
    assert mix["prompt_len"] == {"dist": "lognormal", "median": 2048,
                                 "sigma": 0.5, "min": 512, "max": 6144}
    assert mix["output_len"] == {"dist": "lognormal", "median": 384,
                                 "sigma": 0.5, "min": 128, "max": 1536}
    assert mix["max_total"] == 8192 and mix["check_requests"] == 16
    reqs = traffic.serve_requests(mix)
    assert all(512 <= r["prompt_len"] <= 6144
               and 128 <= r["max_new_tokens"] <= 1536 for r in reqs)
    names = [m["name"] for m in harness.metrics_of(BENCH, CELL, False)]
    assert names == ["serve_tokens_per_s", "setup_s"]


def _reader(name):
    return harness.reader(name).read


def _model():
    return harness.find_cell(BENCH, CELL)["config"]["model"]


def test_the_expert_product_by_hand():
    """One grouped product at 3 experts of 32 holding 5, 0 and 11 rows:
    2 x 16 x 2048 x 1792 FLOPs; two experts' weights (bf16) and 16 rows
    in and out; the bytes bound it."""
    m, counts = _model(), [5, 0, 11] + [0] * 29
    assert roofline_moe_serve.expert_product_flops(m, counts) == \
        2 * 16 * 2048 * 1792
    assert roofline_moe_serve.expert_product_bytes(m, counts) == \
        2 * (2 * 2048 * 1792 + 16 * (2048 + 1792))
    assert roofline_moe_serve.expert_product_bound_s(m, counts) == \
        pytest.approx(2 * (2 * 2048 * 1792 + 16 * 3840) / 3.35e12)
    big = [4096] * 32        # a prefill's rows: the FLOPs bound it
    assert roofline_moe_serve.expert_product_bound_s(m, big) == \
        pytest.approx(2 * 4096 * 32 * 2048 * 1792 / 989e12)
    calls = [[counts, big], [big]]
    assert roofline_moe_serve.expert_launches_bound_s(m, calls) == \
        pytest.approx(3 * (roofline_moe_serve.expert_product_bound_s(
            m, counts) + 2 * roofline_moe_serve.expert_product_bound_s(
                m, big)))


def test_the_gqa_decode_bound_by_hand():
    """N 2 slots, 32 query heads over 8 KV heads of 64, bf16, windows of
    10 and 1: the cache's bytes at 8 heads."""
    ms, what = roofline_moe_serve.decode_attention_gqa_bound(
        2, 32, 8, 64, [9, 0], 2)
    nbytes = (2 * 32 * 64 * 2 + 2 * 2 * 8 * 64 * 2 + 2 * 11 * 8 * 64 * 2
              + 4 * 2 + 2 * 32 * 64 * 2 + 2 * 2 * 8 * 64 * 2)
    assert what == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


GROUPED = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_"
           "for_sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShape")


def test_expert_roofline_reads_the_slices_calls():
    read = _reader("moe_expert_roofline.serve")
    m = _model()
    calls = [[[16] * 32] * 22, [[300] * 32] * 22]
    launches = 3 * 22 * 2
    prof = {"intervals": [[GROUPED, 0.0, 400.0]] * launches
            + [["nvjet_gemm", 0.0, 9e9]]}
    rec = {"model": m, "profile": prof, "moe": {"slice_calls": calls}}
    bound = roofline_moe_serve.expert_launches_bound_s(m, calls)
    assert read(rec) == pytest.approx(100 * bound / (launches * 400e-6))
    assert 0 < read(rec) < 100
    half = dict(prof, intervals=prof["intervals"][:launches // 2])
    assert read(dict(rec, profile=half)) == pytest.approx(
        100 * bound / 2 / (launches // 2 * 400e-6))
    assert read(dict(rec, moe={})) is None                 # no counters
    assert read(dict(rec, profile={"intervals": [["nvjet", 0.0, 1.0]]})) \
        is None                                            # no kernel
    assert read({"model": m}) is None                      # no slice


def test_gqa_roofline_counts_the_cache_at_the_kv_heads():
    read = _reader("decode_attention_roofline.gqa")
    m = _model()
    calls = [[[128, 32, 64], 2, [2047] * 128]] * 6
    kernel = "void (anonymous namespace)::decode_attention_kernel<bf16, 8>"
    prof = {"intervals": [[kernel, 0.0, 400.0]] * 6, "calls":
            {"decode_attention": calls}}
    rec = {"model": m, "profile": prof}
    bound_ms = 6 * roofline_moe_serve.decode_attention_gqa_bound(
        128, 32, 8, 64, [2047] * 128, 2)[0]
    assert read(rec) == pytest.approx(100 * bound_ms / 2.4)
    assert 0 < read(rec) < 100
    assert read({"model": dict(m, n_kv_heads=None), "profile": prof}) is None
    assert read({"model": m, "profile": dict(prof, calls={
        "decode_attention": []})}) is None
    assert read({"model": m}) is None


def test_load_max_reads_the_windows_growth():
    read = _reader("moe_load_max.serve")
    s0 = {"moe_assignments": [[10, 10], [5, 5]]}
    s1 = {"moe_assignments": [[20, 20], [35, 5]]}
    assert read({"stats0": s0, "stats1": s1}) == pytest.approx(30 / 15)
    assert read({"stats0": {}, "stats1": s1}) == pytest.approx(35 / 20)
    assert read({"stats0": s1, "stats1": s1}) is None     # nothing counted
    assert read({"stats0": {}, "stats1": {}}) is None     # no counter
    assert read({}) is None


def test_the_new_metrics_are_listed_for_the_cell_alone():
    listed = {m["name"]: m for m in BENCH["per_layer"]}
    for name in ("moe_expert_roofline.serve", "decode_attention_roofline.gqa",
                 "moe_load_max.serve"):
        assert listed[name]["workloads"] == [CELL]
        assert listed[name]["moves"] == "serve_tokens_per_s"
    for name in ("ttft_p95_ms.serve", "itl_p95_ms.serve",
                 "device_idle_share.serve", "decode_graph_share",
                 "prefill_graph_share"):
        assert listed[name]["workloads"][-1] == CELL
