"""The yardstick's arithmetic and the traffic generator, on the CPU: mixes
repeat by seed, FLOP and roofline counts match hand counts for both
configurations, a share that reads the bound's own time reads 100%."""

from __future__ import annotations

import collections
import math

import pytest
import torch

import tiny  # noqa: F401  (puts the repository on sys.path)
from perfbench import harness, roofline, traffic, weights

BENCH = harness.load_benchmark()
LARGE = harness.find_cell(BENCH, "gpt2-large.chat")
MEDIUM = harness.find_cell(BENCH, "gpt2-medium.pretrain")


def test_chat_mix_repeats_by_seed_and_keeps_its_lengths_across_seeds():
    mix = LARGE["mix"]
    a, b = traffic.serve_requests(mix), traffic.serve_requests(mix)
    assert a == b
    n = mix["clients"]
    # every seed sends the same lengths in the same order; rounds differ
    assert [r["prompt_len"] for r in a[:n]] != \
        [r["prompt_len"] for r in a[n:2 * n]]
    assert collections.Counter(r["prompt_len"] for r in a[:n]) == \
        collections.Counter(r["prompt_len"] for r in a[n:2 * n])
    # the seed draws the token ids
    assert traffic.prompt_tokens(2**31 + 5, 3, 40, 50257) == \
        traffic.prompt_tokens(2**31 + 5, 3, 40, 50257)
    assert traffic.prompt_tokens(2**31 + 5, 3, 40, 50257) != \
        traffic.prompt_tokens(2**31 + 5, 4, 40, 50257)
    assert traffic.prompt_tokens(2**31 + 5, 3, 40, 50257) != \
        traffic.prompt_tokens(12, 3, 40, 50257)


def test_chat_mix_lengths_hold_the_mix_bounds():
    mix = LARGE["mix"]
    reqs = traffic.serve_requests(mix)
    n = mix["clients"]
    assert len(reqs) == mix["pool"]
    for r in reqs:
        assert 32 <= r["prompt_len"] <= 512
        assert 64 <= r["max_new_tokens"] <= 512
        assert r["prompt_len"] + r["max_new_tokens"] <= mix["max_total"]
        assert r["client"] == r["index"] % n
    # every round holds the distributions' quantiles once
    for r0 in range(0, len(reqs) - n + 1, n):
        rnd = reqs[r0:r0 + n]
        assert sorted(r["prompt_len"] for r in rnd) == \
            traffic.quantile_lengths(mix["prompt_len"], n)
    plens = traffic.quantile_lengths(mix["prompt_len"], n)
    outs = traffic.quantile_lengths(mix["output_len"], n)
    assert plens[0] >= 32 and plens[-1] <= 512
    assert abs(plens[n // 2] - 160) <= 2 and abs(outs[n // 2] - 256) <= 3
    # the uniform lengths a later mix may name: evenly over [min, max]
    assert traffic.quantile_lengths(
        {"dist": "uniform", "min": 640, "max": 960}, 4) == [680, 760, 840, 920]


def test_check_sample_holds_the_longest_and_repeats_by_seed():
    done = [{"index": i, "tokens": [0] * (10 + i % 7)} for i in range(40)]
    s = traffic.check_sample(5, done, 6)
    assert len(s) == 6 and s[0]["tokens"] == max((r["tokens"] for r in done),
                                                 key=len)
    assert [r["index"] for r in s] == \
        [r["index"] for r in traffic.check_sample(5, done, 6)]


def test_weights_and_token_batches_repeat_by_seed():
    m = tiny.MODEL
    a = weights.make_weights(m, 2**31 + 1, "cpu")
    b = weights.make_weights(m, 2**31 + 1, "cpu")
    c = weights.make_weights(m, 2, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    for name, shape, fan_in in weights.layout(m):
        assert tuple(a[name].shape) == shape
        assert abs(float(a[name].std()) * math.sqrt(fan_in) - 1) < 0.1
    assert torch.equal(a["blocks.ln1_g"], torch.ones(2, 64))
    g1, g2 = (weights.token_generator(9, "cpu") for _ in range(2))
    assert torch.equal(torch.randint(0, 99, (4, 5), generator=g1),
                       torch.randint(0, 99, (4, 5), generator=g2))


def test_flop_counts_match_hand_counts():
    L = LARGE["config"]["model"]
    M = MEDIUM["config"]["model"]
    # blocks: L x (4 D^2 + 2 D F)
    assert roofline.block_params(L) == 36 * (4 * 1280**2 + 2 * 1280 * 5120)
    assert roofline.block_params(L) == 707_788_800
    assert roofline.block_params(M) == 301_989_888
    # one token at a context of 100: 2 P + 2 D V + L 4 c D
    assert roofline.decode_token_flops(L, 100) == \
        1_415_577_600 + 128_657_920 + 18_432_000
    # a 160-token prompt: 2 P S + L 4 D S (S+1) / 2 + 2 D V
    assert roofline.prefill_flops(L, 160) == \
        226_492_416_000 + 2_374_041_600 + 128_657_920
    # a GPT-2 medium step at 16 x 1024: 6 P T + 6 D V T + 3 x attention
    assert roofline.train_step_flops(M, 16, 1024) == \
        29_686_813_949_952 + 5_059_035_267_072 + 2_476_317_081_600
    assert roofline.train_step_flops(M, 16, 1024) == 37_222_166_298_624


def test_kernel_bounds_match_hand_counts():
    b = roofline.attention_bounds(16, 1024, 16, 64, 2)
    n, rows = 16 * 1024 * 16 * 64 * 2, 16 * 16 * 1024 * 4
    mac = 2 * 64 * 16 * 16 * 1024 * 1025 // 2
    assert b["fwd"] == pytest.approx(
        (max((4 * n + rows) / 3.35e12, 2 * mac / 989e12) * 1e3, "bytes"))
    assert b["bwd_dq"][1] == "operations"
    assert b["bwd_dq"][0] == pytest.approx(3 * mac / 989e12 * 1e3)
    assert b["bwd_dkdv"][0] == pytest.approx(4 * mac / 989e12 * 1e3)
    ms, by = roofline.decode_attention_bound(64, 20, 64, [99] * 64, 2)
    nbytes = 2 * 3 * 64 * 20 * 64 * 2 + 2 * 6400 * 20 * 64 * 2 + 4 * 64
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_roofline_readers_read_100_at_the_bound():
    """A kernel that took exactly its bound reads 100%: the readers'
    arithmetic counts each call's bound once against its time."""
    calls = [((64, 20, 64), 2, [10 * i for i in range(64)]),
             ((64, 20, 64), 2, [900] * 64)]
    ms = [roofline.decode_attention_bound(N, H, hd, p, e)[0]
          for (N, H, hd), e, p in calls]
    t, intervals = 0.0, []
    for x in ms:
        intervals.append(("void decode_attention_kernel<bf16>", t,
                          t + x * 1e3))
        t += x * 1e3 + 5
    prof = {"calls": {"decode_attention": calls, "causal_fwd": []},
            "intervals": intervals, "busy_s": 1.0, "window_s": 2.0}
    rec = {"profile": prof, "requests": []}
    assert harness.reader("decode_attention_roofline").read(rec) == \
        pytest.approx(100.0)
    assert harness.reader("causal_fwd_roofline.serve").read(rec) is None
    assert harness.reader("device_idle_share.serve").read(rec) == \
        pytest.approx(50.0)
    M = MEDIUM["config"]["model"]
    b = roofline.attention_bounds(16, 1024, 16, 64, 2)
    intervals = [("causal_fwd_sm90", 0, b["fwd"][0] * 1e3),
                 ("causal_dq_sm90", 100, 100 + b["bwd_dq"][0] * 1e3),
                 ("causal_dkdv_sm90", 200, 200 + b["bwd_dkdv"][0] * 1e3),
                 ("ampere_bf16_gemm", 300, 900)]
    rec = {"steps": 5, "batch": 16, "seq": 1025, "model": M,
           "profile": {"intervals": intervals}}
    assert harness.reader("causal_attention_roofline.train").read(rec) == \
        pytest.approx(100.0)


def test_union_and_gaps_of_device_intervals():
    spans = [(0, 10), (5, 20), (30, 40)]
    assert roofline.union_seconds(spans) == pytest.approx(30e-6)
    assert roofline.idle_gaps(spans, -5, 50) == [(-5, 0), (20, 30), (40, 50)]


def test_rates_and_shares_read_from_a_record():
    rec = {"t0": 10.0, "t1": 12.0, "window_s": 2.0, "requests": [
        {"end": "eof", "t_send": 9.0, "stamps": [9.5, 10.5, 11.0, 11.5]},
        {"end": "eof", "t_send": 10.2, "stamps": [10.4, 12.5]},
    ]}
    assert harness.reader("serve_tokens_per_s").read(rec) == 2.0
    assert harness.reader("ttft_p95_ms.serve").read(rec) == \
        pytest.approx(500.0)
    assert harness.reader("itl_p95_ms.serve").read(rec) == \
        pytest.approx(500.0)
    M = MEDIUM["config"]["model"]
    rec = {"steps": 10, "batch": 16, "seq": 1025, "window_s": 4.0,
           "model": M}
    assert harness.reader("train_tokens_per_s").read(rec) == 40960.0
    assert harness.reader("train_mfu").read(rec) == pytest.approx(
        100 * 10 * 37_222_166_298_624 / 4.0 / 989e12)


def test_idle_gaps_are_named_after_the_innermost_open_host_events():
    from perfbench.profiling import name_gaps
    spans = [(0, 100, "step"), (10, 20, "kv_to_bytes"), (12, 18, "seq_alloc"),
             (40, 60, "install"), (70, 90, "emit")]
    dev = [("gemm", 0, 10), ("copy", 34, 40), ("decode_attention", 125, 130)]
    gaps = [(14, 16), (30, 34), (50, 52), (95, 99), (110, 125), (130, 140)]
    assert name_gaps(spans, dev, gaps) == [
        ("kv_to_bytes > seq_alloc", 2e-6), ("step", 4e-6),
        ("step > install", 2e-6), ("step", 4e-6),
        ("before decode_attention", 15e-6),
        ("after the last operation", 10e-6)]


class _Event:
    def __init__(self, name, a, b, cuda):
        from torch.autograd import DeviceType
        self.name = name
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.time_range = type("R", (), {"start": a, "end": b})()


def test_a_slice_places_the_host_spans_by_its_anchor():
    from perfbench.profiling import Slice, summarize
    sl = Slice(torch.device("cpu"))
    # the synchronize began at 1000 us on the profiler's clock, 5.0 s on
    # the host's
    sl.anchor = 5.0
    sl.prof = type("P", (), {"events": lambda self: [
        _Event("cudaDeviceSynchronize", 1000, 1002, False),
        _Event("gemm", 1010, 1050, True),
        _Event("copy", 1090, 1100, True)]})()
    out = summarize(sl, [(5.0 + 55e-6, 5.0 + 95e-6, "seq_fetch")])
    assert out["anchored"]
    assert out["busy_s"] == pytest.approx(50e-6)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["breakdown"]["idle_gaps"] == [["seq_fetch", 40e-6],
                                             ["before gemm", 10e-6]]
    assert out["breakdown"]["device_ops"] == [["gemm", 40e-6],
                                              ["copy", 10e-6]]
