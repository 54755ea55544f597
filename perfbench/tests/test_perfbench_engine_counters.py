"""The readers of the serving engine's own counters: each divides the
window's growth of one ``engine.stats()`` counter by the growth of its
count, and reads nothing where the program has no such counter (as a
program without them has not) or where the count did not move; a tiny
traced chat run on the CPU prints all of them."""

from __future__ import annotations

import pytest

import tiny  # noqa: F401  (puts the repository on sys.path)
from perfbench import harness

READERS = [  # metric, counter, count, the counter's unit per the metric's
    ("queue_wait_ms_per_admit", "queue_wait_us", "admitted", 1e3),
    ("prefill_ms_per_admit", "prefill_us", "prefills", 1e3),
    ("kv_copy_ms_per_admit", "kv_route_us", "prefills", 1e3),
    ("kv_route_mb_per_admit", "kv_route_bytes", "prefills", 1e6),
    ("decode_issue_ms", "step_issue_us", "steps", 1e3),
    ("decode_sync_ms", "step_sync_us", "steps", 1e3),
    ("decode_emit_ms", "emit_us", "steps", 1e3),
]


def _stats(**kw):
    base = {"tokens_out": 0, "prefills": 0, "steps": 0, "admitted": 0}
    base.update(kw)
    return base


@pytest.mark.parametrize("metric,key,count,scale", READERS)
def test_a_reader_divides_the_windows_counter_by_its_count(metric, key,
                                                          count, scale):
    read = harness.reader(metric).read
    rec = {"stats0": _stats(**{key: 1000, count: 10}),
           "stats1": _stats(**{key: 1000 + 7 * 4 * 1000, count: 14})}
    assert read(rec) == pytest.approx(7 * 1000 / scale)
    # the parent's engine has no such counter
    assert read({"stats0": _stats(prefills=1, steps=1, admitted=1),
                 "stats1": _stats(prefills=9, steps=9, admitted=9)}) is None
    # nothing was counted in the window
    assert read({"stats0": _stats(**{key: 5, count: 3}),
                 "stats1": _stats(**{key: 5, count: 3})}) is None
    assert read({}) is None


def test_every_reader_is_listed_for_the_chat_cell_alone():
    bench = harness.load_benchmark()
    listed = {m["name"]: m for m in bench["per_layer"]}
    for metric, *_ in READERS:
        assert listed[metric]["workloads"] == ["gpt2-large.chat"]
        assert listed[metric]["moves"] == "serve_tokens_per_s"


def test_a_traced_chat_run_prints_every_counter_metric():
    from test_perfbench_runs import _drive
    line = _drive("gpt2-large.chat", trace=True)
    assert line["correct"] is True, line["checks"]
    got = line["metrics"]
    assert {m for m, *_ in READERS} <= set(got), sorted(got)
    assert got["kv_route_mb_per_admit"]["value"] > 0
    assert got["decode_issue_ms"]["value"] > 0
