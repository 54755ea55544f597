"""The reader of the KV plane's host traffic, ``kv_host_mb_per_admit``: the
window's growth of ``kv_host_bytes`` over the growth of ``prefills``, in
MB; nothing where the program has no such counter or no admit landed in
the window; 0 on a traced chat run, whose route stays on the device."""

from __future__ import annotations

import pytest

import tiny  # noqa: F401  (puts the repository on sys.path)
from perfbench import harness

METRIC, KEY, COUNT = "kv_host_mb_per_admit", "kv_host_bytes", "prefills"


def _stats(**kw):
    base = {"tokens_out": 0, "prefills": 0, "steps": 0, "admitted": 0}
    base.update(kw)
    return base


@pytest.mark.parametrize("stats0,stats1,want", [
    # 28 MB over 4 admits
    (_stats(**{KEY: 1000, COUNT: 10}), _stats(**{KEY: 1000 + 28e6, COUNT: 14}),
     7.0),
    # the device route: admits, and no byte crosses
    (_stats(**{KEY: 5, COUNT: 3}), _stats(**{KEY: 5, COUNT: 9}), 0.0),
    # the parent's engine has no such counter
    (_stats(prefills=1), _stats(prefills=9), None),
    # no admit landed in the window
    (_stats(**{KEY: 5, COUNT: 3}), _stats(**{KEY: 5, COUNT: 3}), None),
    ({}, {}, None),
])
def test_the_reader_divides_the_host_bytes_by_the_admits(stats0, stats1,
                                                         want):
    read = harness.reader(METRIC).read
    got = read({"stats0": stats0, "stats1": stats1} if stats1 else {})
    assert got == (None if want is None else pytest.approx(want))


def test_the_metric_is_listed_for_the_chat_cell_alone():
    listed = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    m = listed[METRIC]
    assert m["workloads"] == ["gpt2-large.chat"]
    assert m["moves"] == "serve_tokens_per_s"
    assert m["layer"] == "KV route and device plane"


def test_a_traced_chat_run_moves_no_kv_byte_through_the_host():
    from test_perfbench_runs import _drive
    line = _drive("gpt2-large.chat", trace=True)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"][METRIC]["value"] == 0
