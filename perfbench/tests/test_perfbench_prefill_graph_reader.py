"""The reader of the prefill's graph share, ``prefill_graph_share``: the
window's growth of ``prefill_graphed`` over the growth of ``prefills``, in
%; nothing where the program has no such counter or no admit ran in the
window; 0 on a traced chat run on the CPU, where the prefill runs
eagerly."""

from __future__ import annotations

import pytest

import tiny  # noqa: F401  (puts the repository on sys.path)
from perfbench import harness

METRIC, KEY, COUNT = "prefill_graph_share", "prefill_graphed", "prefills"


def _stats(**kw):
    base = {"tokens_out": 0, "prefills": 0, "steps": 0, "admitted": 0}
    base.update(kw)
    return base


@pytest.mark.parametrize("stats0,stats1,want", [
    # every admit of the window replayed the graphs
    (_stats(**{KEY: 64, COUNT: 64}), _stats(**{KEY: 190, COUNT: 190}),
     100.0),
    # a quarter of them
    (_stats(**{KEY: 0, COUNT: 20}), _stats(**{KEY: 5, COUNT: 40}), 25.0),
    # the eager prefill: admits, and none replayed
    (_stats(**{KEY: 0, COUNT: 3}), _stats(**{KEY: 0, COUNT: 9}), 0.0),
    # the parent's engine has no such counter
    (_stats(prefills=1), _stats(prefills=9), None),
    # no admit in the window
    (_stats(**{KEY: 5, COUNT: 5}), _stats(**{KEY: 5, COUNT: 5}), None),
    ({}, {}, None),
])
def test_the_reader_divides_the_graphed_prefills_by_the_prefills(
        stats0, stats1, want):
    read = harness.reader(METRIC).read
    got = read({"stats0": stats0, "stats1": stats1} if stats1 else {})
    assert got == (None if want is None else pytest.approx(want))


def test_the_metric_is_listed_for_both_serving_cells():
    listed = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    m = listed[METRIC]
    assert m["workloads"] == ["gpt2-large.chat", "gpt2-large.docqa"]
    assert m["moves"] == "serve_tokens_per_s"
    assert m["layer"] == "model" and m["better"] == "higher"
    assert m["source"] == "program_counter" and m["unit"] == "%"


def test_a_traced_chat_run_on_the_cpu_reads_no_graphed_prefill():
    from test_perfbench_runs import _drive
    line = _drive("gpt2-large.chat", trace=True)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"][METRIC]["value"] == 0
