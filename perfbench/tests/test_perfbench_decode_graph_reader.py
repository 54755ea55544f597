"""The reader of the decode step's graph share, ``decode_graph_share``: the
window's growth of ``step_graphed`` over the growth of ``steps``, in %;
nothing where the program has no such counter or no step ran in the
window; 0 on a traced chat run on the CPU, where the step runs eagerly."""

from __future__ import annotations

import pytest

import tiny  # noqa: F401  (puts the repository on sys.path)
from perfbench import harness

METRIC, KEY, COUNT = "decode_graph_share", "step_graphed", "steps"


def _stats(**kw):
    base = {"tokens_out": 0, "prefills": 0, "steps": 0, "admitted": 0}
    base.update(kw)
    return base


@pytest.mark.parametrize("stats0,stats1,want", [
    # every step of the window replayed the graphs
    (_stats(**{KEY: 10, COUNT: 10}), _stats(**{KEY: 410, COUNT: 410}),
     100.0),
    # a quarter of them
    (_stats(**{KEY: 0, COUNT: 20}), _stats(**{KEY: 5, COUNT: 40}), 25.0),
    # the eager step: steps, and none replayed
    (_stats(**{KEY: 0, COUNT: 3}), _stats(**{KEY: 0, COUNT: 9}), 0.0),
    # the parent's engine has no such counter
    (_stats(steps=1), _stats(steps=9), None),
    # no step ran in the window
    (_stats(**{KEY: 5, COUNT: 5}), _stats(**{KEY: 5, COUNT: 5}), None),
    ({}, {}, None),
])
def test_the_reader_divides_the_graphed_steps_by_the_steps(stats0, stats1,
                                                           want):
    read = harness.reader(METRIC).read
    got = read({"stats0": stats0, "stats1": stats1} if stats1 else {})
    assert got == (None if want is None else pytest.approx(want))


def test_the_metric_is_listed_for_the_chat_cell_alone():
    listed = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    m = listed[METRIC]
    assert m["workloads"] == ["gpt2-large.chat"]
    assert m["moves"] == "serve_tokens_per_s"
    assert m["layer"] == "model"
    assert m["source"] == "program_counter" and m["unit"] == "%"


def test_a_traced_chat_run_on_the_cpu_reads_no_graphed_step():
    from test_perfbench_runs import _drive
    line = _drive("gpt2-large.chat", trace=True)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"][METRIC]["value"] == 0
