"""The benchmark's layout: BENCHMARK.json keeps its contract, every piece
of a cell is found by name (a new mix, metric or configuration needs
only new files and entries), nothing under perfbench/ imports JAX or
the JAX package, the reference imports nothing of the program, and
run.py prints no result where it cannot run."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import tiny
from perfbench import harness

PB = os.path.join(tiny.REPO, "perfbench")
BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "brpc_tpu"}


def _py_files(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(tiny.REPO, "BENCHMARK.json")) \
        <= 64 * 1024
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert json.load(open(os.path.join(tiny.REPO, c["file"])))["name"] \
            == c["name"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert sum(w["chips"] == 4 for w in cells.values()) <= \
        max(1, len(cells) // 4)
    for name in cells:
        e = harness.metrics_of(BENCH, name, False)
        assert "setup_s" in [m["name"] for m in e] and len(e) >= 2
        assert harness.metrics_of(BENCH, name, True)


def test_every_piece_of_every_cell_is_found_by_name():
    for w in BENCH["workloads"]:
        found = harness.find_cell(BENCH, w["name"])
        assert found["config"]["name"] == w["config"]
        assert harness.driver(found["mix"]["driver"]).run
        for m in (harness.metrics_of(BENCH, w["name"], False)
                  + harness.metrics_of(BENCH, w["name"], True)):
            assert callable(harness.reader(m["name"]).read)


def test_a_new_mix_metric_and_config_need_only_new_files(tmp_path):
    """A later change adds a cell as files and entries: a copy of the
    benchmark with a new configuration, mix, limits and metric reader
    finds each by name with no edit of an existing file."""
    root = tmp_path / "repo"
    shutil.copytree(PB, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in _py_files(root)}
    (root / "perfbench/configs/gpt2-small.json").write_text(json.dumps(
        {"name": "gpt2-small", "model": dict(tiny.MODEL),
         "engine": dict(tiny.ENGINE)}))
    (root / "perfbench/mixes/burst.json").write_text(json.dumps(
        dict(tiny.CHAT, driver="serve")))
    (root / "perfbench/limits/gpt2-small.burst.json").write_text(
        json.dumps({"widest_gap": 0.5}))
    (root / "perfbench/metrics/admits_per_s.py").write_text(
        "def read(rec):\n    return len(rec['admits']) / rec['window_s']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "gpt2-small", "source": "x",
                             "file": "perfbench/configs/gpt2-small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "gpt2-small.burst",
                               "config": "gpt2-small", "traffic": "burst",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "admits_per_s", "unit": "1/s",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "serving engine",
                               "moves": "serve_tokens_per_s",
                               "workloads": ["gpt2-small.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    h = harness._load_file(str(root / "perfbench/harness.py"),
                           "perfbench_copy_harness")
    bench = h.load_benchmark(str(root))
    found = h.find_cell(bench, "gpt2-small.burst", str(root))
    assert found["mix"]["driver"] == "serve"
    assert found["limits"] == {"widest_gap": 0.5}
    assert found["config"]["model"]["d_model"] == 64
    names = [m["name"] for m in h.metrics_of(bench, "gpt2-small.burst",
                                             True)]
    assert "admits_per_s" in names and "decode_step_ms" not in names
    assert h.reader("admits_per_s").read(
        {"admits": [1, 2, 3], "window_s": 2.0}) == 1.5
    assert h.read_metrics(bench, "gpt2-small.burst", True,
                          {"admits": [], "window_s": 1.0}) == \
        {"admits_per_s": {"value": 0.0, "unit": "1/s"}}
    assert {p: open(p, "rb").read() for p in before} == before


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    for path in _py_files(PB):
        tops = set(_imports(path))
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if os.sep + "reference" + os.sep in path:
            assert tops <= {"__future__", "contextlib", "math", "typing",
                            "torch"}, (path, tops)


def test_the_harness_reads_no_record_of_the_old_benchmarks():
    """No string in the code (docstrings aside) names bench.py,
    bench_torch.py, chip_smoke.py or the BENCH_/MULTICHIP_ records."""
    pat = re.compile(r"chip_smoke|\bbench(_torch)?\.py|\bBENCH_|\bMULTICHIP_")
    for path in _py_files(PB):
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        tree = ast.parse(open(path).read(), path)
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef,
                                  ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and id(node) not in docs:
                assert not pat.search(node.value), (path, node.value)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib_lookalike", sys)
    assert "jaxlib_lookalike" not in harness.forbidden_modules()
    import brpc_tpu_torch  # noqa: F401  (the port: allowed)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("layout", ["repository", "benchmark_only"])
def test_run_prints_no_result_where_it_cannot_run(tmp_path, layout):
    """Without a CUDA card (this machine), and in a directory that holds
    only BENCHMARK.json and perfbench/, run.py exits non-zero and prints
    nothing on standard output."""
    cwd = tiny.REPO
    if layout == "benchmark_only":
        cwd = str(tmp_path)
        shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), cwd)
        shutil.copytree(PB, os.path.join(cwd, "perfbench"),
                        ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "gpt2-large.chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=cwd, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == "", (r.returncode, r.stdout)
    why = {"repository": "no CUDA device",
           "benchmark_only": "the program is not here"}[layout]
    assert why in r.stderr, r.stderr
