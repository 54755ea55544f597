"""bench_torch.py, the port's bench.py: its serving arms on a gloo world of
8 ranks at dp2 x tp4 (bench.py:79) with the leader's plane on the fake
CUDA driver, its large-attachment arm on the port's core, and an arm
that fails recorded as an error cell."""

import ast
import json
import os
import subprocess
import sys

import pytest

from brpc_tpu_torch import _native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench(*args, timeout=300):
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py"),
                        *args], cwd=REPO, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, f"{args}:\n{r.stdout}\n{r.stderr}"
    lines = r.stdout.strip().splitlines()
    return lines, json.loads(lines[-1])


def _reference_serving_keys():
    """The keys of the dict bench.py's _serving_arm returns."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_serving_arm")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][-1]
    return {k.value for k in ret.value.keys}


@pytest.mark.parametrize("arm", ["auto,none", "host,int8"])
def test_serving_arm_on_a_dp2_tp4_world(arm):
    """One arm: the leader engine and 7 followers serve rpc_press's 6
    concurrent streams; the reference's keys, streams completed with no
    error, the KV accounting balanced, every follower replaying the
    leader's operations; the auto rail takes the fake's d2d rail, the
    host rail runs the int8 codec on the landing bytes."""
    _native.build_core()
    _, j = _bench("--serving-arm", arm, "--brief", "--device", "cpu")
    assert _reference_serving_keys() <= set(j), \
        _reference_serving_keys() - set(j)
    rail, codec = arm.split(",")
    assert (j["rail"], j["codec"]) == (rail, codec), j
    assert j["mesh"] == {"dp": 2, "tp": 4} and j["device"] == "cpu", j
    assert j["plane"] and j["balanced"], j
    assert j["completed"] > 0 and j["errors"] == 0, j
    assert j["tokens"] >= 16 * j["completed"] and j["tokens_per_s"] > 0, j
    assert j["ops"]["prefill"] > 0 and j["ops"]["step"] > 0, j
    if rail == "auto":
        assert j["rail_local"] > 0 and j["rail_host"] == 0, j
    else:
        assert j["rail_host"] > 0 and j["kv_codec_bytes"] > 0, j


def test_attach_bytes_prints_one_json_line():
    """--attach-bytes: one large-attachment run on the port's core, one
    JSON line with the GB/s, the egress rail and the codec counters."""
    lines, j = _bench("--attach-bytes", "524288")
    assert len([ln for ln in lines if ln.startswith("{")]) == 1, lines
    assert j["metric"] == "attach_gbps" and j["attach_bytes"] == 524288, j
    assert j["value"] > 0 and j["qps"] > 0, j
    assert j["payload_codec"] == "none" and j["egress"], j


def test_a_failed_serving_arm_is_an_error_cell():
    """--serving on a host without a card: each of the four arms fails in
    its own subprocess and is recorded as an error cell, the headline
    value None, never a silent 0."""
    _, j = _bench("--serving", "--brief", "--device", "cuda")
    assert j["metric"] == "serving_ab" and j["value"] is None, j
    assert set(j["table"]) == {"auto/none", "host/none", "host/bf16",
                               "host/int8"}, j
    for cell in j["table"].values():
        assert "no CUDA device" in cell["error"], cell
