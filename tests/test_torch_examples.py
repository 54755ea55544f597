"""The port's examples run clean end to end, as tests/test_examples.py
runs the reference's: examples/llm_server_torch.py on the CPU (8 gloo
ranks at dp2 x tp4, the leader's plane on the fake CUDA driver)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_llm_server_torch_serving_proof():
    """>= 8 concurrent clients stream full generations from the leader
    engine and its 7 followers, prefill->decode KV blocks migrate on the
    local d2d rail (counter asserted), a mid-stream cancel evicts and
    frees, offered load beyond the budget is SHED (never queued), and the
    device-buffer accounting balances to zero after the drain."""
    r = subprocess.run(
        [sys.executable, os.path.join("examples", "llm_server_torch.py"),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, \
        f"llm_server_torch failed:\n{r.stdout}\n{r.stderr}"
    j = json.loads(r.stdout.strip().splitlines()[-1])
    assert j["mesh"] == {"dp": 2, "tp": 4}, j
    assert j["clients"] >= 8 and j["streamed"] >= 8, j
    assert j["tokens"] >= 8 * 8, j                   # full generations
    assert j["shed_client"] > 0 and j["shed_server"] > 0, j  # shed>queue
    assert j["canceled"] >= 1 and j["cancel_reset"] >= 1, j  # mid-stream
    assert j["balanced"], j
    assert j["plane"], j                              # the fake driver
    assert j["rail_local"] > 0 and j["d2d_delta"] > 0, j  # local rail
    assert j["live_buffers_end"] == 0, j             # accounting proof
