"""On the card, at each cell's own size: the control (the plain reference
in the program's place, its products in float8 e4m3) fails one of the
cell's numbers on every seed, and the program passes them all on the
same seeds.  Skips without a CUDA card; run on the card with
``python -m pytest --noconftest -m cuda perfbench/tests``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

import tiny
from perfbench import harness

SEEDS = "2147483711,2147483723,2147483729"
CELLS = [("gpt2-medium.pretrain", 1), ("gpt2-large.chat", 30)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", CELLS)
def test_the_control_fails_where_the_program_passes(cell, seconds):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = harness.find_cell(harness.load_benchmark(), cell)["limits"]
    r = subprocess.run([sys.executable, "perfbench/calibrate.py",
                        "--workload", cell, "--seeds", SEEDS, "--seconds",
                        str(seconds)], cwd=tiny.REPO, capture_output=True,
                       text=True, timeout=1800)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith('{"workload"')]
    assert len(lines) == len(SEEDS.split(","))
    for ln in lines:
        cal = ln["calibration"]
        # each side's numbers that have a limit, judged as a run's are
        program, control = ({k: {"value": cal[side][k], "limit": lim}
                             for k, lim in limits.items() if k in cal[side]}
                            for side in ("program", "control"))
        assert harness.judge(program) is True, cal
        assert harness.judge(control) is False, cal
