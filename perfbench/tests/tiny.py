"""Tiny cells for the CPU tests: the harness's drivers, readers and checks
at sizes a CPU run holds, on the port's CPU path (the plain kernels and
the fake CUDA driver's plane).  Limits come from the real cells' files."""

from __future__ import annotations

import copy
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench import harness  # noqa: E402

MODEL = {"vocab": 128, "d_model": 64, "n_heads": 4, "n_layers": 2,
         "d_ff": 256, "max_seq": 64, "dtype": "float32",
         "param_dtype": "float32"}
ENGINE = {"n_slots": 4, "max_len": 64, "max_waiting": 6,
          "kv_block_tokens": 16, "kv_block_bytes": 16 * 2 * 2 * 64 * 4,
          "kv_blocks": 64}
CHAT = {"pool": 1024, "clients": 6, "max_total": 64, "check_requests": 12,
        "trace_steps": 4, "trace_admits": 1,
        "prompt_len": {"dist": "lognormal", "median": 8, "sigma": 0.6,
                       "min": 4, "max": 24},
        "output_len": {"dist": "lognormal", "median": 8, "sigma": 0.5,
                       "min": 4, "max": 24}}
PRETRAIN = {"batch": 4, "seq": 17, "checked_steps": 3, "ref_rows": 2,
            "trace_steps": 2}


def found(cell: str, **model) -> dict:
    """The cell's files with the tiny model, engine and sizes in place."""
    out = copy.deepcopy(harness.find_cell(harness.load_benchmark(), cell))
    out["config"]["model"] = dict(MODEL, **model)
    if "engine" in out["config"]:
        out["config"]["engine"] = dict(ENGINE)
    out["mix"].update(copy.deepcopy(CHAT if out["mix"]["driver"] == "serve"
                                    else PRETRAIN))
    return out


def context(cell: str, seed: int = 7, seconds: float = 2.0,
            trace: bool = False, calibrate: bool = False, **model):
    import torch
    return harness.Context(found(cell, **model), seed, seconds, trace,
                           torch.device("cpu"), time.monotonic(),
                           calibrate=calibrate, log=lambda msg: None)
