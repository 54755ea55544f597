"""Finds a cell's pieces by name and turns a driver's record into the
result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
Everything else is found by those names, so a later change adds a cell,
a configuration, a mix or a metric as new files and entries and edits
nothing here:

    configs/<config>.json   the model, its source and its deployment
    mixes/<traffic>.json    the traffic; its "driver" names drivers/<kind>.py
    limits/<cell>.json      the limit of each number ``correct`` compares
    metrics/<metric>.py     one reader a metric: ``read(record)`` -> number
                            or None when the record has nothing to read
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "brpc_tpu")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = REPO) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench: Dict, name: str, root: str = REPO) -> Dict:
    """{"cell", "config", "mix", "limits"} of the workload `name`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    mix = load_json(os.path.join(HERE, "mixes", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", name + ".json"))
    return {"cell": cell, "config": config, "mix": mix, "limits": limits}


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on):
    those with no "workloads" key and those that list the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def _load_file(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> ModuleType:
    """metrics/<metric>.py (a metric's name may hold dots)."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    return _load_file(path, "perfbench_metric_" + metric.replace(".", "_")
                      .replace("-", "_"))


def driver(kind: str) -> ModuleType:
    return importlib.import_module(f"perfbench.drivers.{kind}")


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level name."""
    tops = {n.split(".")[0] for n in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def read_metrics(bench: Dict, cell: str, trace: bool, record: Dict
                 ) -> Dict[str, Dict]:
    out = {}
    for m in metrics_of(bench, cell, trace):
        value = reader(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(checks: Dict[str, Dict]) -> bool:
    """correct: something was compared, and every number is within its
    limit."""
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values())


def result_line(bench: Dict, cell: str, trace: bool, record: Dict) -> Dict:
    line = {"correct": judge(record["checks"]),
            "attempted": record["attempted"], "failed": record["failed"],
            "metrics": read_metrics(bench, cell, trace, record),
            "device": dict(record["device"])}
    if trace and record.get("breakdown"):
        line["breakdown"] = record["breakdown"]
    # last, as its own key; a reading that is no number (nothing to
    # compare, a NaN) is null in JSON, and not within its limit
    line["checks"] = {k: dict(c, value=c["value"]
                              if math.isfinite(c["value"]) else None)
                      for k, c in record["checks"].items()}
    return line


def check_lines(checks: Dict[str, Dict]) -> List[str]:
    return [f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
            for name, c in checks.items()]


class Context:
    """What a driver is given: the cell's files, the run's arguments, the
    device, and when set-up began (host clock)."""

    def __init__(self, found: Dict, seed: int, seconds: float,
                 trace: bool, device, t_start: float,
                 calibrate: bool = False, log=None):
        self.config, self.mix = found["config"], found["mix"]
        self.limits = found["limits"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.calibrate = calibrate
        self.log = log or (lambda msg: print(msg, file=sys.stderr,
                                             flush=True))


def execute(ctx: Context) -> Dict:
    """Run the cell's driver: its record."""
    return driver(ctx.mix["driver"]).run(ctx)


def model_config(m: Dict):
    """The port's ModelConfig of a config file's "model" group."""
    import torch
    from brpc_tpu_torch.models.transformer import ModelConfig
    return ModelConfig(vocab=m["vocab"], d_model=m["d_model"],
                       n_heads=m["n_heads"], n_layers=m["n_layers"],
                       d_ff=m["d_ff"], max_seq=m["max_seq"], n_experts=0,
                       dtype=getattr(torch, m["dtype"]))


def memory_used(dev) -> int:
    """Bytes in use on the card: the larger of what the driver reports
    taken (the plane's buffers included) and torch's reserved peak."""
    import torch
    if dev.type != "cuda":
        return 0
    free, total = torch.cuda.mem_get_info(dev)
    return max(total - free, torch.cuda.max_memory_reserved(dev))


def device_info(dev, memory_peak: int) -> Dict:
    """The result line's ``device``."""
    import torch
    cuda = dev.type == "cuda"
    return {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": memory_peak}
