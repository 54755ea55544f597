"""Readings that the limits of ``correct`` are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--out FILE]

Runs the cell once a seed in this one process, as ``run.py`` does, and
beside each number the program gives (the sound runs: the lower
reading) prints what the control gives on the same inputs: the plain
reference in place of the program with its products in float8 e4m3,
the next precision below the configurations' bf16 (the upper reading).
For a training cell it also prints the reading of a planted fault: the
reference's steps with half of each batch left out and the mean taken
over the rest.  A state left unchanged reads 1 on ``change_gap`` by
that number's definition and needs no run.  The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="also append each line to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from perfbench import harness
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    bench = harness.load_benchmark()
    found = harness.find_cell(bench, args.workload)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(found, seed, args.seconds, False,
                              torch.device("cuda", 0), time.monotonic(),
                              calibrate=True)
        record = harness.execute(ctx)
        line = {"workload": args.workload, "seed": seed,
                "calibration": record["calibration"],
                "checks": record["checks"],
                "metrics": harness.read_metrics(bench, args.workload, False,
                                                record),
                "sample": record.get("sample"),
                "device": record["device"]}
        print(json.dumps(line), flush=True)
        lines.append(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    _summary(lines)
    return 0


def _summary(lines) -> None:
    """The lower (most of the program's) and upper (least of the control
    and of each fault) reading of every number."""
    if not lines:
        return
    sides = lines[0]["calibration"].keys()
    out = {}
    for num in lines[0]["calibration"]["program"]:
        out[num] = {side: (max if side == "program" else min)(
            ln["calibration"][side][num] for ln in lines)
            for side in sides if side != "leaves"}
    print(json.dumps({"summary": out, "seeds": len(lines)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
