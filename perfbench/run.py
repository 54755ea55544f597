"""The benchmark's one entry point.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card of the machine it starts
on and prints, as its last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``), ``device``, with a trace ``breakdown``, and last
``checks``: each number compared beside its limit, which also close
standard error.  Exits non-zero and prints no result without a CUDA
card, without the program, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".perfbench_cache")


def _fail(msg: str, code: int) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every compiler cache inside the checkout, at a fixed path
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, REPO)
    from perfbench import harness
    bench = harness.load_benchmark()
    try:
        found = harness.find_cell(bench, args.workload)
    except (KeyError, OSError) as e:
        return _fail(f"cannot find the cell: {e}", 2)
    try:
        import brpc_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the program is not here ({e})", 4)
    import torch
    chips = found["cell"]["chips"]
    if not torch.cuda.is_available():
        return _fail("no CUDA device (torch.cuda.is_available() is False)", 3)
    if torch.cuda.device_count() < chips:
        return _fail(f"the cell asks for {chips} cards, this machine has "
                     f"{torch.cuda.device_count()}", 3)
    ctx = harness.Context(found, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
    record = harness.execute(ctx)
    bad = harness.forbidden_modules()
    if bad:
        return _fail(f"modules of JAX or of the JAX package were loaded: "
                     f"{bad}", 5)
    line = harness.result_line(bench, args.workload, bool(args.trace),
                               record)
    for text in harness.check_lines(record["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
