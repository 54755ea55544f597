#!/usr/bin/env python3
r"""Another build of the decode-attention kernel beside the checkout's, on
one NVIDIA GPU: the same checks and the same device-only timing as
chip_smoke.py's kernel phase, in one process.

    mkdir -p scratch
    git show <commit>:brpc_tpu_torch/csrc/decode_attention.cu \
        > scratch/base.cu
    python3 decode_attention_ab.py scratch/base.cu

BASE is a version of ``brpc_tpu_torch/csrc/decode_attention.cu`` with the
same C entry point (``trpc_decode_attention``).  It is built with nvcc
into ``brpc_tpu_torch/_native/build/ab/`` under the entry name
``trpc_decode_attention_base``; the checkout's kernel is built as
chip_smoke.py builds it.  Each build runs chip_smoke.py's ``check_kernel``
at both windows ("mixed" and "full", the same inputs for both builds),
then each is timed with chip_smoke.py's ``device_ms`` (CUDA-graph replay,
L2-warm ``ms`` and L2-cold ``cold_ms``) in the order base, this, this,
base at each window.  Prints the card's ``nvidia-smi`` name and power
limit, BASE's ptxas -v lines, one JSON line per timing, and one summary
line with each build's two readings per window.  Times both builds
even if one is outside chip_smoke.py's tolerance, and then exits
non-zero.
"""

import json
import math
import os
import subprocess
import sys

import chip_smoke
from chip_smoke import KERNEL_SHAPE, WINDOWS, emit


def build_base(src: str) -> str:
    from brpc_tpu_torch import _native
    out_dir = os.path.join(_native.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libdecode_attention_base.so")
    r = subprocess.run(
        [_native._nvcc(), *_native.NVCCFLAGS, "-Xptxas=-v",
         "-Dtrpc_decode_attention=trpc_decode_attention_base", src,
         "-o", out], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}\n{r.stdout}{r.stderr}")
    emit({"base": src, "ptxas": [
        ln.strip() for ln in (r.stdout + r.stderr).splitlines()
        if "entry function" in ln or "registers" in ln or "spill" in ln]})
    return out


def caller(entry):
    """fn(q, k_new, v_new, k_cache, v_cache, p) -> o through a build's C
    entry point, as ops/decode_attention.py calls it."""
    import torch
    codes = {torch.bfloat16: 0, torch.float32: 1}

    def call(q, kn, vn, kc, vc, p):
        o = torch.empty_like(q)
        N, H, hd = q.shape
        rc = entry(q.data_ptr(), kn.data_ptr(), vn.data_ptr(), kc.data_ptr(),
                   vc.data_ptr(), p.data_ptr(), o.data_ptr(), N, kc.shape[1],
                   H, hd, codes[q.dtype], math.sqrt(hd),
                   torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"kernel launch failed: cudaError {rc}"
        return o
    return call


def bind(path: str, name: str):
    import ctypes
    fn = getattr(ctypes.CDLL(path), name)
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return caller(fn)


def main(argv) -> int:
    import torch
    if len(argv) != 2 or not os.path.isfile(argv[1]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("decode_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    from brpc_tpu_torch import _native
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    builds = {"base": bind(build_base(argv[1]), "trpc_decode_attention_base"),
              "this": bind(_native.build_kernels(), "trpc_decode_attention")}
    args, failed = {}, []
    for label, fn in builds.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        for window in WINDOWS:
            a, errs, shares = chip_smoke.check_kernel(fn, g, window)
            args[label, window] = a
            if max(shares.values()) > 1.0:
                failed.append((label, window))
            emit({"build": label, "window": window, "max_abs_err": errs,
                  "share_of_tolerance": shares})
    N, S, H, hd = KERNEL_SHAPE
    flush_buf = torch.ones(chip_smoke.FLUSH_BYTES // 4, device="cuda")
    summary = {}
    for window in WINDOWS:
        p = args["this", window][5].tolist()
        bound_ms, _ = chip_smoke.decode_attention_bound(N, H, hd, p, 2)
        runs = {"base": [], "this": []}
        for label in ("base", "this", "this", "base"):
            fn, a = builds[label], args[label, window]
            ms, cold_ms = chip_smoke.device_ms(lambda: fn(*a), flush_buf.sum)
            runs[label].append((ms, cold_ms))
            emit({"build": label, "window": window, "p": p, "ms": ms,
                  "cold_ms": cold_ms, "bound_ms": bound_ms})
        summary[window] = {
            label: {"ms": sorted(r[0] for r in rs),
                    "cold_ms": sorted(r[1] for r in rs)}
            for label, rs in runs.items()}
        summary[window]["bound_ms"] = bound_ms
    print(json.dumps({"summary": summary, "nvidia_smi": smi,
                      "outside_tolerance": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
