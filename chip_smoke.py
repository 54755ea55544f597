#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (brpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds everything from the checkout (the native core with g++, the CUDA
kernels with nvcc, in parallel), then runs these phases in order, each
printing one JSON line; any failure exits non-zero with no result line:

  card       the card's name and power limit, the build seconds,
             ptxas -v's lines for each kernel (registers, shared memory,
             spills) and each kernel's count of HGMMA (wgmma) instructions
             in its SASS (cuobjdump -sass on the built library): the bf16
             forward, dq and dk/dv kernels of causal_attention and of
             the ring fold must have some (18 instantiations); its
             ptxas_by_kernel key gives each kernel's registers and spills,
             and the f32 CUDA-core kernels (causal forward, dq and dk/dv,
             the fold's forward, dq and dk/dv; 18 instantiations, and the
             fold's forward, dq and dk/dv at hd 8, ring_fold_f32_hd8.cu)
             must spill nothing, and no SIMT fold kernel is left
             (ring_fold_fwd_kernel<, ring_fold_dq_kernel<); the fold's
             bf16 forward, dq and dk/dv at hd 8
             (ring_fold_hd8.cu) must have HMMA (mma.sync) instructions
             (sass_hmma) and spill nothing
  plane      the CUDA device plane: h2d -> d2h and d2d round trips of
             256 KiB are byte-equal, live buffers and errors balance;
             torch's current device and the thread's CUDA context are
             the same after init and a round trip, and a thread with no
             context still has none after one; PLANE_STEADY more rounds
             at 4 KiB, 1 MiB, 8 MiB and 12345 bytes, each with bytes of
             its own (two h2d in flight, a d2d whose source is freed
             under the copy, every h2d -> d2h and d2d result compared),
             make no miss in either pool (tpu_plane.pool_stats(): no
             allocation, free or page-locking in the driver), and the
             line prints the pools' counters and the peer-access matrix
  transport  HbmEcho over tpu:// settles "device" and echoes a 256 KiB
             attachment zero-copy
  uring      the d2h landing zones on io_uring's registered slots: where
             the kernel refuses io_uring or SEND_ZC the line says so and
             the run goes on; else, in a process of its own with the
             ring transport on and SEND_ZC pinned on, HbmEcho, h2d and d2h
             at URING_SIZES (1 MiB: a slot; 8 MiB: larger, the pool) with
             bytes of their own, each equal; the first use of the slots
             (their page-locking) timed apart from URING_ROUNDS steady
             rounds (host clock to the completed call); at least one
             attachment left on a fixed buffer (sendzc_fixed), and no
             slot page-locked and no pool miss after the first use
  kernel     decode_attention against its plain PyTorch version at the
             serving shapes (N=4, S=1024, H=8, hd=64) at two windows,
             "mixed" p = [0, S-1, r1, r2] and "full" p = [S-1] * 4: cache
             rows bit-equal, o within KERNEL_TOL of the plain version
             (bf16: atol 4e-3 + rtol 1e-2, one rounding of the output and
             of the softmax weights; f32: 1e-5, the same sums in another
             order).  Timed in bf16 on the device alone
             by CUDA-graph replay: L2-warm (ms), L2-cold (cold_ms: a graph
             of [flush + launch] x K less a graph of [flush] x K), beside
             its memory bound, PyTorch's scaled_dot_product_attention on
             the same window timed the same way (a yardstick the port
             never calls), a one-element add_ (the floor of one graph
             node) and the wrapper's host-inclusive time (host_call_ms);
             then its grouped-query launches at LFM2-8B-A1B's serving
             shapes (GQA_KERNEL_SHAPE: N=128, S=8192, H=32 over KV=8,
             hd=64) at the same two windows: the same checks (the
             caches bit-equal to the plain version's scatter, so each KV
             head's row p holds k_new/v_new and no other row moved), one
             launch a call, timed the same way beside its bound with the
             cache counted at the KV heads (decode_attention_gqa lines)
  attention  causal_attention's three kernels (forward; backward dq, which
             also writes the softmax backward's row sums; backward dk/dv)
             under autograd against autograd of the plain version at
             B=8, S=1024, H=8, hd=64 and at S=1000, f32 and bf16: o, dq,
             dk, dv and the forward's lse within ATTN_TOL (the
             attention_check line prints the errors and the share of the
             limit used).  The dtype dispatch read from the device's
             kernel names under torch.profiler: bf16 forward, dq and
             dk/dv launch the tensor-core kernels and no SIMT one, f32
             the CUDA-core forward, dq and dk/dv.  Each
             kernel timed in bf16 on the device alone like
             decode_attention, beside its bound, the plain version (CUDA
             events), the wrapper's host-inclusive time (host_call_ms)
             and scaled_dot_product_attention(is_causal=True) forward
             and backward (a yardstick the port never calls); the f32
             route timed the same way at the same shape, its bound at
             the f32 CUDA-core rate, SDPA in f32 beside it (its
             launches: the train phase's f32 twin step)
  serving    ServingEngine at the full width of ModelConfig() on a Server:
             6 streaming LLM.Generate clients (prompts 32..256, 16 new
             tokens) and one that cancels mid-stream; every full client
             gets 16 tokens below the vocab size, the kernel launched
             steps x n_layers times, the KV and plane accounting balance;
             the line adds the plane's h2d and d2h over the run (the KV
             route's blocks) and the KV route's ms per admit (seq_alloc
             plus seq_fetch);
             then a torch.profiler window over 8 steady decode steps of 4
             more clients (device busy share, top device kernels); then
             one decode step through the kernel agrees with the same
             step through the plain version (logits atol 0.1: bf16
             rounding carried through four layers), and a prefill of
             PREFILL_LEN tokens through the causal_attention kernel
             against the plain version (same limit)
  train      the training path at the full width of ModelConfig() with
             the reference's MoE setting (n_experts 4, moe_every 2,
             top-1: layers 1 and 3 MoE), 8 x 1025 tokens (S = 1024):
             one AdamW step through the kernels and one through the plain
             version from the same state, in f32 and in bf16 (loss within
             LOSS_RTOL, each gradient within GRAD_REL of the plain one in
             norm); 5 kernel steps at lr 1e-2 on a fixed seeded batch,
             counted (each kernel launched 5 x 4 times, decode_attention
             never) and timed, the loss must fall; save, restore into a
             fresh state and one more step on each: the same loss, step
             7; step ms, tokens/s and peak device memory; a
             torch.profiler window over one more step
  parallel   an NCCL process group of one rank on the card and a mesh
             {"dp": 1}: every collective (all_reduce add/max/min,
             all_gather tiled and stacked, reduce_scatter, ring_permute,
             all_to_all) once, MeshParallelChannel (add, concat, add with
             the int8 codec) and MeshPartitionChannel's three calls, each
             equal to its closed form over one member; the parameter-
             server merge of a PS_PARAMS-value f32 gradient through
             MeshParallelChannel(codec="int8") (the main path: the codec
             kernel's launches are read over it), its error within
             int8_error_bound; the codec kernel bit-equal to its plain
             version in f32 and bf16 on that gradient and on the CPU
             tests' ragged, short, denormal and ties cases; the kernel
             timed at that size like decode_attention (no single PyTorch
             call computes it: library none), beside its memory bound,
             the plain version and host_call_ms; a 64 MB bf16 NCCL
             all_reduce timed (a time: bus bandwidth is 0 over one
             member)
  ring       on an NCCL world of one rank and a mesh {"dp": 1, "sp": 1}:
             ring_attention and ulysses_attention at B=8, S=1024, H=8,
             hd=64 in bf16, then in f32, forward and backward, against
             autograd of the plain `_dense_local` (the main path of the
             fold: its launches are read over each), and the same at hd 8
             (B=8, S=1024, H=64: d_model 512 in heads of 8; in bf16 the
             tensor-core forward, dq and dk/dv of csrc/ring_fold_hd8.cu,
             in f32 the CUDA-core forward, dq and dk/dv of
             csrc/ring_fold_f32_hd8.cu);
             the three ring-fold kernels
             against their plain versions in f32 and bf16, one full-width
             block and blocks of C=256 at (idx, src) (2, 2), (3, 1),
             (1, 3), causal and not, the wholly future (1, 3) block
             skipped with no launch, and at hd 8 the full-width block and
             a C=256 (3, 1) block (RING_TOL, with the bf16 flip rule; the
             f32 forward's state against the fold in f64, the plain
             version's share of it beside, because the plain f32 GEMM's
             own error from the exact fold reaches RING_TOL);
             exact scores (integer q and k): the bf16 forward and dk/dv
             (at hd 64 and at hd 8) hold m, l, o and dv within EXACT_TOL
             of the plain version (at hd 8 over 1024 keys, of the same
             in f64), which p rounded once to bf16 leaves; at hd 8 the
             bf16 dq on integer q, k, v and dO holds dq (its dS then the
             plain version's bits), which dS left unrounded leaves, the
             f32 dk/dv holds dk and dv, which P and dS rounded once to
             bf16 leave, and the f32 forward on integer q and k holds m,
             l and o (over 1024 keys of the same in f64), which p
             rounded once to bf16 leaves;
             each kernel timed in bf16 and in f32 at the full-width block
             like the others, beside its bound (products of bf16 values
             at the bf16 rate, p's f32 products and every f32 product at
             the f32 CUDA-core rate, or one exponential a visible score
             on the SFUs where that takes longer), the plain version,
             SDPA on the block in the same dtype and host_call_ms; the
             f32 fold's device time a layer (forward, dq and dk/dv,
             cold); the kernel names under torch.profiler: bf16 the
             tensor-core forward, dq and dk/dv, f32 the CUDA-core
             forward, dq and dk/dv, hd 8 in bf16 the tensor-core forward,
             dq and dk/dv, in f32 the CUDA-core forward, dq and dk/dv,
             each timed as above
  mesh_train make_train_step(cfg, mesh) at the train phase's width on
             the same world, mesh {"dp": 1, "ep": 1, "sp": 1, "tp": 1}:
             5 steps from the train phase's seeded state, each loss
             equal bit for bit to the one-device step's, a profiled step
             of each; a checkpoint saved and restored through the mesh
             path and one more step on each, equal; then
             entry.dryrun_multichip(1) (one NCCL process)
  mesh_serving
             ServingEngine(mesh={"dp": 1, "tp": 1}) on the same world at
             the serving phase's width and seed, beside the one-device
             engine: the serving phase's prompts (32..256 tokens, 16 new)
             one at a time stream the same tokens from both; then both
             serve them concurrently with one cancel (the main path of
             the mesh: decode_attention launched steps x n_layers times,
             the causal forward prefills x n_layers), TTFT and
             inter-token p50 of each; one decode step's logits through
             the mesh path against the one-device path (bit-equal is
             reported, STEP_LOGITS_ATOL held); decode_attention (N=4,
             S=1024, both windows) and the causal forward (B=1,
             S=PREFILL_LEN) at the 4, 2 and 1 heads a tp = 2, 4, 8 shard
             holds, hd 64, f32 and bf16, against their plain versions
             (KERNEL_TOL, cache rows bit-equal; ATTN_TOL)
  examples   EXAMPLE_RUNS, each a subprocess on the card: the port's
             device examples (ici_performance_torch with --stream, a
             plane that starts and every byte equal; mesh_collectives_torch
             with its merges' values and shapes; param_server_allreduce_
             torch with --codec none, equal to the dense sum, and int8,
             off it by more than 0 and within the bound;
             long_context_ring_torch, finite logits [2, 4096, 256];
             memcache_client_torch) and bench_torch.py --serving-arm
             auto,none --brief (streams completed, no error, balanced);
             then the plane's h2d, d2h and same-card d2d at PLANE_SIZES
             (4 KiB, 1 MiB, 8 MiB; host clock to the completed wait;
             across cards too where there are two) beside the bound (the
             PCIe link; 2 x bytes over HBM for d2d; NVLink one way
             across cards), torch's copy_ through a pinned host tensor
             and clone(), and torch doing the plane's own work (bytes
             in: frombuffer(...).to("cuda"); bytes out:
             .cpu().numpy().tobytes(); across cards .to("cuda:1")), with
             the pools' counters around the timed loop (no miss); one
             examples line with each run's seconds and numbers

Before the last line it prints the kernels' JSON line (with the HGMMA
count and ptxas registers and spills of each kernel's hd 64
instantiation, hd 8 for the fold's hd-8 rows, with their HMMA count;
the mesh_serving launches
and tp-shard checks on the decode and causal forward rows) and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside the repository, it exits 1 and prints
no result.

    python3 chip_smoke.py --serving-world

needs two or more cards of one host and runs only this: ServingEngine
over a world of one NCCL rank a card (entry.launch_world) at
ModelConfig()'s width, at each of WORLD_LAYOUTS the cards hold (tp 2,
tp 4, dp 2 x tp 2), in bf16 and f32, in SERVE_TURNS with a one-device
engine of the same seed on the leader's card: one serving_world line a
world (each engine's TTFT and inter-token p50, the streams of the two
engines compared and held equal in f32, every follower's device
operations and kernel launches), then the same last two lines.
"""

import json
import os
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor rate
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
# H100 SXM exponentials: 16 an SM a clock on the SFUs, at the 1.98 GHz
# of the f32 rate above (132 SMs x 128 lanes x 2 x 1.98e9 = 67e12)
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# o against the plain version: bf16 carries one rounding of o and of the
# plain version's softmax weights (largest error read on the card 0.0039);
# f32 the same sums in another order (read: 1.5e-7)
KERNEL_TOL = {"bf16": dict(atol=4e-3, rtol=1e-2),
              "f32": dict(atol=1e-5, rtol=1e-5)}
STEP_LOGITS_ATOL = 0.1        # bf16 through four layers
PREFILL_LEN = 300             # prompt length of the prefill comparison
GRAPH_LAUNCHES = 20           # launches captured in one timing graph
GRAPH_ROUNDS = 5              # replays of each graph, alternated
FLUSH_BYTES = 256 << 20       # read between launches: > 5x the 50 MB L2
PROFILE_STEPS = 8             # steady decode steps under torch.profiler
PROFILE_NEW_TOKENS = 400      # per profile client: outlasts the window
PROFILE_WINDOWS = 3           # profiler windows a kernel-name check takes


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph(fn, count):
    """A CUDA graph of `count` calls of fn, warmed up on a side stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(count):
            fn()
    torch.cuda.synchronize()
    return g


def _replay_ms(g) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, flush):
    """(L2-warm ms, L2-cold ms) of one call of fn on the device alone:
    the median over GRAPH_ROUNDS replays of a graph of GRAPH_LAUNCHES
    calls, and of the difference between a graph of [flush, fn] x K and
    one of [flush] x K, replayed in turns.  The flush reads FLUSH_BYTES,
    which evicts fn's inputs from the L2 and, unlike a write such as
    zero_(), leaves no dirty line for fn's reads to write back."""
    k = GRAPH_LAUNCHES
    warm = _graph(fn, k)
    both = _graph(lambda: (flush(), fn()), k)
    alone = _graph(flush, k)
    warm_ms, cold_ms = [], []
    for _ in range(GRAPH_ROUNDS):
        warm_ms.append(_replay_ms(warm) / k)
        a = _replay_ms(alone)
        b = _replay_ms(both)
        cold_ms.append((b - a) / k)
    return _p50(warm_ms), _p50(cold_ms)


def _cuda_tool(name: str) -> str:
    """A tool of the CUDA toolkit, else its copy in Triton's package."""
    import shutil
    for cand in (shutil.which(name),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", name)):
        if cand and os.path.exists(cand):
            return cand
    import triton
    return os.path.join(os.path.dirname(triton.__file__), "backends",
                        "nvidia", "bin", name)


def _kernel_names(mangled):
    """Each mangled kernel name as the demangler gives it, without return
    type, scope and parameters (as causal_dkdv_sm90<64> or
    causal_dkdv_kernel<float, 64>)."""
    import re
    filt = _cuda_tool("cu++filt")
    if not os.path.exists(filt):
        filt = "c++filt"
    plain = subprocess.run([filt, "-p", *mangled], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    assert len(plain) == len(mangled), (mangled, plain)
    names = [re.search(r"(\w+<.*>|\w+)$", d.replace("(int)", ""))
             for d in plain]
    return [m.group(1) if m else d for m, d in zip(names, plain)]


def sass_mma(lib_path):
    """({kernel: count of HGMMA (wgmma) instructions in its SASS},
    {kernel: count of HMMA (mma.sync) instructions, where it has some})."""
    out = subprocess.run([_cuda_tool("cuobjdump"), "-sass", lib_path],
                         capture_output=True, text=True, check=True).stdout
    funcs, counts = [], []
    for line in out.splitlines():
        if "Function :" in line:
            funcs.append(line.split("Function :", 1)[1].strip())
            counts.append([0, 0])
        elif funcs:
            counts[-1][0] += "HGMMA." in line
            counts[-1][1] += "HMMA." in line
    names = _kernel_names(funcs)
    return ({k: c[0] for k, c in zip(names, counts)},
            {k: c[1] for k, c in zip(names, counts) if c[1]})


def launched_kernels(fn, pattern, expected):
    """The sorted names matching `pattern` of the kernels one call of fn
    launches, read under torch.profiler.  A window that records a name
    outside `expected` is returned at once, and the caller's check fails
    on it; one that records only some of `expected` is taken again, at
    most PROFILE_WINDOWS windows: on an H100 the profiler has dropped a
    window's kernel records where the wrappers' launch counts show every
    launch (PERF.md, section 7)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({m.group(0) for e in prof.events()
                        for m in [re.search(pattern, e.name)] if m})
        if not set(names) < set(expected):
            return names
    return names


def ptxas_kernels(report):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from ptxas
    -v's report (bytes of spill stores and loads)."""
    import re
    funcs, props = [], []
    for line in report:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            funcs.append(m.group(1))
            props.append({})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props:
            props[-1]["spill_stores"] = int(m.group(1))
            props[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and props:
            props[-1]["registers"] = int(m.group(1))
    return dict(zip(_kernel_names(funcs), props))


def phase_card():
    import torch
    from brpc_tpu_torch import _native
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.monotonic()
    with ThreadPoolExecutor(2) as ex:
        core = ex.submit(_native.build_core)
        kernels = ex.submit(_native.build_kernels)
        core.result()
        kernels.result()
    with open(_native.PTXAS_REPORT) as f:   # ptxas -v, as it printed it
        ptxas = [ln.strip() for ln in f
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
    assert ptxas, "ptxas reported no kernel"
    hgmma, hmma = sass_mma(kernels.result())
    line = {"phase": "card", "nvidia_smi": smi,
            "device_name": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "build_s": dict(_native.build_seconds),
            "build_wall_s": time.monotonic() - t0,
            "ptxas": ptxas, "sass_hgmma": hgmma, "sass_hmma": hmma,
            "ptxas_by_kernel": ptxas_kernels(ptxas)}
    emit(line)
    tensor_core = {k: n for k, n in hgmma.items()
                   if k.startswith(("causal_fwd_sm90", "causal_dq_sm90",
                                    "causal_dkdv_sm90",
                                    "ring_fold_fwd_sm90_kernel",
                                    "ring_fold_dq_sm90_kernel",
                                    "ring_fold_dkdv_sm90_kernel"))}
    assert len(tensor_core) == 18 and all(tensor_core.values()), hgmma
    f32_cores = {k: p for k, p in line["ptxas_by_kernel"].items()
                 if k.startswith(("causal_fwd_f32_kernel",
                                  "causal_dq_f32_kernel",
                                  "causal_dkdv_f32_kernel",
                                  "ring_fold_fwd_f32_kernel",
                                  "ring_fold_dq_f32_kernel",
                                  "ring_fold_dkdv_f32_kernel"))}
    assert len(f32_cores) == 18 and not any(
        p.get("spill_stores") or p.get("spill_loads")
        for p in f32_cores.values()), f32_cores
    names = ("fwd", "bwd_dq", "bwd_dkdv")
    hd8 = [HD8_KERNELS["bf16"][n][1] for n in names]
    assert all(hmma.get(k) for k in hd8), hmma
    hd8 += [HD8_KERNELS["f32"][n][1] for n in names]
    assert not any(line["ptxas_by_kernel"][k].get("spill_stores") or
                   line["ptxas_by_kernel"][k].get("spill_loads")
                   for k in hd8), line["ptxas_by_kernel"]
    simt = [k for k in line["ptxas_by_kernel"]
            if k.startswith(("ring_fold_fwd_kernel<",
                             "ring_fold_dq_kernel<"))]
    assert not simt, f"SIMT fold kernels left: {simt}"
    return line


def _cu_current(cu):
    """The calling thread's current CUDA context (None: none)."""
    import ctypes
    ctx = ctypes.c_void_p()
    rc = cu.cuCtxGetCurrent(ctypes.byref(ctx))
    assert rc == 0, f"cuCtxGetCurrent: CUresult {rc}"
    return ctx.value


def _plane_roundtrip(data):
    from brpc_tpu_torch import tpu_plane
    buf = tpu_plane.h2d(data, device=0)
    buf.wait()
    assert buf.to_host() == data, "h2d -> d2h round trip differs"
    copy = tpu_plane.d2d(buf, 0)
    assert copy.to_host() == data, "d2d copy differs"
    copy.free()
    buf.free()


def _salted(n, salt):
    """n bytes of their own for each salt."""
    import numpy as np
    rng = np.random.default_rng(salt)
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _plane_steady_round(r):
    """One round of the plane phase's steady loop at each of
    PLANE_STEADY_SIZES, with bytes of this round's own: two h2d in flight
    at once; a d2d of the first, whose source is freed while the copy may
    still be pending; the second read back (h2d -> d2h), then the copy
    (d2d -> d2h).  Every result is compared with its round's bytes."""
    from brpc_tpu_torch import tpu_plane
    for n in PLANE_STEADY_SIZES:
        da, db = _salted(n, 2 * r), _salted(n, 2 * r + 1)
        a = tpu_plane.h2d(da, device=0)
        b = tpu_plane.h2d(db, device=0)
        ca = tpu_plane.d2d(a, 0)
        a.free()
        assert b.to_host() == db, f"h2d -> d2h differs: round {r}, {n} B"
        b.free()
        assert ca.to_host() == da, f"d2d differs: round {r}, {n} B"
        ca.free()


def phase_plane():
    """The plane's round trips, and the caller's CUDA state left as it
    was: torch's current device and this thread's context after init and
    a round trip, and no context on a thread that had none."""
    import ctypes

    import torch
    from brpc_tpu_torch import tpu_plane
    torch.zeros(1, device="cuda")     # torch's context current here
    cu = ctypes.CDLL("libcuda.so.1")  # the driver the plane binds
    device, ctx = torch.cuda.current_device(), _cu_current(cu)
    assert ctx is not None
    assert tpu_plane.init(), tpu_plane.error()
    assert tpu_plane.platform() == "cuda", tpu_plane.platform()
    assert tpu_plane.device_count() >= 1
    s0 = tpu_plane.stats()
    data = bytes(bytearray(range(256)) * 1024)
    _plane_roundtrip(data)
    held = (torch.cuda.current_device(), _cu_current(cu))
    assert held == (device, ctx), ("the plane moved the caller's CUDA "
                                   f"state: {held} != {(device, ctx)}")
    bare = []

    def no_context():
        bare.append(_cu_current(cu))
        _plane_roundtrip(data)
        bare.append(_cu_current(cu))

    t = threading.Thread(target=no_context)
    t.start()
    t.join(60)
    assert not t.is_alive() and bare == [None, None], bare
    # steady state: a warm round pools every block, then each round moves
    # bytes of its own, so a block handed out again before its copy landed
    # reads back another round's bytes
    _plane_steady_round(0)
    pools0 = tpu_plane.pool_stats()
    for r in range(1, PLANE_STEADY + 1):
        _plane_steady_round(r)
    pools1 = tpu_plane.pool_stats()
    steady = _pool_delta(pools0, pools1)
    for pool in ("device", "host"):
        assert steady[pool]["misses"] == 0, steady
        assert steady[pool]["hits"] >= PLANE_STEADY, steady
    s1 = tpu_plane.stats()
    assert s1["live_buffers"] == s0["live_buffers"], (s0, s1)
    assert s1["errors"] == s0["errors"], (s0, s1)
    emit({"phase": "plane", "platform": tpu_plane.platform(),
          "device_count": tpu_plane.device_count(), "stats": s1,
          "caller_state_held": {"current_device": device,
                                "context": True,
                                "bare_thread_context": None},
          "steady_rounds": PLANE_STEADY,
          "steady_sizes": list(PLANE_STEADY_SIZES), "steady_pools": steady,
          "pool_stats": pools1})


PLANE_STEADY = 50             # rounds of the plane phase's steady loop
PLANE_STEADY_SIZES = (4 << 10, 1 << 20, 8 << 20, 12345)  # and an odd size


def _pool_delta(before, after):
    """The pools' hits, misses, releases and retries between two
    tpu_plane.pool_stats() readings, and the bytes cached at the second."""
    return {pool: {k: after[pool][k] - (0 if k == "cached_bytes"
                                         else before[pool][k])
                   for k in after[pool]}
            for pool in ("device", "host")}


def phase_transport():
    from brpc_tpu_torch import tpu_plane
    from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
    from brpc_tpu_torch.rpc.controller import Controller
    from brpc_tpu_torch.rpc.server import Server
    srv = Server()
    srv.add_hbm_echo_service()
    srv.start("127.0.0.1:0")
    try:
        ch = Channel(f"tpu://0/0@127.0.0.1:{srv.port}",
                     ChannelOptions(max_retry=0, timeout_ms=60_000))
        data = bytes(bytearray(range(256)) * 1024)
        before = tpu_plane.stats()
        cntl = Controller()
        assert ch.call("HbmEcho", b"ping", attachment=data,
                       cntl=cntl) == b"ping"
        assert cntl.response_attachment == data, "attachment differs"
        state = ch.transport_state
        assert state == "device", state
        after = tpu_plane.stats()
        assert after["zero_copy_sends"] > before["zero_copy_sends"], \
            (before, after)
        ch.close()
    finally:
        srv.destroy()
    emit({"phase": "transport", "transport_state": state,
          "zero_copy_sends": after["zero_copy_sends"]
          - before["zero_copy_sends"]})


URING_SIZES = (1 << 20, 8 << 20)   # a slot of io_uring's pool; larger
URING_ROUNDS = 10                  # steady rounds after the slots' first use

# The uring phase's body, in a process of its own: the ring transport and
# SEND_ZC are process-wide switches the later phases must not inherit.
URING_CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch._native import lib
from brpc_tpu_torch.metrics.native import read_native_metrics as metrics_dump
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.server import Server
from brpc_tpu_torch.utils import flags

flags.set_flag("use_io_uring", True)
L = lib()
L.trpc_set_io_uring(1)
if not L.trpc_sendzc_available():
    print(json.dumps({"phase": "uring",
                      "skipped": "the kernel lacks IORING_OP_SEND_ZC"}))
    sys.exit(0)
srv = Server()
srv.add_hbm_echo_service()
srv.start("127.0.0.1:0")
assert tpu_plane.init(), tpu_plane.error()
ch = Channel(f"tpu://0/0@127.0.0.1:{srv.port}",
             ChannelOptions(max_retry=0, timeout_ms=60_000))


def settled():
    end = time.time() + 10
    c = metrics_dump()
    while (c["native_uring_sendzc_retired"] < c["native_uring_sendzc_submitted"]
           or c["native_uring_zc_pool_in_use"]) and time.time() < end:
        time.sleep(0.05)
        c = metrics_dump()
    return c


def one(n, salt):
    data = cs._salted(n, salt)
    t0 = time.perf_counter()
    b = tpu_plane.h2d(data, device=0)
    b.wait()
    t1 = time.perf_counter()
    assert b.to_host() == data, f"d2h differs: {n} B"
    t2 = time.perf_counter()
    b.free()
    cntl = Controller()
    assert ch.call("HbmEcho", b"x", attachment=data, cntl=cntl) == b"x"
    t3 = time.perf_counter()
    assert cntl.response_attachment == data, f"HbmEcho differs: {n} B"
    return {"h2d": (t1 - t0) * 1e3, "d2h": (t2 - t1) * 1e3,
            "echo": (t3 - t2) * 1e3}


# the slots' first use (their page-locking) and two more warm rounds
first = {n: one(n, n) for n in cs.URING_SIZES}
for r in range(2):
    for n in cs.URING_SIZES:
        one(n, 10 * r + n)
settled()
pools0, c0 = tpu_plane.pool_stats(), metrics_dump()
steady = {n: [one(n, 100 + r + n) for r in range(cs.URING_ROUNDS)]
          for n in cs.URING_SIZES}
c1, pools1 = settled(), tpu_plane.pool_stats()
ch.close()
srv.destroy()
line = {"phase": "uring", "sizes": list(cs.URING_SIZES),
        "rounds": cs.URING_ROUNDS,
        "first_use_ms": {str(n): t for n, t in first.items()},
        "steady_p50_ms": {str(n): {op: statistics.median(t[op] for t in ts)
                                   for op in ("h2d", "d2h", "echo")}
                          for n, ts in steady.items()},
        "slots": pools1["slots"], "host_pool": pools1["host"],
        "sendzc_fixed": c1["native_uring_sendzc_fixed"],
        "sendzc_fixed_steady": c1["native_uring_sendzc_fixed"]
        - c0["native_uring_sendzc_fixed"],
        "zc_pool_slots": c1["native_uring_zc_pool_slots"],
        "zc_pool_in_use": c1["native_uring_zc_pool_in_use"]}
print(json.dumps(line), flush=True)
assert line["sendzc_fixed"] >= 1, line
assert pools1["slots"] == pools0["slots"], (pools0["slots"], line)
assert pools0["slots"]["registered"] >= 1, pools0["slots"]
assert pools1["host"]["misses"] == pools0["host"]["misses"], line
assert line["zc_pool_in_use"] == 0, line
"""


def phase_uring():
    """The d2h landing zones on io_uring's registered slots (see the
    module's docstring); a kernel that refuses io_uring or SEND_ZC is
    reported on a line of its own, and the run goes on."""
    from brpc_tpu_torch._native import lib
    if not lib().trpc_io_uring_available():
        line = {"phase": "uring", "skipped": "the kernel refuses io_uring "
                                             "(trpc_io_uring_available() 0)"}
    else:
        here = os.path.dirname(os.path.abspath(__file__))
        r = subprocess.run([sys.executable, "-c", URING_CHILD, here],
                           env={**os.environ, "TRPC_SENDZC_FORCE": "1"},
                           capture_output=True, text=True, timeout=600)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        assert r.returncode == 0 and lines, \
            f"uring phase failed: {r.stdout[-2000:]} {r.stderr[-4000:]}"
        line = json.loads(lines[-1])
    if "skipped" in line:
        print(f"uring: skipped: {line['skipped']}", flush=True)
    emit(line)
    return line


def decode_attention_bound(N, H, hd, p, elt, kv=None):
    """(least ms, what bounds it): each input read once (q, k_new, v_new,
    the valid K/V window of this run's p, p itself), each output written
    once (o, the two appended rows); the products at the bf16 rate.  The
    caches and the new rows are counted at the `kv` KV heads (default H)."""
    kv = H if kv is None else kv
    window = sum(int(x) + 1 for x in p)
    nbytes = (2 * N * H * hd * elt + 4 * N * kv * hd * elt
              + 2 * window * kv * hd * elt + 4 * N)
    flops = 4 * window * H * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


KERNEL_SHAPE = (4, 1024, 8, 64)     # N, S, H, hd: ModelConfig(), 4 slots
# N, S, H, hd and the KV heads of LFM2-8B-A1B's served attention layers:
# 128 slots of 8192 positions, 32 query heads over 8 KV heads of 64
GQA_KERNEL_SHAPE = (128, 8192, 32, 64)
GQA_KV_HEADS = 8
WINDOWS = ("mixed", "full")


def kernel_inputs(g, dtype, window, shape=KERNEL_SHAPE, kv=None):
    """q, k_new, v_new, k_cache, v_cache, p at `shape` (N, S, H, hd),
    k_new, v_new and the caches at `kv` KV heads (default H), drawn from
    the CUDA generator g: p = [0, S-1, r1, ...] ("mixed") or [S-1] * N
    ("full")."""
    import torch
    N, S, H, hd = shape
    kv = H if kv is None else kv

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    rest = torch.randint(1, S - 1, (N - 2,), generator=g, device="cuda")
    p = torch.cat([torch.tensor([0, S - 1], device="cuda"),
                   rest]).to(torch.int32)
    if window == "full":
        p = torch.full((N,), S - 1, dtype=torch.int32, device="cuda")
    return (draw(N, H, hd), draw(N, kv, hd), draw(N, kv, hd),
            draw(N, S, kv, hd), draw(N, S, kv, hd), p)


def check_kernel(fn, g, window, shape=KERNEL_SHAPE, kv=None):
    """fn (the kernel's wrapper, or a call of another build of the kernel)
    against the plain version on the same inputs at `shape`, in f32 then
    bf16: the
    appended cache rows must be bit-equal.  Returns the bf16 inputs after
    the call, {dtype: max abs error of o} and {dtype: the largest
    |o - plain| / (atol + rtol |plain|) under KERNEL_TOL}: o is within
    the tolerance when that share is at most 1."""
    import torch
    from brpc_tpu_torch.ops.decode_attention import decode_attention_plain
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain f32 einsums
    errs, shares = {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = kernel_inputs(g, dtype, window, shape, kv)
        q, kn, vn, kc, vc, p = args
        kp, vp = kc.clone(), vc.clone()
        o = fn(*args).float()
        want = decode_attention_plain(q, kn, vn, kp, vp, p).float()
        torch.cuda.synchronize()
        assert torch.equal(kc, kp) and torch.equal(vc, vp), \
            f"{window} {name}: appended cache rows differ from the plain " \
            f"version"
        tol = KERNEL_TOL[name]
        diff = (o - want).abs()
        errs[name] = float(diff.max())
        shares[name] = float((diff / (tol["atol"] + tol["rtol"]
                                      * want.abs())).max())
    return args, errs, shares


def phase_kernel():
    import torch
    import torch.nn.functional as F
    from brpc_tpu_torch.ops.decode_attention import (decode_attention,
                                                     decode_attention_plain)
    N, S, H, hd = KERNEL_SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    one = torch.zeros(1, device="cuda")
    floor_ms, _ = device_ms(lambda: one.add_(1), flush_buf.sum)
    results = {}
    for window in WINDOWS:
        (q, kn, vn, kc, vc, p), errs, shares = check_kernel(
            decode_attention, g, window)               # bf16: timed
        assert max(shares.values()) <= 1.0, \
            f"{window}: o differs from the plain version by {errs} " \
            f"(tolerance {KERNEL_TOL})"
        ms, cold_ms = device_ms(
            lambda: decode_attention(q, kn, vn, kc, vc, p), flush_buf.sum)
        host_call_ms = cuda_ms(
            lambda: decode_attention(q, kn, vn, kc, vc, p), 200)
        plain_ms = cuda_ms(
            lambda: decode_attention_plain(q, kn, vn, kc, vc, p), 50)
        mask = (torch.arange(S, device="cuda")[None, :]
                <= p.long()[:, None])[:, None, None, :]
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        library_ms, library_cold_ms = device_ms(
            lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kt, vt, attn_mask=mask), flush_buf.sum)
        bound_ms, bound_by = decode_attention_bound(N, H, hd, p.tolist(), 2)
        r = {"window": {"name": window, "p": p.tolist()},
             "max_abs_err": errs["bf16"], "ms": ms,
             "cold_ms": cold_ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "library_cold_ms": library_cold_ms,
             "launch_floor_ms": floor_ms, "host_call_ms": host_call_ms,
             "bound_ms": bound_ms, "bound_by": bound_by}
        emit({"phase": "kernel", "name": "decode_attention",
              "shape": dict(zip(("N", "S", "H", "hd"), KERNEL_SHAPE)),
              "max_abs_err_by_dtype": errs, "share_of_tolerance": shares,
              "tolerance": KERNEL_TOL, "bound_share": bound_ms / cold_ms,
              **r})
        results[window] = r
    results["gqa"] = kernel_gqa(g, flush_buf.sum)
    return results


def kernel_gqa(g, flush):
    """The grouped-query leg of the kernel phase at GQA_KERNEL_SHAPE, each
    window checked (f32 and bf16, one launch a call) and timed in bf16
    -> {window: its line}."""
    import torch
    from brpc_tpu_torch.ops.decode_attention import decode_attention
    N, S, H, hd = GQA_KERNEL_SHAPE
    kv = GQA_KV_HEADS
    out = {}
    for window in WINDOWS:
        before = decode_attention.launches
        (q, kn, vn, kc, vc, p), errs, shares = check_kernel(
            decode_attention, g, window, GQA_KERNEL_SHAPE, kv)
        launches = decode_attention.launches - before
        assert launches == 2, f"gqa {window}: {launches} launches for " \
            f"the f32 and bf16 calls"
        assert max(shares.values()) <= 1.0, \
            f"gqa {window}: o differs from the plain version by {errs} " \
            f"(tolerance {KERNEL_TOL})"
        ms, cold_ms = device_ms(
            lambda: decode_attention(q, kn, vn, kc, vc, p), flush)
        bound_ms, bound_by = decode_attention_bound(N, H, hd, p.tolist(), 2,
                                                    kv)
        r = {"window": {"name": window, "p_max": int(p.max()),
                        "p_sum": int(p.sum())},
             "max_abs_err": errs["bf16"], "ms": ms, "cold_ms": cold_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "bound_share": bound_ms / cold_ms, "launches": launches}
        emit({"phase": "kernel", "name": "decode_attention_gqa",
              "shape": dict(zip(("N", "S", "H", "hd"), GQA_KERNEL_SHAPE),
                            KV=kv),
              "max_abs_err_by_dtype": errs, "share_of_tolerance": shares,
              "tolerance": KERNEL_TOL, **r})
        out[window] = r
        del q, kn, vn, kc, vc, p
        torch.cuda.empty_cache()
    return out


ATTN_SHAPE = (8, 1024, 8, 64)    # B, S, H, hd: one layer of the train step
ATTN_RAGGED_S = 1000
# o, dq, dk, dv against the plain version: a flip of one bf16 rounding of
# a score, weight, dW or dS moves an output by about one weight step
# times |v| (largest reading 0.0078); f32 the same sums in another order
# (largest reading 1.9e-6)
ATTN_TOL = {"bf16": dict(atol=1e-2, rtol=2e-2),
            "f32": dict(atol=1e-5, rtol=1e-5)}
ATTN_OUTPUTS = ("o", "dq", "dk", "dv")
ATTN_PREFILL_SHAPE = (1, 256, 8, 64)   # one prefill of a 256-token prompt


def attention_bounds(B, S, H, hd, elt, flops=BF16_FLOPS):
    """{kernel: (least ms, what bounds it)}: each input read once and
    each output written once (n: one [B, S, H, hd] tensor, rows: one
    [B, H, S] f32 row statistic), the products of the causal half (pairs
    t <= s) at the rate `flops` (bf16 on the tensor cores; f32 on the
    CUDA cores, since TF32 keeps too few bits for the f32 checks).  fwd: q, k, v -> o, lse with q.k and w.v;
    bwd_dq: q, k, v, dO, lse -> dq, D with q.k, dO.v and dS.k; bwd_dkdv:
    q, k, v, dO, lse, D -> dk, dv with q.k, dO.v, p.dO and dS.q; bwd (the
    backward as one function): q, k, v, o, dO -> dq, dk, dv with five
    products; fwd_bwd: q, k, v, dO -> dq, dk, dv with seven."""
    n, rows = B * S * H * hd * elt, B * H * S * 4
    mac = 2 * hd * B * H * S * (S + 1) // 2     # flops of one product

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")
    return {"fwd": bound(4 * n + rows, 2 * mac),
            "bwd_dq": bound(5 * n + 2 * rows, 3 * mac),
            "bwd_dkdv": bound(6 * n + 2 * rows, 4 * mac),
            "bwd": bound(8 * n, 5 * mac),
            "fwd_bwd": bound(7 * n, 7 * mac)}


def attention_grads(fn, q, k, v, do):
    """[o, dq, dk, dv] of fn(q, k, v) with cotangent do, as f32."""
    import torch
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o = fn(*leaves)
    return [o.detach().float()] + [
        t.float() for t in torch.autograd.grad(o, leaves, do)]


def _lse_plain(q, k):
    """[B, H, S]: the log-sum-exp of each row's masked f32 scores (the
    product in the working type, as the plain version takes it)."""
    import torch
    S, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bshk,bthk->bhst", q, k).float() / hd ** 0.5
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    return torch.logsumexp(s.masked_fill(~mask, -1e30), dim=-1)


def check_attention(g):
    """The kernels (CausalAttention) against the plain version's autograd
    on the same inputs, at ATTN_SHAPE and at S = ATTN_RAGGED_S, in f32
    and bf16, and the forward's lse against the rows' log-sum-exp:
    {case: {output: max abs error}} and {case: {output: largest
    |got - plain| / (atol + rtol |plain|)}} under ATTN_TOL."""
    import torch
    from brpc_tpu_torch.ops.causal_attention import (CausalAttention,
                                                     causal_attention_forward,
                                                     causal_attention_plain)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain f32 einsums
    B, _, H, hd = ATTN_SHAPE
    errs, shares = {}, {}
    for S in (ATTN_SHAPE[1], ATTN_RAGGED_S):
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            args = [torch.randn(B, S, H, hd, generator=g,
                                device="cuda").to(dtype) for _ in range(4)]
            got = attention_grads(CausalAttention.apply, *args)
            want = attention_grads(causal_attention_plain, *args)
            got.append(causal_attention_forward(*args[:3])[1])
            want.append(_lse_plain(*args[:2]))
            torch.cuda.synchronize()
            tol = ATTN_TOL[name]
            case = f"{name}_S{S}"
            errs[case], shares[case] = {}, {}
            for out, a, w in zip(ATTN_OUTPUTS + ("lse",), got, want):
                diff = (a - w).abs()
                errs[case][out] = float(diff.max())
                shares[case][out] = float(
                    (diff / (tol["atol"] + tol["rtol"] * w.abs())).max())
            del got, want, args
    return errs, shares


# the kernels each dtype's causal attention launches, by name
ATTN_ROUTES = {"bf16": ["causal_dkdv_sm90", "causal_dq_sm90",
                        "causal_fwd_sm90"],
               "f32": ["causal_dkdv_f32_kernel", "causal_dq_f32_kernel",
                       "causal_fwd_f32_kernel"]}


def attention_routes(g):
    """{dtype: the causal_attention kernels that one forward and backward
    through CausalAttention launched}, read from the device's kernel
    names under torch.profiler (at B=1, S=130, H=2, hd=64;
    launched_kernels)."""
    import torch

    from brpc_tpu_torch.ops.causal_attention import CausalAttention
    routes = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        args = [torch.randn(1, 130, 2, 64, generator=g,
                            device="cuda").to(dtype) for _ in range(4)]
        routes[name] = launched_kernels(
            lambda: attention_grads(CausalAttention.apply, *args),
            r"causal_\w+", ATTN_ROUTES[name])
    return routes


def phase_attention():
    """causal_attention's three kernels: checked against the plain
    version, then timed in bf16 at ATTN_SHAPE on the device alone (as
    decode_attention: L2-warm ms and L2-cold cold_ms), each beside its
    bound, the plain version's time (CUDA events around its calls), the
    wrapper's host-inclusive time and scaled_dot_product_attention(
    is_causal=True) on the same inputs; the forward and dq also at one
    prefill's shape (ATTN_PREFILL_SHAPE: device ms and host-inclusive
    ms); then the kernels each dtype launches (attention_routes)."""
    import torch
    import torch.nn.functional as F
    from brpc_tpu_torch.ops.causal_attention import (
        CausalAttention, causal_attention_backward_dkdv,
        causal_attention_backward_dq, causal_attention_forward,
        causal_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(3)
    errs, shares = check_attention(g)
    emit({"phase": "attention_check", "shape": ATTN_SHAPE,
          "ragged_S": ATTN_RAGGED_S, "max_abs_err": errs,
          "share_of_tolerance": shares, "tolerance": ATTN_TOL})
    bad = {c: v for c, sh in shares.items() for o, v in sh.items() if v > 1}
    assert not bad, f"causal_attention differs from the plain version: {bad}"

    B, S, H, hd = ATTN_SHAPE
    q, k, v, do = (torch.randn(B, S, H, hd, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    flush_buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    flush = flush_buf.sum
    _, lse = causal_attention_forward(q, k, v)
    _, delta = causal_attention_backward_dq(q, k, v, do, lse)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def fwd_bwd(fn, cot):
        return lambda: torch.autograd.grad(fn(*leaves), leaves, cot)

    def sdpa(*a):
        return F.scaled_dot_product_attention(*a, is_causal=True)

    def sdpa_bshk(*a):        # [B, S, H, hd] through [B, H, S, hd] views
        return sdpa(*(x.transpose(1, 2) for x in a)).transpose(1, 2)

    t = {"fwd": device_ms(lambda: causal_attention_forward(q, k, v), flush),
         "bwd_dq": device_ms(
             lambda: causal_attention_backward_dq(q, k, v, do, lse), flush),
         "bwd_dkdv": device_ms(
             lambda: causal_attention_backward_dkdv(q, k, v, do, lse, delta),
             flush),
         "fwd_bwd": device_ms(fwd_bwd(CausalAttention.apply, do), flush),
         "sdpa_fwd": device_ms(lambda: sdpa_bshk(q, k, v), flush),
         "sdpa_fwd_bwd": device_ms(fwd_bwd(sdpa_bshk, do), flush)}
    host_call = {
        "fwd": cuda_ms(lambda: causal_attention_forward(q, k, v), 200),
        "bwd_dq": cuda_ms(
            lambda: causal_attention_backward_dq(q, k, v, do, lse), 200),
        "bwd_dkdv": cuda_ms(
            lambda: causal_attention_backward_dkdv(q, k, v, do, lse, delta),
            200)}
    # at one prefill's shape the kernels take microseconds, so the
    # wrapper's host work (checks, tensor maps, ctypes) shows
    pq, pk, pv, pdo = (torch.randn(*ATTN_PREFILL_SHAPE, generator=g,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
    _, plse = causal_attention_forward(pq, pk, pv)
    prefill = {
        "fwd": (device_ms(lambda: causal_attention_forward(pq, pk, pv),
                          flush)[0],
                cuda_ms(lambda: causal_attention_forward(pq, pk, pv), 200)),
        "bwd_dq": (device_ms(lambda: causal_attention_backward_dq(
            pq, pk, pv, pdo, plse), flush)[0], cuda_ms(
                lambda: causal_attention_backward_dq(pq, pk, pv, pdo, plse),
                200))}
    plain_fwd = cuda_ms(lambda: causal_attention_plain(q, k, v), 10)
    plain_fwd_bwd = cuda_ms(fwd_bwd(causal_attention_plain, do), 5)
    bounds = attention_bounds(B, S, H, hd, 2)
    # the backward alone (the library's and the plain version's): fwd+bwd
    # less fwd, L2-warm
    sdpa_bwd = t["sdpa_fwd_bwd"][0] - t["sdpa_fwd"][0]
    sdpa_bwd_cold = t["sdpa_fwd_bwd"][1] - t["sdpa_fwd"][1]
    plain_bwd = plain_fwd_bwd - plain_fwd
    rows = {}
    for name, library, library_cold, plain in (
            ("fwd", t["sdpa_fwd"][0], t["sdpa_fwd"][1], plain_fwd),
            ("bwd_dq", sdpa_bwd, sdpa_bwd_cold, plain_bwd),
            ("bwd_dkdv", sdpa_bwd, sdpa_bwd_cold, plain_bwd)):
        ms, cold_ms = t[name]
        bound_ms, bound_by = bounds[name]
        rows[name] = {"ms": ms, "cold_ms": cold_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "bound_share": bound_ms / cold_ms,
                      "library_ms": library, "library_cold_ms": library_cold,
                      "plain_ms": plain, "host_call_ms": host_call[name]}
        if name in prefill:
            rows[name]["prefill_ms"], rows[name]["prefill_host_call_ms"] = \
                prefill[name]
    rows_f32 = f32_attention_rows(q, k, v, do, flush, sdpa_bshk)
    routes = attention_routes(g)  # read after the timings: no profiler in them
    emit({"phase": "attention", "name": "causal_attention",
          "shape": dict(zip(("B", "S", "H", "hd"), ATTN_SHAPE)),
          "dtype": "bf16", "kernels": rows, "kernels_f32": rows_f32,
          "kernels_by_dtype": routes,
          "prefill_shape": dict(zip(("B", "S", "H", "hd"),
                                    ATTN_PREFILL_SHAPE)),
          "fwd_bwd_ms": t["fwd_bwd"][0], "fwd_bwd_cold_ms": t["fwd_bwd"][1],
          "fwd_bwd_bound": bounds["fwd_bwd"], "bwd_bound": bounds["bwd"],
          "sdpa_fwd_bwd_ms": t["sdpa_fwd_bwd"][0],
          "sdpa_fwd_bwd_cold_ms": t["sdpa_fwd_bwd"][1],
          "plain_fwd_bwd_ms": plain_fwd_bwd,
          "library": "torch.nn.functional.scaled_dot_product_attention("
                     "is_causal=True); its backward and the plain "
                     "version's: fwd+bwd less fwd"})
    assert routes == ATTN_ROUTES, routes
    return {"errs": errs, "rows": rows, "rows_f32": rows_f32}


def f32_attention_rows(q, k, v, do, flush, sdpa_bshk):
    """The f32 route (the forward, dq and dk/dv of
    csrc/causal_attention_f32.cu) timed at the same
    shape like the bf16 one: {kernel: row} with its bound at the f32
    CUDA-core rate, the plain version, SDPA in f32 (the backward: fwd+bwd
    less fwd) and the wrapper's host-inclusive time."""
    import torch
    from brpc_tpu_torch.ops.causal_attention import (
        causal_attention_backward_dkdv, causal_attention_backward_dq,
        causal_attention_forward, causal_attention_plain)
    q, k, v, do = (t.float() for t in (q, k, v, do))
    _, lse = causal_attention_forward(q, k, v)
    _, delta = causal_attention_backward_dq(q, k, v, do, lse)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(*leaves), leaves, do)

    calls = {"fwd": lambda: causal_attention_forward(q, k, v),
             "bwd_dq": lambda: causal_attention_backward_dq(q, k, v, do,
                                                            lse),
             "bwd_dkdv": lambda: causal_attention_backward_dkdv(
                 q, k, v, do, lse, delta)}
    t = {name: device_ms(fn, flush) for name, fn in calls.items()}
    sdpa_fwd = device_ms(lambda: sdpa_bshk(q, k, v), flush)
    sdpa_fwd_bwd = device_ms(fwd_bwd(sdpa_bshk), flush)
    plain_fwd = cuda_ms(lambda: causal_attention_plain(q, k, v), 5)
    plain_bwd = cuda_ms(fwd_bwd(causal_attention_plain), 3) - plain_fwd
    bounds = attention_bounds(*q.shape, 4, flops=F32_FLOPS)
    rows = {}
    for name, library, plain in (
            ("fwd", sdpa_fwd[0], plain_fwd),
            ("bwd_dq", sdpa_fwd_bwd[0] - sdpa_fwd[0], plain_bwd),
            ("bwd_dkdv", sdpa_fwd_bwd[0] - sdpa_fwd[0], plain_bwd)):
        ms, cold_ms = t[name]
        bound_ms, bound_by = bounds[name]
        rows[name] = {"ms": ms, "cold_ms": cold_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by,
                      "bound_share": bound_ms / cold_ms,
                      "library_ms": library, "plain_ms": plain,
                      "host_call_ms": cuda_ms(calls[name], 20)}
    return rows


TRAIN_MOE = dict(n_experts=4, moe_every=2, moe_topk=1)
TRAIN_TOKENS = (8, 1025)     # B x (S + 1): S = 1024 = max_seq
TRAIN_LR = 1e-2
TRAIN_STEPS = 5
# one step through the kernels against one through the plain version,
# from the same state, in the working type and in f32: the loss within
# LOSS_RTOL, each gradient's ||kernel - plain|| / ||plain|| within
# GRAD_REL.  f32 is the check of the kernels inside the model (largest
# reading 1.7e-6).  In bf16 one flipped rounding in attention makes every
# later bf16 rounding its own, so the two gradients differ at the bf16
# noise level of the whole step (largest reading 0.060).  A parameter
# whose plain gradient stays below GRAD_FLOOR of the largest gradient
# element anywhere is printed but not held: the top-1 router, whose gates
# renormalise to 1, so that its gradient (~3e-10) comes only through the
# 1e-9 of the renormalisation.
LOSS_RTOL = {"bf16": 1e-3, "f32": 1e-5}
GRAD_REL = {"bf16": 0.1, "f32": 1e-4}
GRAD_FLOOR = 1e-6


def _twin_steps(cfg, tokens):
    """One AdamW step from a fresh seeded state through the kernels and
    one from a copy of it through the plain version: (the kernel-stepped
    state, loss through the kernels, loss through the plain version,
    {parameter: [max |kernel - plain| / max |plain|,
    ||kernel - plain|| / ||plain||, max |plain|]} of the gradients)."""
    import torch

    from brpc_tpu_torch import weights
    from brpc_tpu_torch.models import train
    from brpc_tpu_torch.models import transformer as T
    from brpc_tpu_torch.ops.causal_attention import causal_attention_plain
    tx, step = train.make_train_step(cfg, lr=TRAIN_LR, device="cuda")
    model = T.init(torch.Generator().manual_seed(0), cfg, "cuda")
    state = train.TrainState(model, tx(model),
                             torch.zeros((), dtype=torch.int32))
    twin = weights.train_state_from_jax(
        weights.train_state_to_flat(state), cfg, lr=TRAIN_LR, device="cuda")
    state, loss_kernel = step(state, tokens)
    saved = T.causal_attention
    T.causal_attention = causal_attention_plain
    try:
        twin, loss_plain = step(twin, tokens)
    finally:
        T.causal_attention = saved
    grads = {}
    for (name, p), (_, pp) in zip(state.params.named_parameters(),
                                  twin.params.named_parameters()):
        d, top = p.grad - pp.grad, pp.grad.abs().max()
        grads[name] = [float(d.abs().max() / top),
                       float(d.norm() / pp.grad.norm()), float(top)]
    return state, loss_kernel.item(), loss_plain.item(), grads


def phase_train():
    """The training path at the full width of ModelConfig() with the
    reference's MoE setting (layers 1 and 3 MoE): one AdamW step through
    the kernels and one through the plain version from the same state,
    in bf16 and in f32; TRAIN_STEPS kernel steps on a fixed seeded batch
    (the main path: the launch counts are read over it), the loss must
    fall; save, restore into a fresh state, one more step on each: the
    same loss and step 7; a torch.profiler window over one more step."""
    import dataclasses
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from brpc_tpu_torch.models import checkpoint, train
    from brpc_tpu_torch.models import transformer as T
    from brpc_tpu_torch.ops.causal_attention import (
        causal_attention_backward_dkdv, causal_attention_backward_dq,
        causal_attention_forward)
    from brpc_tpu_torch.ops.decode_attention import decode_attention

    cfg = T.ModelConfig(**TRAIN_MOE)
    assert [cfg.is_moe(i) for i in range(cfg.n_layers)] == \
        [False, True, False, True]
    tx, step = train.make_train_step(cfg, lr=TRAIN_LR, device="cuda")

    def fresh(seed):
        model = T.init(torch.Generator().manual_seed(seed), cfg, "cuda")
        return train.TrainState(model, tx(model),
                                torch.zeros((), dtype=torch.int32))

    tokens = torch.randint(0, cfg.vocab, TRAIN_TOKENS,
                           generator=torch.Generator().manual_seed(2))
    tokens = tokens.to("cuda")

    # 1. the kernels against the plain version, one step each, from the
    #    same state: in f32 (then dropped), and in bf16, whose kernel-
    #    stepped state goes on
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = (causal_attention_forward, causal_attention_backward_dq,
                causal_attention_backward_dkdv)
    twins = {}
    for c in counters:
        c.launches = 0
    _, *twins["f32"] = _twin_steps(
        dataclasses.replace(cfg, dtype=torch.float32), tokens)
    f32_launches = {c.__name__: c.launches for c in counters}
    state, *twins["bf16"] = _twin_steps(cfg, tokens)
    loss_kernel = twins["bf16"][0]
    held = {}
    for dt, (_, _, grads) in twins.items():
        floor = GRAD_FLOOR * max(g[2] for g in grads.values())
        held[dt] = [n for n, g in grads.items() if g[2] >= floor]
    torch.cuda.empty_cache()
    # 2. the main path: TRAIN_STEPS kernel steps, counted and timed
    for c in counters:
        c.launches = 0
    decode_attention.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        losses.append(loss.item())          # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    # 3. save, restore into a fresh state, one more step on each
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        t0 = time.perf_counter()
        nbytes = checkpoint.save(path, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = checkpoint.restore(path, fresh(1))
        restore_s = time.perf_counter() - t0
    assert int(restored.step) == int(state.step) == 1 + TRAIN_STEPS
    state, loss_next = step(state, tokens)
    restored, loss_restored = step(restored, tokens)
    assert int(restored.step) == int(state.step) == 7

    # 4. one more step under torch.profiler
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        restored, _ = step(restored, tokens)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    prof_line = device_profile(prof, window_us)
    by_name = prof_line.pop("_by_name", {})
    attn_us = sum(v[1] for k, v in by_name.items() if "causal_" in k)

    line = {"phase": "train", "device_name": torch.cuda.get_device_name(0),
            "config": dict(vocab=cfg.vocab, d_model=cfg.d_model,
                           n_heads=cfg.n_heads, n_layers=cfg.n_layers,
                           d_ff=cfg.d_ff, max_seq=cfg.max_seq, **TRAIN_MOE),
            "tokens_shape": TRAIN_TOKENS, "lr": TRAIN_LR,
            "twin_steps": {dt: {"loss_kernel": lk, "loss_plain": lp,
                                "grads": grads}
                           for dt, (lk, lp, grads) in twins.items()},
            "twin_grads_held": {dt: sorted(held[dt]) for dt in held},
            "losses": [loss_kernel] + losses,
            "step_ms": step_ms, "step_ms_p50": _p50(step_ms),
            "tokens_per_s": (TRAIN_TOKENS[0] * (TRAIN_TOKENS[1] - 1))
            / (_p50(step_ms) / 1e3),
            "peak_mem_bytes": peak, "launches": launches,
            "f32_twin_launches": f32_launches,
            "decode_attention_launches": decode_attention.launches,
            "checkpoint_bytes": nbytes, "save_s": save_s,
            "restore_s": restore_s, "loss_next": loss_next.item(),
            "loss_restored": loss_restored.item(),
            "profile": {**prof_line,
                        "causal_attention_device_ms": attn_us / 1e3}}
    emit(line)
    for dt, (lk, lp, grads) in twins.items():
        assert abs(lk - lp) <= LOSS_RTOL[dt] * abs(lp), (dt, lk, lp)
        bad = {n: grads[n] for n in held[dt] if grads[n][1] > GRAD_REL[dt]}
        assert not bad, (dt, bad)
    assert all(x == x and x > 0 for x in losses), losses
    assert losses[-1] < loss_kernel, (loss_kernel, losses)
    assert loss_next.item() == loss_restored.item(), \
        (loss_next.item(), loss_restored.item())
    want = TRAIN_STEPS * cfg.n_layers
    assert all(n == want for n in launches.values()), launches
    assert decode_attention.launches == 0
    return launches, f32_launches


# The parameter-server gradient: sum of resnet50_param_shapes()
# (examples/param_server_allreduce.py:49), ResNet-50's parameter count.
PS_PARAMS = 25_557_032
ALLREDUCE_MBYTES = 64         # bf16 all_reduce timed at world size 1


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _codec_cases(g):
    """{name: f32 tensor on the card}: the parameter-server gradient and
    the ragged, short, denormal and ties cases of the CPU tests."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    special = np.zeros((5, 256), np.float32)
    special[1] = 1e-40
    special[2] = 1e-37
    special[2, 3] = 2e-37
    special[3] = rng.standard_normal(256)
    special[3, :40] = 3e-41
    ties = np.zeros((1, 256), np.float32)
    ties[0, 0] = 127.0
    ties[0, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    cases = {"ragged": rng.standard_normal((3, 700)),
             "short": rng.standard_normal((2, 17)),
             "zero_and_denormal": special, "ties": ties}
    cases = {k: torch.from_numpy(np.asarray(v, np.float32)).cuda()
             for k, v in cases.items()}
    cases["param_server"] = torch.randn(PS_PARAMS, generator=g,
                                        device="cuda")
    return cases


def _bit_equal(a, b) -> bool:
    """The same shape, dtype and bits (-0.0 is not 0.0 here)."""
    import torch
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(view), b.view(view)))


def phase_parallel(smi):
    """The mesh, the collectives and the combo channels on NCCL at world
    size 1, and the int8 codec kernel against its plain version."""
    import torch
    import torch.distributed as dist

    from brpc_tpu_torch.ops.quant_codec import (fake_quant_int8,
                                                fake_quant_int8_plain)
    from brpc_tpu_torch.parallel import (MeshParallelChannel,
                                         MeshPartitionChannel, collectives,
                                         make_mesh, quantize)

    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        backend = dist.get_backend()
        assert backend == "nccl", backend
        mesh = make_mesh({"dp": 1}, device_type="cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(8, 64, generator=g, device="cuda")
        c = collectives
        # every verb once: over one member each result is known
        got = {
            "all_reduce_add": (c.all_reduce(mesh, "dp", x), x),
            "all_reduce_max": (c.all_reduce(mesh, "dp", x, op="max"), x),
            "all_reduce_min": (c.all_reduce(mesh, "dp", x, op="min"), x),
            "all_gather_tiled": (c.all_gather(mesh, "dp", x), x),
            "all_gather_stacked": (c.all_gather(mesh, "dp", x,
                                                tiled=False), x[None]),
            "reduce_scatter": (c.reduce_scatter(mesh, "dp", x), x),
            "ring_permute": (c.ring_permute(mesh, "dp", x, shift=1), x),
            "all_to_all": (c.all_to_all(mesh, "dp", x), x),
        }
        add = MeshParallelChannel(mesh, "dp", merger="add")
        cat = MeshParallelChannel(mesh, "dp", merger="concat")
        part = MeshPartitionChannel(mesh, "dp")
        assert add.channel_count() == part.partition_count() == 1
        got.update({
            "channel_add": (add.call_tensor(x), x),
            "channel_concat": (cat.call_tensor(x), x),
            "channel_add_int8": (
                MeshParallelChannel(mesh, "dp", merger="add",
                                    codec="int8").call_tensor(x),
                fake_quant_int8_plain(x)),
            "partition_gather": (part.call_gather(x), x),
            "partition_reduce_scatter": (part.call_reduce_scatter(x), x),
            "partition_all_to_all": (part.call_all_to_all(x), x)})
        torch.cuda.synchronize()
        verbs = {k: _bit_equal(a, b) for k, (a, b) in got.items()}
        assert all(verbs.values()), verbs

        # the main path: the parameter-server merge through the int8 codec
        cases = _codec_cases(g)
        grad = cases["param_server"]
        ps = MeshParallelChannel(mesh, "dp", merger="add", codec="int8")
        fake_quant_int8.launches = 0
        merged = ps.call_tensor(grad)
        torch.cuda.synchronize()
        launches = fake_quant_int8.launches
        assert launches >= 1, launches
        ps_err = float((merged - grad).abs().max())
        ps_bound = quantize.int8_error_bound(grad)
        assert 0.0 < ps_err <= ps_bound, (ps_err, ps_bound)

        # the kernel against its plain version, bit for bit
        checks = {}
        for name, t in cases.items():
            for dt, dtype in (("f32", torch.float32),
                              ("bf16", torch.bfloat16)):
                xt = t.to(dtype)
                out, want = fake_quant_int8(xt), fake_quant_int8_plain(xt)
                err = float((out.float() - xt.float()).abs().max())
                checks[f"{name}/{dt}"] = {
                    "bit_equal": _bit_equal(out, want), "int8_err": err,
                    "int8_bound": quantize.int8_error_bound(xt.float())}
        torch.cuda.synchronize()
        bad = {k: v for k, v in checks.items()
               if not v["bit_equal"]
               or not v["int8_err"] <= v["int8_bound"]}
        assert not bad, bad

        # times at the parameter-server size, f32 and bf16
        flush_buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
        timing = {}
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            xt = grad.to(dtype)
            ms, cold_ms = device_ms(lambda: fake_quant_int8(xt),
                                    flush_buf.sum)
            nbytes = 2 * xt.numel() * xt.element_size()
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            timing[dt] = {
                "ms": ms, "cold_ms": cold_ms, "bound_ms": bound_ms,
                "bound_by": "bytes", "bound_share": bound_ms / cold_ms,
                "plain_ms": cuda_ms(lambda: fake_quant_int8_plain(xt), 10),
                "host_call_ms": cuda_ms(lambda: fake_quant_int8(xt), 50)}
        del flush_buf

        # NCCL all_reduce of 64 MB bf16 at world size 1: a time, not a
        # bandwidth (bus_bandwidth_gbps is 0 over one member by its formula)
        y = torch.ones(ALLREDUCE_MBYTES * 10**6 // 2, dtype=torch.bfloat16,
                       device="cuda")
        grp = mesh.group("dp")
        allreduce_ms = cuda_ms(lambda: dist.all_reduce(y, group=grp), 10)
        busbw = collectives.bus_bandwidth_gbps(mesh, "dp",
                                               ALLREDUCE_MBYTES, iters=10)
        assert busbw == 0.0, busbw
        emit({"phase": "parallel_collectives", "backend": backend,
              "mesh": mesh.shape, "world_size": dist.get_world_size(),
              "checks": verbs,
              "all_reduce_bf16_mbytes": ALLREDUCE_MBYTES,
              "all_reduce_ms": allreduce_ms, "bus_bandwidth_gbps": busbw,
              "nvidia_smi": smi})
        line = {"phase": "parallel", "name": "fake_quant_int8",
                "device_name": torch.cuda.get_device_name(0),
                "nvidia_smi": smi, "values": PS_PARAMS,
                "launches": launches, "param_server_int8_err": ps_err,
                "param_server_int8_bound": ps_bound,
                "checks": checks, "library": "none", "library_ms": None,
                **timing["f32"], "bf16": timing["bf16"]}
        emit(line)
        return line
    finally:
        dist.destroy_process_group()


# The ring fold (csrc/ring_fold*.cu).  One block at the full width of the
# train phase's attention (B=8, C=1024, H=8, hd=64: the ring's only block
# on one card), and blocks of C=256 at (idx, src) = (2, 2) diagonal, (3, 1)
# past and (1, 3) wholly future, which a causal fold skips with no launch.
RING_SHAPE = (8, 1024, 8, 64)
RING_SMALL = (2, 256, 8, 64)
RING_BLOCKS = ((2, 2), (3, 1), (1, 3))
# head dim 8, the reference tests' (in bf16 csrc/ring_fold_hd8.cu's
# forward, dq and dk/dv; in f32 csrc/ring_fold_f32_hd8.cu's):
# ModelConfig()'s d_model 512 as 64 heads of 8, the full-width causal
# block and a C=256 block in the past, (3, 1)
RING_HD8 = (8, 1024, 64, 8)
RING_HD8_SMALL = (2, 256, 64, 8)
# kernels against the plain version: f32 the same sums in another order;
# bf16 the same roundings, but a sum in another order can flip one of
# them, and a flipped dS moves a row of dq (or a column of dk) by one
# bf16 step of dS times |k|: at most RING_FLIP_SHARE of the elements may
# leave RING_TOL, and none RING_FLIP_TOL (tests/test_torch_ring_fold.py)
RING_TOL = {"bf16": dict(atol=1e-2, rtol=2e-2),
            "f32": dict(atol=1e-5, rtol=1e-5)}
RING_FLIP_SHARE = 1e-4
RING_FLIP_TOL = dict(atol=4e-2, rtol=8e-2)
# exact scores: with q and k of entries in {-1, 0, 1} every score is the
# same bits in the kernels and the plain version, so the bf16 kernels'
# m, l, o and dv (p's f32 products as f32 FMAs) hold the plain version's
# f32 within EXACT_TOL, the same sums in another order; p rounded once to
# bf16 (the control) must leave it
EXACT_TOL = dict(atol=1e-5, rtol=1e-5)
# the kernels one RingAttention forward and backward launches, by dtype
RING_ROUTES = {"bf16": ["ring_fold_dkdv_sm90_kernel",
                        "ring_fold_dq_sm90_kernel",
                        "ring_fold_fwd_sm90_kernel"],
               "f32": ["ring_fold_dkdv_f32_kernel", "ring_fold_dq_f32_kernel",
                       "ring_fold_fwd_f32_kernel"],
               "hd8_bf16": ["ring_fold_dkdv_hd8_kernel",
                            "ring_fold_dq_hd8_kernel",
                            "ring_fold_fwd_hd8_kernel"],
               "hd8_f32": ["ring_fold_dkdv_f32_hd8_kernel",
                           "ring_fold_dq_f32_hd8_kernel",
                           "ring_fold_fwd_f32_hd8_kernel"]}
# the kernel behind each hd-8 row of the kernels line: (source, kernel as
# ptxas and cuobjdump name it), by dtype and wrapper
HD8_KERNELS = {
    "bf16": {"fwd": ("ring_fold_hd8.cu", "ring_fold_fwd_hd8_kernel"),
             "bwd_dq": ("ring_fold_hd8.cu", "ring_fold_dq_hd8_kernel"),
             "bwd_dkdv": ("ring_fold_hd8.cu", "ring_fold_dkdv_hd8_kernel")},
    "f32": {"fwd": ("ring_fold_f32_hd8.cu", "ring_fold_fwd_f32_hd8_kernel"),
            "bwd_dq": ("ring_fold_f32_hd8.cu", "ring_fold_dq_f32_hd8_kernel"),
            "bwd_dkdv": ("ring_fold_f32_hd8.cu",
                         "ring_fold_dkdv_f32_hd8_kernel")}}
MESH_AXES = {"dp": 1, "ep": 1, "sp": 1, "tp": 1}


def fold_bounds(B, C, H, hd, elt):
    """{kernel: (least ms, what bounds it, what bounds the operations)}
    of one causal diagonal block: each input read once, each output
    written once (the f32 state and accumulators are both: n one [B, C,
    H, hd] tensor, acc one f32 [B, H, C, hd], rows one f32 [B, H, C]);
    the products over the causal half: those of the working type's
    values (q.k, dO.v, dS.k, dS^T.q) at its rate, bf16 on the tensor
    cores; p.v and P^T.dO, f32 products of an f32 p, at the CUDA cores'
    f32 rate (the tensor cores' sum of p split in bf16 parts did not hold
    them to f32: PERF.md, Findings).  Every kernel takes one exponential
    a visible score (p, or P of the backward) on the SFUs, which run
    beside the CUDA cores: the operations take the longer of the two
    ("products" or "exponentials"); at hd 8 in bf16 dq's exponentials
    are longer than its bytes."""
    n, acc, rows = B * C * H * hd * elt, B * H * C * hd * 4, B * H * C * 4
    scores = B * H * C * (C + 1) // 2
    prod = 2 * hd * scores
    typed = prod / (BF16_FLOPS if elt == 2 else F32_FLOPS)
    of_p = prod / F32_FLOPS
    t_exp = scores / SFU_EXP_PER_S

    def bound(nbytes, t_products):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = max(t_products, t_exp)
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations",
                "products" if t_products >= t_exp else "exponentials")
    return {"fwd": bound(3 * n + 4 * rows + 2 * acc, typed + of_p),
            "bwd_dq": bound(4 * n + 2 * rows + 2 * acc, 3 * typed),
            "bwd_dkdv": bound(4 * n + 2 * rows + 4 * acc, 3 * typed + of_p)}


def _fold_inputs(g, shape, dtype, fresh):
    """q, k, v, dO and a state (m, l, o): fresh (-1e30, 0, 0) or one an
    earlier fold could leave."""
    import torch
    B, C, H, hd = shape
    qkvd = [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(4)]
    if fresh:
        state = [torch.full((B, H, C), -1e30, device="cuda"),
                 torch.zeros(B, H, C, device="cuda"),
                 torch.zeros(B, H, C, hd, device="cuda")]
    else:
        state = [torch.rand(B, H, C, generator=g, device="cuda") * 3 - 1,
                 torch.rand(B, H, C, generator=g, device="cuda") * 3 + 1,
                 torch.randn(B, H, C, hd, generator=g, device="cuda")]
    return qkvd, state


def _lse_delta(m, l, o, do):
    o = o / l.clamp(min=1e-30)[..., None]
    return (m + l.log()).contiguous(), \
        (do.float().transpose(1, 2) * o).sum(-1).contiguous()


def _fold_block(fns, qkvd, state, q_off, k_off, causal, scale):
    """[m, l, o, dq, dk, dv] of one block through `fns` (fold, dq, dkdv:
    the wrappers or the plain versions), the backward from the plain
    fold's lse and D; and whether the fold ran."""
    import torch
    from brpc_tpu_torch.ops import ring_fold as rf
    q, k, v, do = qkvd
    plain = [t.clone() for t in state]
    rf.ring_fold_plain(q, k, v, *plain, q_off, k_off, causal, scale)
    lse, delta = _lse_delta(*plain, do)
    out = [t.clone() for t in state]
    ran = fns[0](q, k, v, *out, q_off, k_off, causal, scale)
    grads = [torch.zeros_like(state[2]) for _ in range(3)]
    fns[1](q, k, v, do, lse, delta, grads[0], q_off, k_off, causal, scale)
    fns[2](q, k, v, do, lse, delta, *grads[1:], q_off, k_off, causal, scale)
    return out + grads, ran


def _fold_f64(qkvd, state, q_off, k_off, causal, scale):
    """[m, l, o] of the fold of one block into the state in f64
    throughout."""
    import torch
    q, k, v = (t.double() for t in qkvd[:3])
    m, l, o = (t.double() for t in state)
    s = torch.einsum("bchk,bdhk->bhcd", q, k) * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, -1e30)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    del s
    alpha = torch.exp(m - m_new)
    return [m_new, l * alpha + p.sum(-1),
            o * alpha[..., None] + torch.einsum("bhcd,bdhk->bhck", p, v)]


def _held(got, want, dt):
    """(max abs error, share of the tolerance used) of one output under
    the RING_TOL / flip rule (held when the share is at most 1)."""
    tol = RING_TOL[dt]
    diff = (got.float() - want.float()).abs()
    share = float((diff / (tol["atol"] + tol["rtol"] * want.abs())).max())
    if dt == "bf16":
        out = diff > tol["atol"] + tol["rtol"] * want.abs()
        flip = float((diff / (RING_FLIP_TOL["atol"] + RING_FLIP_TOL["rtol"]
                              * want.abs())).max())
        share = max(flip, float(out.float().mean()) / RING_FLIP_SHARE)
    return float(diff.max()), share


def _fold_p_bf16(qkvd, state, q_off, k_off, causal, scale):
    """The exact-scores control: [o, dv] of the plain fold and dk/dv with
    p (P) rounded once to bf16 in their products."""
    import torch
    from brpc_tpu_torch.ops import ring_fold as rf
    q, k, v, do = qkvd
    m, l, o = state
    s = rf.scores_plain(q, k, q_off, k_off, causal, scale)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    o = o * alpha[..., None] + torch.einsum(
        "bhcd,bdhk->bhck", p.to(torch.bfloat16).float(), v.float())
    lse, _ = _lse_delta(m_new, l * alpha + p.sum(-1), o, do)
    pb = torch.exp(s - lse[..., None]).to(torch.bfloat16).float()
    return [o, torch.einsum("bhcd,bchk->bhdk", pb, do.float())]


def _exact_f64(qkvd, state, lse, q_off, k_off, causal, scale):
    """[m, l, o, dv] of one block with every sum in f64, from the
    kernels' own scores (the bf16 product scaled in f32), f32 state and
    lse: the fold, and P^T . dO."""
    import torch
    from brpc_tpu_torch.ops import ring_fold as rf
    q, k, v, do = qkvd
    s = rf.scores_plain(q, k, q_off, k_off, causal, scale).double()
    m, l, o = (t.double() for t in state)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    out = [m_new, l * alpha + p.sum(-1),
           o * alpha[..., None] + torch.einsum("bhcd,bdhk->bhck", p,
                                               v.double())]
    del p
    big_p = torch.exp(s - lse.double()[..., None])
    return out + [torch.einsum("bhcd,bchk->bhdk", big_p, do.double())]


def _bwd_parts(qkvd, lse, delta, args):
    """The plain backward's f32 scores s, P, dP and dS = P (dP - D) scale
    (unrounded) of one block, from lse and D."""
    import torch
    from brpc_tpu_torch.ops import ring_fold as rf
    q, k, v, do = qkvd
    s = rf.scores_plain(q, k, *args)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bchk,bdhk->bhcd", do.float(), v.float())
    return s, p, dp, p * (dp - delta[..., None]) * args[3]


def check_exact_inputs_hd8(g, kernels, plains):
    """At hd 8, the bf16 dq with q, k, v and dO in {-1, 0, 1} (every dP
    exact, so every P and dS the plain version's bits, dq a sum of exact
    products), the f32 dk/dv with q and k in {-1, 0, 1} (every score
    exact) and the f32 forward likewise, each on the RING_HD8 block from
    a fresh state against the same sums in f64 (its dS from the plain
    version's bits; dk and dv from the plain lse and D, everything after
    them in f64; m, l and o from the scores in f64), with the plain
    version's own share beside (plain_*, held to nothing), and on a
    RING_HD8_SMALL (3, 1) block against the plain version, within
    EXACT_TOL.  Controls: dS left unrounded (dq), dS and P rounded once
    to bf16 (dk, dv), p rounded once to bf16 (o).  Returns {case:
    {output: [max abs err, share of EXACT_TOL]}}."""
    import torch

    def share(a, b):
        diff = (a.double() - b.double()).abs()
        return [float(diff.max()), float((diff / (
            EXACT_TOL["atol"] + EXACT_TOL["rtol"] * b.double().abs())).max())]
    out = {}
    for name, shape, dtype, part, idx, src, fresh, ref in (
            ("hd8_dq_full_0_0_causal", RING_HD8, torch.bfloat16, "dq", 0, 0,
             True, "f64"),
            ("hd8_dq_c256_3_1_causal", RING_HD8_SMALL, torch.bfloat16, "dq",
             3, 1, False, "plain"),
            ("hd8_f32_full_0_0_causal", RING_HD8, torch.float32, "dkdv", 0,
             0, True, "f64"),
            ("hd8_f32_c256_3_1_causal", RING_HD8_SMALL, torch.float32,
             "dkdv", 3, 1, False, "plain"),
            ("hd8_f32_fwd_full_0_0_causal", RING_HD8, torch.float32, "fwd",
             0, 0, True, "f64"),
            ("hd8_f32_fwd_c256_3_1_causal", RING_HD8_SMALL, torch.float32,
             "fwd", 3, 1, False, "plain")):
        C, hd = shape[1], shape[3]
        qkvd, state = _fold_inputs(g, shape, dtype, fresh)
        n_int = 4 if part == "dq" else 2
        qkvd[:n_int] = [torch.randint(-1, 2, shape, generator=g,
                                      device="cuda").to(dtype)
                        for _ in range(n_int)]
        args = (idx * C, src * C, True, hd ** -0.5)
        got, _ = _fold_block(kernels, qkvd, state, *args)
        want, _ = _fold_block(plains, qkvd, state, *args)
        # the backward's lse and D, as _fold_block takes them
        lse, delta = _lse_delta(*want[:3], qkvd[3])
        q, k, v, do = qkvd
        exact = {}
        if part == "fwd":
            outs = {"m": (got[0], want[0], None), "l": (got[1], want[1], None),
                    "o": (got[2], want[2],
                          _fold_p_bf16(qkvd, state, *args)[0])}
            if ref == "f64":
                exact = dict(zip("mlo", _exact_f64(qkvd, state, lse,
                                                   *args)[:3]))
        elif part == "dq":
            s, p, dp, ds = _bwd_parts(qkvd, lse, delta, args)
            outs = {"dq": (got[3], want[3], torch.einsum(
                "bhcd,bdhk->bhck", ds, k.float()))}
            if ref == "f64":
                exact = {"dq": torch.einsum(
                    "bhcd,bdhk->bhck", ds.to(dtype).double(), k.double())}
            del s, p, dp, ds
        else:
            s, p, dp, ds = _bwd_parts(qkvd, lse, delta, args)
            outs = {"dk": (got[4], want[4], torch.einsum(
                        "bhcd,bchk->bhdk", ds.to(torch.bfloat16).float(), q)),
                    "dv": (got[5], want[5], torch.einsum(
                        "bhcd,bchk->bhdk", p.to(torch.bfloat16).float(), do))}
            if ref == "f64":
                del ds, dp
                p64 = torch.exp(s.double() - lse.double()[..., None])
                ds64 = p64 * (torch.einsum(
                    "bchk,bdhk->bhcd", do.double(), v.double())
                    - delta.double()[..., None]) * args[3]
                exact = {"dk": torch.einsum("bhcd,bchk->bhdk", ds64,
                                            q.double()),
                         "dv": torch.einsum("bhcd,bchk->bhdk", p64,
                                            do.double())}
                del p64, ds64
            del s, p
        torch.cuda.synchronize()
        res = {}
        for o, (kern, plain, control) in outs.items():
            want_o = exact[o] if ref == "f64" else plain
            res[o] = share(kern, want_o)
            if control is not None:
                res["control_" + o] = share(control, want_o)
            if ref == "f64":
                res["plain_" + o] = share(plain, want_o)
        res["against"] = ref
        out[name] = res
        del qkvd, state, got, want, outs, exact
    return out


def check_exact_scores(g, kernels, plains):
    """The bf16 kernels on exact scores (EXACT_TOL): the full-width block
    from a fresh state and a C=256 (3, 1) block on an earlier one, at hd
    64 and at hd 8, each against the plain version; and at hd 8 the
    full-width block against the same in f64, where the plain version's
    own sums of 1024 f32 products are no nearer the truth than the
    kernels' (its o and dv against the f64 ones are reported beside, as
    plain_o and plain_dv, and held to nothing); then
    check_exact_inputs_hd8.
    Returns {case: {output: [max abs err, share of EXACT_TOL]}}, with the
    control's share on o and dv (p rounded once to bf16)."""
    import torch

    def share(a, b):
        diff = (a.double() - b.double()).abs()
        return [float(diff.max()), float((diff / (
            EXACT_TOL["atol"] + EXACT_TOL["rtol"] * b.double().abs())).max())]
    out = {}
    for name, shape, idx, src, fresh, ref in (
            ("full_0_0_causal", RING_SHAPE, 0, 0, True, "plain"),
            ("c256_3_1_causal", RING_SMALL, 3, 1, False, "plain"),
            ("hd8_full_0_0_causal", RING_HD8, 0, 0, True, "f64"),
            ("hd8_c256_3_1_causal", RING_HD8_SMALL, 3, 1, False, "plain")):
        C, hd = shape[1], shape[3]
        qkvd, state = _fold_inputs(g, shape, torch.bfloat16, fresh)
        qkvd[:2] = [torch.randint(-1, 2, shape, generator=g, device="cuda")
                    .to(torch.bfloat16) for _ in range(2)]
        # the same f32 scale on both sides: the same bits of every score
        args = (idx * C, src * C, True, hd ** -0.5)
        got, _ = _fold_block(kernels, qkvd, state, *args)
        want, _ = _fold_block(plains, qkvd, state, *args)
        control = _fold_p_bf16(qkvd, state, *args)
        res = {}
        if ref == "f64":   # dk/dv ran from the plain fold's lse
            lse, _ = _lse_delta(*want[:3], qkvd[3])
            exact = _exact_f64(qkvd, state, lse, *args)
            res["plain_o"] = share(want[2], exact[2])
            res["plain_dv"] = share(want[5], exact[3])
            want = exact[:3] + [None, None, exact[3]]
        torch.cuda.synchronize()
        res.update({o: share(got[i], want[i]) for o, i in
                    (("m", 0), ("l", 1), ("o", 2), ("dv", 5))})
        res["control_o"] = share(control[0], want[2])
        res["control_dv"] = share(control[1], want[5])
        res["against"] = ref
        out[name] = res
        del qkvd, state, got, want, control
    return {**out, **check_exact_inputs_hd8(g, kernels, plains)}


def check_ring_fold(g):
    """The three fold kernels against their plain versions, f32 and bf16:
    the full-width block and the RING_BLOCKS at C=256, causal and not, and
    at hd 8 the RING_HD8 block and a RING_HD8_SMALL (3, 1) block; then
    check_exact_scores.  Returns {case: {kernel: [max abs err, share of
    the tolerance]}} (the forward's error on the normalised output
    o / l, its share over the state m, l, o; in f32 that share against
    the fold in f64, and plain_fwd_vs_f64 the plain version's, held to
    nothing), the skip checks and the exact-scores results."""
    import torch
    from brpc_tpu_torch.ops import ring_fold as rf
    kernels = (rf.ring_fold_forward, rf.ring_fold_backward_dq,
               rf.ring_fold_backward_dkdv)
    plains = (rf.ring_fold_plain, rf.ring_fold_bwd_dq_plain,
              rf.ring_fold_bwd_dkdv_plain)
    names = ("fwd", "bwd_dq", "bwd_dkdv")
    cases = [("full_0_0_causal", RING_SHAPE, 0, 0, True, True)]
    for idx, src in RING_BLOCKS:
        for causal in (True, False):
            cases.append((f"c256_{idx}_{src}_{'causal' if causal else 'full'}",
                          RING_SMALL, idx, src, causal, False))
    cases += [("hd8_full_0_0_causal", RING_HD8, 0, 0, True, True),
              ("hd8_c256_3_1_causal", RING_HD8_SMALL, 3, 1, True, False)]
    results, skipped = {}, {}
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for name, shape, idx, src, causal, fresh in cases:
            C, hd = shape[1], shape[3]
            qkvd, state = _fold_inputs(g, shape, dtype, fresh)
            before = [(w.launches, w.skips) for w in kernels]
            got, ran = _fold_block(kernels, qkvd, state, idx * C, src * C,
                                   causal, hd ** -0.5)
            want, _ = _fold_block(plains, qkvd, state, idx * C, src * C,
                                  causal, hd ** -0.5)
            torch.cuda.synchronize()
            after = [(w.launches, w.skips) for w in kernels]
            if not rf.visible(idx * C, C, src * C, causal):
                assert ran is False and after == [(n, s + 1)
                                                  for n, s in before], \
                    (name, before, after)
                assert all(torch.equal(a, b) for a, b in
                           zip(got[:3], state)), name
                skipped[f"{dt}/{name}"] = {"launched": False,
                                           "state_unchanged": True}
            else:
                assert ran and after == [(n + 1, s) for n, s in before], \
                    (name, before, after)
            res = {}
            for kname, outs in zip(names, ((0, 1, 2), (3,), (4, 5))):
                held = [_held(got[i], want[i], dt) for i in outs]
                res[kname] = [max(h[0] for h in held),
                              max(h[1] for h in held)]
            if dt == "f32":
                # the f32 forward's state against the fold in f64: the
                # plain version's f32 GEMM sums in its own order, and its
                # own error from the exact fold reaches RING_TOL (its
                # share beside, held to nothing)
                exact = _fold_f64(qkvd, state, idx * C, src * C, causal,
                                  hd ** -0.5)
                for who, outs in (("fwd", got), ("plain_fwd_vs_f64", want)):
                    held = [_held(outs[i], exact[i], dt) for i in range(3)]
                    res[who] = [max(h[0] for h in held),
                                max(h[1] for h in held)]
                del exact
            # the forward's error as attention reads it: o / l
            res["fwd"][0] = float((got[2] / got[1].clamp(min=1e-30)[..., None]
                                   - want[2] / want[1].clamp(
                                       min=1e-30)[..., None]).abs().max())
            results[f"{dt}/{name}"] = res
            del qkvd, state, got, want
    return results, skipped, check_exact_scores(g, kernels, plains)


def _dense_plain(q, k, v, scale):
    """`_dense_local` (ring_attention.py:125-133) in plain torch."""
    import torch
    from brpc_tpu_torch.ops.ring_fold import scores_plain
    w = torch.softmax(scores_plain(q, k, 0, 0, True, scale), dim=-1)
    return torch.einsum("bhcd,bdhk->bchk", w, v.float()).to(q.dtype)


def fold_rows(g, dtype, flush, shape=RING_SHAPE):
    """The three fold kernels timed at the full-width causal diagonal
    block (`shape`, a fresh state) in `dtype` on the device alone,
    each beside its bound (fold_bounds at the dtype's width), the plain
    version (CUDA events), SDPA in the same dtype on the block (the
    backward rows: fwd+bwd less fwd) and host_call_ms: ({kernel: row},
    the block's q, k, v, dO)."""
    import torch
    import torch.nn.functional as F

    from brpc_tpu_torch.ops import ring_fold as rf
    B, C, H, hd = shape
    scale = hd ** -0.5
    (q, k, v, do), state = _fold_inputs(g, shape, dtype, True)
    rf.ring_fold_forward(q, k, v, *state, 0, 0, True, scale)
    lse, delta = _lse_delta(*state, do)
    acc = [torch.zeros_like(state[2]) for _ in range(3)]
    calls = {
        "fwd": (lambda: rf.ring_fold_forward(q, k, v, *state, 0, 0, True,
                                             scale),
                lambda: rf.ring_fold_plain(q, k, v, *state, 0, 0, True,
                                           scale)),
        "bwd_dq": (lambda: rf.ring_fold_backward_dq(
            q, k, v, do, lse, delta, acc[0], 0, 0, True, scale),
            lambda: rf.ring_fold_bwd_dq_plain(
                q, k, v, do, lse, delta, acc[0], 0, 0, True, scale)),
        "bwd_dkdv": (lambda: rf.ring_fold_backward_dkdv(
            q, k, v, do, lse, delta, acc[1], acc[2], 0, 0, True, scale),
            lambda: rf.ring_fold_bwd_dkdv_plain(
                q, k, v, do, lse, delta, acc[1], acc[2], 0, 0, True,
                scale))}
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa(*a):
        return F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in a), is_causal=True).transpose(1, 2)

    sdpa_fwd = device_ms(lambda: sdpa(q, k, v), flush)
    sdpa_fwd_bwd = device_ms(
        lambda: torch.autograd.grad(sdpa(*leaves), leaves, do), flush)
    bounds = fold_bounds(B, C, H, hd, q.element_size())
    rows = {}
    for name, (kernel, plain) in calls.items():
        ms, cold_ms = device_ms(kernel, flush)
        bound_ms, bound_by, ops_by = bounds[name]
        library = sdpa_fwd if name == "fwd" else [
            a - b for a, b in zip(sdpa_fwd_bwd, sdpa_fwd)]
        rows[name] = {"ms": ms, "cold_ms": cold_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "bound_ops_by": ops_by,
                      "bound_share": bound_ms / cold_ms,
                      "plain_ms": cuda_ms(plain, 3),
                      "library_ms": library[0],
                      "library_cold_ms": library[1],
                      "host_call_ms": cuda_ms(kernel, 20)}
    return rows, (q, k, v, do)


def fold_paths(mesh, dtype, g, shape=RING_SHAPE):
    """ring_attention and ulysses_attention over `mesh` at `shape` in
    `dtype`, forward and backward, against autograd of the plain
    `_dense_local`, with every fold wrapper's count set to 0 just before:
    ({path: {output: [max abs error, share of RING_TOL]}}, {wrapper:
    launches}, {wrapper: skips})."""
    import torch

    from brpc_tpu_torch.ops import ring_fold as rf
    from brpc_tpu_torch.parallel.ring_attention import (ring_attention,
                                                        ulysses_attention)
    kernels = (rf.ring_fold_forward, rf.ring_fold_backward_dq,
               rf.ring_fold_backward_dkdv)
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    scale = shape[3] ** -0.5
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    want = attention_grads(lambda *a: _dense_plain(*a, scale), q, k, v, do)
    for w in kernels:
        w.launches = w.skips = 0
    torch.cuda.synchronize()
    got = {name: attention_grads(
        lambda *a, fn=fn: fn(*a, mesh, axis="sp", causal=True), q, k, v, do)
        for name, fn in (("ring", ring_attention),
                         ("ulysses", ulysses_attention))}
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in kernels}
    skips = {w.__name__: w.skips for w in kernels}
    paths = {name: {out: _held(a, b, dt) for out, a, b in
                    zip(ATTN_OUTPUTS, outs, want)}
             for name, outs in got.items()}
    return paths, launches, skips


def phase_ring(smi):
    """ring_attention and ulysses_attention on the NCCL world of one (the
    main path of the fold: the launches are read over it), in bf16 and in
    f32, at hd 64 and at hd 8 (RING_HD8: in bf16 the tensor-core forward,
    dq and dk/dv of ring_fold_hd8.cu, in f32 the CUDA-core forward, dq
    and dk/dv of ring_fold_f32_hd8.cu); the fold kernels
    against their plain versions, and their times on the device at the
    full-width block in bf16 and in f32, at both head dims."""
    import torch

    from brpc_tpu_torch.parallel import make_mesh
    from brpc_tpu_torch.parallel.ring_attention import RingAttention
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(5)
    scale = RING_SHAPE[3] ** -0.5

    # 1. the main path: ring and Ulysses attention, forward and backward,
    #    over the mesh of the NCCL world of one, against plain autograd,
    #    in bf16 (the model's working type) and in f32; then at hd 8
    mesh = make_mesh({"dp": 1, "sp": 1}, device_type="cuda")
    paths, launches, skips = fold_paths(mesh, torch.bfloat16, g)
    paths_f32, launches_f32, skips_f32 = fold_paths(mesh, torch.float32, g)
    hd8 = {dt: fold_paths(mesh, dtype, g, RING_HD8) for dt, dtype in
           (("bf16", torch.bfloat16), ("f32", torch.float32))}

    # 2. each kernel against its plain version
    checks, skipped, exact = check_ring_fold(g)

    # 3. times of the full-width diagonal block in bf16 and in f32, at
    #    hd 64 and at hd 8
    flush_buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    rows_f32, _ = fold_rows(g, torch.float32, flush_buf.sum)
    rows, qkvd = fold_rows(g, torch.bfloat16, flush_buf.sum)
    rows_hd8 = {dt: fold_rows(g, dtype, flush_buf.sum, RING_HD8)[0]
                for dt, dtype in (("bf16", torch.bfloat16),
                                  ("f32", torch.float32))}
    del flush_buf

    # 4. the kernels one RingAttention forward and backward launched, in
    #    bf16 and in f32, and at hd 8 in each
    names = {dt: launched_kernels(
        lambda dtype=dtype: attention_grads(
            lambda *a: RingAttention.apply(*a, None, "sp", True, scale),
            *(t.to(dtype) for t in qkvd)),
        r"ring_fold_\w+_kernel", RING_ROUTES[dt])
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    small = [torch.randn(RING_HD8_SMALL, generator=g, device="cuda")
             for _ in range(4)]
    names_hd8 = {dt: launched_kernels(
        lambda dtype=dtype: attention_grads(
            lambda *a: RingAttention.apply(*a, None, "sp", True,
                                           RING_HD8[3] ** -0.5),
            *(t.to(dtype) for t in small)),
        r"ring_fold_\w+_kernel", RING_ROUTES[f"hd8_{dt}"])
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}

    def errs(dt, prefix="full"):
        return {kname: max(c[kname][0] for key, c in checks.items()
                           if key.startswith(f"{dt}/{prefix}"))
                for kname in ("fwd", "bwd_dq", "bwd_dkdv")}
    line = {"phase": "ring", "device_name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "shape": dict(zip(("B", "C", "H", "hd"),
                                                 RING_SHAPE)),
            "dtype": "bf16", "mesh": mesh.shape,
            "launches": launches, "skips": skips,
            "paths_vs_plain_autograd": paths,
            "launches_f32": launches_f32, "skips_f32": skips_f32,
            "paths_f32_vs_plain_autograd": paths_f32, "checks": checks,
            "skipped_blocks": skipped, "exact_scores": exact,
            "exact_tolerance": EXACT_TOL, "tolerance": RING_TOL,
            "flip_share": RING_FLIP_SHARE, "flip_tolerance": RING_FLIP_TOL,
            "kernels": rows, "kernels_f32": rows_f32,
            "f32_fold_layer_cold_ms": sum(r["cold_ms"]
                                          for r in rows_f32.values()),
            "max_abs_err": errs("bf16"), "max_abs_err_f32": errs("f32"),
            "kernel_names": names["bf16"], "kernel_names_f32": names["f32"],
            "hd8": {"shape": dict(zip(("B", "C", "H", "hd"), RING_HD8)),
                    "launches": {dt: hd8[dt][1] for dt in hd8},
                    "paths_vs_plain_autograd": {dt: hd8[dt][0]
                                                for dt in hd8},
                    "kernels": rows_hd8,
                    "max_abs_err": {dt: errs(dt, "hd8") for dt in hd8},
                    "kernel_names": names_hd8},
            "library": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True) on the block, in the row's dtype; "
                       "it rounds its weights as it likes, not the fold's "
                       "f32: a yardstick of time, not of the arithmetic"}
    emit(line)
    bad = {c: v for c, res in checks.items() for o, v in res.items()
           if not o.startswith("plain") and v[1] > 1}
    assert not bad, f"the fold kernels differ from the plain version: {bad}"
    bad = {c: o for c, res in exact.items() for o, v in res.items()
           if o != "against" and not o.startswith("plain")
           and (v[1] > 1) != o.startswith("control")}
    assert not bad, f"exact scores: outside EXACT_TOL or a control inside: " \
        f"{bad}"
    bad = {f"{dt}/{p}": o for dt, ps in (("bf16", paths), ("f32", paths_f32),
                                         ("hd8_bf16", hd8["bf16"][0]),
                                         ("hd8_f32", hd8["f32"][0]))
           for p, res in ps.items() for o, v in res.items() if v[1] > 1}
    assert not bad, f"ring/ulysses differ from plain autograd: {bad}"
    assert all(n == 2 for n in launches.values()), launches
    assert all(n == 2 for n in launches_f32.values()), launches_f32
    assert all(n == 2 for dt in hd8 for n in hd8[dt][1].values()), hd8
    assert names == {dt: RING_ROUTES[dt] for dt in names}, names
    assert names_hd8 == {dt: RING_ROUTES[f"hd8_{dt}"] for dt in names_hd8}, \
        names_hd8
    assert len(skipped) == 2, skipped
    return line


def phase_mesh_train(smi):
    """make_train_step(cfg, mesh) at the train phase's width over the
    mesh MESH_AXES of the NCCL world of one: TRAIN_STEPS steps from the
    train phase's seeded state, each loss equal to the one-device step's
    bit for bit (the main path: the causal kernels' launches are read
    over it); a checkpoint saved and restored through the mesh path and
    one more step on each, equal; then entry.dryrun_multichip(1)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from brpc_tpu_torch import entry
    from brpc_tpu_torch.models import checkpoint, train
    from brpc_tpu_torch.models import transformer as T
    from brpc_tpu_torch.ops.causal_attention import (
        causal_attention_backward_dkdv, causal_attention_backward_dq,
        causal_attention_forward)
    from brpc_tpu_torch.parallel import make_mesh

    cfg = T.ModelConfig(**TRAIN_MOE)
    tokens = torch.randint(0, cfg.vocab, TRAIN_TOKENS,
                           generator=torch.Generator().manual_seed(2))
    tokens = tokens.to("cuda")
    mesh = make_mesh(MESH_AXES, device_type="cuda")

    def fresh(seed, mesh):
        tx, step = train.make_train_step(cfg, mesh, lr=TRAIN_LR,
                                         device="cuda")
        model = T.init(torch.Generator().manual_seed(seed), cfg, "cuda",
                       mesh)
        return step, train.TrainState(model, tx(model),
                                      torch.zeros((), dtype=torch.int32))

    def steps(step, state, n):
        losses, ms = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            state, loss = step(state, tokens)
            losses.append(loss.item())          # synchronises
            ms.append((time.perf_counter() - t0) * 1e3)
        return state, losses, ms

    def profiled(step, state):
        """One more step under torch.profiler: its device profile and
        the count of NCCL kernels in it."""
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, tokens)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        out = device_profile(prof, window_us)
        by_name = out.pop("_by_name", {})
        out["nccl_kernels"] = sum(v[0] for k, v in by_name.items()
                                  if "nccl" in k.lower())
        return out

    step1, state1 = fresh(0, None)
    state1, one_device, one_ms = steps(step1, state1, TRAIN_STEPS)
    prof_one = profiled(step1, state1)
    del state1
    torch.cuda.empty_cache()
    counters = (causal_attention_forward, causal_attention_backward_dq,
                causal_attention_backward_dkdv)
    step, state = fresh(0, mesh)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    state, meshed, mesh_ms = steps(step, state, TRAIN_STEPS)
    launches = {c.__name__: c.launches for c in counters}
    prof_mesh = profiled(step, state)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        nbytes = checkpoint.save(path, state)
        restored = checkpoint.restore(path, fresh(1, mesh)[1])
    assert restored.params.mesh is mesh
    state, loss_next = step(state, tokens)
    restored, loss_restored = step(restored, tokens)
    assert int(restored.step) == int(state.step) == TRAIN_STEPS + 2
    del state, restored
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dryrun = entry.dryrun_multichip(1)
    dryrun_s = time.perf_counter() - t0
    line = {"phase": "mesh_train", "device_name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "mesh": mesh.shape,
            "backend": torch.distributed.get_backend(),
            "losses_one_device": one_device, "losses_mesh": meshed,
            "losses_bit_equal": meshed == one_device,
            "step_ms_one_device": one_ms, "step_ms_mesh": mesh_ms,
            "profile_one_device": prof_one, "profile_mesh": prof_mesh,
            "launches": launches, "checkpoint_bytes": nbytes,
            "loss_next": loss_next.item(),
            "loss_restored": loss_restored.item(),
            "dryrun_multichip_1": dryrun, "dryrun_s": dryrun_s}
    emit(line)
    assert meshed == one_device, (meshed, one_device)
    assert loss_next.item() == loss_restored.item()
    want = TRAIN_STEPS * cfg.n_layers
    assert all(n == want for n in launches.values()), launches
    assert len(dryrun) == 1 and dryrun[0].startswith(
        "nccl: dryrun_multichip(1):") and dryrun[0].endswith(" ok"), dryrun
    return line


SERVE_MESH_AXES = {"dp": 1, "tp": 1}   # the serving mesh of one card
SERVE_PLENS = (32, 64, 96, 128, 192, 256)   # the serving phase's prompts
# the engines in turns, so that neither goes first alone
SERVE_TURNS = ("one_device", "mesh", "mesh", "one_device")
# the heads one rank holds at ModelConfig() (8 heads) over tp = 2, 4, 8
TP_SHARD_HEADS = (4, 2, 1)


def _serve(cfg, mesh, device="cuda"):
    """A ServingEngine at the width of `cfg`, 4 slots, seeded like the
    serving phase (on `mesh`, or on `device` without one), on a Server,
    warmed by one short request: (engine, server, addr)."""
    from brpc_tpu_torch.rpc.server import Server, ServerOptions
    from brpc_tpu_torch.serving import ServingEngine
    from brpc_tpu_torch.serving.kv_cache import KvBlockPlane
    where = {"mesh": mesh} if mesh is not None else {"device": device}
    engine = ServingEngine(cfg=cfg, n_slots=4,
                           kv=KvBlockPlane(block_bytes=1 << 20, n_blocks=64),
                           **where)
    server = Server(ServerOptions(
        method_max_concurrency={"LLM.Generate": engine.method_cap}))
    engine.register(server)
    addr = f"127.0.0.1:{server.start('127.0.0.1:0')}"
    engine.start()
    _client(addr, 8, 2, 1000, 0, [], threading.Lock())
    return engine, server, addr


def _concurrent(engine, addr):
    """The serving phase's clients: SERVE_PLENS at once, 16 new tokens
    each, and one that cancels after three tokens (the main path: the
    kernels' counts set to 0 just before and read once the KV plane has
    drained).  Returns (results, {device operation or kernel wrapper:
    count over the run}, wall s)."""
    from brpc_tpu_torch.ops.causal_attention import causal_attention_forward
    from brpc_tpu_torch.ops.decode_attention import decode_attention
    results, lock = [], threading.Lock()
    ops0 = dict(engine.dev.ops)
    decode_attention.launches = 0      # the main path starts here
    causal_attention_forward.launches = 0
    t0 = time.monotonic()
    threads = [threading.Thread(target=_client,
                                args=(addr, n, 16, i, 0, results, lock))
               for i, n in enumerate(SERVE_PLENS)]
    threads.append(threading.Thread(target=_client,
                                    args=(addr, 48, 16, 99, 3, results,
                                          lock)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
        assert not t.is_alive(), "a client did not finish"
    wall = time.monotonic() - t0
    deadline = time.monotonic() + 60
    while engine.stats()["kv_live_seqs"] > 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    ops = {k: v - ops0[k] for k, v in engine.dev.ops.items()}
    ops["decode_attention"] = decode_attention.launches   # the path ends
    ops["causal_attention_forward"] = causal_attention_forward.launches
    return results, ops, wall


def _serve_clients(engine, addr):
    """SERVE_PLENS one at a time (each stream's tokens), then
    _concurrent: (sequential token lists, results, ops, wall s)."""
    sequential = []
    for i, n in enumerate(SERVE_PLENS):
        one = []
        _client(addr, n, 16, i, 0, one, threading.Lock())
        sequential.append(one[0]["tokens"])
    return (sequential, *_concurrent(engine, addr))


def _serve_turns(cfg, meshes, device="cuda"):
    """The engines of `meshes` ({"one_device": None, "mesh": mesh}) in
    SERVE_TURNS, each through _serve (the one-device engine on `device`)
    and _serve_clients, stopped and drained: (turns, {engine: TTFT and
    inter-token p50 over its turns}, {engine: its parameters})."""
    turns, samples, params = [], {n: ([], []) for n in meshes}, {}
    for name in SERVE_TURNS:
        engine, server, addr = _serve(cfg, meshes[name], device)
        sequential, results, ops, wall = _serve_clients(engine, addr)
        stats = engine.stats()
        engine.stop()
        engine.assert_drained()
        server.destroy()
        full = [r for r in results if not r["cancel"]]
        assert len(full) == len(SERVE_PLENS), results
        assert all(len(r["tokens"]) == 16 and
                   all(0 <= t < cfg.vocab for t in r["tokens"])
                   for r in full), full
        ttft = [r["stamps"][0] - r["t0"] for r in full]
        gaps = [b - a for r in full for a, b in zip(r["stamps"],
                                                   r["stamps"][1:])]
        samples[name][0].extend(ttft)
        samples[name][1].extend(gaps)
        turns.append({"engine": name, "sequential": sequential, "ops": ops,
                      "wall_s": wall, "ttft_p50_ms": _p50(ttft) * 1e3,
                      "inter_token_p50_ms": _p50(gaps) * 1e3,
                      "canceled": stats["canceled"],
                      "rail_local": stats["rail_local"],
                      "rail_host": stats["rail_host"],
                      "ops_total": dict(engine.dev.ops)})
        params[name] = engine.params
        del engine
    p50 = {n: {"ttft_p50_ms": _p50(t) * 1e3,
               "inter_token_p50_ms": _p50(g) * 1e3}
           for n, (t, g) in samples.items()}
    return turns, p50, params


def check_tp_shards(g):
    """decode_attention and the causal forward at the head counts a tp
    shard gives one rank at ModelConfig() (TP_SHARD_HEADS), against their
    plain versions: decode at N=4, S=1024, hd 64 in both windows (cache
    rows bit-equal, o within KERNEL_TOL), the causal forward at B=1,
    S=PREFILL_LEN, hd 64 (o within ATTN_TOL); f32 and bf16.  Returns
    {case: {dtype: share of the tolerance}}."""
    import torch
    from brpc_tpu_torch.ops.causal_attention import (causal_attention_forward,
                                                     causal_attention_plain)
    from brpc_tpu_torch.ops.decode_attention import decode_attention
    N, S, _, hd = KERNEL_SHAPE
    out = {}
    for H in TP_SHARD_HEADS:
        for window in WINDOWS:
            _, errs, shares = check_kernel(decode_attention, g, window,
                                           (N, S, H, hd))
            out[f"decode_H{H}_{window}"] = {
                dt: [errs[dt], shares[dt]] for dt in errs}
        res = {}
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = (torch.randn(1, PREFILL_LEN, H, hd, generator=g,
                                   device="cuda").to(dtype)
                       for _ in range(3))
            got = causal_attention_forward(q, k, v)[0].float()
            want = causal_attention_plain(q, k, v).float()
            tol = ATTN_TOL[dt]
            diff = (got - want).abs()
            res[dt] = [float(diff.max()), float(
                (diff / (tol["atol"] + tol["rtol"] * want.abs())).max())]
        out[f"causal_fwd_H{H}"] = res
    return out


def phase_mesh_serving(smi):
    """ServingEngine(mesh=SERVE_MESH_AXES) on the NCCL world of one at
    ModelConfig()'s width beside the one-device engine, both seeded like
    the serving phase, in SERVE_TURNS: the SERVE_PLENS prompts served one
    at a time give every turn the same tokens; then concurrent clients
    with one cancel (the main path of the mesh: decode_attention and the
    causal forward counted over it); TTFT and inter-token p50 of each
    turn and of each engine's two turns together; one decode step's
    logits through the mesh path against the one-device path on the same
    cache; then check_tp_shards."""
    import torch

    from brpc_tpu_torch import tpu_plane
    from brpc_tpu_torch.models import decode as D
    from brpc_tpu_torch.models.transformer import ModelConfig
    from brpc_tpu_torch.parallel import make_mesh

    cfg = ModelConfig()
    mesh = make_mesh(SERVE_MESH_AXES, device_type="cuda")
    meshes = {"one_device": None, "mesh": mesh}
    live0 = tpu_plane.stats()["live_buffers"]
    turns, p50, params = _serve_turns(cfg, meshes)
    live1 = tpu_plane.stats()["live_buffers"]
    assert live1 == live0, (live0, live1)
    mesh_ops = [t["ops"] for t in turns if t["engine"] == "mesh"]

    # one decode step through the mesh path against the one-device path,
    # from caches filled the same way (outside the counted window)
    gen = torch.Generator().manual_seed(1)
    caches = {n: D.init_cache(cfg, 4, 1024, "cuda", m)
              for n, m in meshes.items()}
    for slot, plen in enumerate((32, 100, 257, 1000)):
        toks = torch.randint(0, cfg.vocab, (1, plen), generator=gen)
        for n, m in meshes.items():
            _, k, v = D.prefill(params[n], toks, cfg, m)
            D.install(caches[n], slot, k[:, 0], v[:, 0], plen, m)
    tokens = torch.randint(0, cfg.vocab, (4,), generator=gen)
    active = torch.ones(4, dtype=torch.bool)
    # the one-card side through the serving engine's graphed step
    logits = {n: D.StepGraphs(params[n], caches[n], cfg).run(tokens, active)
              if m is None else
              D.decode_step(params[n], caches[n], tokens, active, cfg, m)[0]
              for n, m in meshes.items()}
    step_bit_equal = torch.equal(logits["mesh"], logits["one_device"])
    step_err = float((logits["mesh"] - logits["one_device"]).abs().max())

    shards = check_tp_shards(torch.Generator(device="cuda").manual_seed(7))
    line = {"phase": "mesh_serving",
            "device_name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "mesh": mesh.shape,
            "backend": torch.distributed.get_backend(),
            "tokens_equal": all(t["sequential"] == turns[0]["sequential"]
                                for t in turns),
            "step_logits_bit_equal": step_bit_equal,
            "step_logits_max_abs_err": step_err,
            "decode_attention_launches": sum(o["decode_attention"]
                                             for o in mesh_ops),
            "causal_attention_fwd_launches": sum(
                o["causal_attention_forward"] for o in mesh_ops),
            "p50": p50, "turns": turns, "tp_shards": shards,
            "tp_shard_heads": TP_SHARD_HEADS,
            "kernel_tolerance": KERNEL_TOL, "attention_tolerance": ATTN_TOL}
    emit(line)
    assert line["tokens_equal"], turns
    assert step_err <= STEP_LOGITS_ATOL, step_err
    for ops in mesh_ops:
        assert ops["decode_attention"] == ops["step"] * cfg.n_layers > 0, ops
        assert ops["causal_attention_forward"] == \
            ops["prefill"] * cfg.n_layers > 0, ops
    assert all(t["canceled"] >= 1 for t in turns), turns
    bad = {c: r for c, r in shards.items() for dt, v in r.items()
           if v[1] > 1}
    assert not bad, f"a kernel at a tp shard's heads differs from its " \
        f"plain version: {bad}"
    return line


def phase_mesh(smi):
    """The ring, mesh_train and mesh_serving phases inside one NCCL
    process group of one rank on the card (built as phase_parallel
    builds its own)."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        assert dist.get_backend() == "nccl"
        t0 = time.monotonic()
        ring = phase_ring(smi)
        t1 = time.monotonic()
        mesh = phase_mesh_train(smi)
        t2 = time.monotonic()
        serving = phase_mesh_serving(smi)
        emit({"phase": "mesh_phases_s", "ring": t1 - t0,
              "mesh_train": t2 - t1,
              "mesh_serving": time.monotonic() - t2})
        return ring, mesh, serving
    finally:
        dist.destroy_process_group()


# the examples phase: the port's device examples and bench_torch.py's
# serving arm, each in a subprocess on the card, and the plane's rates
EXAMPLE_RUNS = (
    ("ici_performance", ("examples/ici_performance_torch.py", "--stream",
                         "--seconds", "2")),
    ("mesh_collectives", ("examples/mesh_collectives_torch.py",)),
    ("param_server_none", ("examples/param_server_allreduce_torch.py",
                           "--codec", "none")),
    ("param_server_int8", ("examples/param_server_allreduce_torch.py",
                           "--codec", "int8")),
    ("long_context_ring", ("examples/long_context_ring_torch.py",)),
    ("memcache_client", ("examples/memcache_client_torch.py",)),
    ("serving_arm", ("bench_torch.py", "--serving-arm", "auto,none",
                     "--brief")),
)
EXAMPLE_TIMEOUT_S = 300
PLANE_SIZES = (4 << 10, 1 << 20, 8 << 20)   # a KV block, 1 MiB, ici's 8 MiB
PLANE_REPS = 50
PCIE_GTS = {3: 8e9, 4: 16e9, 5: 32e9, 6: 64e9}   # transfers/s a lane
NVLINK_BYTES_PER_S = 450e9    # H100 SXM NVLink 4, one way

def _example(args):
    """(its last JSON line, its seconds); raises with its output's tail
    when it exits non-zero."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, *args], cwd=root,
                       capture_output=True, text=True,
                       timeout=EXAMPLE_TIMEOUT_S)
    seconds = time.monotonic() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(args)} exit {r.returncode}:\n"
                           f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1]), seconds


def _pcie_bytes_per_s():
    """(bytes/s one way over the card's PCIe link after 128b/130b
    encoding, where the link was read): nvidia-smi's maximum link
    generation and width; where it reports [N/A] (a virtual machine
    hides the link), the device's sysfs entry; failing that, the H100
    SXM data sheet's host link, PCIe gen 5 x16."""
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.max,pcie.link.width.max,"
         "pci.bus_id", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip()
    gen, width, bus = (x.strip() for x in q.splitlines()[0].split(","))
    if gen.isdigit() and width.isdigit():
        gen, width, src = int(gen), int(width), "nvidia-smi"
    else:
        sysfs = os.path.join("/sys/bus/pci/devices", bus.lower()[-12:])
        try:
            with open(os.path.join(sysfs, "max_link_speed")) as f:
                gts = float(f.read().split()[0])
            with open(os.path.join(sysfs, "max_link_width")) as f:
                width = int(f.read())
            gen = {8.0: 3, 16.0: 4, 32.0: 5, 64.0: 6}[gts]
            src = f"sysfs {sysfs} (nvidia-smi: [N/A])"
        except (OSError, ValueError, KeyError):
            gen, width = 5, 16
            src = "H100 SXM data sheet (nvidia-smi and sysfs: no link)"
    return PCIE_GTS[gen] * width * 128 / 130 / 8, f"gen {gen} x{width}, {src}"


def _median_ms(fn, reps=PLANE_REPS):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _plane_ops(data, across):
    """The plane's transfers of `data`, each to its completed wait and
    its buffer freed (so a steady loop reuses pooled blocks): h2d, d2h
    and same-card d2d, and d2d to device 1 when `across`."""
    from brpc_tpu_torch import tpu_plane
    src = tpu_plane.h2d(data, device=0)
    src.wait()

    def h2d():
        b = tpu_plane.h2d(data, device=0)
        b.wait()
        b.free()

    def hop(dev):
        def call():
            b = tpu_plane.d2d(src, dev)
            b.wait()
            b.free()
        return call

    ops = {"h2d": h2d, "d2h": lambda: src.to_host(), "d2d": hop(0)}
    if across:
        ops["d2d_across"] = hop(1)
    return src, ops


def _torch_ops(data, across):
    """torch's yardsticks for the same sizes: `library`, one copy through
    a pinned host tensor or on the device (copy_, clone, to); `same_work`,
    torch doing what the plane does: bytes in, bytes out, a copy to the
    other card.  Each synchronizes before it returns."""
    import torch
    n = len(data)
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    dev = torch.empty(n, dtype=torch.uint8, device="cuda:0")

    def synced(fn):
        def call():
            fn()
            torch.cuda.synchronize(0)
        return call

    library = {"h2d": lambda: dev.copy_(pinned, non_blocking=True),
               "d2h": lambda: pinned.copy_(dev, non_blocking=True),
               "d2d": lambda: dev.clone()}
    same = {"h2d": lambda: torch.frombuffer(bytearray(data),
                                            dtype=torch.uint8).to("cuda:0"),
            "d2h": lambda: dev.cpu().numpy().tobytes(),
            "d2d": lambda: dev.clone()}
    if across:
        def to1():
            dev.to("cuda:1")
            torch.cuda.synchronize(1)
        library["d2d_across"] = same["d2d_across"] = to1
    device_ms = {k: cuda_ms(f, PLANE_REPS) for k, f in library.items()
                 if k != "d2d_across"}
    return ({k: synced(f) for k, f in library.items()},
            {k: synced(f) for k, f in same.items()}, device_ms)


def plane_rates():
    """The plane's h2d, d2h and same-card d2d at each of PLANE_SIZES (and
    a d2d to device 1 where there are two), host clock to the completed
    wait (median of PLANE_REPS), beside the bound (PCIe one way for h2d
    and d2h, read and write of HBM for d2d, NVLink one way across cards)
    and torch's two yardsticks (_torch_ops), timed the same way; the
    library copies also on the device alone (CUDA events).  Every
    operation is warmed once first; after the timed loop each size moves
    bytes of its own through the reused blocks (h2d -> d2h, d2d), and
    they must compare equal; the pools' counters around both must show
    no miss (a steady state allocates nothing)."""
    import torch
    from brpc_tpu_torch import tpu_plane
    across = tpu_plane.device_count() > 1 and torch.cuda.device_count() > 1
    link, link_name = _pcie_bytes_per_s()
    cases = []
    for n in PLANE_SIZES:
        data = bytes(bytearray(range(256)) * (n // 256))
        src, ops = _plane_ops(data, across)
        back = tpu_plane.d2d(src, 1 if across else 0)
        equal = src.to_host() == data and back.to_host() == data
        back.free()
        assert equal, f"plane bytes differ at {n} bytes"
        library, same, library_device = _torch_ops(data, across)
        cases.append((n, src, ops, library, same, library_device))
        for fn in (*ops.values(), *library.values(), *same.values()):
            fn()                                    # warm every route
    pools0 = tpu_plane.pool_stats()
    out = {}
    for n, src, ops, library, same, library_device in cases:
        plane = {k: _median_ms(f) for k, f in ops.items()}
        bound = {"h2d": n / link * 1e3, "d2h": n / link * 1e3,
                 "d2d": 2 * n / HBM_BYTES_PER_S * 1e3}
        if across:
            bound["d2d_across"] = n / NVLINK_BYTES_PER_S * 1e3
        out[str(n)] = {
            "ms": plane,
            "library_ms": {k: _median_ms(f) for k, f in library.items()},
            "same_work_ms": {k: _median_ms(f) for k, f in same.items()},
            "library_device_ms": library_device, "bound_ms": bound,
            "gbps": {k: n / ms / 1e6 for k, ms in plane.items()},
            "bytes_equal": True}
    for i, (n, src, *_) in enumerate(cases):
        # the blocks the timed loop reused, checked with fresh bytes
        src.free()
        fresh = _salted(n, 1000 + i)
        b = tpu_plane.h2d(fresh, device=0)
        assert b.to_host() == fresh, f"plane h2d -> d2h differs at {n} B"
        for dev in (0, 1) if across else (0,):
            c = tpu_plane.d2d(b, dev)
            assert c.to_host() == fresh, f"plane d2d differs at {n} B"
            c.free()
        b.free()
    pools1 = tpu_plane.pool_stats()
    steady = _pool_delta(pools0, pools1)
    for pool in ("device", "host"):
        assert steady[pool]["misses"] == 0, steady
    return {"sizes": out, "steady_pools": steady,
            "peer_access": pools1["peer_access"], "pcie": link_name,
            "nvlink": "H100 SXM NVLink 4, 450 GB/s one way" if across
            else None}


def phase_examples(smi):
    """Every device example and the serving arm of bench_torch.py on the
    card, each checked by its own numbers; the plane's rates."""
    t0 = time.monotonic()
    runs = {}
    seconds = {}
    for name, args in EXAMPLE_RUNS:
        runs[name], seconds[name] = _example(args)
        print(f"example {name} {seconds[name]:.1f} s: "
              f"{json.dumps(runs[name])[:600]}", flush=True)
    ici, col, ring = (runs["ici_performance"], runs["mesh_collectives"],
                      runs["long_context_ring"])
    assert ici["available"], ici
    assert ici["raw"]["rounds"] > 0 and ici["rpc"]["transport"] == "device"
    stream = ici.get("stream", {})
    assert stream.get("bytes_equal", "skipped" in stream), stream
    assert ici["live_buffers_end"] == 0, ici
    tp = col["mesh"]["tp"]
    assert col["allreduce_value"] == tp, col
    assert col["gather_shape"] == [8, 8], col
    assert col["reduce_scatter_shape"] == [16 // tp, 8], col
    for codec in ("none", "int8"):
        ps = runs[f"param_server_{codec}"]
        assert ps["numeric_check"] == "ok" and ps["platform"] == "cuda", ps
        assert ps["params"] == PS_PARAMS, ps
    ps8 = runs["param_server_int8"]
    assert 0.0 < ps8["codec_max_abs_err"] <= ps8["codec_err_bound"], ps8
    assert ring["finite"] and ring["logits_shape"] == [2, 4096, 256], ring
    assert sum(ring["launches_all_ranks"].values()) > 0, ring
    assert runs["memcache_client"]["cas"] == "compare-and-swapped"
    arm = runs["serving_arm"]
    assert arm["completed"] > 0 and arm["errors"] == 0, arm
    assert arm["balanced"] and arm["device"] == "cuda", arm
    rates = plane_rates()
    line = {
        "phase": "examples", "nvidia_smi": smi, "seconds": seconds,
        "ici_8MiB": {"h2d_gbps": ici["raw"]["h2d_gbps"],
                     "roundtrip_gbps": ici["raw"]["roundtrip_gbps"],
                     "hbm_echo_device_gbps": ici["rpc"]["device_gbps"],
                     "stream": stream},
        "mesh_collectives": {k: col[k] for k in (
            "mesh", "allreduce_value", "gather_shape",
            "reduce_scatter_shape", "busbw_gbps")},
        "allreduce_algbw_gbps": {c: runs[f"param_server_{c}"][
            "allreduce_algbw_gbps"] for c in ("none", "int8")},
        "int8_err": [ps8["codec_max_abs_err"], ps8["codec_err_bound"]],
        "long_context_ring": {k: ring[k] for k in (
            "mesh", "logits_shape", "forward_s", "launches_all_ranks")},
        "serving_arm": {k: arm[k] for k in (
            "mesh", "completed", "tokens_per_s", "ttft_p50_us",
            "gap_p50_us", "rail_local", "rail_host")},
        "plane": rates,
        "phase_s": time.monotonic() - t0}
    emit(line)
    return line


# python3 chip_smoke.py --serving-world: serving worlds across the cards
# of one host, each layout that the cards hold
WORLD_LAYOUTS = ({"dp": 1, "tp": 2}, {"dp": 1, "tp": 4}, {"dp": 2, "tp": 2})
WORLD_DTYPES = ("bf16", "f32")


def serving_world_rank(mesh):
    """One rank of a serving world (entry.launch_world's target) at
    ModelConfig()'s width, in each of WORLD_DTYPES.  The leader runs
    _serve_turns: the mesh engine over the world, in turns with a
    one-device engine of the same seed on the leader's card; a follower
    follows each mesh turn and counts its device operations and its own
    kernel launches."""
    import torch
    import torch.distributed as dist
    from brpc_tpu_torch import tpu_plane
    from brpc_tpu_torch.models.transformer import ModelConfig
    from brpc_tpu_torch.ops.causal_attention import causal_attention_forward
    from brpc_tpu_torch.ops.decode_attention import decode_attention
    from brpc_tpu_torch.serving import ServingEngine
    leader = dist.get_rank() == 0
    if leader:
        assert tpu_plane.init(), tpu_plane.error()
    out = {}
    for dt in WORLD_DTYPES:
        cfg = ModelConfig(dtype=torch.float32 if dt == "f32"
                          else torch.bfloat16)
        if leader:
            turns, p50, _ = _serve_turns(
                cfg, {"one_device": None, "mesh": mesh}, mesh.device)
            out[dt] = {"turns": turns, "p50": p50}
            continue
        out[dt] = []
        for _ in range(SERVE_TURNS.count("mesh")):
            decode_attention.launches = 0
            causal_attention_forward.launches = 0
            engine = ServingEngine(cfg=cfg, mesh=mesh, n_slots=4)
            engine.start()
            engine.stop()
            out[dt].append({
                **engine.dev.ops,
                "decode_attention": decode_attention.launches,
                "causal_attention_forward": causal_attention_forward.launches})
    return out


def world_line(axes, ranks, n_layers):
    """The serving_world line of one world from its ranks' returns, with
    what failed its checks under "failed": each engine streams the same tokens in both its turns;
    in f32 the mesh streams the one-device engine's tokens (bf16 is
    reported: the row-parallel partial sums are rounded to bf16 before
    the tp all-reduce adds them, so a greedy near-tie may part the
    streams); every follower replays the leader's device operations and
    launches decode_attention steps x n_layers and the causal forward
    prefills x n_layers times."""
    line = {"phase": "serving_world", "axes": axes, "ranks": len(ranks),
            "failed": []}
    for dt in WORLD_DTYPES:
        turns = ranks[0][dt]["turns"]
        seqs = {n: [t["sequential"] for t in turns if t["engine"] == n]
                for n in ("one_device", "mesh")}
        mesh_seq, one_seq = seqs["mesh"][0], seqs["one_device"][0]
        first_diff = [next((i for i, (a, b) in enumerate(zip(m, o))
                            if a != b), None)
                      for m, o in zip(mesh_seq, one_seq)]
        leader_ops = [t["ops_total"] for t in turns if t["engine"] == "mesh"]
        followers = [r[dt] for r in ranks[1:]]
        line[dt] = {
            "streams_equal": mesh_seq == one_seq,
            "prompts_equal": sum(d is None for d in first_diff),
            "first_diff": first_diff,
            "turns_repeat": all(s == v[0] for v in seqs.values()
                                for s in v),
            "p50": ranks[0][dt]["p50"],
            "turns": [{k: v for k, v in t.items() if k != "sequential"}
                      for t in turns],
            "follower_ops": followers[0] if followers else None}
        if not line[dt]["turns_repeat"]:
            line["failed"].append(f"{dt}: an engine's turns differ")
        if dt == "f32" and not line[dt]["streams_equal"]:
            line["failed"].append("f32: the mesh's streams differ from "
                                  "the one-device engine's")
        for r, f in enumerate(followers, 1):
            if [{k: o[k] for k in lo} for o, lo in
                    zip(f, leader_ops)] != leader_ops:
                line["failed"].append(f"{dt}: rank {r} replayed other "
                                      f"operations than the leader's")
            if not all(o["decode_attention"] == o["step"] * n_layers > 0
                       and o["causal_attention_forward"] ==
                       o["prefill"] * n_layers > 0 for o in f):
                line["failed"].append(f"{dt}: rank {r}'s launches are not "
                                      f"steps/prefills x n_layers")
    return line


def serving_worlds() -> int:
    """python3 chip_smoke.py --serving-world: ServingEngine(mesh=) at
    ModelConfig()'s width over each of WORLD_LAYOUTS that the host's
    cards hold, one entry.launch_world each (one NCCL rank a card, the
    leader's KV plane on its card), beside a one-device engine of the
    same seed: one serving_world line each (world_line's checks, the
    f32 streams held equal), then the card's name and power limit and
    the ok line."""
    import math
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from brpc_tpu_torch import _native
        from brpc_tpu_torch.entry import launch_world
        from brpc_tpu_torch.models.transformer import ModelConfig
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1
    n = torch.cuda.device_count()
    layouts = [a for a in WORLD_LAYOUTS if math.prod(a.values()) <= n]
    if not layouts:
        print(f"chip_smoke: --serving-world needs 2 cards, found {n}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    with ThreadPoolExecutor(2) as ex:   # built once, before the ranks
        for f in [ex.submit(_native.build_core),
                  ex.submit(_native.build_kernels)]:
            f.result()
    lines = []
    for axes in layouts:
        t0 = time.monotonic()
        ranks = launch_world(math.prod(axes.values()), axes,
                             f"{os.path.abspath(__file__)}"
                             ":serving_world_rank", device_type="cuda")
        line = world_line(axes, ranks, ModelConfig().n_layers)
        line.update(nvidia_smi=smi, wall_s=time.monotonic() - t0)
        emit(line)
        lines.append(line)
    failed = [f for line in lines for f in line["failed"]]
    assert not failed, failed
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": n}})
    return 0


def _client(addr, plen, max_new, seed, cancel_after, results, lock):
    import struct
    from brpc_tpu_torch.rpc import errors
    from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
    from brpc_tpu_torch.rpc.stream import StreamReset
    ch = Channel(addr, ChannelOptions(timeout_ms=120_000, max_retry=0))
    prompt = [(seed * 7919 + 31 * i) % 32000 for i in range(plen)]
    body = json.dumps({"prompt": prompt, "max_new_tokens": max_new}).encode()
    try:
        t0 = time.monotonic()
        while True:
            try:
                _, st = ch.create_stream("LLM.Generate", body)
                break
            except errors.RpcError as e:
                if e.code != errors.ELIMIT:
                    raise
                time.sleep(0.02)
        toks, stamps = [], []
        try:
            while True:
                b = st.read(timeout_s=120)
                if b is None:
                    break
                stamps.append(time.monotonic())
                toks.append(struct.unpack("<I", b)[0])
                if cancel_after and len(toks) == cancel_after:
                    st.rst(errors.ECANCELED)
                    break
        except StreamReset:
            pass
        st.destroy()
        with lock:
            results.append({"plen": plen, "tokens": toks, "t0": t0,
                            "stamps": stamps, "cancel": bool(cancel_after)})
    finally:
        ch.close()


def _p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def phase_serving():
    import torch
    from brpc_tpu_torch import tpu_plane
    from brpc_tpu_torch.models import decode as D
    from brpc_tpu_torch.models import transformer as T
    from brpc_tpu_torch.models.transformer import ModelConfig
    from brpc_tpu_torch.ops.causal_attention import causal_attention_plain
    from brpc_tpu_torch.ops.decode_attention import decode_attention_plain

    cfg = ModelConfig()
    live0 = tpu_plane.stats()["live_buffers"]
    engine, server, addr = _serve(cfg, None)
    kv_ms = _time_kv_route(engine.kv)
    plane0 = tpu_plane.stats()
    results, ops, wall = _concurrent(engine, addr)
    plane1 = tpu_plane.stats()
    kv_run = {k: list(v) for k, v in kv_ms.items()}   # this run's admits
    launches = ops["decode_attention"]
    prefill_launches = ops["causal_attention_forward"]
    steps = ops["step"]
    stats = engine.stats()
    _profile_decode(engine, addr)
    engine.stop()
    engine.assert_drained()
    server.destroy()
    full = [r for r in results if not r["cancel"]]
    assert len(full) == len(SERVE_PLENS) and \
        len(results) == len(SERVE_PLENS) + 1, results
    for r in full:
        assert len(r["tokens"]) == 16, r
        assert all(0 <= t < cfg.vocab for t in r["tokens"]), r
    assert launches == steps * cfg.n_layers and launches > 0, \
        (launches, steps)
    live1 = tpu_plane.stats()["live_buffers"]
    assert live1 == live0, (live0, live1)
    ttft = [r["stamps"][0] - r["t0"] for r in full]
    gaps = [b - a for r in full for a, b in zip(r["stamps"],
                                                  r["stamps"][1:])]
    n_tok = sum(len(r["tokens"]) for r in results)

    # one step through the kernel against the same step through the
    # plain version, from the same cache (outside the counted window)
    gen = torch.Generator().manual_seed(1)
    cache = D.init_cache(cfg, 4, 1024, "cuda")
    for slot, plen in enumerate((32, 100, 257, 1000)):
        toks = torch.randint(0, cfg.vocab, (1, plen), generator=gen)
        _, k, v = D.prefill(engine.params, toks, cfg)
        D.install(cache, slot, k[:, 0], v[:, 0], plen)
    tokens = torch.randint(0, cfg.vocab, (4,), generator=gen)
    active = torch.ones(4, dtype=torch.bool)
    twin = {key: t.clone() for key, t in cache.items()}
    # the kernel's side through the serving engine's graphed step
    got = D.StepGraphs(engine.params, cache, cfg).run(tokens, active)
    saved = D.decode_attention
    D.decode_attention = decode_attention_plain
    try:
        want, _ = D.decode_step(engine.params, twin, tokens, active, cfg)
    finally:
        D.decode_attention = saved
    step_err = float((got - want).abs().max())
    assert step_err <= STEP_LOGITS_ATOL, step_err

    # prefill logits through the causal_attention kernel against the same
    # prefill through the plain version (outside the counted window)
    toks = torch.randint(0, cfg.vocab, (2, PREFILL_LEN), generator=gen)
    got_p, got_k, _ = D.prefill(engine.params, toks, cfg)
    saved_causal = T.causal_attention
    T.causal_attention = causal_attention_plain
    try:
        want_p, want_k, _ = D.prefill(engine.params, toks, cfg)
    finally:
        T.causal_attention = saved_causal
    prefill_err = float((got_p - want_p).abs().max())
    assert prefill_err <= STEP_LOGITS_ATOL, prefill_err
    assert torch.equal(got_k[0], want_k[0]), "layer 0 K differs"
    assert torch.equal(cache["pos"], twin["pos"])
    assert torch.isfinite(got).all()

    emit({"phase": "serving", "device_name": torch.cuda.get_device_name(0),
          "clients": len(results), "tokens": n_tok, "wall_s": wall,
          "tok_per_s": n_tok / wall, "ttft_p50_ms": _p50(ttft) * 1e3,
          "inter_token_p50_ms": _p50(gaps) * 1e3, "steps": steps,
          "decode_attention_launches": launches,
          "causal_attention_fwd_launches": prefill_launches,
          "prefill_len": PREFILL_LEN,
          "prefill_logits_max_abs_err": prefill_err,
          "prefills": stats["prefills"], "canceled": stats["canceled"],
          "kv_blocks_allocs": stats["kv_pool_allocs"],
          "kv_route": {
              "plane_h2d": plane1["h2d_transfers"] - plane0["h2d_transfers"],
              "plane_d2h": plane1["d2h_transfers"] - plane0["d2h_transfers"],
              "block_bytes": engine.kv.block_bytes,
              "admits": len(kv_run["seq_alloc"]),
              "ms_per_admit": (sum(kv_run["seq_alloc"])
                               + sum(kv_run["seq_fetch"]))
              / max(1, len(kv_run["seq_alloc"])),
              "seq_alloc_ms_p50": _p50(kv_run["seq_alloc"]),
              "seq_fetch_ms_p50": _p50(kv_run["seq_fetch"])},
          "step_logits_max_abs_err": step_err})
    assert prefill_launches > 0 and prefill_launches % cfg.n_layers == 0, \
        prefill_launches
    return launches, prefill_launches


def _time_kv_route(kv):
    """Time each seq_alloc and seq_fetch of the engine's KV block plane
    from now on (host clock, ms): {method: [ms, ...]}."""
    times = {"seq_alloc": [], "seq_fetch": []}
    for name in times:
        inner = getattr(kv, name)

        def timed(*args, _inner=inner, _name=name):
            t0 = time.perf_counter()
            try:
                return _inner(*args)
            finally:
                times[_name].append((time.perf_counter() - t0) * 1e3)
        setattr(kv, name, timed)
    return times


def _profile_decode(engine, addr):
    """One torch.profiler window (CPU + CUDA) over PROFILE_STEPS steady
    decode steps of 4 clients, all admitted and none waiting: the device
    busy share of the window, the top device kernels by total time, and
    decode_attention's share.  Busy is the union of the device events'
    intervals over the window's host-clock length."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):   # start-up (CUPTI) outside the window
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    results, lock = [], threading.Lock()
    prefills0 = engine.prefills
    threads = [threading.Thread(target=_client,
                                args=(addr, 32, PROFILE_NEW_TOKENS, 200 + i,
                                      0, results, lock)) for i in range(4)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 120
    while engine.prefills - prefills0 < 4 or engine.stats()["waiting"]:
        assert time.monotonic() < deadline, "profile clients not admitted"
        time.sleep(0.002)
    with profile(activities=acts) as prof:
        steps0 = engine.steps
        t0 = time.perf_counter()
        while engine.steps - steps0 < PROFILE_STEPS:
            assert time.monotonic() < deadline, \
                f"{engine.steps - steps0} decode steps in the window"
            time.sleep(0.001)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
        steps = engine.steps - steps0
    for t in threads:
        t.join(600)
        assert not t.is_alive(), "a profile client did not finish"
    assert len(results) == 4 and all(
        len(r["tokens"]) == PROFILE_NEW_TOKENS for r in results), results
    line = {"phase": "profile", "steps": steps,
            **device_profile(prof, window_us)}
    if line["device_events"]:
        by_name = line.pop("_by_name")
        total = sum(v[1] for v in by_name.values())
        attn = sum(v[1] for k, v in by_name.items()
                   if "decode_attention" in k)
        line.update({
            "decode_attention_device_ms": attn / 1e3,
            "decode_attention_share_of_device": attn / total,
            "decode_attention_share_of_window": attn / window_us})
    emit(line)


def device_profile(prof, window_us):
    """What a torch.profiler window shows of the device: its events, the
    busy time (the union of the device events' intervals) and its share
    of the window's host-clock length, the top device kernels by total
    time; "_by_name" holds {kernel name: [count, total us]}."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, spans = {}, []
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        tot = by_name.setdefault(e.name, [0, 0.0])
        tot[0] += 1
        tot[1] += b - a
    busy, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    out = {"window_ms": window_us / 1e3, "device_events": len(dev)}
    if dev:
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        out.update({
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / window_us,
            "top_device_kernels": [
                {"name": k[:96], "count": v[0], "total_ms": v[1] / 1e3}
                for k, v in top],
            "_by_name": by_name})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    try:
        import brpc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1
    card = phase_card()
    smi = card["nvidia_smi"]
    phase_plane()
    phase_transport()
    phase_uring()
    kern = phase_kernel()
    k, gqa = kern["full"], kern["gqa"]["full"]
    attn = phase_attention()
    launches, prefill_launches = phase_serving()
    train_launches, f32_twin_launches = phase_train()
    par = phase_parallel(smi)
    ring, _, mesh_serving = phase_mesh(smi)
    phase_examples(smi)
    shards = mesh_serving["tp_shards"]
    kernels = [{
        "name": "decode_attention", "route": "cuda",
        "source": "brpc_tpu_torch/csrc/decode_attention.cu",
        "replaces": "brpc_tpu/models/decode.py:178",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        "max_err": k["max_abs_err"], "kernel_ms": k["ms"],
        "cold_ms": k["cold_ms"], "library_cold_ms": k["library_cold_ms"],
        "launch_floor_ms": k["launch_floor_ms"],
        "host_call_ms": k["host_call_ms"], "window": k["window"],
        "mesh_serving_launches": mesh_serving["decode_attention_launches"],
        "tp_shards": {c: r for c, r in shards.items()
                      if c.startswith("decode")}}, {
        "name": "decode_attention_gqa", "route": "cuda",
        "source": "brpc_tpu_torch/csrc/decode_attention.cu",
        "replaces": "brpc_tpu/models/decode.py:178",
        "shape": dict(zip(("N", "S", "H", "hd"), GQA_KERNEL_SHAPE),
                      KV=GQA_KV_HEADS),
        **{n: gqa[n] for n in ("launches", "max_abs_err", "ms", "cold_ms",
                               "bound_ms", "bound_by", "bound_share",
                               "window")},
        "launches_in": "kernel phase, the GQA leg's f32 and bf16 checks"}]

    def compiled(kernel):   # the hd 64 instantiation the shapes here run
        return {"sass_hgmma": card["sass_hgmma"].get(kernel),
                "ptxas": card["ptxas_by_kernel"].get(kernel)}

    err = attn["errs"]["bf16_S1024"]
    for name, wrapper, outs, replaces in (
            ("fwd", "causal_attention_forward", ("o",),
             "brpc_tpu/models/transformer.py:197"),
            ("bwd_dq", "causal_attention_backward_dq", ("dq",),
             "brpc_tpu/models/transformer.py:197 (its jax.grad)"),
            ("bwd_dkdv", "causal_attention_backward_dkdv", ("dk", "dv"),
             "brpc_tpu/models/transformer.py:197 (its jax.grad)")):
        row = attn["rows"][name]
        kernels.append({
            "name": f"causal_attention_{name}", "route": "cuda",
            "source": "brpc_tpu_torch/csrc/causal_attention_sm90.cu",
            "replaces": replaces, "launches": train_launches[wrapper],
            "max_abs_err": max(err[o] for o in outs), **row,
            **compiled(f"causal_{name.replace('bwd_', '')}_sm90<64>"),
            "launches_in": "train phase, 5 steps x 4 layers",
            **({"serving_prefill_launches": prefill_launches,
                "mesh_serving_prefill_launches":
                    mesh_serving["causal_attention_fwd_launches"],
                "tp_shards": {c: r for c, r in shards.items()
                              if c.startswith("causal")}}
               if name == "fwd" else {})})
    err = attn["errs"]["f32_S1024"]
    for name, wrapper, outs, source, kernel in (
            ("fwd", "causal_attention_forward", ("o", "lse"),
             "causal_attention_f32.cu", "causal_fwd_f32_kernel<64>"),
            ("bwd_dq", "causal_attention_backward_dq", ("dq",),
             "causal_attention_f32.cu", "causal_dq_f32_kernel<64>"),
            ("bwd_dkdv", "causal_attention_backward_dkdv", ("dk", "dv"),
             "causal_attention_f32.cu", "causal_dkdv_f32_kernel<64>")):
        kernels.append({
            "name": f"causal_attention_{name}_f32", "route": "cuda",
            "source": f"brpc_tpu_torch/csrc/{source}",
            "replaces": "brpc_tpu/models/transformer.py:197"
                        + ("" if name == "fwd" else " (its jax.grad)"),
            "launches": f32_twin_launches[wrapper],
            "max_abs_err": max(err[o] for o in outs),
            **attn["rows_f32"][name], **compiled(kernel),
            "launches_in": "train phase, the f32 twin step (4 layers)"})
    kernels.append({
        "name": "fake_quant_int8", "route": "cuda",
        "source": "brpc_tpu_torch/csrc/quant_codec.cu",
        "replaces": "brpc_tpu/parallel/quantize.py:25",
        "launches": par["launches"], "max_abs_err": 0.0,   # bit-equal
        **{k: par[k] for k in ("ms", "cold_ms", "plain_ms", "bound_ms",
                               "bound_by", "bound_share", "library_ms",
                               "host_call_ms")},
        "values": PS_PARAMS, "dtype": "f32",
        "launches_in": "parallel phase, one int8 merge of the "
                       "parameter-server gradient"})
    for name, wrapper, replaces, source, kernel in (
            ("fwd", "ring_fold_forward",
             "brpc_tpu/parallel/ring_attention.py:56", "ring_fold_sm90.cu",
             "ring_fold_fwd_sm90_kernel<64>"),
            ("bwd_dq", "ring_fold_backward_dq",
             "brpc_tpu/parallel/ring_attention.py:56 (its jax.grad)",
             "ring_fold_sm90.cu", "ring_fold_dq_sm90_kernel<64>"),
            ("bwd_dkdv", "ring_fold_backward_dkdv",
             "brpc_tpu/parallel/ring_attention.py:56 (its jax.grad)",
             "ring_fold_sm90.cu", "ring_fold_dkdv_sm90_kernel<64>")):
        kernels.append({
            "name": f"ring_fold_{name}", "route": "cuda",
            "source": f"brpc_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": ring["launches"][wrapper],
            "max_abs_err": ring["max_abs_err"][name],
            **ring["kernels"][name], **compiled(kernel),
            "launches_in": "ring phase: ring_attention and "
                           "ulysses_attention, forward and backward, on "
                           "the NCCL world of one"})
    for name, wrapper, kernel in (
            ("fwd", "ring_fold_forward", "ring_fold_fwd_f32_kernel<64>"),
            ("bwd_dq", "ring_fold_backward_dq", "ring_fold_dq_f32_kernel<64>"),
            ("bwd_dkdv", "ring_fold_backward_dkdv",
             "ring_fold_dkdv_f32_kernel<64>")):
        kernels.append({
            "name": f"ring_fold_{name}_f32", "route": "cuda",
            "source": "brpc_tpu_torch/csrc/ring_fold_f32.cu",
            "replaces": "brpc_tpu/parallel/ring_attention.py:56"
                        + ("" if name == "fwd" else " (its jax.grad)"),
            "launches": ring["launches_f32"][wrapper],
            "max_abs_err": ring["max_abs_err_f32"][name],
            **ring["kernels_f32"][name], **compiled(kernel),
            "launches_in": "ring phase: ring_attention and "
                           "ulysses_attention in f32, forward and "
                           "backward, on the NCCL world of one"})
    hd8 = ring["hd8"]
    for dt in ("f32", "bf16"):
        for name, wrapper in (("fwd", "ring_fold_forward"),
                              ("bwd_dq", "ring_fold_backward_dq"),
                              ("bwd_dkdv", "ring_fold_backward_dkdv")):
            source, kernel = HD8_KERNELS[dt][name]
            kernels.append({
                "name": f"ring_fold_{name}_hd8_{dt}", "route": "cuda",
                "source": f"brpc_tpu_torch/csrc/{source}",
                "kernel": kernel,
                "replaces": "brpc_tpu/parallel/ring_attention.py:56"
                            + ("" if name == "fwd" else " (its jax.grad)"),
                "launches": hd8["launches"][dt][wrapper],
                "max_abs_err": hd8["max_abs_err"][dt][name],
                **hd8["kernels"][dt][name],
                **compiled(kernel),
                "sass_hmma": card["sass_hmma"].get(kernel, 0),
                "shape": hd8["shape"],
                "launches_in": "ring phase: ring_attention and "
                               f"ulysses_attention in {dt} at hd 8 (64 "
                               "heads of 8), forward and backward, on the "
                               "NCCL world of one; no path of "
                               "ModelConfig() (hd 64) launches them"})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = serving_worlds() if sys.argv[1:] == ["--serving-world"] \
            else main()
    except Exception:  # a failed phase: report it, print no result
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(rc)
