#!/usr/bin/env python3
r"""Other trees' causal_attention and ring-fold kernels beside the
checkout's, on one NVIDIA GPU: the bf16 forward, dq and dk/dv kernels,
their wrappers' host time, the f32 forward's time and accuracy, the
time of the ring fold's f32 forward, the f32 dq and dk/dv kernels'
(causal and the fold's) times, bits and accuracy, the causal bf16 dq's
accuracy, and the fold's kernels at head dim 8 in bf16 and in f32.

    mkdir -p scratch/base
    git archive <commit> | tar -x -C scratch/base
    python3 causal_attention_ab.py scratch/base [TREE ...]

A TREE is a checkout of this repo; its ``brpc_tpu_torch`` builds its own
kernels at first use (every tree's build runs at once, before any
timing).  Each tree is measured in a process of its own that imports its
package, in the order TREE ..., the checkout, the checkout, TREE ...
reversed.  Each prints one JSON line:

* ``device_ms``: one call of the forward, dq and dk/dv on the device alone
  (chip_smoke.py's ``device_ms``: [L2-warm ms, L2-cold ms]) at
  chip_smoke.py's ATTN_SHAPE (``train``) and ATTN_PREFILL_SHAPE
  (``prefill``);
* ``prefill_host_us``: microseconds of host time per call at
  ATTN_PREFILL_SHAPE, where the kernels take a few microseconds: the
  median of 7 rounds of 400 calls timed before the device catches up,
  through the wrapper (contiguous inputs, and q, k, v as views of one
  fused projection, as the model passes them) and through the C entry
  alone (ctypes, the arguments made once);
* ``f32_fwd``: the f32 forward's ``device_ms`` at ATTN_SHAPE, and
  ``f64_err``: at S = 1000 and 1024, head dims 16, 64 and 128, unit
  scale and a wide range (q, k x 2, v x 8; B=2, H=3, numpy seed 14),
  the largest |o - o64| of the kernel and of the plain version against
  o computed in f64 throughout, and the kernel's o against the plain
  version as a share of ATTN_TOL["f32"];
* ``f32_dq``: the f32 dq's ``device_ms`` at ATTN_SHAPE, and
  ``f32_fold_dq`` the fold's f32 dq's at RING_SHAPE (lse and D of the
  fold of that block; one causal diagonal block, a fresh state), each
  beside ``sdpa_f32``'s backward;
* ``f32_fold_fwd``: the ring fold's f32 forward's ``device_ms`` at
  chip_smoke.py's RING_SHAPE (one causal diagonal block, a fresh state,
  folded again at every call as chip_smoke.py times it);
* ``sdpa_f32``: scaled_dot_product_attention(is_causal=True) in f32 at
  ATTN_SHAPE, forward and forward+backward, ``device_ms`` (a yardstick of
  time, the same library in every tree's process);
* ``fold_f64_err``: the ring fold's f32 forward at head dims 16, 64 and
  128 on a carried state (m ~ U(-1, 2), l ~ U(1, 4), o unit normal;
  B=2, C=1000, H=3, q_off 1000, k_off 0, causal: every key seen) and
  from a fresh state on a diagonal block (C=1024, offsets 0): the
  largest |x - x64| / (atol + rtol |x64|) under RING_TOL["f32"] over m,
  l and o of the kernel and of the plain version against the fold in
  f64, and of the kernel against the plain version (numpy seed 17);
* ``f32_dkdv``: the f32 dk/dv's ``device_ms`` at ATTN_SHAPE (lse and D
  from the tree's own forward and dq), and ``f32_fold_dkdv`` the fold's
  f32 dk/dv's at RING_SHAPE (lse and D of the fold of that block); each
  beside ``sdpa_f32``'s backward (fwd_bwd less fwd);
* ``bf16_fold_hd8``: the ring fold's bf16 forward's, dq's and dk/dv's
  ``device_ms`` at chip_smoke.py's RING_HD8 (hd 8; one causal diagonal
  block from a fresh state, folded again at every call; dq and dk/dv
  from the plain fold's lse and D), the share of chip_smoke.py's bf16
  rule (RING_TOL and its flips) that m, l, o, dq, dk and dv use against
  the plain version on the same inputs, and a digest of the bits of m,
  l, o, dk and dv (``digest``) and of dq (``dq_digest``);
* ``f32_fold_hd8``: the same in f32 (the share of RING_TOL["f32"]), with
  a digest of dk and dv, and ``fwd_f64``: the forward's m, l and o
  against the fold in f64 throughout, [max abs err, share of
  RING_TOL["f32"]] (the largest over m, l and o) of the kernel and of
  the plain version;
* ``dq_digest`` and ``dkdv_digest``: a sha256 of the bytes of dq (the
  causal kernel's with its D) and of dk and dv of those calls (two trees
  that print the same digest computed the same bits);
* ``dq_f64_err`` and ``dkdv_f64_err``: at S = C = 1000 and 1024, head
  dims 16, 64 and 128 (the fold also 8), unit scale and a wide range
  (q, k x 2, v x 8; B=2, H=3, numpy seed 23), of causal attention (lse
  from the plain softmax in f32; dk/dv also its D; ``causal_bf16_*``:
  the bf16 dq on the same values rounded to bf16, lse from the bf16
  scores) and of the fold (a ring's first, diagonal block; lse and D of
  the plain f32 fold): the largest |x - x64| of the kernel and of the
  plain version against the same in f64 throughout, [kernel dq, plain
  dq] and [kernel dk, plain dk, kernel dv, plain dv].

Prints the card's nvidia-smi name and power limit first and, after the
trees' lines, one line ``f32_fold_hd8_dq_bits_equal_first_tree``: for
each process in order, whether its f32 hd-8 ``dq_digest`` equals the
first TREE's (the same dq bits); exits non-zero if a tree's process
failed.
"""

import hashlib
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    """The checkout's chip_smoke.py (its timing helpers and shapes)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(fn, calls=400, rounds=7) -> float:
    import torch
    per_call = []
    for _ in range(rounds):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        per_call.append((t1 - t0) / calls * 1e6)
    return statistics.median(per_call)


def f64_errors(ca, cs) -> dict:
    """{case: [kernel's max |o - o64|, plain version's, kernel's largest
    |o - plain| / (atol + rtol |plain|) under ATTN_TOL["f32"]]}."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = cs.ATTN_TOL["f32"]
    out = {}
    for S in (1000, 1024):
        for hd in (16, 64, 128):
            for name, scale, v_scale in (("unit", 1.0, 1.0),
                                         ("wide", 2.0, 8.0)):
                rng = np.random.default_rng(14)
                q, k, v = (torch.from_numpy((scale * rng.standard_normal(
                    (2, S, 3, hd))).astype(np.float32)).to("cuda")
                    for _ in range(3))
                v = v * v_scale
                o, _ = ca.causal_attention_forward(q, k, v)
                plain = ca.causal_attention_plain(q, k, v)
                s = torch.einsum("bshk,bthk->bhst", q.double(),
                                 k.double()) / math.sqrt(hd)
                mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                             device="cuda"))
                w = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
                o64 = torch.einsum("bhst,bthk->bshk", w, v.double())
                out[f"S{S}_hd{hd}_{name}"] = [
                    float((o.double() - o64).abs().max()),
                    float((plain.double() - o64).abs().max()),
                    float(((o - plain).abs() / (
                        tol["atol"] + tol["rtol"] * plain.abs())).max())]
    return out


def fold_f64_errors(rf, cs) -> dict:
    """{case: [kernel vs f64, plain vs f64, kernel vs plain]}: shares of
    RING_TOL["f32"], the largest over m, l and o."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = cs.RING_TOL["f32"]

    def share(got, want):
        return max(float(((a.double() - b.double()).abs() / (
            tol["atol"] + tol["rtol"] * b.double().abs())).max())
            for a, b in zip(got, want))
    out = {}
    for name, C, q_off, k_off, fresh in (("carried_c1000", 1000, 1000, 0,
                                          False),
                                         ("fresh_c1024", 1024, 0, 0, True)):
        for hd in (16, 64, 128):
            rng = np.random.default_rng(17)
            q, k, v, o = (torch.from_numpy(rng.standard_normal(
                shape).astype(np.float32)).to("cuda") for shape in (
                    (2, C, 3, hd), (2, C, 3, hd), (2, C, 3, hd),
                    (2, 3, C, hd)))
            m = torch.from_numpy(rng.uniform(-1, 2, (2, 3, C)).astype(
                np.float32)).to("cuda")
            l = torch.from_numpy(rng.uniform(1, 4, (2, 3, C)).astype(
                np.float32)).to("cuda")
            if fresh:
                m, l, o = m.fill_(-1e30), l.zero_(), o.zero_()
            scale = hd ** -0.5
            kern = [t.clone() for t in (m, l, o)]
            rf.ring_fold_forward(q, k, v, *kern, q_off, k_off, True, scale)
            plain = [t.clone() for t in (m, l, o)]
            rf.ring_fold_plain(q, k, v, *plain, q_off, k_off, True, scale)
            exact = cs._fold_f64((q, k, v), (m, l, o), q_off, k_off, True,
                                 scale)
            out[f"{name}_hd{hd}"] = [share(kern, exact),
                                     share(plain, exact),
                                     share(kern, plain)]
    return out


def _causal_f64_grads(q, k, v, do):
    """dq, dk, dv of causal attention in f64 throughout."""
    import torch
    S, hd = q.shape[1], q.shape[-1]
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    s = torch.einsum("bshk,bthk->bhst", *leaves[:2]) / math.sqrt(hd)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device="cuda"))
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    o = torch.einsum("bhst,bthk->bshk", w, leaves[2])
    return torch.autograd.grad(o, leaves, do.double())


def _fold_f64_grads(q, k, v, do, scale):
    """dq, dk, dv [B, H, C, hd] of a ring's first, diagonal fold in f64
    throughout (its lse and D from the f64 fold)."""
    import torch
    q, k, v, do = (t.double() for t in (q, k, v, do))
    C = q.shape[1]
    s = torch.einsum("bchk,bdhk->bhcd", q, k) * scale
    pos = torch.arange(C, device="cuda")
    s = torch.where(pos[:, None] >= pos[None, :], s, -1e30)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhcd,bdhk->bhck", p, v)
    delta = (do.transpose(1, 2) * o).sum(-1)
    ds = p * (torch.einsum("bchk,bdhk->bhcd", do, v) - delta[..., None]) \
        * scale
    return (torch.einsum("bhcd,bdhk->bhck", ds, k),
            torch.einsum("bhcd,bchk->bhdk", ds, q),
            torch.einsum("bhcd,bchk->bhdk", p, do))


def _lse(q, k, S, hd):
    """The plain softmax's f32 lse of causal attention's scores (the
    product in q's type)."""
    import torch
    s = torch.einsum("bshk,bthk->bhst", q, k).float() / math.sqrt(hd)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device="cuda"))
    return s, torch.logsumexp(s.masked_fill(~mask, -1e30), -1)


def causal_errors(ca, q, k, v, do, S, name, out, err) -> dict:
    """Causal attention's dq, dk, dv in f32 and its dq in bf16 against
    f64 (bwd_f64_errors' causal rows): {case: [kernel dq, plain dq]},
    and [kernel dk, plain dk, kernel dv, plain dv] into `out`."""
    import torch
    hd = q.shape[-1]
    # lse and D of the plain f32 softmax
    s, lse = _lse(q, k, S, hd)
    p = torch.exp(s - lse[..., None]).tril()
    delta = (p * torch.einsum("bshk,bthk->bhst", do, v)).sum(-1)
    got = (ca.causal_attention_backward_dq(q, k, v, do, lse)[0],
           *ca.causal_attention_backward_dkdv(q, k, v, do, lse, delta))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = torch.autograd.grad(ca.causal_attention_plain(*leaves), leaves,
                                do)
    exact = _causal_f64_grads(q, k, v, do)
    key = f"S{S}_hd{hd}_{name}"
    out[f"causal_{key}"] = [err(got[1], exact[1]), err(plain[1], exact[1]),
                            err(got[2], exact[2]), err(plain[2], exact[2])]
    # the bf16 dq (its D = sum_t p dW unnormalised) on the values in bf16
    qb, kb, vb, dob = (t.to(torch.bfloat16) for t in (q, k, v, do))
    got_b = ca.causal_attention_backward_dq(qb, kb, vb, dob,
                                            _lse(qb, kb, S, hd)[1])[0]
    leaves = [t.clone().requires_grad_(True) for t in (qb, kb, vb)]
    plain_b, = torch.autograd.grad(ca.causal_attention_plain(*leaves),
                                   leaves[0], dob)
    exact_b = _causal_f64_grads(qb, kb, vb, dob)[0]
    return {f"causal_{key}": [err(got[0], exact[0]), err(plain[0], exact[0])],
            f"causal_bf16_{key}": [err(got_b, exact_b),
                                   err(plain_b, exact_b)]}


def bwd_f64_errors(ca, rf, cs):
    """({case: [kernel dq, plain dq]}, {case: [kernel dk, plain dk,
    kernel dv, plain dv]}): the largest |x - x64| against the same
    function in f64 throughout."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False

    def err(a, b):
        return float((a.double() - b).abs().max())
    dq_out, out = {}, {}
    for S in (1000, 1024):
        for hd in (8, 16, 64, 128):
            for name, scale, v_scale in (("unit", 1.0, 1.0),
                                         ("wide", 2.0, 8.0)):
                rng = np.random.default_rng(23)
                q, k, v, do = (torch.from_numpy((scale * rng.standard_normal(
                    (2, S, 3, hd))).astype(np.float32)).to("cuda")
                    for _ in range(4))
                v = v * v_scale
                if hd != 8:   # causal attention takes 16, 64 and 128
                    dq_out.update(causal_errors(ca, q, k, v, do, S, name,
                                                out, err))
                # the fold: a ring's first, diagonal block
                fscale = hd ** -0.5
                m = torch.full((2, 3, S), -1e30, device="cuda")
                l = torch.zeros(2, 3, S, device="cuda")
                o = torch.zeros(2, 3, S, hd, device="cuda")
                rf.ring_fold_plain(q, k, v, m, l, o, 0, 0, True, fscale)
                flse, fdelta = cs._lse_delta(m, l, o, do)
                kern = [torch.zeros_like(o) for _ in range(3)]
                rf.ring_fold_backward_dq(q, k, v, do, flse, fdelta, kern[0],
                                         0, 0, True, fscale)
                rf.ring_fold_backward_dkdv(q, k, v, do, flse, fdelta,
                                           *kern[1:], 0, 0, True, fscale)
                fplain = [torch.zeros_like(o) for _ in range(3)]
                rf.ring_fold_bwd_dq_plain(q, k, v, do, flse, fdelta,
                                          fplain[0], 0, 0, True, fscale)
                rf.ring_fold_bwd_dkdv_plain(q, k, v, do, flse, fdelta,
                                            *fplain[1:], 0, 0, True, fscale)
                fexact = _fold_f64_grads(q, k, v, do, fscale)
                dq_out[f"fold_C{S}_hd{hd}_{name}"] = [
                    err(kern[0], fexact[0]), err(fplain[0], fexact[0])]
                out[f"fold_C{S}_hd{hd}_{name}"] = [
                    err(kern[1], fexact[1]), err(fplain[1], fexact[1]),
                    err(kern[2], fexact[2]), err(fplain[2], fexact[2])]
    return dq_out, out


def fold_hd8(rf, cs, g, flush, dtype) -> dict:
    """The ring fold's forward, dq and dk/dv at RING_HD8 in `dtype` (one
    causal diagonal block from a fresh state; dq and dk/dv from the plain
    fold's lse and D): ``device_ms`` of each, the share of chip_smoke.py's
    rule (RING_TOL, in bf16 its flips) each output uses against the plain
    version, and digests of the kernels' outputs."""
    import torch
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    scale = cs.RING_HD8[3] ** -0.5
    qkvd, state = cs._fold_inputs(g, cs.RING_HD8, dtype, True)
    kernels = (rf.ring_fold_forward, rf.ring_fold_backward_dq,
               rf.ring_fold_backward_dkdv)
    plains = (rf.ring_fold_plain, rf.ring_fold_bwd_dq_plain,
              rf.ring_fold_bwd_dkdv_plain)
    got, _ = cs._fold_block(kernels, qkvd, state, 0, 0, True, scale)
    want, _ = cs._fold_block(plains, qkvd, state, 0, 0, True, scale)
    names = ("m", "l", "o", "dq", "dk", "dv")
    held = {n: cs._held(a, b, dt)[1] for n, a, b in zip(names, got, want)}
    q, k, v, do = qkvd
    lse, delta = cs._lse_delta(*want[:3], do)
    acc = [torch.zeros_like(state[2]) for _ in range(3)]
    fwd_f64 = None
    if dtype == torch.float32:
        exact = cs._fold_f64(qkvd, state, 0, 0, True, scale)
        fwd_f64 = {}
        for who, outs in (("kernel", got), ("plain", want)):
            errs = [cs._held(outs[i], exact[i], dt) for i in range(3)]
            fwd_f64[who] = [max(e[0] for e in errs), max(e[1] for e in errs)]
        del exact
    return {"shape": list(cs.RING_HD8), "fwd_f64": fwd_f64,
            "fwd": cs.device_ms(lambda: rf.ring_fold_forward(
                q, k, v, *state, 0, 0, True, scale), flush),
            "bwd_dq": cs.device_ms(lambda: rf.ring_fold_backward_dq(
                q, k, v, do, lse, delta, acc[0], 0, 0, True, scale), flush),
            "bwd_dkdv": cs.device_ms(lambda: rf.ring_fold_backward_dkdv(
                q, k, v, do, lse, delta, *acc[1:], 0, 0, True, scale),
                flush),
            "share_vs_plain": held,
            "digest": _digest(*(got[i] for i in (0, 1, 2, 4, 5))),
            "dkdv_digest": _digest(got[4], got[5]),
            "dq_digest": _digest(got[3])}


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch
    ca = importlib.import_module("brpc_tpu_torch.ops.causal_attention")
    cs = _chip_smoke()
    g = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.ones(cs.FLUSH_BYTES // 4, device="cuda").sum
    device = {}
    for label, shape in (("train", cs.ATTN_SHAPE),
                         ("prefill", cs.ATTN_PREFILL_SHAPE)):
        q, k, v, do = (torch.randn(*shape, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        _, lse = ca.causal_attention_forward(q, k, v)
        _, delta = ca.causal_attention_backward_dq(q, k, v, do, lse)
        device[label] = {
            "fwd": cs.device_ms(lambda: ca.causal_attention_forward(q, k, v),
                                flush),
            "bwd_dq": cs.device_ms(
                lambda: ca.causal_attention_backward_dq(q, k, v, do, lse),
                flush),
            "bwd_dkdv": cs.device_ms(
                lambda: ca.causal_attention_backward_dkdv(q, k, v, do, lse,
                                                          delta), flush)}
    # the host time, at the prefill shape: q, k, v, do, lse, delta of the
    # last pass
    B, S, H, hd = shape
    fq, fk, fv = torch.randn(B, S, 3, H, hd, generator=g, device="cuda").to(
        torch.bfloat16).unbind(2)
    lib = ca._kernels()
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    lse2, delta2 = (torch.empty(B, H, S, device="cuda") for _ in range(2))
    tail = [B, S, H, hd, 0, math.sqrt(hd),   # 0: bf16
            torch.cuda.current_stream().cuda_stream]
    fwd_args = ([t.data_ptr() for t in (q, k, v, o, lse2)]
                + [ca._strides((q, k, v))] + tail)
    dq_args = ([t.data_ptr() for t in (q, k, v, do, lse, dq, delta2)]
               + [ca._strides((q, k, v, do))] + tail)
    dkdv_args = ([t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)]
                 + [ca._strides((q, k, v, do))] + tail)
    assert lib.trpc_causal_attention_fwd(*fwd_args) == 0
    assert lib.trpc_causal_attention_bwd_dq(*dq_args) == 0
    assert lib.trpc_causal_attention_bwd_dkdv(*dkdv_args) == 0
    host = {
        "wrapper_fwd": host_us(lambda: ca.causal_attention_forward(q, k, v)),
        "wrapper_fwd_fused_views": host_us(
            lambda: ca.causal_attention_forward(fq, fk, fv)),
        "wrapper_dq": host_us(
            lambda: ca.causal_attention_backward_dq(q, k, v, do, lse)),
        "wrapper_dkdv": host_us(
            lambda: ca.causal_attention_backward_dkdv(q, k, v, do, lse,
                                                      delta)),
        "c_entry_fwd": host_us(lambda: lib.trpc_causal_attention_fwd(
            *fwd_args)),
        "c_entry_dq": host_us(lambda: lib.trpc_causal_attention_bwd_dq(
            *dq_args)),
        "c_entry_dkdv": host_us(lambda: lib.trpc_causal_attention_bwd_dkdv(
            *dkdv_args))}
    q, k, v, do = (torch.randn(*cs.ATTN_SHAPE, generator=g, device="cuda")
                   for _ in range(4))
    _, lse = ca.causal_attention_forward(q, k, v)
    f32 = {"device_ms": cs.device_ms(
        lambda: ca.causal_attention_forward(q, k, v), flush),
        "f64_err": f64_errors(ca, cs)}
    f32_dq = cs.device_ms(
        lambda: ca.causal_attention_backward_dq(q, k, v, do, lse), flush)
    dq_digest = {"causal": _digest(*ca.causal_attention_backward_dq(
        q, k, v, do, lse))}
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa(*a):
        return torch.nn.functional.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in a), is_causal=True).transpose(1, 2)

    sdpa_f32 = {"fwd": cs.device_ms(lambda: sdpa(q, k, v), flush),
                "fwd_bwd": cs.device_ms(lambda: torch.autograd.grad(
                    sdpa(*leaves), leaves, do), flush)}
    _, delta = ca.causal_attention_backward_dq(q, k, v, do, lse)
    f32_dkdv = cs.device_ms(lambda: ca.causal_attention_backward_dkdv(
        q, k, v, do, lse, delta), flush)
    digest = {"causal": _digest(*ca.causal_attention_backward_dkdv(
        q, k, v, do, lse, delta))}
    rf = importlib.import_module("brpc_tpu_torch.ops.ring_fold")
    (fq, fk, fv, fdo), state = cs._fold_inputs(g, cs.RING_SHAPE,
                                               torch.float32, True)
    scale = cs.RING_SHAPE[3] ** -0.5
    fold = cs.device_ms(lambda: rf.ring_fold_forward(
        fq, fk, fv, *state, 0, 0, True, scale), flush)
    # the dk/dv of one fold of the block from a fresh state
    _, state = cs._fold_inputs(g, cs.RING_SHAPE, torch.float32, True)
    rf.ring_fold_forward(fq, fk, fv, *state, 0, 0, True, scale)
    flse, fdelta = cs._lse_delta(*state, fdo)
    acc = [torch.zeros_like(state[2]) for _ in range(2)]
    rf.ring_fold_backward_dkdv(fq, fk, fv, fdo, flse, fdelta, *acc, 0, 0,
                               True, scale)
    digest["fold"] = _digest(*acc)
    fold_dkdv = cs.device_ms(lambda: rf.ring_fold_backward_dkdv(
        fq, fk, fv, fdo, flse, fdelta, *acc, 0, 0, True, scale), flush)
    # the dq of the same fold
    fdq = torch.zeros_like(state[2])
    rf.ring_fold_backward_dq(fq, fk, fv, fdo, flse, fdelta, fdq, 0, 0, True,
                             scale)
    dq_digest["fold"] = _digest(fdq)
    fold_dq = cs.device_ms(lambda: rf.ring_fold_backward_dq(
        fq, fk, fv, fdo, flse, fdelta, fdq, 0, 0, True, scale), flush)
    dq_err, dkdv_err = bwd_f64_errors(ca, rf, cs)
    print(json.dumps({"tree": tree,
                      "bf16_fold_hd8": fold_hd8(rf, cs, g, flush,
                                                torch.bfloat16),
                      "f32_fold_hd8": fold_hd8(rf, cs, g, flush,
                                               torch.float32),
                      "device_ms": device,
                      "prefill_host_us": host, "f32_fwd": f32,
                      "f32_dq": f32_dq, "f32_fold_fwd": fold,
                      "f32_fold_dq": fold_dq, "f32_dkdv": f32_dkdv,
                      "f32_fold_dkdv": fold_dkdv, "dq_digest": dq_digest,
                      "dkdv_digest": digest, "sdpa_f32": sdpa_f32,
                      "fold_f64_err": fold_f64_errors(rf, cs),
                      "dq_f64_err": dq_err, "dkdv_f64_err": dkdv_err}),
          flush=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--measure":
        measure(argv[2])
        return 0
    trees = [os.path.abspath(t) for t in argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("causal_attention_ab.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)

    def build(tree):
        subprocess.run([sys.executable, "-c", "from brpc_tpu_torch import "
                        "_native; _native.build_kernels()"], cwd=tree,
                       check=True)
    with ThreadPoolExecutor(len(trees) + 1) as ex:
        list(ex.map(build, trees + [HERE]))
    rc, runs = 0, []
    for tree in trees + [HERE, HERE] + trees[::-1]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--measure", tree], stdout=subprocess.PIPE,
                           text=True)
        sys.stdout.write(r.stdout)
        sys.stdout.flush()
        rc |= r.returncode
        lines = [json.loads(ln) for ln in r.stdout.splitlines()
                 if ln.startswith("{")]
        runs.append((tree, lines[-1]["f32_fold_hd8"]["dq_digest"]
                     if lines else None))
    print(json.dumps({"f32_fold_hd8_dq_bits_equal_first_tree": [
        {"tree": tree, "equal": digest is not None
         and digest == runs[0][1]} for tree, digest in runs]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
