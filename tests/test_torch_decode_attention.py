"""The split-KV design of the decode-attention kernel
(brpc_tpu_torch/csrc/decode_attention.cu).

On the CPU, a plain-torch model of the kernel's split (SPLIT blocks per
(n, h), block r owning positions [r*c, min((r+1)*c, p+1)) with
c = ceil((p+1)/SPLIT), one (m, l, acc) per chunk, position p taken from
k_new / v_new and never from the cache row, the log-sum-exp merge) is
held against ``decode_attention_plain`` and against the reference's jnp
fragment (brpc_tpu/models/decode.py:178-186) in f32 at 1e-6: the same
sums, grouped otherwise.  The windows hit the split's edges: p = 0 (seven
empty chunks), p = S-1, p = SPLIT*k - 1 and SPLIT*k, and N = 1 and 5.

The bf16 tolerance of the kernel against the plain version (atol 4e-3 +
rtol 1e-2, as chip_smoke.py's) was set from the card's readings (largest
error 0.0039); on the CPU the split model passes it at chip_smoke.py's
full window and the same model with one chunk dropped fails it.  The
kernel's branch-free score division (``div_rn``: reciprocal, product, one
FMA correction) is held against IEEE division, in exact arithmetic, for
the sqrt(hd) of every head dim the kernel takes.

The ``cuda``-marked legs run the kernel itself at the same windows, at
head dims 16, 64 and 128, in bf16 (one rounding of o and of the softmax
weights) and f32 (within 1e-5: sums in another order), against the plain
version on the same inputs; the appended cache rows must be bit-equal.
One more decodes tiny_config (hd 16, the serving engine's default)
through the kernel and through the plain version.  They skip without a
card; on the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_decode_attention.py``.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from brpc_tpu_torch.ops.decode_attention import (KERNEL_HEAD_DIMS,
                                                 decode_attention,
                                                 decode_attention_plain)

SPLIT = 8            # blocks per cluster in the kernel (kSplit)
S = 64
SPLIT_TOL = dict(atol=1e-6, rtol=0)
CARD_TOL = {torch.bfloat16: dict(atol=4e-3, rtol=1e-2),
            torch.float32: dict(atol=1e-5, rtol=1e-5)}

# p = 0: seven empty chunks; p = S-1; p = SPLIT*k - 1 and SPLIT*k
WINDOWS = [[0], [S - 1], [7, 8, 15, 16], [0, S - 1, 23, 24, 40]]


def chunks(p: int):
    """The kernel's chunk of each block of a cluster, as (start, end)."""
    c = -(-(p + 1) // SPLIT)
    return [(r * c, min((r + 1) * c, p + 1)) for r in range(SPLIT)]


def split_model(q, k_new, v_new, kc, vc, p, drop=None):
    """The kernel's split on tensors: per chunk an f32 (m, l, acc) from
    rows read before the append (row p from k_new / v_new), merged with
    the log-sum-exp rule; then the append, in place as the kernel does.
    ``drop``: the index of a chunk left out of the merge (a wrong kernel,
    for the tolerance's control)."""
    N, _, H, hd = kc.shape
    o = torch.empty_like(q)
    for n in range(N):
        pn = int(p[n])
        parts = []
        for r, (start, end) in enumerate(chunks(pn)):
            if start >= end or r == drop:
                continue            # an empty chunk: l = 0, adds nothing
            k = kc[n, start:end].clone()
            v = vc[n, start:end].clone()
            if start <= pn < end:   # the block whose chunk holds p
                k[pn - start] = k_new[n]
                v[pn - start] = v_new[n]
            s = torch.einsum("hk,thk->ht", q[n], k)
            s = (s / math.sqrt(hd)).float()
            m = s.max(dim=-1).values
            w = torch.exp(s - m[:, None])
            parts.append((m, w.sum(-1), torch.einsum("ht,thk->hk", w,
                                                     v.float())))
        mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        den = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        num = sum(a * torch.exp(m - mx)[:, None] for m, _, a in parts)
        o[n] = (num / den[:, None]).to(q.dtype)
    rows = torch.arange(N)
    kc[rows, p.long()] = k_new
    vc[rows, p.long()] = v_new
    return o


def _inputs(p, hd, dtype=np.float32, H=4, seed=0, S=S):
    rng = np.random.default_rng(seed)
    N = len(p)
    q, kn, vn = (rng.standard_normal((N, H, hd)).astype(dtype)
                 for _ in range(3))
    kc, vc = (rng.standard_normal((N, S, H, hd)).astype(dtype)
              for _ in range(2))
    return q, kn, vn, kc, vc, np.array(p, np.int32)


def _torch(arrays, device="cpu", dtype=None):
    out = [torch.from_numpy(a.copy()).to(device) for a in arrays]
    if dtype is not None:
        out[:5] = [t.to(dtype) for t in out[:5]]
    return out


def test_chunks_cover_the_window_once():
    for p in range(3 * S):
        covered = [t for a, b in chunks(p) for t in range(a, b)]
        assert covered == list(range(p + 1)), p
    assert sum(a >= b for a, b in chunks(0)) == SPLIT - 1
    assert [b - a for a, b in chunks(S - 1)] == [S // SPLIT] * SPLIT


@pytest.mark.parametrize("p", WINDOWS, ids=lambda p: "p" + "-".join(
    map(str, p)))
def test_split_model_matches_plain_and_reference(p):
    from test_torch_model import _jnp_fragment   # imports jax
    import jax.numpy as jnp

    arrays = _inputs(p, hd=16)
    q, kn, vn, kc, vc, pa = _torch(arrays)
    kp, vp = kc.clone(), vc.clone()
    got = split_model(q, kn, vn, kc, vc, pa)
    want = decode_attention_plain(q, kn, vn, kp, vp, pa)
    torch.testing.assert_close(got, want, **SPLIT_TOL)
    assert torch.equal(kc, kp) and torch.equal(vc, vp)
    wo, wk, wv = _jnp_fragment(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(wo), **SPLIT_TOL)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(wv))


def test_split_model_reads_row_p_from_k_new_not_the_cache():
    """A stale cache row p (garbage before the append) changes nothing."""
    arrays = _inputs([0, S - 1, 16], hd=16)
    q, kn, vn, kc, vc, pa = _torch(arrays)
    rows = torch.arange(3)
    kc[rows, pa.long()] = 1e4
    vc[rows, pa.long()] = float("nan")
    kp, vp = kc.clone(), vc.clone()
    got = split_model(q, kn, vn, kc, vc, pa)
    want = decode_attention_plain(q, kn, vn, kp, vp, pa)
    torch.testing.assert_close(got, want, **SPLIT_TOL)


def test_cpu_takes_a_head_dim_the_kernel_does_not():
    assert 48 not in KERNEL_HEAD_DIMS
    arrays = _inputs([5, S - 1], hd=48)
    q, kn, vn, kc, vc, pa = _torch(arrays)
    kp, vp = kc.clone(), vc.clone()
    got = decode_attention(q, kn, vn, kc, vc, pa)   # CPU: the plain version
    torch.testing.assert_close(got, split_model(q, kn, vn, kp, vp, pa),
                               **SPLIT_TOL)


def test_kernel_takes_the_head_dims_the_port_launches():
    from brpc_tpu_torch.models.transformer import ModelConfig
    from brpc_tpu_torch.serving.engine import tiny_config
    assert ModelConfig().head_dim in KERNEL_HEAD_DIMS      # chip_smoke
    assert tiny_config().head_dim in KERNEL_HEAD_DIMS      # ServingEngine()


def _within(got, want, tol) -> bool:
    return bool(((got.float() - want.float()).abs()
                 <= tol["atol"] + tol["rtol"] * want.float().abs()).all())


def test_bf16_tolerance_passes_the_split_and_fails_a_dropped_chunk():
    """At chip_smoke.py's full window (N=4, S=1024, H=8, hd=64, every
    slot at p = S-1), in bf16: the kernel's split is within CARD_TOL of
    the plain version; leaving out any one of the eight chunks is not."""
    Sf = 1024
    arrays = _inputs([Sf - 1] * 4, hd=64, H=8, S=Sf)
    tol = CARD_TOL[torch.bfloat16]
    base = _torch(arrays, dtype=torch.bfloat16)
    q, kn, vn, kc, vc, pa = base
    want = decode_attention_plain(q, kn, vn, kc.clone(), vc.clone(), pa)
    got = split_model(q, kn, vn, kc.clone(), vc.clone(), pa)
    assert _within(got, want, tol)
    for r in range(SPLIT):
        wrong = split_model(q, kn, vn, kc.clone(), vc.clone(), pa, drop=r)
        assert not _within(wrong, want, tol), r


def _f32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    c = np.float32(float(x))
    cands = (np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.float32(v).view(np.uint32)) & 1))


@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
def test_div_rn_is_ieee_division(hd):
    """The kernel's div_rn(x, y, inv) with inv = __frcp_rn(y): q = x * inv,
    r = fma(-q, y, x), fma(r, inv, q), each rounded once to float32,
    equals the correctly rounded x / y for y = float32(sqrt(hd)) (what
    the wrapper passes) on f32 and bf16-valued scores of every scale."""
    y = np.float32(math.sqrt(hd))
    Y = Fraction(float(y))
    inv = Fraction(float(_f32(1 / Y)))
    rng = np.random.default_rng(hd)
    xs = np.concatenate([
        (rng.standard_normal(1500)
         * 10.0 ** rng.integers(-6, 5, 1500)).astype(np.float32),
        (rng.standard_normal(1500).astype(np.float32).view(np.uint32)
         & np.uint32(0xFFFF0000)).view(np.float32),          # bf16 values
        np.arange(-300, 301, dtype=np.float32)])
    bad = []
    for x in xs:
        X = Fraction(float(x))
        q = _f32(X * inv)
        r = _f32(X - Fraction(float(q)) * Y)
        got = _f32(Fraction(float(r)) * inv + Fraction(float(q)))
        if got != x / y:                  # numpy: IEEE float32 division
            bad.append(float(x))
    assert not bad, bad[:5]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc for the kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("p", WINDOWS, ids=lambda p: "p" + "-".join(
    map(str, p)))
def test_kernel_matches_plain_on_the_card(p, hd, dtype):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kn, vn, kc, vc, pa = _torch(_inputs(p, hd), "cuda", dtype)
    kp, vp = kc.clone(), vc.clone()
    before = decode_attention.launches
    got = decode_attention(q, kn, vn, kc, vc, pa)
    want = decode_attention_plain(q, kn, vn, kp, vp, pa)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert torch.equal(kc, kp) and torch.equal(vc, vp)
    torch.testing.assert_close(got.float(), want.float(), **CARD_TOL[dtype])


@pytest.mark.cuda
def test_tiny_config_decodes_through_the_kernel():
    """ServingEngine()'s default model (tiny_config: f32, hd 16) decodes
    on the card through the kernel as through the plain version."""
    _card()
    from brpc_tpu_torch.models import decode as D
    from brpc_tpu_torch.models import transformer as T
    from brpc_tpu_torch.serving.engine import tiny_config
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_config()
    model = T.init(torch.Generator().manual_seed(0), cfg, "cuda")
    cache = D.init_cache(cfg, 3, cfg.max_seq, "cuda")
    gen = torch.Generator().manual_seed(1)
    for slot, plen in enumerate((1, 17, cfg.max_seq - 2)):
        toks = torch.randint(0, cfg.vocab, (1, plen), generator=gen)
        _, k, v = D.prefill(model, toks, cfg)
        D.install(cache, slot, k[:, 0], v[:, 0], plen)
    twin = {key: t.clone() for key, t in cache.items()}
    active = torch.ones(3, dtype=torch.bool)
    before = decode_attention.launches
    for _ in range(3):                 # the last slot reaches p = S-1
        tokens = torch.randint(0, cfg.vocab, (3,), generator=gen)
        got, _ = D.decode_step(model, cache, tokens, active, cfg)
        saved = D.decode_attention
        D.decode_attention = decode_attention_plain
        try:
            want, _ = D.decode_step(model, twin, tokens, active, cfg)
        finally:
            D.decode_attention = saved
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert decode_attention.launches == before + 3 * cfg.n_layers
    assert torch.equal(cache["pos"], twin["pos"])
    for key in ("k", "v"):     # layer 2's rows carry layer 1's rounding
        torch.testing.assert_close(cache[key], twin[key], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.cuda
def test_kernel_refuses_a_head_dim_it_does_not_take():
    _card()
    q, kn, vn, kc, vc, pa = _torch(_inputs([3], hd=48), "cuda")
    with pytest.raises(ValueError, match="not 48"):
        decode_attention(q, kn, vn, kc, vc, pa)
