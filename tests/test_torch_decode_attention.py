"""The split-KV design of the decode-attention kernel
(brpc_tpu_torch/csrc/decode_attention.cu).

On the CPU, a plain-torch model of the kernel's split (SPLIT blocks per
(n, h), block r owning positions [r*c, min((r+1)*c, p+1)) with
c = ceil((p+1)/SPLIT), one (m, l) per chunk merged by the log-sum-exp
rule into the window's (M, L), then per chunk the weights
exp(s - M) / L rounded to the working type times V, the chunks' sums
added; position p taken from k_new / v_new and never from the cache
row) is
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

The scores are divided in f32, as JAX promotes the working-type scores
against the numpy scalar ``np.sqrt(hd)``.  At hd 128, where sqrt(hd) is
no power of two, ``decode_attention_plain`` in bf16 equals the
reference's jnp fragment but for rare one-step flips, and the same
arithmetic with the quotient rounded to bf16 (what ``bf16 / float``
gives in PyTorch) differs in far more than 1% of the outputs.  A small hd-128
config decodes through the port's ``decode_step`` as through the
reference's, in f32 (in bf16 the two frameworks round the projections
differently, so a whole step is compared in f32).

The weights are rounded as the reference rounds them: at hd 128 with
inputs scaled by 2 the split so rounded stays within CARD_TOL of the
plain version, and the same split with f32 weights (the kernel's
arithmetic until the card failed it there) leaves it at p = S-1.

The ``cuda``-marked legs run the kernel itself at the same windows, at
head dims 16, 64 and 128, in bf16 (the softmax weights and o rounded
as in the plain version, sums in another order) and f32 (within 1e-5),
against the plain version on the same inputs; the appended cache rows
must be bit-equal.  One more runs hd 128 in bf16 on inputs scaled by 2;
others run windows of up to 131072 positions, where each pass loops
and the stored scores need more shared memory than a launch gets
without opting in.
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


def split_model(q, k_new, v_new, kc, vc, p, drop=None, f32_weights=False):
    """The kernel's split on tensors: per chunk an f32 (m, l) from rows
    read before the append (row p from k_new / v_new), merged with the
    log-sum-exp rule into the window's (M, L); then per chunk
    sum_t T(exp(s_t - M) / L) v_t in f32, the weights rounded to the
    working type, and the chunks' sums added; then the append, in place
    as the kernel does.  ``drop``: the index of a chunk left out of the
    merge (a wrong kernel, for the tolerance's control).
    ``f32_weights``: the weights kept in f32, each chunk's
    sum_t exp(s_t - m) v_t merged with the log-sum-exp rule (the
    kernel's arithmetic before it rounded them)."""
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
            s = torch.einsum("hk,thk->ht", q[n], k).float() / math.sqrt(hd)
            m = s.max(dim=-1).values
            parts.append((s, m, torch.exp(s - m[:, None]).sum(-1),
                          v.float()))
        mx = torch.stack([m for _, m, _, _ in parts]).max(dim=0).values
        den = sum(l * torch.exp(m - mx) for _, m, l, _ in parts)
        if f32_weights:
            num = sum(torch.einsum("ht,thk->hk", torch.exp(s - m[:, None]),
                                   v) * torch.exp(m - mx)[:, None]
                      for s, m, _, v in parts)
            o[n] = (num / den[:, None]).to(q.dtype)
            continue
        w = [(torch.exp(s - mx[:, None]) / den[:, None]).to(q.dtype).float()
             for s, _, _, _ in parts]
        o[n] = sum(torch.einsum("ht,thk->hk", wc, v)
                   for wc, (_, _, _, v) in zip(w, parts)).to(q.dtype)
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


def test_cpu_plain_version_takes_head_dim_256():
    """Past the kernel's largest head dim the plain version still runs on
    the CPU (as the reference's decode step takes any head dim): hd 256
    within SPLIT_TOL of the split model and the jnp fragment."""
    assert 256 > max(KERNEL_HEAD_DIMS)
    arrays = _inputs([0, S - 1, 23], hd=256)
    q, kn, vn, kc, vc, pa = _torch(arrays)
    kp, vp = kc.clone(), vc.clone()
    got = decode_attention(q, kn, vn, kc, vc, pa)   # CPU: the plain version
    torch.testing.assert_close(
        got, decode_attention_plain(q, kn, vn, kp.clone(), vp.clone(), pa),
        atol=0, rtol=0)
    torch.testing.assert_close(got, split_model(q, kn, vn, kp, vp, pa),
                               **SPLIT_TOL)
    import jax.numpy as jnp
    from test_torch_model import _jnp_fragment
    wo, _, _ = _jnp_fragment(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(wo), **SPLIT_TOL)


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


def _reference_fragment_bf16(arrays):
    """decode.py:178-186 in bf16, as the reference writes it: o as f32."""
    from test_torch_model import _jnp_fragment   # imports jax
    import jax.numpy as jnp
    *floats, pa = arrays
    wo, _, _ = _jnp_fragment(*(jnp.asarray(a, jnp.bfloat16) for a in floats),
                             jnp.asarray(pa))
    return torch.from_numpy(np.asarray(wo.astype(jnp.float32)))


def _rounded_quotient(q, k_new, v_new, kc, vc, p):
    """decode_attention_plain with the quotient rounded to the working
    type (``bf16 / float`` in PyTorch): the wrong division."""
    N, S = kc.shape[0], kc.shape[1]
    rows = torch.arange(N)
    kc[rows, p.long()] = k_new
    vc[rows, p.long()] = v_new
    s = torch.einsum("nhk,nshk->nhs", q, kc) / math.sqrt(q.shape[-1])
    valid = torch.arange(S)[None, :] <= p.long()[:, None]
    s = torch.where(valid[:, None, :], s.float(), torch.tensor(-1e30))
    return torch.einsum("nhs,nshk->nhk",
                        torch.softmax(s, dim=-1).to(q.dtype), vc)


def _one_step_but_rare_flips(got, want) -> bool:
    """Within one bf16 step of |want| everywhere, and equal but in at most
    1% of the elements (the frameworks may round a sum near a tie
    differently)."""
    got, want = got.float(), want.float()
    step = (want.abs() * 2.0 ** -7).clamp_min(2.0 ** -126)
    return bool(((got - want).abs() <= step).all()) and \
        float((got != want).float().mean()) <= 0.01


def test_bf16_scores_are_divided_in_f32_at_hd128():
    """At hd 128 (sqrt(hd) no power of two) the plain version equals the
    reference's jnp fragment in bf16 but for rare flips; rounding the
    quotient to bf16 leaves that."""
    arrays = _inputs([0, S - 1, 17, 40], hd=128, H=2, seed=11)
    want = _reference_fragment_bf16(arrays)
    q, kn, vn, kc, vc, pa = _torch(arrays, dtype=torch.bfloat16)
    got = decode_attention_plain(q, kn, vn, kc.clone(), vc.clone(), pa)
    assert _one_step_but_rare_flips(got, want)
    wrong = _rounded_quotient(q, kn, vn, kc.clone(), vc.clone(), pa)
    assert not _one_step_but_rare_flips(wrong, want)


def test_decode_step_matches_the_reference_at_hd128():
    """A dense config with head_dim 128 (d_model 256, 2 heads) decodes
    four steps of three slots (one idle) through the port's decode_step
    as through the reference's, in f32: logits atol 1e-4 / rtol 1e-5,
    caches atol 1e-5 (the sums in another order)."""
    import jax
    import jax.numpy as jnp
    from brpc_tpu.models import decode as ref_decode
    from brpc_tpu.models import transformer as ref_tf
    from brpc_tpu_torch.models import decode as D
    from brpc_tpu_torch.models import transformer as T
    from brpc_tpu_torch.weights import params_from_jax
    shape = dict(vocab=128, d_model=256, n_heads=2, n_layers=2, d_ff=256,
                 max_seq=48, n_experts=0)
    ref_cfg = ref_tf.ModelConfig(dtype=jnp.float32, **shape)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_tf.init(jax.random.PRNGKey(0), ref_cfg))
    cfg = T.ModelConfig(dtype=torch.float32, **shape)
    assert cfg.head_dim == 128
    model = params_from_jax(tree, cfg, device="cpu")
    rng = np.random.default_rng(12)
    slots, Sc = 3, 48
    rc = ref_decode.init_cache(ref_cfg, slots, Sc)
    pc = D.init_cache(cfg, slots, Sc, device="cpu")
    for slot, plen in {0: 9, 2: 30}.items():
        toks = rng.integers(0, 128, (1, plen), dtype=np.int32)
        _, k, v = ref_decode.prefill(tree, jnp.asarray(toks), ref_cfg)
        k, v = np.asarray(k[:, 0]), np.asarray(v[:, 0])
        rc = ref_decode.install(rc, slot, k, v, plen)
        D.install(pc, slot, k, v, plen)
    active = np.array([True, False, True])
    tokens = rng.integers(0, 128, (slots,), dtype=np.int32)
    for _ in range(4):
        wl, rc = ref_decode.decode_step(tree, rc, jnp.asarray(tokens),
                                        jnp.asarray(active), ref_cfg)
        gl, pc = D.decode_step(model, pc, torch.from_numpy(tokens),
                               torch.from_numpy(active), cfg)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-4,
                                   rtol=1e-5)
        for key in ("k", "v"):
            np.testing.assert_allclose(pc[key].numpy(), np.asarray(rc[key]),
                                       atol=1e-5, rtol=0)
        tokens = np.asarray(wl).argmax(-1).astype(np.int32)


def test_decode_step_matches_the_reference_at_hd256():
    """A dense config with head_dim 256 (d_model 256, one head), past
    every kernel head dim, decodes on the CPU through the port's
    decode_step as through the reference's: two slots, three steps, in
    f32, logits atol 1e-4 / rtol 1e-5 and caches atol 1e-5, as at hd
    128."""
    import jax
    import jax.numpy as jnp
    from brpc_tpu.models import decode as ref_decode
    from brpc_tpu.models import transformer as ref_tf
    from brpc_tpu_torch.models import decode as D
    from brpc_tpu_torch.models import transformer as T
    from brpc_tpu_torch.weights import params_from_jax
    shape = dict(vocab=64, d_model=256, n_heads=1, n_layers=2, d_ff=256,
                 max_seq=32, n_experts=0)
    ref_cfg = ref_tf.ModelConfig(dtype=jnp.float32, **shape)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_tf.init(jax.random.PRNGKey(1), ref_cfg))
    cfg = T.ModelConfig(dtype=torch.float32, **shape)
    assert cfg.head_dim == 256
    model = params_from_jax(tree, cfg, device="cpu")
    rng = np.random.default_rng(14)
    slots, Sc = 2, 32
    rc = ref_decode.init_cache(ref_cfg, slots, Sc)
    pc = D.init_cache(cfg, slots, Sc, device="cpu")
    for slot, plen in {0: 5, 1: 17}.items():
        toks = rng.integers(0, 64, (1, plen), dtype=np.int32)
        _, k, v = ref_decode.prefill(tree, jnp.asarray(toks), ref_cfg)
        k, v = np.asarray(k[:, 0]), np.asarray(v[:, 0])
        rc = ref_decode.install(rc, slot, k, v, plen)
        D.install(pc, slot, k, v, plen)
    active = np.array([True, True])
    tokens = rng.integers(0, 64, (slots,), dtype=np.int32)
    for _ in range(3):
        wl, rc = ref_decode.decode_step(tree, rc, jnp.asarray(tokens),
                                        jnp.asarray(active), ref_cfg)
        gl, pc = D.decode_step(model, pc, torch.from_numpy(tokens),
                               torch.from_numpy(active), cfg)
        assert gl.shape == (slots, 64)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-4,
                                   rtol=1e-5)
        for key in ("k", "v"):
            np.testing.assert_allclose(pc[key].numpy(), np.asarray(rc[key]),
                                       atol=1e-5, rtol=0)
        tokens = np.asarray(wl).argmax(-1).astype(np.int32)


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
@pytest.mark.parametrize("S_, hd, dtype, p", [
    (4096, 16, torch.bfloat16, [4095, 1365, 5]),
    (4096, 64, torch.bfloat16, [4095, 1365, 5]),
    (4096, 128, torch.float32, [4095, 1365, 5]),
    (131072, 64, torch.bfloat16, [131071])],
    ids=["S4096-hd16-bf16", "S4096-hd64-bf16", "S4096-hd128-f32",
         "S131072-hd64-bf16"])
def test_kernel_matches_plain_on_long_windows_on_the_card(S_, hd, dtype, p):
    """Chunks longer than one batch of a block's row groups (each pass
    loops), and at S = 131072 scores past the 48 KB of shared memory a
    launch gets without opting in."""
    _card()
    q, kn, vn, kc, vc, pa = _torch(_inputs(p, hd, H=2, S=S_), "cuda", dtype)
    kp, vp = kc.clone(), vc.clone()
    got = decode_attention(q, kn, vn, kc, vc, pa)
    want = decode_attention_plain(q, kn, vn, kp, vp, pa)
    torch.cuda.synchronize()
    assert torch.equal(kc, kp) and torch.equal(vc, vp)
    torch.testing.assert_close(got.float(), want.float(), **CARD_TOL[dtype])


@pytest.mark.cuda
def test_kernel_refuses_head_dim_256_on_the_card():
    """No fallback: on the card a head dim outside KERNEL_HEAD_DIMS
    raises before any launch, though the CPU takes it."""
    _card()
    q, kn, vn, kc, vc, pa = _torch(_inputs([0, S - 1], 256), "cuda")
    before = decode_attention.launches
    with pytest.raises(ValueError, match="not 256"):
        decode_attention(q, kn, vn, kc, vc, pa)
    assert decode_attention.launches == before


def _scaled_hd128(p, scale=2.0):
    """bf16 inputs at hd 128 scaled by 2 (the scores by 4; exact in
    bf16): where the weights' rounding decides the tolerance."""
    arrays = list(_inputs(p, 128, seed=13))
    arrays[:5] = [a * np.float32(scale) for a in arrays[:5]]
    return arrays


def test_rounded_weights_keep_scaled_inputs_inside_the_card_tolerance():
    """At hd 128 with inputs scaled by 2, the split with its weights
    rounded to bf16 (the kernel's arithmetic) stays within CARD_TOL of
    the plain version at every window; with its weights kept in f32 (the
    kernel's arithmetic before) it leaves CARD_TOL at p = S-1, as the
    card showed."""
    tol = CARD_TOL[torch.bfloat16]
    for p in WINDOWS:
        q, kn, vn, kc, vc, pa = _torch(_scaled_hd128(p), dtype=torch.bfloat16)
        want = decode_attention_plain(q, kn, vn, kc.clone(), vc.clone(), pa)
        got = split_model(q, kn, vn, kc.clone(), vc.clone(), pa)
        assert _within(got, want, tol), p
        old = split_model(q, kn, vn, kc.clone(), vc.clone(), pa,
                          f32_weights=True)
        assert _within(old, want, tol) == (p != [S - 1]), p


@pytest.mark.cuda
@pytest.mark.parametrize("p", WINDOWS, ids=lambda p: "p" + "-".join(
    map(str, p)))
def test_kernel_divides_in_f32_at_hd128_on_the_card(p):
    """bf16 at hd 128, where sqrt(hd) is no power of two, on inputs scaled
    by 2: the kernel's f32 division and its rounded weights against the
    plain version's."""
    _card()
    q, kn, vn, kc, vc, pa = _torch(_scaled_hd128(p), "cuda", torch.bfloat16)
    want = decode_attention_plain(q, kn, vn, kc.clone(), vc.clone(), pa)
    got = decode_attention(q, kn, vn, kc, vc, pa)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **CARD_TOL[torch.bfloat16])


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
