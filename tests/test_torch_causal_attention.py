"""Causal attention of the port (brpc_tpu_torch/ops/causal_attention.py,
csrc/causal_attention*.cu) against the reference's jnp fragment
(brpc_tpu/models/transformer.py:198-203) and against its own kernels.

On the CPU:

* ``causal_attention_plain`` against the jnp fragment, forward and
  ``jax.vjp`` (dq, dk, dv), in f32 (atol 1e-5: the same sums in another
  order) and bf16: bit-equal but for rare one-step flips, where the two
  frameworks round a product near a tie differently (``BF16_REF_TOL``
  per element, at most ``BF16_REF_FLIPS`` of the elements differing; the
  CPU readings: at most 0.3% differ, the largest gap 0.0039).
* The weight-rounding trap: a plain version that keeps the softmax
  weights in f32 leaves the bf16 tolerance (about 40% of o differs).
  The division trap: JAX divides the bf16 scores by np.sqrt(hd) in f32;
  rounding the quotient to bf16 (what PyTorch does for ``bf16 / float``)
  moves the scores at hd = 32, where sqrt(hd) is no power of two.
* ``kernel_model``, the kernels' arithmetic written in torch in their
  order of work over 64-key tiles (the bf16 forward's two passes: the
  online (m, l), then the weights rounded as the registers feed them to
  the tensor cores, times V; the f32 forward's one pass, the
  accumulator rescaled with the online (m, l) and divided by l at the
  end, held at S = 1024 at unit scale and at a wider range; p
  recomputed from lse; D = sum_t p dW taken
  exactly, per tile and then over the tiles; dS rounded as the
  registers feed it; dk/dv per 64-key tile over the query tiles that
  see it, on transposed tiles, rows keys and columns queries, summed
  over the query tiles in f32, held at S = 1024 against jax.vjp of the
  fragment too), against autograd of the plain version: within
  ``CARD_TOL``, the tolerance the card legs and chip_smoke.py hold the
  kernels to.
  Controls: the same model with the diagonal key (t = s) left out of
  every row leaves it; a one-pass online softmax, which rounds
  exp(s - m_running), leaves the bf16 agreement of o at unit-scale
  inputs and CARD_TOL at a wider range; the forward's mask applied to
  dk/dv's transposed tiles (keys t >= s kept in each diagonal tile)
  leaves it in dk and dv.  (The
  rowsum(dO * o) stand-in for D would stay inside CARD_TOL: at these
  shapes it moves dq and dk by about one bf16 step, as the kernels' own
  flips do; the kernels take D exactly all the same.)
* The plain f32 dq, dk and dv against the same function in f64, at unit
  scale and at a wide range (q, k x 2, v x 8), S = 1000 and 1024, hd 16,
  64 and 128: what f32 itself leaves there.  The f32 dq kernel's
  weights and D (p and sum_t p dW divided by l = sum_t p, summed in its
  lanes with their rounding errors carried) as exact as the plain
  version there, on the card leg's data and on causal_attention_ab.py's;
  controls: the unnormalised p, and the lanes' plain sums, each leave
  it.
* Argument checks.

The ``cuda``-marked legs run on the card: the
three kernels at head dims 16, 64 and 128, S from 1 to 1024 (tile edges
63/64/65, a ragged 1000), bf16 and f32, against the plain version on
the same inputs; strided (fused-projection) q, k, v, a transposed dO
and an unaligned view in bf16; two dk/dv calls bit-equal; the one-pass
f32 forward's o and lse at S = 1000 and 1024 (at a wider range against
an f64 reference, as near to it as the plain version); an unaligned f32
view copied for the f32 forward's, dq's and dk/dv's cp.async,
bit-equal, and dq and dk/dv twice to the same bits; the bf16 dq (its D
unnormalised) and the f32 dq and
dk/dv kernels against f64 at unit scale and a wide range, as exact as
the plain version, and the f32 dk/dv kernel alone against the plain
version at S = 65 to 1024; and
the dtype dispatch (bf16 on the tensor cores, f32 on the CUDA-core
forward, dq and dk/dv) read from the device's kernel names.  They skip
without a card and run there with
``python -m pytest --noconftest -m cuda tests/test_torch_causal_attention.py``
(this file imports jax only inside its CPU legs).
"""

import math

import numpy as np
import pytest
import torch

from brpc_tpu_torch.ops.causal_attention import (
    KERNEL_HEAD_DIMS, CausalAttention, causal_attention,
    causal_attention_backward_dkdv, causal_attention_backward_dq,
    causal_attention_forward, causal_attention_plain)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_REF_TOL = dict(atol=1e-3, rtol=2 ** -7)    # one bf16 step
BF16_REF_FLIPS = 0.01
# the kernels against the plain version: a flip of one bf16 rounding of a
# score, weight, dW or dS moves an output by about one weight step times
# |v| (largest reading at B=8, S=1024, H=8, hd=64: 0.0078); f32 the same
# sums in another order (largest reading 1.9e-6)
CARD_TOL = {torch.bfloat16: dict(atol=1e-2, rtol=2e-2),
            torch.float32: dict(atol=1e-5, rtol=1e-5)}
# the f32 forward at a wide range (q, k x 2, v x 8), against an f64
# reference: its largest error over the plain version's
WIDE_ERR_RATIO = 1.5


def _draw(seed, B, S, H, hd, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal((B, S, H, hd))).astype(np.float32)
            for _ in range(4)]


def _jnp_fragment(q, k, v):
    """transformer.py:198-203 for one layer, as the reference writes it."""
    import jax
    import jax.numpy as jnp
    S = q.shape[1]
    scores = jnp.einsum("bshk,bthk->bhst", q, k) / np.sqrt(q.shape[-1])
    mask = jnp.tril(jnp.ones((S, S), bool))
    scores = jnp.where(mask[None, None], scores.astype(jnp.float32), -1e30)
    w = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    return jnp.einsum("bhst,bthk->bshk", w, v)


def _jax_vjp(arrays, dtype):
    import jax
    import jax.numpy as jnp
    q, k, v, do = (jnp.asarray(a, dtype) for a in arrays)
    o, pull = jax.vjp(_jnp_fragment, q, k, v)
    return [np.asarray(t.astype(jnp.float32)) for t in (o, *pull(do))]


def _torch_grads(fn, arrays, dtype, device="cpu"):
    q, k, v, do = (torch.from_numpy(a).to(device, dtype) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    o = fn(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), do)
    return [t.detach().float() for t in (o, *grads)]


def _gap_share(got, want, tol):
    """The largest |got - want| / (atol + rtol |want|) over every output
    (within the tolerance when at most 1)."""
    return max(float(((g - w).abs() / (tol["atol"] + tol["rtol"]
                                       * w.abs())).max())
               for g, w in zip(got, _tensors(want)))


def _tensors(arrays):
    return [torch.as_tensor(np.array(a, np.float32)) for a in arrays]


def _bf16_agrees(got, want) -> bool:
    """Within one bf16 step everywhere, and equal but for rare flips."""
    flips = max(float((g != w).float().mean())
                for g, w in zip(got, _tensors(want)))
    return _gap_share(got, want, BF16_REF_TOL) <= 1.0 and \
        flips <= BF16_REF_FLIPS


TILE = 64    # query and key rows of a tile in the kernels


def kernel_model(q, k, v, do, drop_diagonal=False, one_pass=None,
                 untransposed_mask=False):
    """The kernels' arithmetic (csrc/causal_attention_sm90.cu for bf16;
    csrc/causal_attention_f32.cu for f32: the one-pass forward, dq and
    the transposed dk/dv) on tensors, in their order of work over 64-row
    tiles: (o, dq, dk, dv) as f32.

    Forward in bf16, two passes: the online row max and sum (m, l) over
    the key tiles; then p = exp(s - m) / l, rounded to the working type
    as the registers feed it to the tensor cores, times each V tile,
    summed over the tiles in f32 and rounded once.  Forward in f32, one
    pass (``one_pass``, the default there): per key tile the online
    (m, l), the accumulator rescaled by exp(m_old - m) plus exp(s - m)
    times the V tile, divided by l at the end (T() is the identity in
    f32, so no weight is rounded).  dq: D = sum_t p dW taken per tile
    and then over the tiles, from p recomputed from lse (in f32 p and D
    divided by p's row sum, both sums in the kernel's order,
    ``_f32_dq_weights``); dS rounded as the registers feed it to
    dS . K.  dk/dv, per 64-key tile over query
    tiles kt.. (the causal skip rule: the tiles wholly before the key
    tile are never visited): the transposed tiles S^T = T(K.Q^T) /
    sqrt(hd) and dW^T, P^T and dS^T from lse and D per column (query), a
    query tile's dv += T(P^T) dO and dk += dS^T q summed in f32 and added
    to the key tile's sums, rounded once.
    ``drop_diagonal``: leave key t = s out of row s (a wrong kernel, for
    the tolerance's control; row 0 keeps its only key).  ``one_pass``:
    the online softmax of one pass, which in bf16 rounds
    exp(s - m_running) and rescales the sum (a different rounding of the
    weights, for the second control); None: one pass in f32 only, as the
    kernels.  ``untransposed_mask``: dk/dv's diagonal tiles masked as
    the untransposed S = Q.K^T is (column <= row), which on S^T keeps the
    keys t >= s (the third control).  The exponential is ``expf`` in both
    dtypes, as in the plain version."""
    dt = q.dtype
    if one_pass is None:
        one_pass = dt == torch.float32
    S, hd = q.shape[1], q.shape[-1]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    tiles = [(t0, min(t0 + TILE, S)) for t0 in range(0, S, TILE)]

    def rt(x):
        return x.to(dt).float()

    s = rt(torch.einsum("bshk,bthk->bhst", qf, kf)) / math.sqrt(hd)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool),
                      diagonal=-1 if drop_diagonal else 0)
    mask[0, 0] = True
    s = s.masked_fill(~mask, float("-inf"))
    m = torch.full(s.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape[0], qf.shape[2], S, hd)      # [B, H, S, hd]
    for a, b in tiles:                       # pass 1 (with one_pass: all)
        st = s[..., a:b]
        mn = torch.maximum(m, st.amax(-1, keepdim=True))
        e = torch.exp(st - mn)
        corr = torch.exp(m - mn)
        l = l * corr + e.sum(-1, keepdim=True)
        if one_pass:
            acc = acc * corr + torch.einsum("bhst,bthk->bhsk", rt(e),
                                            vf[:, a:b])
        m = mn
    if one_pass:
        o = rt((acc / l).transpose(1, 2))
    else:
        acc.zero_()
        for a, b in tiles:                   # pass 2
            w = rt(torch.exp(s[..., a:b] - m) / l)
            acc = acc + torch.einsum("bhst,bthk->bhsk", w, vf[:, a:b])
        o = rt(acc.transpose(1, 2))
    lse = m + torch.log(l)                          # [B, H, S, 1]
    p = torch.exp(s - lse)
    dw = rt(torch.einsum("bshk,bthk->bhst", dof, vf))
    delta = sum((p[..., a:b] * dw[..., a:b]).sum(-1, keepdim=True)
                for a, b in tiles)
    pd = p
    if dt == torch.float32:
        pd, delta = _f32_dq_weights(p, dw)
    ds = rt(pd * (dw - delta) / math.sqrt(hd))
    dq = rt(sum(torch.einsum("bhst,bthk->bshk", ds[..., a:b], kf[:, a:b])
                for a, b in tiles))
    # dk/dv on the transposed tiles: rows keys t, columns queries s
    lse_t, delta_t = lse.transpose(-1, -2), delta.transpose(-1, -2)
    dk, dv = torch.zeros_like(qf), torch.zeros_like(qf)
    for ka, kb in tiles:
        acc_k = torch.zeros(qf.shape[0], kb - ka, qf.shape[2], hd)
        acc_v = torch.zeros_like(acc_k)
        for qa, qb in tiles[ka // TILE:]:
            st = rt(torch.einsum("bthk,bshk->bhts", kf[:, ka:kb],
                                 qf[:, qa:qb])) / math.sqrt(hd)
            keep = mask[qa:qb, ka:kb].T                  # [t, s]: t <= s
            if untransposed_mask and qa == ka:
                keep = mask[ka:kb, qa:qb]                # s <= t
            st = st.masked_fill(~keep, float("-inf"))
            pt = torch.exp(st - lse_t[..., qa:qb])
            wt = rt(torch.einsum("bthk,bshk->bhts", vf[:, ka:kb],
                                 dof[:, qa:qb]))
            dst = rt(pt * (wt - delta_t[..., qa:qb]) / math.sqrt(hd))
            acc_v = acc_v + torch.einsum("bhts,bshk->bthk", rt(pt),
                                         dof[:, qa:qb])
            acc_k = acc_k + torch.einsum("bhts,bshk->bthk", dst,
                                         qf[:, qa:qb])
        dk[:, ka:kb], dv[:, ka:kb] = rt(acc_k), rt(acc_v)
    return [o, dq, dk, dv]


def _lane_sums(x, compensate=True):
    """Row sums of x [..., S] [..., 1] in the f32 dq kernel's order: lane
    c of a row's 8 sums keys c, c + 8, ... in turn (``compensate``: each
    add's rounding error carried into the next term, Kahan), then the 8
    lanes in three butterfly steps, their carried errors likewise and
    taken off."""
    S = x.shape[-1]
    n = -(-S // 8)
    terms = torch.nn.functional.pad(x, (0, 8 * n - S)).unflatten(-1, (n, 8))
    acc = torch.zeros(terms[..., 0, :].shape)
    err = torch.zeros_like(acc)
    for t in range(n):
        if compensate:
            y = terms[..., t, :] - err
            total = acc + y
            err = (total - acc) - y
            acc = total
        else:
            acc = acc + terms[..., t, :]

    def butterfly(a):
        for off in (1, 2, 4):
            a = a + a[..., torch.arange(8) ^ off]
        return a[..., :1]
    return butterfly(acc) - butterfly(err)


def _f32_dq_weights(p, dw, compensate=True, normalise=True):
    """The f32 dq kernel's weights and D from p and dW [..., S]: w = p (1
    / l) and D = sum_t p dW / l, l = sum_t p, the sums as `_lane_sums`
    takes them; without ``normalise`` p and sum_t p dW as they are."""
    D = _lane_sums(p * dw, compensate)
    if not normalise:
        return p, D
    l = _lane_sums(p, compensate)
    return p * (1.0 / l), D / l


@pytest.mark.parametrize("S", [1, 13, 40])
def test_plain_matches_the_jnp_fragment_f32(S):
    arrays = _draw(1, 2, S, 3, 16)
    want = _jax_vjp(arrays, np.float32)
    got = _torch_grads(causal_attention, arrays, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **F32_TOL)


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_plain_matches_the_jnp_fragment_bf16(hd):
    import jax.numpy as jnp
    arrays = _draw(2, 2, 48, 2, hd, scale=2.0)
    want = _jax_vjp(arrays, jnp.bfloat16)
    got = _torch_grads(causal_attention_plain, arrays, torch.bfloat16)
    assert _bf16_agrees(got, want)


def test_unrounded_weights_leave_the_bf16_tolerance():
    """The weight-rounding trap: the reference rounds the softmax weights
    to bf16 before the product with V."""
    import jax.numpy as jnp
    arrays = _draw(3, 2, 48, 2, 16, scale=2.0)
    want = _jax_vjp(arrays, jnp.bfloat16)

    def unrounded(q, k, v):
        S = q.shape[1]
        s = torch.einsum("bshk,bthk->bhst", q, k).float() / 4.0
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool))
        s = torch.where(mask, s, torch.tensor(-1e30))
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bhst,bthk->bshk", w, v.float()).to(q.dtype)

    got = _torch_grads(unrounded, arrays, torch.bfloat16)
    assert not _bf16_agrees(got[:1], want[:1])


def test_scores_are_divided_in_f32_as_jax_promotes_them():
    """JAX divides the bf16 scores by the numpy scalar np.sqrt(hd) in f32;
    PyTorch keeps ``bf16 / float`` in bf16.  At hd = 32 the two differ,
    and the plain version follows JAX."""
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    x = (3 * rng.standard_normal(4096)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(xb / np.sqrt(32))
    assert want.dtype == np.float32
    t = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal((t.float() / math.sqrt(32)).numpy(), want)
    assert not np.array_equal((t / math.sqrt(32)).float().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 17, 80, 130])
def test_kernel_model_matches_plain_autograd(S, dtype):
    arrays = _draw(5, 2, S, 2, 16)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    got = kernel_model(q, k, v, do)
    want = _torch_grads(causal_attention_plain, arrays, dtype)
    assert _gap_share(got, want, CARD_TOL[dtype]) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_card_tolerance_fails_a_dropped_diagonal(dtype):
    arrays = _draw(6, 2, 200, 2, 16)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    want = _torch_grads(causal_attention_plain, arrays, dtype)
    got = kernel_model(q, k, v, do, drop_diagonal=True)
    for g, w in zip(got, want):
        assert _gap_share([g], [w], CARD_TOL[dtype]) > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [65, 200])
def test_card_tolerance_fails_an_untransposed_mask_in_dkdv(S, dtype):
    """dk/dv masks its transposed tiles (rows keys): reusing the forward's
    mask there keeps the keys t >= s of every diagonal tile and drops the
    keys t < s, and dk and dv leave CARD_TOL (o and dq, from their own
    kernels, stay inside)."""
    arrays = _draw(12, 2, S, 2, 16)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    want = _torch_grads(causal_attention_plain, arrays, dtype)
    got = kernel_model(q, k, v, do, untransposed_mask=True)
    tol = CARD_TOL[dtype]
    assert _gap_share(got[:2], want[:2], tol) <= 1.0
    for g, w in zip(got[2:], want[2:]):
        assert _gap_share([g], [w], tol) > 1.0


def test_one_pass_weights_leave_the_two_pass_rounding():
    """The second control: a one-pass online softmax rounds
    exp(s - m_running) where the reference rounds the final weights.  At
    the card legs' unit-scale inputs its o leaves the bf16 agreement
    (one step, rare flips) that the two-pass model keeps, though it stays
    inside CARD_TOL there (about a quarter of the limit); with scores and
    values of a wider range (q, k x 2, v x 8) it leaves CARD_TOL too,
    where the two-pass model stays inside."""
    dtype, tol = torch.bfloat16, CARD_TOL[torch.bfloat16]
    for scale, v_scale, within in ((1.0, 1.0, True), (2.0, 8.0, False)):
        arrays = _draw(11, 2, 300, 2, 16, scale)
        arrays[2] = arrays[2] * v_scale
        q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
        want = _torch_grads(causal_attention_plain, arrays, dtype)
        two = kernel_model(q, k, v, do)
        one = kernel_model(q, k, v, do, one_pass=True)
        assert _bf16_agrees(two[:1], want[:1])
        assert not _bf16_agrees(one[:1], want[:1])
        assert _gap_share(two, want, tol) <= 1.0
        assert (_gap_share(one[:1], want[:1], tol) <= 1.0) == within


@pytest.mark.parametrize("scale,v_scale", [(1.0, 1.0), (2.0, 8.0)],
                         ids=["unit", "wide"])
def test_one_pass_f32_forward_stays_within_the_card_tolerance(scale,
                                                              v_scale):
    """In f32 no weight is rounded before its product, so the f32 forward
    may make one pass: at S = 1024, at unit scale and with scores and
    values of a wider range (q, k x 2, v x 8), the one-pass model's o is
    within CARD_TOL of the plain softmax-then-product.  The backward is
    the same in both models."""
    arrays = _draw(13, 1, 1024, 2, 64, scale)
    arrays[2] = arrays[2] * v_scale
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    want = _torch_grads(causal_attention_plain, arrays, torch.float32)
    got = kernel_model(q, k, v, do)
    assert _gap_share(got[:1], want[:1], CARD_TOL[torch.float32]) <= 1.0


def _f64_grads(q, k, v, do):
    """[dq, dk, dv] of the causal attention in f64 throughout."""
    S, hd = q.shape[1], q.shape[-1]
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    s = torch.einsum("bshk,bthk->bhst", *leaves[:2]) / math.sqrt(hd)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    o = torch.einsum("bhst,bthk->bshk", w, leaves[2])
    return list(torch.autograd.grad(o, leaves, do.double()))


def _share64(got, want):
    """The largest |got - want| / (atol + rtol |want|) under CARD_TOL's
    f32 limits, in f64 (want an f64 reference)."""
    tol = CARD_TOL[torch.float32]
    return float(((got.double() - want).abs() / (
        tol["atol"] + tol["rtol"] * want.abs())).max())


def _wide(seed, B, S, H, hd, wide):
    """q, k, v, dO: unit normal, or at a wide range (q, k x 2, v x 8)."""
    arrays = _draw(seed, B, S, H, hd, 2.0 if wide else 1.0)
    if wide:
        arrays[2] = arrays[2] * 8.0
    return arrays


def test_dkdv_model_holds_plain_and_jax_grad_at_S1024():
    """The f32 dk/dv kernel's order of work (64-key tiles over query
    tiles kt.., transposed tiles, per-tile sums) at S = 1024, hd 64:
    dk and dv within CARD_TOL of autograd of the plain version and of
    jax.vjp of the reference's fragment."""
    arrays = _draw(21, 1, 1024, 2, 64)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    got = kernel_model(q, k, v, do)[2:]
    want = _torch_grads(causal_attention_plain, arrays, torch.float32)[2:]
    tol = CARD_TOL[torch.float32]
    assert _gap_share(got, want, tol) <= 1.0
    assert _gap_share(got, _jax_vjp(arrays, np.float32)[2:], tol) <= 1.0


@pytest.mark.parametrize("wide", [False, True], ids=["unit", "wide"])
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S", [1000, 1024])
def test_plain_f32_dkdv_against_f64(S, hd, wide):
    """What f32 itself leaves in dk and dv: the plain version's autograd
    against the same function in f64, as a share of CARD_TOL (CPU
    readings: unit 0.06-0.11 in dk and dv; wide, dk 3.9-16.5 and dv
    0.53-1.05).  At unit scale the plain version is well inside CARD_TOL
    of f64; at the wide range its dk leaves it, so there two f32 orders
    of the sums may differ by more than CARD_TOL, and the card leg holds
    the kernel to f64 at WIDE_ERR_RATIO times the plain version's
    error."""
    arrays = _wide(20, 1, S, 2, hd, wide)
    got = _torch_grads(causal_attention_plain, arrays, torch.float32)[2:]
    want = _f64_grads(*(torch.from_numpy(a) for a in arrays))[1:]
    shares = [_share64(g, w) for g, w in zip(got, want)]
    if wide:
        assert 1.0 < shares[0] <= 40.0 and shares[1] <= 2.5, shares
    else:
        assert max(shares) <= 0.5, shares


@pytest.mark.parametrize("wide", [False, True], ids=["unit", "wide"])
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S", [1000, 1024])
def test_plain_f32_dq_against_f64(S, hd, wide):
    """What f32 itself leaves in dq: the plain version's autograd
    against the same function in f64, as a share of CARD_TOL (CPU
    readings: unit 0.03-0.08; wide 5.2-18.2).  At the wide range the
    plain dq leaves CARD_TOL of f64, so the card leg holds the kernel to
    f64 at WIDE_ERR_RATIO times the plain version's error."""
    arrays = _wide(20, 1, S, 2, hd, wide)
    got = _torch_grads(causal_attention_plain, arrays, torch.float32)[1]
    want = _f64_grads(*(torch.from_numpy(a) for a in arrays))[0]
    share = _share64(got, want)
    if wide:
        assert 1.0 < share <= 40.0, share
    else:
        assert share <= 0.5, share


def _dq_from_lse(arrays, **how):
    """dq of the f32 dq kernel's formula from the plain softmax's f32
    lse: p = exp(s - lse), then w and D as `_f32_dq_weights` takes them
    (``how``: its options), dS = w (dW - D) / sqrt(hd)."""
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    S, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bshk,bthk->bhst", q, k) / math.sqrt(hd)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool))
    p = torch.exp(s.masked_fill(~mask, float("-inf"))
                  - _lse_plain(q, k)[..., None])
    dw = torch.einsum("bshk,bthk->bhst", do, v)
    w, delta = _f32_dq_weights(p, dw, **how)
    return torch.einsum("bhst,bthk->bshk", w * (dw - delta) / math.sqrt(hd),
                        k)


def _dq_err_ratio(seed, S, hd, **how):
    """dq's largest error against f64 of `_dq_from_lse` over the plain
    version's, at the wide range (q, k x 2, v x 8)."""
    arrays = _wide(seed, 2, S, 3, hd, True)
    exact = _f64_grads(*(torch.from_numpy(a) for a in arrays))[0]
    plain = _torch_grads(causal_attention_plain, arrays, torch.float32)[1]
    got = _dq_from_lse(arrays, **how)
    return float((got.double() - exact).abs().max()) / float(
        (plain.double() - exact).abs().max())


@pytest.mark.parametrize("seed", [23, 25])
@pytest.mark.parametrize("S,hd", [(1000, 16), (1000, 64), (1000, 128),
                                  (1024, 16), (1024, 64), (1024, 128)])
def test_f32_dq_order_holds_f64_at_a_wide_range(S, hd, seed):
    """The f32 dq kernel's weights and D at the wide range (q, k x 2, v
    x 8): p and sum_t p dW divided by l = sum_t p, both summed in the
    kernel's lanes with their rounding errors carried.  dq's largest
    error against f64 stays within WIDE_ERR_RATIO of the plain
    version's (CPU readings 0.45-1.02x), on the data of the card leg
    (seed 25) and of causal_attention_ab.py (seed 23)."""
    assert _dq_err_ratio(seed, S, hd) <= WIDE_ERR_RATIO


@pytest.mark.parametrize("seed,S,hd,how", [
    (25, 1000, 16, dict(normalise=False)),
    (23, 1024, 16, dict(compensate=False))], ids=["unnormalised", "lanes"])
def test_f32_dq_controls_leave_f64_at_a_wide_range(seed, S, hd, how):
    """Controls of the f32 dq kernel's order.  p from a rounded f32 lse
    sums to 1 only within lse's rounding (about 1e-6 at the wide range),
    and D = sum_t p dW then enters every dS as -(l - 1) D p: unnormalised
    dq leaves WIDE_ERR_RATIO (CPU 2.0x; the card's kernel read 2.5-2.7x
    there before it normalised).  A lane's plain sum of S / 8 terms
    rounds at D's magnitude each time: uncompensated sums leave it too
    (CPU 1.9x; the card's kernel read 2.2x there)."""
    assert _dq_err_ratio(seed, S, hd, **how) > WIDE_ERR_RATIO


def test_cpu_tensors_take_the_plain_version():
    arrays = _draw(7, 1, 9, 2, 24)         # a head dim no kernel takes
    q, k, v, _ = (torch.from_numpy(a) for a in arrays)
    before = (causal_attention_forward.launches,
              causal_attention_backward_dq.launches,
              causal_attention_backward_dkdv.launches)
    got = causal_attention(q, k, v)
    assert torch.equal(got, causal_attention_plain(q, k, v))
    assert before == (causal_attention_forward.launches,
                      causal_attention_backward_dq.launches,
                      causal_attention_backward_dkdv.launches)


def test_arguments_the_kernels_do_not_take_raise():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(TypeError):
        causal_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        causal_attention(q, q, q.bfloat16())
    with pytest.raises(ValueError):
        causal_attention(q, q, torch.zeros(1, 9, 2, 16))
    with pytest.raises(ValueError):
        causal_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError):
        causal_attention(*(torch.zeros(1, 0, 2, 16),) * 3)
    meta = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        causal_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="run on cuda"):
        causal_attention_forward(q, q, q)


def test_the_kernels_take_the_head_dims_the_port_runs():
    from brpc_tpu_torch.models.transformer import ModelConfig
    from brpc_tpu_torch.serving.engine import tiny_config
    for cfg in (ModelConfig(), tiny_config()):
        assert cfg.head_dim in KERNEL_HEAD_DIMS


# ---------------------------------------------------------------------------
# the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc for the kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 63, 64, 65, 200, 1000, 1024])
def test_kernels_match_plain_on_the_card(S, hd, dtype):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = _draw(8, 2, S, 3, hd)
    before = (causal_attention_forward.launches,
              causal_attention_backward_dq.launches,
              causal_attention_backward_dkdv.launches)
    got = _torch_grads(causal_attention, arrays, dtype, "cuda")
    want = _torch_grads(causal_attention_plain, arrays, dtype, "cuda")
    torch.cuda.synchronize()
    assert (causal_attention_forward.launches,
            causal_attention_backward_dq.launches,
            causal_attention_backward_dkdv.launches) == tuple(
                n + 1 for n in before)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **CARD_TOL[dtype])


@pytest.mark.cuda
def test_kernels_read_strided_inputs():
    """q, k, v as views of one fused [B, S, 3, H, hd] projection, and dO
    with a transposed layout: the kernels read the strides."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(9)
    B, S, H, hd = 2, 100, 4, 64
    qkv = torch.randn(B, S, 3, H, hd, generator=g, device="cuda")
    q, k, v = (qkv[:, :, i] for i in range(3))
    do = torch.randn(B, H, S, hd, generator=g,
                     device="cuda").transpose(1, 2)
    o, lse = causal_attention_forward(q, k, v)
    dq, delta = causal_attention_backward_dq(q, k, v, do, lse)
    dk, dv = causal_attention_backward_dkdv(q, k, v, do, lse, delta)
    c = [t.contiguous() for t in (q, k, v, do)]
    o2, lse2 = causal_attention_forward(*c[:3])
    dq2, delta2 = causal_attention_backward_dq(*c, lse2)
    dk2, dv2 = causal_attention_backward_dkdv(*c, lse2, delta2)
    torch.cuda.synchronize()
    for a, b in ((o, o2), (lse, lse2), (dq, dq2), (delta, delta2),
                 (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S", [65, 1000])
def test_tensor_core_kernels_read_strided_and_unaligned_inputs(S, hd):
    """bf16: q, k, v as views of one fused [B, S, 3, H, hd] projection and
    a transposed dO go to TMA as they are; a view whose base is not 16-byte
    aligned (offset by one element) is copied by the wrapper.  Each gives
    the same outputs, to the bit, as contiguous copies (forward, dq and
    dk/dv), and o, dk and dv are within CARD_TOL of the plain version."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(15)
    B, H = 2, 3
    qkv = torch.randn(B, S, 3, H, hd, generator=g,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (qkv[:, :, i] for i in range(3))
    do = torch.randn(B, H, S, hd, generator=g,
                     device="cuda").to(torch.bfloat16).transpose(1, 2)
    flat = torch.randn(B * S * H * hd + 1, generator=g,
                       device="cuda").to(torch.bfloat16)
    k_odd = flat[1:].view(B, S, H, hd)          # base off by 2 bytes
    k_odd.copy_(k)
    c = [t.contiguous() for t in (q, k, v, do)]
    o, lse = causal_attention_forward(q, k_odd, v)
    dq, delta = causal_attention_backward_dq(q, k_odd, v, do, lse)
    dk, dv = causal_attention_backward_dkdv(q, k_odd, v, do, lse, delta)
    o2, lse2 = causal_attention_forward(*c[:3])
    dq2, delta2 = causal_attention_backward_dq(*c, lse2)
    dk2, dv2 = causal_attention_backward_dkdv(*c, lse2, delta2)
    leaves = [t.clone().requires_grad_(True) for t in c[:3]]
    want = causal_attention_plain(*leaves)
    _, want_dk, want_dv = torch.autograd.grad(want, leaves, c[3])
    torch.cuda.synchronize()
    for a, b in ((o, o2), (lse, lse2), (dq, dq2), (delta, delta2),
                 (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)
    for a, b in ((o, want), (dk, want_dk), (dv, want_dv)):
        torch.testing.assert_close(a.float(), b.detach().float(),
                                   **CARD_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
def test_dkdv_kernel_is_deterministic(hd):
    """No atomics: two dk/dv calls on the same inputs are bit-equal."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, do = (torch.randn(2, 1000, 3, hd, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    _, lse = causal_attention_forward(q, k, v)
    _, delta = causal_attention_backward_dq(q, k, v, do, lse)
    first = causal_attention_backward_dkdv(q, k, v, do, lse, delta)
    second = causal_attention_backward_dkdv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_takes_the_tensor_cores_and_f32_the_simt_kernels():
    """The dtype dispatch, read from the device's own kernel names under
    torch.profiler: bf16 forward, dq and dk/dv launch the wgmma kernels
    and no SIMT kernel; f32 launches the CUDA-core forward, dq and dk/dv
    (causal_fwd_f32_kernel, causal_dq_f32_kernel,
    causal_dkdv_f32_kernel) and no wgmma one; no dtype launches a SIMT
    kernel (causal_dq_kernel, causal_dkdv_kernel), which are gone."""
    _card()
    from torch.profiler import ProfilerActivity, profile
    arrays = _draw(16, 1, 130, 2, 64)
    names = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _torch_grads(causal_attention, arrays, dtype, "cuda")
            torch.cuda.synchronize()
        names[name] = {e.name for e in prof.events() if "causal_" in e.name}

    def has(dt, kernel):
        return any(kernel in n for n in names[dt])

    assert has("bf16", "causal_fwd_sm90") and has("bf16", "causal_dq_sm90")
    assert has("bf16", "causal_dkdv_sm90")
    assert not has("bf16", "causal_fwd_kernel")
    assert not has("bf16", "causal_dq_kernel")
    assert not has("bf16", "causal_dkdv_kernel")
    assert not has("bf16", "causal_fwd_f32_kernel")
    assert has("f32", "causal_fwd_f32_kernel")
    assert has("f32", "causal_dq_f32_kernel")
    assert has("f32", "causal_dkdv_f32_kernel")
    assert not has("f32", "causal_dkdv_kernel")
    assert not has("f32", "causal_dq_kernel")
    assert not has("f32", "causal_fwd_kernel")
    assert not has("f32", "_sm90")


def _lse_plain(q, k):
    """[B, H, S]: the log-sum-exp of each row's masked f32 scores."""
    S, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bshk,bthk->bhst", q, k).float() / math.sqrt(hd)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    return torch.logsumexp(s.masked_fill(~mask, -1e30), dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S", [1000, 1024])
def test_f32_forward_matches_plain_on_the_card(S, hd):
    """The one-pass f32 forward: o and lse within CARD_TOL of the plain
    version."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = _draw(14, 2, S, 3, hd)
    q, k, v, _ = (torch.from_numpy(a).to("cuda") for a in arrays)
    launches = causal_attention_forward.launches
    o, lse = causal_attention_forward(q, k, v)
    want = causal_attention_plain(q, k, v)
    want_lse = _lse_plain(q, k)
    torch.cuda.synchronize()
    assert causal_attention_forward.launches == launches + 1
    torch.testing.assert_close(o, want, **CARD_TOL[torch.float32])
    torch.testing.assert_close(lse, want_lse, **CARD_TOL[torch.float32])


def _f64_reference(q, k, v):
    """o [B, S, H, hd] and lse [B, H, S] in f64 throughout."""
    S, hd = q.shape[1], q.shape[-1]
    q, k, v = (t.double() for t in (q, k, v))
    s = torch.einsum("bshk,bthk->bhst", q, k) / math.sqrt(hd)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    s = s.masked_fill(~mask, float("-inf"))
    return (torch.einsum("bhst,bthk->bshk", torch.softmax(s, -1), v),
            torch.logsumexp(s, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S", [1000, 1024])
def test_f32_forward_at_a_wide_range_is_as_exact_as_plain(S, hd):
    """q, k x 2 and v x 8: there f32 itself leaves CARD_TOL (the plain
    version's largest error against an f64 reference is 6-16x its atol),
    and two f32 versions that order their sums differently may differ by
    more than CARD_TOL (the one-pass forward read up to 1.76x, the
    earlier two-pass SIMT kernel up to 1.22x; causal_attention_ab.py on
    an H100).  So o is held to the f64 reference: its largest error at
    most WIDE_ERR_RATIO times the plain version's (read: 0.97-1.06); lse
    within CARD_TOL of the reference's."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = _draw(14, 2, S, 3, hd, 2.0)
    arrays[2] = arrays[2] * 8.0
    q, k, v, _ = (torch.from_numpy(a).to("cuda") for a in arrays)
    o, lse = causal_attention_forward(q, k, v)
    plain = causal_attention_plain(q, k, v)
    ref, ref_lse = _f64_reference(q, k, v)
    torch.cuda.synchronize()
    err = float((o.double() - ref).abs().max())
    plain_err = float((plain.double() - ref).abs().max())
    assert err <= WIDE_ERR_RATIO * plain_err, (err, plain_err)
    torch.testing.assert_close(lse.double(), ref_lse,
                               **CARD_TOL[torch.float32])


@pytest.mark.cuda
def test_f32_forward_copies_an_unaligned_view():
    """An f32 k whose base is off 16 bytes (the rule of the forward's
    16-byte cp.async copies) is copied by the wrapper: o and lse are the
    bits of a contiguous k."""
    _card()
    q, k, v, _ = (torch.from_numpy(a).to("cuda")
                  for a in _draw(18, 2, 200, 3, 64))
    flat = torch.empty(k.numel() + 1, device="cuda")
    k_odd = flat[1:].view(k.shape)               # base off by 4 bytes
    k_odd.copy_(k)
    got = causal_attention_forward(q, k_odd, v)
    want = causal_attention_forward(q, k, v)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
def test_f32_dq_copies_an_unaligned_view_and_repeats_its_bits(hd):
    """The f32 dq kernel: a k and a dO whose bases are off 16 bytes (its
    16-byte cp.async copies) are copied by the wrapper, giving the bits
    of contiguous ones; a second run gives the same bits; and dq and D
    are within CARD_TOL of the plain version's dq and of sum_t p dW."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = _draw(19, 2, 1000, 3, hd)
    q, k, v, do = (torch.from_numpy(a).to("cuda") for a in arrays)
    _, lse = causal_attention_forward(q, k, v)
    odd = []
    for t in (k, do):
        flat = torch.empty(t.numel() + 1, device="cuda")
        odd.append(flat[1:].view(t.shape))           # base off by 4 bytes
        odd[-1].copy_(t)
    got = [causal_attention_backward_dq(q, odd[0], v, odd[1], lse)]
    got += [causal_attention_backward_dq(q, k, v, do, lse) for _ in range(2)]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_dq, = torch.autograd.grad(causal_attention_plain(*leaves), leaves[0],
                                   do)
    p = torch.exp(torch.einsum("bshk,bthk->bhst", q, k) / math.sqrt(hd)
                  - lse[..., None]).tril()
    want_delta = (p * torch.einsum("bshk,bthk->bhst", do, v)).sum(-1)
    torch.cuda.synchronize()
    for a, b, c in zip(*got):
        assert torch.equal(a, b) and torch.equal(b, c)
    torch.testing.assert_close(got[0][0], want_dq, **CARD_TOL[torch.float32])
    torch.testing.assert_close(got[0][1], want_delta,
                               **CARD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["unit", "wide"])
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S", [1000, 1024])
def test_f32_dq_at_a_wide_range_is_as_exact_as_plain(S, hd, wide):
    """dq of the f32 dq kernel against the function in f64 throughout,
    at unit scale and at a wide range (q, k x 2, v x 8, where the plain
    version's dq lies up to 18x CARD_TOL from f64; CPU leg
    test_plain_f32_dq_against_f64): the kernel's largest error at most
    WIDE_ERR_RATIO times the plain version's, the kernel from the plain
    softmax's f32 lse (it takes D itself)."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = _wide(25, 2, S, 3, hd, wide)
    q, k, v, do = (torch.from_numpy(a).to("cuda") for a in arrays)
    got, _ = causal_attention_backward_dq(q, k, v, do, _lse_plain(q, k))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain, = torch.autograd.grad(causal_attention_plain(*leaves), leaves[0],
                                 do)
    exact = _f64_grads(q, k, v, do)[0]
    torch.cuda.synchronize()
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    assert err <= WIDE_ERR_RATIO * plain_err, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["unit", "wide"])
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S", [1000, 1024])
def test_bf16_dq_at_a_wide_range_is_as_exact_as_plain(S, hd, wide):
    """dq of the bf16 dq kernel (causal_dq_sm90, which takes D = sum_t p
    dW without dividing p by its row sum) against the function in f64
    throughout on the same bf16 inputs, at unit scale and at a wide range
    (q, k x 2, v x 8, where the same cause once left the f32 dq at 2.7x
    the plain version's error): the kernel's
    largest error at most WIDE_ERR_RATIO times the plain version's
    (autograd in bf16), the kernel from the plain bf16 scores' f32 lse."""
    _card()
    arrays = _wide(25, 2, S, 3, hd, wide)
    q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                   for a in arrays)
    got, _ = causal_attention_backward_dq(q, k, v, do, _lse_plain(q, k))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain, = torch.autograd.grad(causal_attention_plain(*leaves), leaves[0],
                                 do)
    exact = _f64_grads(q, k, v, do)[0]
    torch.cuda.synchronize()
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    assert err <= WIDE_ERR_RATIO * plain_err, (err, plain_err)


def _dkdv_inputs(arrays):
    """q, k, v, dO on the card, and the lse and D the plain version's
    softmax gives them (f32): the dk/dv kernel's inputs, apart from the
    forward and dq kernels."""
    q, k, v, do = (torch.from_numpy(a).to("cuda") for a in arrays)
    hd = q.shape[-1]
    lse = _lse_plain(q, k)
    p = torch.exp(torch.einsum("bshk,bthk->bhst", q, k) / math.sqrt(hd)
                  - lse[..., None]).tril()
    delta = (p * torch.einsum("bshk,bthk->bhst", do, v)).sum(-1)
    return q, k, v, do, lse, delta


def _plain_dkdv(q, k, v, do):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    return torch.autograd.grad(causal_attention_plain(*leaves), leaves[1:],
                               do)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S", [65, 200, 1000, 1024])
def test_f32_dkdv_matches_plain_on_the_card(S, hd):
    """The f32 dk/dv kernel alone, from the plain softmax's lse and D:
    dk and dv within CARD_TOL of the plain version's autograd, one
    launch."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, lse, delta = _dkdv_inputs(_draw(22, 2, S, 3, hd))
    launches = causal_attention_backward_dkdv.launches
    got = causal_attention_backward_dkdv(q, k, v, do, lse, delta)
    want = _plain_dkdv(q, k, v, do)
    torch.cuda.synchronize()
    assert causal_attention_backward_dkdv.launches == launches + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **CARD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["unit", "wide"])
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S", [1000, 1024])
def test_f32_dkdv_at_a_wide_range_is_as_exact_as_plain(S, hd, wide):
    """dk and dv of the f32 dk/dv kernel against the function in f64
    throughout, at unit scale and at a wide range (q, k x 2, v x 8, where
    the plain version's dk lies up to 16x CARD_TOL from f64; CPU leg
    test_plain_f32_dkdv_against_f64): the kernel's largest error at most
    WIDE_ERR_RATIO times the plain version's, both from the same f32 lse
    and D."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, lse, delta = _dkdv_inputs(_wide(23, 2, S, 3, hd, wide))
    got = causal_attention_backward_dkdv(q, k, v, do, lse, delta)
    plain = _plain_dkdv(q, k, v, do)
    exact = _f64_grads(q, k, v, do)[1:]
    torch.cuda.synchronize()
    for name, g, p, e in zip(("dk", "dv"), got, plain, exact):
        err = float((g.double() - e).abs().max())
        plain_err = float((p.double() - e).abs().max())
        assert err <= WIDE_ERR_RATIO * plain_err, (name, err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
def test_f32_dkdv_copies_an_unaligned_view_and_repeats_its_bits(hd):
    """The f32 dk/dv kernel: a q and a v whose bases are off 16 bytes
    (its 16-byte cp.async copies) are copied by the wrapper, giving the
    bits of contiguous ones, and a second run gives the same bits."""
    _card()
    q, k, v, do, lse, delta = _dkdv_inputs(_draw(24, 2, 1000, 3, hd))
    odd = []
    for t in (q, v):
        flat = torch.empty(t.numel() + 1, device="cuda")
        odd.append(flat[1:].view(t.shape))           # base off by 4 bytes
        odd[-1].copy_(t)
    got = [causal_attention_backward_dkdv(odd[0], k, odd[1], do, lse,
                                          delta)]
    got += [causal_attention_backward_dkdv(q, k, v, do, lse, delta)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b, c in zip(*got):
        assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.cuda
def test_autograd_function_is_the_kernels():
    _card()
    arrays = _draw(10, 1, 70, 2, 16)
    got = _torch_grads(CausalAttention.apply, arrays, torch.float32, "cuda")
    want = _torch_grads(causal_attention, arrays, torch.float32, "cuda")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernels_refuse_a_head_dim_they_do_not_take():
    _card()
    q = torch.zeros(1, 8, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="not 48"):
        causal_attention(q, q, q)


@pytest.mark.cuda
def test_bf16_kernels_match_plain_at_8k_and_32_heads():
    """The three bf16 kernels at the lfm2 pretraining cell's attention,
    S = 8192 and 32 heads of 64 (one sequence), against autograd of the
    plain version on the same inputs, taken 8 heads at a time: o, dq, dk
    and dv within CARD_TOL and, since at this length most values lie
    below its atol, within 2% of the plain version's norm."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(23)
    B, S, H, hd = 1, 8192, 32, 64
    q, k, v, do = (torch.randn(B, S, H, hd, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = causal_attention(*leaves)
    got = [o.detach(), *torch.autograd.grad(o, leaves, do)]
    for h in range(0, H, 8):
        heads = slice(h, h + 8)
        part = [t[:, :, heads].clone().requires_grad_(True) for t in (q, k, v)]
        want_o = causal_attention_plain(*part)
        want = [want_o.detach(), *torch.autograd.grad(
            want_o, part, do[:, :, heads].contiguous())]
        for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
            a, b = a[:, :, heads].float(), b.float()
            torch.testing.assert_close(a, b, **CARD_TOL[torch.bfloat16])
            rel = float((a - b).norm() / b.norm())
            assert rel < 0.02, (name, h, rel)
