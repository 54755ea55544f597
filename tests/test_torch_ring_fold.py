"""The ring-attention fold of the port (brpc_tpu_torch/ops/ring_fold.py,
csrc/ring_fold*.cu) against the reference's jnp fold
(brpc_tpu/parallel/ring_attention.py:56-71, `_dense_local` :125-133) and
against its own kernels.

On the CPU:

* ``ring_fold_plain`` against the reference's fold written in jnp, one
  block at an offset (a state from an earlier fold, off-diagonal and
  diagonal blocks, causal and not), within ``CARD_TOL``: f32 the same
  sums in another order; bf16 the same roundings, but XLA's CPU
  contraction sums in its own (thread-dependent) order, so a product's
  rounding to bf16 may flip, which the flip rule below admits.
* :class:`RingAttention` on one block (Ulysses' local attention) under
  autograd against ``jax.vjp`` of ``_dense_local``: f32 within 1e-5
  forward and backward; bf16 bit-equal but for rare one-step flips.
* ``fold_model``, the kernels' arithmetic written in torch in their order
  of work (64-row query tiles, 64-key tiles; the forward in bf16 in two
  passes, the block's row max then p, its sum and p . V; in
  f32 in one pass from the carried m, the sum and p . V rescaled as the
  running max rises; a tile pair with every query before every key
  skipped unless a row of the tile has seen no key, decided in one pass
  before the loop from m and positions; dq per query tile, summed over
  its key tiles and added to the carried dq once, dk/dv per key tile
  over query tiles), against the plain version within ``CARD_TOL`` (in
  bf16 all but a few flipped elements, within ``FLIP_TOL``), the
  tolerance the card legs and chip_smoke.py hold the kernels to.  The
  one-pass order also over 1024 keys against the plain version and the
  jnp fold (a fresh state, a carried one, an off-diagonal block), and
  its up-front rule against the two-pass rule's decision.  The dk/dv
  order (the block's sums per key tile, added to a carried dk, dv once)
  on the small blocks, and over 1024 queries (fresh, carried and
  off-diagonal) against the plain version and jax.vjp of the
  reference's fold; the dq order (per query tile, summed over the keys
  in order, added to a carried dq once) likewise over 1024 keys.  The
  plain f32 dq, dk and dv against f64 at unit scale and a wide range
  (q, k x 2, v x 8).  The hd-8 bf16 forward and dk/dv of
  ``csrc/ring_fold_hd8.cu`` (``fold_model_hd8``, ``dkdv_model_hd8``: one
  pass with a per-tile rescale, each thread's 16 key (query) columns of
  a tile summed apart and then added, the quad's partials summed at the
  end; 8-term f32 sums for s and dP, dS^T rounded to bf16, dk per
  16-query chunk) against the plain version on the small blocks, over
  1024 keys against the plain version, the jnp fold and jax.vjp of the
  reference's fold in bf16, and on exact scores within ``EXACT_TOL``
  (over 1024 keys against the fold in f64, which the plain version's
  own sums leave); the dk/dv skip rule read from the rows that see no
  key of the block alone, against the SIMT kernel's scan.  Control: the
  same model skipping masked tile pairs unconditionally leaves it on a
  block whose first rows have seen no key (the reference weighs their
  masked scores by 1), in either order.  The hd-8 bf16 dq of
  ``csrc/ring_fold_hd8.cu`` (``dq_model_hd8``: dq per 16-key chunk, the
  SIMT kernel's skip rule, with the same control) and the hd-8 f32 dk/dv
  of ``csrc/ring_fold_f32_hd8.cu`` (``dkdv_model_f32_hd8``: each key
  row's 8 owners sum their queries straight, then a tree of 8) against
  the plain version on the small blocks (from zeros and from carried
  accumulators), over 1024 keys against the plain version and jax.vjp
  of the reference's fold (bf16 and f32), the f32 dk/dv against f64 at
  unit and wide range (at most WIDE_ERR_RATIO times the plain version's
  error), and the dq on integer q, k, v, dO over 1024 keys against the
  same sum in f64 within EXACT_TOL (control: dS unrounded).  The hd-8
  f32 forward of ``csrc/ring_fold_f32_hd8.cu`` (``fold_model_f32_hd8``:
  one pass, each row's keys split over 8 owners, each tile's p . v
  summed apart, the row sum's adds TwoSums, the owners' parts summed by
  a tree) and its dq (``bwd_model``: the SIMT kernel's order, kept)
  against the plain version on the small blocks (fresh and carried
  states, from zeros and into a carried dq), over 1024 keys against the
  jnp fold and the fold in f64 (and the plain version's m, l and o / l:
  its own unnormalised o lies near CARD_TOL from f64 there) and jax.vjp
  of the reference's fold, against f64 at unit and wide range (m, l, o at
  most WIDE_ERR_RATIO times the plain version's error), on exact scores
  over 1024 keys against the same sums in f64 within EXACT_TOL (control:
  p rounded to bf16), and the same control of the skip rule.
* ``split_bf16x3``, the split of p into three bf16 parts (of p 2^32)
  for its products on the tensor cores: their sum is p exactly for
  every f32 p in [0, 1] (a split of p itself loses bits below 2^-109),
  and the three-part product with bf16 values, summed in IEEE f32,
  holds the f32 product within ``F32_TOL``, which the single part hi
  leaves.  (wgmma's own sum of them did not, on an H100: the kernels
  take p's products as f32 FMAs.)
* The wrappers: a wholly future block skipped with no launch, argument
  checks.

The ``cuda``-marked legs run on the card: the three kernels against the
plain version at head dims 8, 16, 64 and 128, bf16 and f32, ragged
blocks, off-diagonal offsets, causal and not; strided q, k, v, dO bit-equal
to contiguous ones; two runs bit-equal; an unaligned bf16 view copied
for TMA, and an unaligned f32 view copied for the f32 forward's, dq's
and dk/dv's cp.async, bit-equal; the wholly future block with no launch; no
fallback (a head dim the kernels lack raises); the route under
torch.profiler (bf16 at hd 16, 64 and 128: the tensor-core forward, dq
and dk/dv; f32 there: the CUDA-core forward, dq and dk/dv; hd 8 in bf16:
the tensor-core forward, dq and dk/dv of ring_fold_hd8.cu, in f32 the
CUDA-core forward, dq and dk/dv of ring_fold_f32_hd8.cu); dq added into
a carried dq; the f32 dq and
dk/dv added into a carried dq, dk, dv at C = 65 to 1024, and against
f64 at unit scale and a wide range, as exact as the plain version (at
hd 8 too, with their strided, repeated and unaligned legs; the hd-8 f32
forward's m, l and o against f64 likewise); and
exact scores: with integer q and k every score is
the same bits on both sides, so the kernels' m, l, o and dv hold the
plain version's f32 products of p within ``EXACT_TOL`` (their sums in
another order), which p rounded once to bf16 leaves; at hd 8 the same
for the hd-8 kernels (over 1024 keys against the fold in f64), and on
integer q, k, v, dO the bf16 dq (every dS the plain version's bits)
and on integer q, k the f32 dk and dv and the f32 forward's m, l and o
within ``EXACT_TOL``, which dS left unrounded (dq) or P and dS (dk, dv)
or p (o) rounded to bf16 leave.  Every
``KERNEL_HEAD_DIMS`` leg at hd 8 reaches, in bf16, the hd-8
tensor-core forward, dq and dk/dv, and in f32 the hd-8 CUDA-core
forward, dq and dk/dv (a view not 16-byte aligned is copied
for their 16-byte copies).  They skip without
a card and run there with ``python -m pytest --noconftest -m cuda
tests/test_torch_ring_fold.py`` (this file imports jax only inside its
CPU legs).
"""

import math
import re

import numpy as np
import pytest
import torch

from brpc_tpu_torch.ops.ring_fold import (
    KERNEL_HEAD_DIMS, NEG, SPLIT_SHIFT, ring_fold_backward_dkdv,
    ring_fold_backward_dq, ring_fold_bwd_dkdv_plain, ring_fold_bwd_dq_plain,
    ring_fold_forward, ring_fold_plain, scores_plain, split_bf16x3,
    visible)
from brpc_tpu_torch.parallel.ring_attention import RingAttention

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_REF_TOL = dict(atol=1e-3, rtol=2 ** -7)    # one bf16 step
BF16_REF_FLIPS = 0.01
# the kernels against the plain version: f32 the same sums in another
# order; bf16 rounds the same products and dS, but a sum taken in
# another order can land a rounding on the other side of a tie.  Such a
# flip of one score's rounding moves its p and dS; a flip of one dS
# moves a whole row of dq (or column of dk) by one bf16 step of that dS
# times |k|: with unit-normal inputs at hd 128, dS reaches O(1), a step
# of 2^-7, times |k| up to 4, about 0.03 (read on an H100: 2 elements
# of 768,000 at 0.022).  So in bf16 at most FLIP_SHARE of the elements
# may leave CARD_TOL, and none FLIP_TOL.
CARD_TOL = {torch.bfloat16: dict(atol=1e-2, rtol=2e-2),
            torch.float32: dict(atol=1e-5, rtol=1e-5)}
FLIP_SHARE = 1e-4
FLIP_TOL = dict(atol=4e-2, rtol=8e-2)
# exact scores: the f32 products of p against the plain version's, the
# same sums in another order
EXACT_TOL = dict(atol=1e-5, rtol=1e-5)
TILE = 64
# the f32 dk/dv kernel at a wide range (q, k x 2, v x 8), against f64:
# its largest error over the plain version's
WIDE_ERR_RATIO = 1.5


def _draw(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def _block(seed, B, Cq, Ck, H, hd, dtype, device="cpu"):
    """q, k, v, dO in `dtype` and a state (m, l, o) from an earlier fold."""
    q, k, v, do, o = _draw(seed, (B, Cq, H, hd), (B, Ck, H, hd),
                           (B, Ck, H, hd), (B, Cq, H, hd), (B, H, Cq, hd))
    rng = np.random.default_rng(seed + 1)
    m = rng.uniform(-1, 2, (B, H, Cq)).astype(np.float32)
    l = rng.uniform(1, 4, (B, H, Cq)).astype(np.float32)
    t = [torch.from_numpy(a).to(device) for a in (q, k, v, do, m, l, o)]
    return [x.to(dtype) for x in t[:4]] + t[4:]


# (Cq, Ck, q_off, k_off, causal): diagonal, off-diagonal past, partly
# masked, ragged tiles, and a block whose first rows see no key
BLOCKS = [(130, 130, 130, 130, True), (130, 130, 260, 0, True),
          (70, 130, 100, 64, True), (65, 63, 0, 0, False),
          (130, 130, 130, 130, False), (128, 128, 0, 64, True)]


# ---------------------------------------------------------------------------
# the reference's fold in jnp


def _jnp_fold(q, k, v, m, l, o, q_off, k_off, causal, scale):
    """ring_attention.py:57-69 (`fold`), one held block."""
    import jax
    import jax.numpy as jnp
    s = jnp.einsum("bchk,bdhk->bhcd", q, k).astype(jnp.float32) * scale
    if causal:
        qpos = q_off + jnp.arange(q.shape[1])
        kpos = k_off + jnp.arange(k.shape[1])
        mask = qpos[:, None] >= kpos[None, :]
        s = jnp.where(mask[None, None], s, np.float32(NEG))
    m_new = jnp.maximum(m, s.max(-1))
    p = jnp.exp(s - m_new[..., None])
    alpha = jnp.exp(m - m_new)
    l_new = l * alpha + p.sum(-1)
    o_new = o * alpha[..., None] + jnp.einsum(
        "bhcd,bdhk->bhck", p, v.astype(jnp.float32))
    del jax
    return m_new, l_new, o_new


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal", BLOCKS[:5])
def test_plain_fold_matches_the_jnp_fold(Cq, Ck, q_off, k_off, causal,
                                         dtype):
    import jax.numpy as jnp
    q, k, v, _, m, l, o = _block(3, 2, Cq, Ck, 2, 8, dtype)
    scale = 1.0 / math.sqrt(8)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    # copies: jax may alias a numpy buffer, and the port updates in place
    want = _jnp_fold(*(jnp.asarray(t.float().numpy(), jdt)
                       for t in (q, k, v)),
                     *(jnp.array(t.numpy()) for t in (m, l, o)),
                     q_off, k_off, causal, scale)
    want = [torch.from_numpy(np.array(w)) for w in want]
    ring_fold_plain(q, k, v, m, l, o, q_off, k_off, causal, scale)
    _close((m, l, o), want, dtype)


def _f64_fold(q, k, v, m, l, o, q_off, k_off, causal, scale):
    """The fold of ring_fold_plain in f64 throughout: new (m, l, o)."""
    q, k, v, m, l, o = (t.double() for t in (q, k, v, m, l, o))
    s = torch.einsum("bchk,bdhk->bhcd", q, k) * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    return (m_new, l * alpha + p.sum(-1),
            o * alpha[..., None] + torch.einsum("bhcd,bdhk->bhck", p, v))


def _jnp_dense_local(q, k, v, causal, scale):
    """ring_attention.py:125-133."""
    import jax
    import jax.numpy as jnp
    s = jnp.einsum("bchk,bdhk->bhcd", q, k).astype(jnp.float32) * scale
    if causal:
        Sq = q.shape[1]
        mask = jnp.tril(jnp.ones((Sq, Sq), bool))
        s = jnp.where(mask[None, None], s, np.float32(NEG))
    w = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhcd,bdhk->bchk", w,
                      v.astype(jnp.float32)).astype(q.dtype)


def _local_grads(fn, arrays, dtype, device="cpu"):
    q, k, v, do = (torch.from_numpy(a).to(device, dtype) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    o = fn(q, k, v)
    return [t.detach().float() for t in
            (o, *torch.autograd.grad(o, (q, k, v), do))]


def _fold_attention(causal):
    def fn(q, k, v):
        return RingAttention.apply(q, k, v, None, "sp", causal,
                                   1.0 / math.sqrt(q.shape[-1]))
    return fn


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_one_fold_matches_dense_local_and_its_vjp(dtype, causal):
    import jax
    import jax.numpy as jnp
    arrays = _draw(5, *[(2, 70, 3, 16)] * 4)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrays)
    out, pull = jax.vjp(
        lambda q, k, v: _jnp_dense_local(q, k, v, causal, 0.25), jq, jk, jv)
    want = [np.asarray(t.astype(jnp.float32)) for t in (out, *pull(jdo))]
    got = _local_grads(_fold_attention(causal), arrays, dtype)
    for g, w in zip(got, want):
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w, **F32_TOL)
        else:
            w = torch.from_numpy(np.array(w))
            gap = ((g - w).abs() / (BF16_REF_TOL["atol"] + BF16_REF_TOL[
                "rtol"] * w.abs())).max()
            assert float(gap) <= 1.0
            assert float((g != w).float().mean()) <= BF16_REF_FLIPS


# ---------------------------------------------------------------------------
# the kernels' order of work, on the CPU


def _tile_scores(qf, kf, q0, k0, nq, nk, q_off, k_off, causal, scale,
                 dtype):
    """The kernels' `scores` for a tile pair (rows q0.., keys k0..)."""
    s = torch.einsum("bchk,bdhk->bhcd", qf[:, q0:q0 + nq],
                     kf[:, k0:k0 + nk]).to(dtype).float() * scale
    if causal:
        qpos = q_off + torch.arange(q0, q0 + nq)
        kpos = k_off + torch.arange(k0, k0 + nk)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG)
    return s


def _all_masked(q_off, q0, Cq, k_off, k0, causal):
    return causal and q_off + min(q0 + TILE - 1, Cq - 1) < k_off + k0


def _degenerate(x):
    return bool((torch.exp(NEG - x) != 0).any())


def _pass1_max(qf, kf, m_old, q0, nq, tiles, q_off, k_off, causal, scale,
               dtype):
    """The two-pass forward's first pass: max(m, the block's row max over
    `tiles`)."""
    m_new = torch.full_like(m_old, -math.inf)
    for k0 in tiles:
        s = _tile_scores(qf, kf, q0, k0, nq, min(TILE, kf.shape[1] - k0),
                         q_off, k_off, causal, scale, dtype)
        m_new = torch.maximum(m_new, s.amax(-1))
    return torch.maximum(m_old, m_new)


def _degenerate_up_front(m_old, q0, q_off, k_off, causal):
    """The one-pass forward's rule, decided before its loop, per (b, h):
    some row of the tile has a degenerate m and (causal) sees no key of
    the block, q_off + row < k_off."""
    rows = q_off + torch.arange(q0, q0 + m_old.shape[-1])
    sees_none = causal & (rows < k_off)
    return ((torch.exp(NEG - m_old) != 0) & sees_none).any(-1)


def fold_model(q, k, v, m, l, o, q_off, k_off, causal, scale,
               skip_always=False, one_pass=None):
    """The fold kernels' forward in their order of work, per 64-row query
    tile over the key tiles that are not wholly masked (every tile if a
    row of the tile has seen no key and sees none of the block), then the
    update (m', l a + sum, o a + acc) once, a = exp(m - m').  Two passes
    (csrc/ring_fold_sm90.cu): the block's row max m',
    then p = exp(s - m'), its sum and p . V, the rule read from m'.  One
    pass (``one_pass``; csrc/ring_fold_f32.cu): the rule decided up front
    from m and positions; per key tile m_t = max(m_run, tile max) from
    m_run = m, c = exp(m_run - m_t), sum = sum c + sum exp(s - m_t), acc
    = acc c + exp(s - m_t) . V.  None: one pass in f32, as the kernels
    (at head dim 8 fold_model_f32_hd8 is the kernel's exact order).
    Returns new (m, l, o)."""
    dtype, (Cq, Ck) = q.dtype, (q.shape[1], k.shape[1])
    if one_pass is None:
        one_pass = dtype == torch.float32
    qf, kf, vf = q.float(), k.float(), v.float()
    m, l, o = m.clone(), l.clone(), o.clone()
    for q0 in range(0, Cq, TILE):
        nq = min(TILE, Cq - q0)
        tiles = [k0 for k0 in range(0, Ck, TILE)
                 if not _all_masked(q_off, q0, Cq, k_off, k0, causal)]
        m_old = m[:, :, q0:q0 + nq].clone()
        if one_pass:
            degen = bool(_degenerate_up_front(m_old, q0, q_off, k_off,
                                              causal).any())
        else:
            m_new = _pass1_max(qf, kf, m_old, q0, nq, tiles, q_off, k_off,
                               causal, scale, dtype)
            degen = _degenerate(m_new)
        if degen and not skip_always:
            tiles = list(range(0, Ck, TILE))
        m_run = m_old.clone()
        total = torch.zeros_like(m_old)
        acc = torch.zeros_like(o[:, :, q0:q0 + nq])
        for k0 in tiles:
            nk = min(TILE, Ck - k0)
            s = _tile_scores(qf, kf, q0, k0, nq, nk, q_off, k_off, causal,
                             scale, dtype)
            if one_pass:
                m_new = torch.maximum(m_run, s.amax(-1))
                corr = torch.exp(m_run - m_new)
                total, acc = total * corr, acc * corr[..., None]
                m_run = m_new
            p = torch.exp(s - m_new[..., None])
            total = total + p.sum(-1)
            acc = acc + torch.einsum("bhcd,bdhk->bhck", p,
                                     vf[:, k0:k0 + nk])
        if one_pass:
            m_new = m_run
        alpha = torch.exp(m_old - m_new)
        l[:, :, q0:q0 + nq] = l[:, :, q0:q0 + nq] * alpha + total
        o[:, :, q0:q0 + nq] = o[:, :, q0:q0 + nq] * alpha[..., None] + acc
        m[:, :, q0:q0 + nq] = m_new
    return m, l, o


def _tile_p_ds(qf, kf, vf, dof, lse, delta, q0, k0, nq, nk, q_off, k_off,
               causal, scale, dtype):
    s = _tile_scores(qf, kf, q0, k0, nq, nk, q_off, k_off, causal, scale,
                     dtype)
    p = torch.exp(s - lse[:, :, q0:q0 + nq, None])
    dp = torch.einsum("bchk,bdhk->bhcd", dof[:, q0:q0 + nq],
                      vf[:, k0:k0 + nk])
    ds = ((p * (dp - delta[:, :, q0:q0 + nq, None])) * scale).to(dtype)
    return p, ds.float()


def bwd_model(q, k, v, do, lse, delta, q_off, k_off, causal, scale,
              dq=None, dk=None, dv=None):
    """The dq kernel (per query tile over key tiles) and the dk/dv kernel
    (per key tile over query tiles): (dq, dk, dv), each the carried one
    (zeros by default) plus the block's.  As the f32 dq kernels order
    their work (csrc/ring_fold_f32.cu, and at hd 8 ring_fold_f32_hd8.cu,
    each row's keys in one thread): per query tile the block's dS . K
    summed over the key tiles it visits (every tile if a row of the query
    tile has seen no key), then added to the carried dq once.  As the
    dk/dv kernels order theirs (csrc/ring_fold_f32.cu in f32 at hd 16, 64
    and 128, on transposed tiles; the tensor-core kernels alike): per
    64-key tile the
    block's dS^T . Q and P^T . dO summed over the query tiles it visits
    (every tile if a row of the block has seen no key, else those not
    wholly before the key tile), then added to the carried dk, dv
    once."""
    dtype, (B, Cq, H, hd), Ck = q.dtype, q.shape, k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.zeros(B, H, Cq, hd) if dq is None else dq.clone()
    dk = torch.zeros(B, H, Ck, hd) if dk is None else dk.clone()
    dv = torch.zeros(B, H, Ck, hd) if dv is None else dv.clone()
    degen = _degenerate(lse)
    for q0 in range(0, Cq, TILE):
        nq = min(TILE, Cq - q0)
        tile_degen = _degenerate(lse[:, :, q0:q0 + nq])
        acc = torch.zeros(B, H, nq, hd)
        for k0 in range(0, Ck, TILE):
            if _all_masked(q_off, q0, Cq, k_off, k0, causal) and \
                    not tile_degen:
                break
            nk = min(TILE, Ck - k0)
            _, ds = _tile_p_ds(qf, kf, vf, dof, lse, delta, q0, k0, nq, nk,
                               q_off, k_off, causal, scale, dtype)
            acc = acc + torch.einsum("bhcd,bdhk->bhck", ds,
                                     kf[:, k0:k0 + nk])
        dq[:, :, q0:q0 + nq] = dq[:, :, q0:q0 + nq] + acc
    for k0 in range(0, Ck, TILE):
        nk = min(TILE, Ck - k0)
        acc_k = torch.zeros(B, H, nk, hd)
        acc_v = torch.zeros(B, H, nk, hd)
        for q0 in range(0, Cq, TILE):
            if _all_masked(q_off, q0, Cq, k_off, k0, causal) and not degen:
                continue
            nq = min(TILE, Cq - q0)
            p, ds = _tile_p_ds(qf, kf, vf, dof, lse, delta, q0, k0, nq, nk,
                               q_off, k_off, causal, scale, dtype)
            acc_k = acc_k + torch.einsum("bhcd,bchk->bhdk", ds,
                                         qf[:, q0:q0 + nq])
            acc_v = acc_v + torch.einsum("bhcd,bchk->bhdk", p,
                                         dof[:, q0:q0 + nq])
        dk[:, :, k0:k0 + nk] = dk[:, :, k0:k0 + nk] + acc_k
        dv[:, :, k0:k0 + nk] = dv[:, :, k0:k0 + nk] + acc_v
    return dq, dk, dv


def _rows(B, H, C, hd, device="cpu"):
    return torch.zeros(B, H, C, hd, device=device)


def _plain_block(q, k, v, do, m, l, o, q_off, k_off, causal, scale):
    """The plain fold and backward of one block from the state (m, l, o):
    [m, l, o, dq, dk, dv] with lse and D of the folded state."""
    m, l, o = m.clone(), l.clone(), o.clone()
    ring_fold_plain(q, k, v, m, l, o, q_off, k_off, causal, scale)
    lse, delta = _lse_delta(m, l, o, do)
    B, Cq, H, hd = q.shape
    dq, dk, dv = (_rows(B, H, c, hd, q.device)
                  for c in (Cq, k.shape[1], k.shape[1]))
    ring_fold_bwd_dq_plain(q, k, v, do, lse, delta, dq, q_off, k_off,
                           causal, scale)
    ring_fold_bwd_dkdv_plain(q, k, v, do, lse, delta, dk, dv, q_off, k_off,
                             causal, scale)
    return [m, l, o, dq, dk, dv], (lse, delta)


def _lse_delta(m, l, o, do):
    on = o / torch.clamp(l, min=1e-30)[..., None]
    return (m + torch.log(l),
            (do.float().transpose(1, 2) * on).sum(-1).contiguous())


def _close(got, want, dtype):
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, **CARD_TOL[dtype])
            continue
        tol = CARD_TOL[dtype]
        out = (g - w).abs() > tol["atol"] + tol["rtol"] * w.abs()
        assert float(out.float().mean()) <= FLIP_SHARE, int(out.sum())
        torch.testing.assert_close(g, w, **FLIP_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal", BLOCKS)
def test_fold_model_matches_plain(Cq, Ck, q_off, k_off, causal, dtype):
    q, k, v, do, m, l, o = _block(7, 1, Cq, Ck, 2, 16, dtype)
    scale = 0.25
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                      causal, scale)
    got = list(fold_model(q, k, v, m, l, o, q_off, k_off, causal, scale))
    got += bwd_model(q, k, v, do, lse, delta, q_off, k_off, causal, scale)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal", BLOCKS)
def test_dq_model_adds_the_block_to_a_carried_dq(Cq, Ck, q_off, k_off,
                                                 causal, dtype):
    """The dq kernel's order of work (the block's sum per query tile,
    then one add) from a dq carried over earlier blocks, against
    ring_fold_bwd_dq_plain from the same dq."""
    q, k, v, do, m, l, o = _block(41, 1, Cq, Ck, 2, 16, dtype)
    scale = 0.25
    _, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                   causal, scale)
    carried, = _draw(43, (1, 2, Cq, 16))
    carried = torch.from_numpy(carried)
    want = carried.clone()
    ring_fold_bwd_dq_plain(q, k, v, do, lse, delta, want, q_off, k_off,
                           causal, scale)
    got = bwd_model(q, k, v, do, lse, delta, q_off, k_off, causal, scale,
                    dq=carried)[0]
    assert not torch.equal(got, carried)
    _close([got], [want], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal", BLOCKS)
def test_dkdv_model_adds_the_block_to_a_carried_dkdv(Cq, Ck, q_off, k_off,
                                                     causal, dtype):
    """The dk/dv kernels' order of work (the block's sums per key tile,
    then one add) from dk, dv carried over earlier blocks, against
    ring_fold_bwd_dkdv_plain from the same dk, dv."""
    q, k, v, do, m, l, o = _block(55, 1, Cq, Ck, 2, 16, dtype)
    scale = 0.25
    _, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                   causal, scale)
    carried = [torch.from_numpy(a) for a in _draw(57, *[(1, 2, Ck, 16)] * 2)]
    want = [t.clone() for t in carried]
    ring_fold_bwd_dkdv_plain(q, k, v, do, lse, delta, *want, q_off, k_off,
                             causal, scale)
    got = bwd_model(q, k, v, do, lse, delta, q_off, k_off, causal, scale,
                    dk=carried[0], dv=carried[1])[1:]
    assert not any(torch.equal(g, c) for g, c in zip(got, carried))
    _close(got, want, dtype)


@pytest.mark.parametrize("one_pass", [True, False],
                         ids=["one_pass", "two_pass"])
def test_fold_model_skipping_every_masked_tile_fails_a_fresh_block(one_pass):
    """Rows 0..63 at q_off 0 see no key at k_off 64: from m = -1e30 the
    reference weighs their masked scores by exp(0) = 1, so the masked
    tile pairs cannot be skipped there (in either order of work)."""
    q, k, v, _, m, l, o = _block(9, 1, 128, 128, 2, 16, torch.float32)
    m.fill_(NEG)
    l.zero_()
    o.zero_()
    want = [t.clone() for t in (m, l, o)]
    ring_fold_plain(q, k, v, *want, 0, 64, True, 0.25)
    assert float(want[1][:, :, :64].min()) == 128.0    # p = 1 on every key
    _close(fold_model(q, k, v, m, l, o, 0, 64, True, 0.25,
                      one_pass=one_pass), want, torch.float32)
    bad = fold_model(q, k, v, m, l, o, 0, 64, True, 0.25, skip_always=True,
                     one_pass=one_pass)
    with pytest.raises(AssertionError):
        _close(bad, want, torch.float32)


@pytest.mark.parametrize("fresh", [False, True], ids=["carried", "fresh"])
@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal",
                         BLOCKS + [(200, 130, 0, 100, True)])
def test_up_front_degenerate_rule_is_the_two_pass_rule(Cq, Ck, q_off, k_off,
                                                       causal, fresh):
    """The one-pass forward decides before its loop, from m and
    positions, whether a query tile must visit every key tile; the
    two-pass forward decided it from m' after its first pass.  Per (b, h,
    query tile) the decisions agree, on a state from an earlier fold and
    on a fresh one (m = -1e30), where a block whose first rows see no key
    makes them true."""
    q, k, _, _, m, _, _ = _block(47, 2, Cq, Ck, 2, 16, torch.float32)
    if fresh:
        m.fill_(NEG)
    qf, kf = q.float(), k.float()
    decided = []
    for q0 in range(0, Cq, TILE):
        nq = min(TILE, Cq - q0)
        tiles = [k0 for k0 in range(0, Ck, TILE)
                 if not _all_masked(q_off, q0, Cq, k_off, k0, causal)]
        m_old = m[:, :, q0:q0 + nq]
        m_new = _pass1_max(qf, kf, m_old, q0, nq, tiles, q_off, k_off,
                           causal, 0.25, torch.float32)
        after = (torch.exp(NEG - m_new) != 0).any(-1)
        up_front = _degenerate_up_front(m_old, q0, q_off, k_off, causal)
        assert torch.equal(up_front, after), (q0, up_front, after)
        decided.append(bool(after.any()))
    sees_none = causal and q_off < k_off
    assert any(decided) == (fresh and sees_none), decided


@pytest.mark.parametrize("case", ["fresh", "carried", "off_diagonal"])
def test_one_pass_f32_fold_holds_plain_and_jnp_over_1024_keys(case):
    """The one-pass order of the f32 forward against ring_fold_plain and
    the reference's jnp fold, within CARD_TOL, at C = 1024 (16 key tiles,
    so the running max rises past the first tile in many rows): a ring's
    first, diagonal block from a fresh state; the diagonal block of a
    state carried from an earlier fold (the past block at k_off 0); and
    an off-diagonal block on a state from an earlier fold."""
    import jax.numpy as jnp
    C, hd = 1024, 64
    q, k, v, _, m, l, o = _block(49, 1, C, C, 2, hd, torch.float32)
    scale = 1.0 / math.sqrt(hd)
    q_off, k_off = {"fresh": (0, 0), "carried": (C, C),
                    "off_diagonal": (C, 0)}[case]
    if case != "off_diagonal":
        m, l, o = _fresh(m, l, o)
    if case == "carried":
        k0, v0, _ = _draw(51, (1, C, 2, hd), (1, C, 2, hd), (1,))
        ring_fold_plain(q, torch.from_numpy(k0), torch.from_numpy(v0), m, l,
                        o, C, 0, True, scale)
    want = [t.clone() for t in (m, l, o)]
    ring_fold_plain(q, k, v, *want, q_off, k_off, True, scale)
    jnp_want = _jnp_fold(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                         *(jnp.array(t.numpy()) for t in (m, l, o)),
                         q_off, k_off, True, scale)
    got = fold_model(q, k, v, m, l, o, q_off, k_off, True, scale)
    _close(got, want, torch.float32)
    _close(got, [torch.from_numpy(np.array(w)) for w in jnp_want],
           torch.float32)
    assert not torch.equal(got[2], want[2])    # another order of sums


def _jnp_fold_grads(q, k, v, do, m, l, o, q_off, k_off, causal, scale):
    """[dq, dk, dv] ([B, H, C, hd]) of the reference: jax.vjp of the
    normalised output o' / l' of one `fold` (ring_attention.py:57-69)
    from the state (m, l, o), held constant, with cotangent dO."""
    import jax
    import jax.numpy as jnp

    def out(q, k, v):
        _, l2, o2 = _jnp_fold(q, k, v,
                              *(jnp.array(t.numpy()) for t in (m, l, o)),
                              q_off, k_off, causal, scale)
        return o2 / l2[..., None]
    _, pull = jax.vjp(out, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    grads = pull(jnp.asarray(do.numpy().transpose(0, 2, 1, 3)))
    return [torch.from_numpy(np.array(g).transpose(0, 2, 1, 3))
            for g in grads]


def _c1024_case(case, seed, hd=64):
    """q, k, v, dO, (m, l, o) and the offsets of a C = 1024 block: a
    ring's first, diagonal block from a fresh state; the diagonal block
    of a state carried from an earlier fold (the past block at k_off 0);
    an off-diagonal block on a state from an earlier fold."""
    C = 1024
    q, k, v, do, m, l, o = _block(seed, 1, C, C, 2, hd, torch.float32)
    q_off, k_off = {"fresh": (0, 0), "carried": (C, C),
                    "off_diagonal": (C, 0)}[case]
    if case != "off_diagonal":
        m, l, o = _fresh(m, l, o)
    if case == "carried":
        k0, v0 = (torch.from_numpy(a)
                  for a in _draw(seed + 2, *[(1, C, 2, hd)] * 2))
        ring_fold_plain(q, k0, v0, m, l, o, C, 0, True, hd ** -0.5)
    return q, k, v, do, (m, l, o), q_off, k_off


@pytest.mark.parametrize("case", ["fresh", "carried", "off_diagonal"])
def test_dkdv_model_holds_plain_and_jax_grad_over_1024_queries(case):
    """The f32 dk/dv kernel's order of work (64-key tiles over the query
    tiles that see them, transposed tiles, per-tile sums, the skip rule)
    at C = 1024, hd 64, from the lse and D of the plain fold: dk and dv
    within CARD_TOL of ring_fold_bwd_dkdv_plain and of jax.vjp of the
    reference's fold, normalised."""
    q, k, v, do, state, q_off, k_off = _c1024_case(case, 59)
    scale = 1.0 / math.sqrt(64)
    want, (lse, delta) = _plain_block(q, k, v, do, *state, q_off, k_off,
                                      True, scale)
    got = bwd_model(q, k, v, do, lse, delta, q_off, k_off, True, scale)[1:]
    _close(got, want[4:], torch.float32)
    _close(got, _jnp_fold_grads(q, k, v, do, *state, q_off, k_off, True,
                                scale)[1:], torch.float32)


@pytest.mark.parametrize("case", ["fresh", "carried", "off_diagonal"])
def test_dq_model_holds_plain_and_jax_grad_over_1024_keys(case):
    """The f32 dq kernel's order of work (64-row query tiles over the key
    tiles they see, dq summed over the keys in order, the skip rule, the
    block's sum added once) at C = 1024, hd 64, from the lse and D of the
    plain fold: dq within CARD_TOL of ring_fold_bwd_dq_plain and of
    jax.vjp of the reference's fold, normalised."""
    q, k, v, do, state, q_off, k_off = _c1024_case(case, 71)
    scale = 1.0 / math.sqrt(64)
    want, (lse, delta) = _plain_block(q, k, v, do, *state, q_off, k_off,
                                      True, scale)
    got = bwd_model(q, k, v, do, lse, delta, q_off, k_off, True, scale)[0]
    _close([got], want[3:4], torch.float32)
    _close([got], _jnp_fold_grads(q, k, v, do, *state, q_off, k_off, True,
                                  scale)[:1], torch.float32)


def _f64_bwd(q, k, v, do, m, l, o, q_off, k_off, causal, scale):
    """[dq, dk, dv] of one block in f64 throughout: the f64 fold's lse
    and D, then the backward's formulas."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    m, l, o = _f64_fold(q, k, v, m, l, o, q_off, k_off, causal, scale)
    lse = m + torch.log(l)
    delta = (do.transpose(1, 2) * o / l[..., None]).sum(-1)
    s = torch.einsum("bchk,bdhk->bhcd", q, k) * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG)
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.einsum("bchk,bdhk->bhcd", do, v) - delta[..., None]) \
        * scale
    return [torch.einsum("bhcd,bdhk->bhck", ds, k),
            torch.einsum("bhcd,bchk->bhdk", ds, q),
            torch.einsum("bhcd,bchk->bhdk", p, do)]


def _wide_block(seed, B, C, H, hd, wide, device="cpu"):
    """A ring's first, diagonal block (a fresh state), its q, k, v, dO
    unit normal or at a wide range (q, k x 2, v x 8)."""
    q, k, v, do, m, l, o = _block(seed, B, C, C, H, hd, torch.float32)
    if wide:
        q, k, v = q * 2.0, k * 2.0, v * 8.0
    return [t.to(device) for t in (q, k, v, do, *_fresh(m, l, o))]


def _share64(got, want):
    """The largest |got - want| / (atol + rtol |want|) under CARD_TOL's
    f32 limits, in f64 (want an f64 reference)."""
    tol = CARD_TOL[torch.float32]
    return float(((got.double() - want).abs() / (
        tol["atol"] + tol["rtol"] * want.abs())).max())


@pytest.mark.parametrize("wide", [False, True], ids=["unit", "wide"])
@pytest.mark.parametrize("hd", (16, 64, 128))
@pytest.mark.parametrize("C", [1000, 1024])
def test_plain_f32_dkdv_against_f64(C, hd, wide):
    """What f32 itself leaves in the fold's dk and dv: the plain fold and
    backward (a ring's first, diagonal block) against the same in f64
    throughout, as a share of CARD_TOL (CPU readings: unit 0.06-0.12 in
    dk and dv; wide, dk 6.2-15.2 and dv 0.53-1.01).  At the wide range
    the plain dk leaves CARD_TOL of f64, so the card leg holds the
    kernel to f64 at WIDE_ERR_RATIO times the plain version's error."""
    q, k, v, do, m, l, o = _wide_block(61, 1, C, 2, hd, wide)
    scale = hd ** -0.5
    got = _plain_block(q, k, v, do, m, l, o, 0, 0, True, scale)[0][4:]
    want = _f64_bwd(q, k, v, do, m, l, o, 0, 0, True, scale)[1:]
    shares = [_share64(g, w) for g, w in zip(got, want)]
    if wide:
        assert 1.0 < shares[0] <= 40.0 and shares[1] <= 2.5, shares
    else:
        assert max(shares) <= 0.5, shares


@pytest.mark.parametrize("wide", [False, True], ids=["unit", "wide"])
@pytest.mark.parametrize("hd", (16, 64, 128))
@pytest.mark.parametrize("C", [1000, 1024])
def test_plain_f32_dq_against_f64(C, hd, wide):
    """What f32 itself leaves in the fold's dq: the plain fold and
    backward (a ring's first, diagonal block) against the same in f64
    throughout, as a share of CARD_TOL (CPU readings: unit 0.03-0.15;
    wide 1.97-4.23).  At the wide range the plain dq leaves CARD_TOL of
    f64, so the card leg holds the kernel to f64 at WIDE_ERR_RATIO times
    the plain version's error."""
    q, k, v, do, m, l, o = _wide_block(61, 1, C, 2, hd, wide)
    scale = hd ** -0.5
    got = _plain_block(q, k, v, do, m, l, o, 0, 0, True, scale)[0][3]
    want = _f64_bwd(q, k, v, do, m, l, o, 0, 0, True, scale)[0]
    share = _share64(got, want)
    if wide:
        assert 1.0 < share <= 40.0, share
    else:
        assert share <= 0.5, share


# ---------------------------------------------------------------------------
# the split of p


def _naive_split(p):
    hi = p.to(torch.bfloat16)
    mid = (p - hi.float()).to(torch.bfloat16)
    return hi, mid, (p - hi.float() - mid.float()).to(torch.bfloat16)


def test_the_split_holds_p_exactly():
    """hi + mid + lo = p 2^32 for every f32 p in [0, 1]: within 2^-24 of p
    relative, and 2^-149 absolute below the smallest normal f32, with no
    error at all; a split of p itself misses below 2^-109, where its
    parts fall under bf16's normal range."""
    rng = np.random.default_rng(29)
    tiny = [2.0 ** -149, 3 * 2.0 ** -149, 2.0 ** -130, 2.0 ** -126,
            2.0 ** -120 * (1 + 2.0 ** -23), 2.0 ** -110]
    p = torch.cat([
        torch.tensor([0.0, 1.0, 1 - 2.0 ** -24, 0.5, 2.0 ** -24] + tiny),
        torch.from_numpy(rng.uniform(0, 1, 4096).astype(np.float32)),
        # exp over a whole row's range of scores, down to subnormal p
        torch.exp(torch.from_numpy(
            rng.uniform(-104, 0, 4096).astype(np.float32))),
        # a row that has seen no key weighs its masked scores by exp(0)
        torch.exp(torch.tensor([NEG]) - torch.tensor([NEG]))]).float()
    hi, mid, lo = split_bf16x3(p)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = (hi.float() + mid.float() + lo.float()) * 2.0 ** -SPLIT_SHIFT
    err = (back - p).abs()
    normal = p >= 2.0 ** -126
    assert bool((err[normal] <= 2.0 ** -24 * p[normal]).all())
    assert bool((err[~normal] <= 2.0 ** -149).all())
    assert torch.equal(back, p)
    naive = sum(t.float() for t in _naive_split(p))
    assert not torch.equal(naive, p)
    assert bool((naive[p >= 2.0 ** -109] == p[p >= 2.0 ** -109]).all())


def test_three_part_products_hold_the_f32_product():
    """sum_i part_i . f32(v) against the f32 einsum: within F32_TOL; the
    part hi alone (p rounded once to bf16) is not."""
    rng = np.random.default_rng(31)
    s = torch.from_numpy(rng.normal(0, 2, (2, 3, 70, 130)).astype(
        np.float32))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    v = torch.from_numpy(rng.standard_normal((2, 130, 3, 16)).astype(
        np.float32)).to(torch.bfloat16).float()
    want = torch.einsum("bhcd,bdhk->bhck", p, v)
    parts = split_bf16x3(p)
    got = sum(torch.einsum("bhcd,bdhk->bhck", t.float(), v)
              for t in parts) * 2.0 ** -SPLIT_SHIFT
    torch.testing.assert_close(got, want, **F32_TOL)
    hi_only = torch.einsum("bhcd,bdhk->bhck", parts[0].float(),
                           v) * 2.0 ** -SPLIT_SHIFT
    with pytest.raises(AssertionError):
        torch.testing.assert_close(hi_only, want, **F32_TOL)


# ---------------------------------------------------------------------------
# the wrappers


def test_a_wholly_future_block_is_skipped_without_a_launch():
    q, k, v, do, m, l, o = _block(11, 1, 16, 16, 2, 8, torch.float32)
    assert visible(32, 16, 32, True) and visible(48, 16, 16, True)
    assert not visible(16, 16, 48, True) and visible(16, 16, 48, False)
    before = [(w.launches, w.skips) for w in (
        ring_fold_forward, ring_fold_backward_dq, ring_fold_backward_dkdv)]
    state = [t.clone() for t in (m, l, o)]
    assert ring_fold_forward(q, k, v, *state, 16, 48, True, 0.5) is False
    assert all(torch.equal(a, b) for a, b in zip(state, (m, l, o)))
    acc = [torch.zeros(1, 2, 16, 8) for _ in range(3)]
    assert not ring_fold_backward_dq(q, k, v, do, m, l, acc[0], 16, 48,
                                     True, 0.5)
    assert not ring_fold_backward_dkdv(q, k, v, do, m, l, acc[1], acc[2],
                                       16, 48, True, 0.5)
    assert all(float(a.abs().max()) == 0.0 for a in acc)
    after = [(w.launches, w.skips) for w in (
        ring_fold_forward, ring_fold_backward_dq, ring_fold_backward_dkdv)]
    assert after == [(n, s + 1) for n, s in before]   # skipped, no launch
    assert ring_fold_forward(q, k, v, *state, 48, 16, True, 0.5) is True
    assert ring_fold_forward.launches == before[0][0]   # the CPU: plain


def test_arguments_the_fold_does_not_take_raise():
    q, k, v, do, m, l, o = _block(13, 1, 8, 8, 2, 8, torch.float32)
    with pytest.raises(TypeError, match="bf16 or f32"):
        ring_fold_forward(q.half(), k.half(), v.half(), m, l, o, 0, 0, True,
                          1.0)
    with pytest.raises(ValueError, match="contiguous f32"):
        ring_fold_forward(q, k, v, m.repeat(1, 1, 2)[..., ::2], l, o, 0, 0,
                          True, 1.0)
    with pytest.raises(ValueError, match="contiguous f32"):
        ring_fold_forward(q, k, v, m, l, o.double(), 0, 0, True, 1.0)
    with pytest.raises(ValueError, match="do not match"):
        ring_fold_forward(q, k[..., :4], v[..., :4], m, l, o, 0, 0, True,
                          1.0)
    meta = [t.to("meta") for t in (q, k, v, m, l, o)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ring_fold_forward(*meta, 0, 0, True, 1.0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, do, m, l, o = _block(15, 2, 40, 24, 2, 8, torch.float32)
    want = [t.clone() for t in (m, l, o)]
    ring_fold_plain(q, k, v, *want, 40, 16, True, 0.3)
    launches = ring_fold_forward.launches
    assert ring_fold_forward(q, k, v, m, l, o, 40, 16, True, 0.3)
    assert ring_fold_forward.launches == launches
    assert all(torch.equal(a, b) for a, b in zip((m, l, o), want))
    s = scores_plain(q, k, 0, 16, True, 0.3)    # query 0 before key 16
    assert s[0, 0, 0, 0] == np.float32(NEG) and s[0, 0, 16, 0] > NEG


# ---------------------------------------------------------------------------
# the hd-8 bf16 forward and dk/dv (csrc/ring_fold_hd8.cu), on the CPU

# a thread (g, t) of a warp holds columns 8 j + 2 t + c (j < 8, c < 2) of
# a 64-column tile: its 16 columns, in the order it visits them
QUAD_COLS = [[8 * j + 2 * t + c for j in range(8) for c in range(2)]
             for t in range(4)]


def _quad_sum(x):
    """The quad's sum of per-thread partials x[..., t, ...] (t on dim 3),
    as two xor-shuffles add them: (x0 + x1) + (x2 + x3)."""
    return (x[:, :, :, 0] + x[:, :, :, 1]) + (x[:, :, :, 2] + x[:, :, :, 3])


def _padded(x, n):
    """x [B, H, rows, cols] with cols padded to n by -inf."""
    pad = n - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad), value=-math.inf) if pad \
        else x


def fold_model_hd8(q, k, v, m, l, o, q_off, k_off, causal, scale):
    """ring_fold_fwd_hd8_kernel in its order of work: per 64-row query
    tile the skip rule decided up front, then one pass over the visited
    key tiles: m_t = max(m_run, tile row max), c = exp(m_run - m_t), and
    per thread of a row's quad (its 16 key columns of the tile) l_t = l_t
    c + (its tile's p summed in column order) and o_t = o_t c + (its
    tile's p . f32(v) summed over its columns in order; each FMA modelled
    as a product and a sum);
    at the end the quad sums l_t and o_t, and (m', l a + l, o a + o) is
    written once, a = exp(m - m').  Returns new (m, l, o)."""
    (B, Cq, H, hd), Ck = q.shape, k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    m, l, o = m.clone(), l.clone(), o.clone()
    for q0 in range(0, Cq, TILE):
        nq = min(TILE, Cq - q0)
        m_old = m[:, :, q0:q0 + nq].clone()
        tiles = range(0, Ck, TILE)
        if not bool(_degenerate_up_front(m_old, q0, q_off, k_off,
                                         causal).any()):
            tiles = [k0 for k0 in tiles
                     if not _all_masked(q_off, q0, Cq, k_off, k0, causal)]
        m_run = m_old.clone()
        l_t = torch.zeros(B, H, nq, 4)
        o_t = torch.zeros(B, H, nq, 4, hd)
        for k0 in tiles:
            nk = min(TILE, Ck - k0)
            s = _padded(_tile_scores(qf, kf, q0, k0, nq, nk, q_off, k_off,
                                     causal, scale, q.dtype), TILE)
            vt = torch.zeros(B, TILE, H, hd)
            vt[:, :nk] = vf[:, k0:k0 + nk]
            m_t = torch.maximum(m_run, s.amax(-1))
            corr = torch.exp(m_run - m_t)
            m_run = m_t
            l_t = l_t * corr[..., None]
            o_t = o_t * corr[..., None, None]
            p = torch.exp(s - m_t[..., None])
            tile_sum = torch.zeros(B, H, nq, 4)
            part = torch.zeros_like(o_t)
            for i in range(16):
                cols = [QUAD_COLS[t][i] for t in range(4)]
                pc = p[..., cols]                        # [B, H, nq, 4]
                tile_sum = tile_sum + pc
                part = part + pc[..., None] * vt[:, cols].permute(
                    0, 2, 1, 3)[:, :, None]
            l_t = l_t + tile_sum
            o_t = o_t + part
        alpha = torch.exp(m_old - m_run)
        l[:, :, q0:q0 + nq] = l[:, :, q0:q0 + nq] * alpha + _quad_sum(l_t)
        o[:, :, q0:q0 + nq] = o[:, :, q0:q0 + nq] * alpha[..., None] + \
            _quad_sum(o_t)
        m[:, :, q0:q0 + nq] = m_run
    return m, l, o


def _unseen_degenerate(lse, q_off, k_off, causal):
    """The dk/dv kernel's flag: a row that sees no key of the block
    (causal, q_off + row < k_off) has a degenerate lse.  Only those rows
    are read."""
    unseen = max(0, min(lse.shape[-1], k_off - q_off)) if causal else 0
    return _degenerate(lse[..., :unseen]) if unseen else False


def dkdv_model_hd8(q, k, v, do, lse, delta, q_off, k_off, causal, scale,
                   dk=None, dv=None):
    """ring_fold_dkdv_hd8_kernel in its order of work: per 64-key tile,
    over the query tiles it visits (every tile if a row that sees no key
    of the block has a degenerate lse, else those not wholly before the
    key tile), S^T and dP^T as 8-term f32 sums (the products of bf16
    values exact), P^T = exp(S^T - lse), dS^T = bf16(P^T (dP^T - D)
    scale); dk's f32 sum of dS^T . Q per 16-query chunk (the tensor
    cores' m16n8k16), dv per thread of a key's quad over its query
    columns in order (each FMA a product and a sum), each query tile's
    part summed apart and then added, the quad's partials summed at the
    end; then the carried dk, dv plus the block's, once.
    Returns (dk, dv)."""
    (B, Cq, H, hd), Ck = q.shape, k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dk = torch.zeros(B, H, Ck, hd) if dk is None else dk.clone()
    dv = torch.zeros(B, H, Ck, hd) if dv is None else dv.clone()
    degen = _unseen_degenerate(lse, q_off, k_off, causal)
    for k0 in range(0, Ck, TILE):
        nk = min(TILE, Ck - k0)
        acc_k = torch.zeros(B, H, nk, hd)
        dv_t = torch.zeros(B, H, nk, 4, hd)
        for q0 in range(0, Cq, TILE):
            if _all_masked(q_off, q0, Cq, k_off, k0, causal) and not degen:
                continue
            nq = min(TILE, Cq - q0)
            p, ds = _tile_p_ds(qf, kf, vf, dof, lse, delta, q0, k0, nq, nk,
                               q_off, k_off, causal, scale, q.dtype)
            pt = torch.zeros(B, H, TILE, nk)           # rows past Cq: p = 0
            pt[:, :, :nq] = p
            qt = torch.zeros(B, TILE, H, hd)
            qt[:, :nq] = qf[:, q0:q0 + nq]
            dot = torch.zeros(B, TILE, H, hd)
            dot[:, :nq] = dof[:, q0:q0 + nq]
            for c0 in range(0, nq, 16):
                acc_k = acc_k + torch.einsum(
                    "bhcd,bchk->bhdk", ds[:, :, c0:c0 + 16],
                    qf[:, q0 + c0:q0 + min(c0 + 16, nq)])
            part = torch.zeros_like(dv_t)
            for i in range(16):
                cols = [QUAD_COLS[t][i] for t in range(4)]
                pc = pt[:, :, cols].transpose(2, 3)       # [B, H, nk, 4]
                part = part + pc[..., None] * dot[:, cols].permute(
                    0, 2, 1, 3)[:, :, None]
            dv_t = dv_t + part
        dk[:, :, k0:k0 + nk] = dk[:, :, k0:k0 + nk] + acc_k
        dv[:, :, k0:k0 + nk] = dv[:, :, k0:k0 + nk] + _quad_sum(dv_t)
    return dk, dv


def dq_model_hd8(q, k, v, do, lse, delta, q_off, k_off, causal, scale,
                 dq=None, skip_always=False):
    """ring_fold_dq_hd8_kernel in its order of work: per 64-row query
    tile, over the key tiles it visits (every tile if a row of the query
    tile has a degenerate lse, else those not wholly masked; with
    ``skip_always`` never every tile), S and dP as 8-term f32 sums (the
    products of bf16 values exact), P = exp(S - lse), dS = bf16(P (dP -
    D) scale); dq's f32 sum of dS . K per 16-key chunk (the tensor cores'
    m16n8k16), over the chunks in key order; then the carried dq plus the
    block's, once.  Returns dq."""
    (B, Cq, H, hd), Ck = q.shape, k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.zeros(B, H, Cq, hd) if dq is None else dq.clone()
    for q0 in range(0, Cq, TILE):
        nq = min(TILE, Cq - q0)
        tiles = range(0, Ck, TILE)
        if skip_always or not _degenerate(lse[:, :, q0:q0 + nq]):
            tiles = [k0 for k0 in tiles
                     if not _all_masked(q_off, q0, Cq, k_off, k0, causal)]
        acc = torch.zeros(B, H, nq, hd)
        for k0 in tiles:
            nk = min(TILE, Ck - k0)
            _, ds = _tile_p_ds(qf, kf, vf, dof, lse, delta, q0, k0, nq, nk,
                               q_off, k_off, causal, scale, q.dtype)
            for c0 in range(0, nk, 16):
                acc = acc + torch.einsum(
                    "bhcd,bdhk->bhck", ds[..., c0:c0 + 16],
                    kf[:, k0 + c0:k0 + min(c0 + 16, nk)])
        dq[:, :, q0:q0 + nq] = dq[:, :, q0:q0 + nq] + acc
    return dq


def _oct_sum(x):
    """The sum of 8 owners' partials x[..., cb, :] (cb on dim 3), as three
    xor-shuffles add them: ((x0 + x1) + (x2 + x3)) + ((x4 + x5) +
    (x6 + x7))."""
    pairs = [x[:, :, :, i] + x[:, :, :, i + 1] for i in range(0, 8, 2)]
    return (pairs[0] + pairs[1]) + (pairs[2] + pairs[3])


def dkdv_model_f32_hd8(q, k, v, do, lse, delta, q_off, k_off, causal,
                       scale, dk=None, dv=None):
    """ring_fold_dkdv_f32_hd8_kernel in its order of work: per 64-key
    tile, over the query tiles it visits (as dkdv_model_hd8: every tile
    if a row that sees no key of the block has a degenerate lse, else
    those not wholly before the key tile), P^T and dS^T in f32 (nothing
    rounded); each of a key row's 8 owners cb (query columns cb + 8 j of
    every tile) sums dS^T q and P^T dO over its queries in order straight
    into its accumulators (each FMA a product and a sum), the owners'
    sums added as three xor-shuffles add them, once; then the carried
    dk, dv plus the block's.  Returns (dk, dv)."""
    (B, Cq, H, hd), Ck = q.shape, k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dk = torch.zeros(B, H, Ck, hd) if dk is None else dk.clone()
    dv = torch.zeros(B, H, Ck, hd) if dv is None else dv.clone()
    degen = _unseen_degenerate(lse, q_off, k_off, causal)
    for k0 in range(0, Ck, TILE):
        nk = min(TILE, Ck - k0)
        acc = [torch.zeros(B, H, nk, 8, hd) for _ in range(2)]
        for q0 in range(0, Cq, TILE):
            if _all_masked(q_off, q0, Cq, k_off, k0, causal) and not degen:
                continue
            nq = min(TILE, Cq - q0)
            p, ds = _tile_p_ds(qf, kf, vf, dof, lse, delta, q0, k0, nq, nk,
                               q_off, k_off, causal, scale, q.dtype)
            w = [torch.zeros(B, H, TILE, nk) for _ in range(2)]
            rows = [torch.zeros(B, TILE, H, hd) for _ in range(2)]
            for x, y, src in zip(w, rows, ((ds, qf), (p, dof))):
                x[:, :, :nq] = src[0]        # rows past Cq: P = dS = 0
                y[:, :nq] = src[1][:, q0:q0 + nq]
            for j in range(8):
                cols = [cb + 8 * j for cb in range(8)]
                for a, x, y in zip(acc, w, rows):
                    a += x[:, :, cols].transpose(2, 3)[..., None] * \
                        y[:, cols].permute(0, 2, 1, 3)[:, :, None]
        dk[:, :, k0:k0 + nk] = dk[:, :, k0:k0 + nk] + _oct_sum(acc[0])
        dv[:, :, k0:k0 + nk] = dv[:, :, k0:k0 + nk] + _oct_sum(acc[1])
    return dk, dv


def _two_sum(a, b):
    """(s, e): s = a + b rounded, e its rounding error, exactly (TwoSum,
    each op rounded once in f32)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _oct_sum_compensated(hi, lo):
    """The sum of 8 owners' hi + lo (owners on dim 3) as the kernel's
    sum8_compensated adds them: a tree of TwoSums, each level's rounding
    error added to the carried lo, then hi + lo."""
    his = [hi[:, :, :, i] for i in range(8)]
    los = [lo[:, :, :, i] for i in range(8)]
    while len(his) > 1:
        pairs = [(_two_sum(his[i], his[i + 1]), los[i] + los[i + 1])
                 for i in range(0, len(his), 2)]
        his = [s for (s, _), _ in pairs]
        los = [c + e for (_, e), c in pairs]
    return his[0] + los[0]


def fold_model_f32_hd8(q, k, v, m, l, o, q_off, k_off, causal, scale,
                       skip_always=False):
    """ring_fold_fwd_f32_hd8_kernel in its order of work: per 64-row query
    tile the skip rule decided up front (every key tile if a row of the
    tile has a degenerate m and sees no key of the block, else those not
    wholly masked; with ``skip_always`` never every tile), then one pass
    over the visited key tiles: m_t = max(m_run, tile row max) from m_run
    = m, c = exp(m_run - m_t), and per owner cb of a row (keys cb + 8 j
    of each tile, j < 8) l_own + l_err = (l_own c + l_err c) + (its 8 p
    summed in j order), a TwoSum carrying each add's rounding error in
    l_err, and acc = acc c + (its p . v summed apart in j order from 0;
    each FMA modelled as a product and a sum); at the end the 8 owners'
    acc added
    as three xor-shuffles add them and their l_own + l_err by a tree of
    TwoSums, and (m', l a + l_acc, o a + acc) written once, a = exp(m -
    m').  Its dq (ring_fold_dq_f32_hd8_kernel) keeps the SIMT kernel's
    order, which bwd_model models.  Returns new (m, l, o)."""
    (B, Cq, H, hd), Ck = q.shape, k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    m, l, o = m.clone(), l.clone(), o.clone()
    for q0 in range(0, Cq, TILE):
        nq = min(TILE, Cq - q0)
        m_old = m[:, :, q0:q0 + nq].clone()
        tiles = range(0, Ck, TILE)
        if skip_always or not bool(_degenerate_up_front(
                m_old, q0, q_off, k_off, causal).any()):
            tiles = [k0 for k0 in tiles
                     if not _all_masked(q_off, q0, Cq, k_off, k0, causal)]
        m_run = m_old.clone()
        l_own = torch.zeros(B, H, nq, 8)
        l_err = torch.zeros(B, H, nq, 8)
        acc = torch.zeros(B, H, nq, 8, hd)
        for k0 in tiles:
            nk = min(TILE, Ck - k0)
            s = _padded(_tile_scores(qf, kf, q0, k0, nq, nk, q_off, k_off,
                                     causal, scale, q.dtype), TILE)
            vt = torch.zeros(B, TILE, H, hd)
            vt[:, :nk] = vf[:, k0:k0 + nk]
            m_t = torch.maximum(m_run, s.amax(-1))
            corr = torch.exp(m_run - m_t)
            m_run = m_t
            p = torch.exp(s - m_t[..., None])
            tile_sum = torch.zeros(B, H, nq, 8)
            for j in range(8):
                tile_sum = tile_sum + p[..., 8 * j:8 * j + 8]
            l_own, e = _two_sum(l_own * corr[..., None], tile_sum)
            l_err = l_err * corr[..., None] + e
            part = torch.zeros_like(acc)
            for j in range(8):
                cols = slice(8 * j, 8 * j + 8)      # keys cb + 8 j
                part = part + p[..., cols, None] * vt[:, cols].permute(
                    0, 2, 1, 3)[:, :, None]
            acc = acc * corr[..., None, None] + part
        alpha = torch.exp(m_old - m_run)
        l[:, :, q0:q0 + nq] = l[:, :, q0:q0 + nq] * alpha + \
            _oct_sum_compensated(l_own, l_err)
        o[:, :, q0:q0 + nq] = o[:, :, q0:q0 + nq] * alpha[..., None] + \
            _oct_sum(acc)
        m[:, :, q0:q0 + nq] = m_run
    return m, l, o


@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal",
                         BLOCKS + [(200, 130, 0, 100, True)])
def test_hd8_bf16_models_match_plain(Cq, Ck, q_off, k_off, causal):
    """The hd-8 bf16 forward's and dk/dv's orders of work against the
    plain version on the small blocks (a state from an earlier fold, a
    block whose first rows see no key), within the bf16 rule, and dk, dv
    added into carried ones."""
    q, k, v, do, m, l, o = _block(73, 1, Cq, Ck, 2, 8, torch.bfloat16)
    scale = 8 ** -0.5
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                      causal, scale)
    got = list(fold_model_hd8(q, k, v, m, l, o, q_off, k_off, causal,
                              scale))
    got += dkdv_model_hd8(q, k, v, do, lse, delta, q_off, k_off, causal,
                          scale)
    _close(got, want[:3] + want[4:], torch.bfloat16)
    carried = [torch.from_numpy(a) for a in _draw(75, *[(1, 2, Ck, 8)] * 2)]
    more = [t.clone() for t in carried]
    ring_fold_bwd_dkdv_plain(q, k, v, do, lse, delta, *more, q_off, k_off,
                             causal, scale)
    _close(dkdv_model_hd8(q, k, v, do, lse, delta, q_off, k_off, causal,
                          scale, *carried), more, torch.bfloat16)


@pytest.mark.parametrize("fresh", [False, True], ids=["carried", "fresh"])
@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal",
                         BLOCKS + [(200, 130, 0, 100, True)])
def test_hd8_dkdv_degenerate_rule_reads_only_unseen_rows(Cq, Ck, q_off,
                                                         k_off, causal,
                                                         fresh):
    """The hd-8 dk/dv kernel reads the lse of only the rows that see no
    key of the block for its skip rule; on the lse of a fold of the block
    (from an earlier state or a fresh one) that decides as the SIMT
    kernel's scan of the whole row, and it is true exactly on a fresh
    state whose first rows see no key."""
    q, k, v, do, m, l, o = _block(77, 2, Cq, Ck, 2, 8, torch.bfloat16)
    if fresh:
        m, l, o = _fresh(m, l, o)
    _, (lse, _) = _plain_block(q, k, v, do, m, l, o, q_off, k_off, causal,
                               8 ** -0.5)
    rule = _unseen_degenerate(lse, q_off, k_off, causal)
    assert rule == _degenerate(lse)
    assert rule == (fresh and causal and q_off < k_off)


def _c1024_hd8(case, seed):
    """A C = 1024 block at hd 8 in bf16, as _c1024_case."""
    C = 1024
    q, k, v, do, m, l, o = _block(seed, 1, C, C, 2, 8, torch.bfloat16)
    q_off, k_off = {"fresh": (0, 0), "carried": (C, C),
                    "off_diagonal": (C, 0)}[case]
    if case != "off_diagonal":
        m, l, o = _fresh(m, l, o)
    if case == "carried":
        k0, v0 = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _draw(seed + 2, *[(1, C, 2, 8)] * 2))
        ring_fold_plain(q, k0, v0, m, l, o, C, 0, True, 8 ** -0.5)
    return q, k, v, do, (m, l, o), q_off, k_off


def _jnp_bf16(t):
    import jax.numpy as jnp
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("case", ["fresh", "carried", "off_diagonal"])
def test_hd8_bf16_models_hold_plain_jnp_and_jax_grad_over_1024(case):
    """At C = 1024 (16 tiles, so the running max rises past the first
    tile in many rows), hd 8, bf16: the forward's model against the plain
    fold and the reference's jnp fold in bf16, and the dk/dv model (from
    the plain fold's lse and D) against the plain version and jax.vjp of
    the reference's fold in bf16, normalised, all within the bf16 rule."""
    import jax
    import jax.numpy as jnp
    q, k, v, do, state, q_off, k_off = _c1024_hd8(case, 79)
    scale = 8 ** -0.5
    want, (lse, delta) = _plain_block(q, k, v, do, *state, q_off, k_off,
                                      True, scale)
    got = fold_model_hd8(q, k, v, *state, q_off, k_off, True, scale)
    _close(got, want[:3], torch.bfloat16)
    jnp_fold = _jnp_fold(*(_jnp_bf16(t) for t in (q, k, v)),
                         *(jnp.array(t.numpy()) for t in state),
                         q_off, k_off, True, scale)
    _close(got, [torch.from_numpy(np.array(w)) for w in jnp_fold],
           torch.bfloat16)
    dkdv = dkdv_model_hd8(q, k, v, do, lse, delta, q_off, k_off, True,
                          scale)
    _close(dkdv, want[4:], torch.bfloat16)

    def out(q, k, v):
        _, l2, o2 = _jnp_fold(q, k, v,
                              *(jnp.array(t.numpy()) for t in state),
                              q_off, k_off, True, scale)
        return o2 / l2[..., None]
    _, pull = jax.vjp(out, *(_jnp_bf16(t) for t in (q, k, v)))
    grads = pull(jnp.asarray(do.float().numpy().transpose(0, 2, 1, 3)))
    _close(dkdv, [torch.from_numpy(np.array(
        g.astype(jnp.float32)).transpose(0, 2, 1, 3)) for g in grads[1:]],
        torch.bfloat16)


@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal,fresh",
                         [(256, 256, 256, 256, True, True),
                          (130, 130, 260, 0, True, False),
                          (128, 128, 0, 64, True, True),
                          (200, 70, 0, 0, False, False)])
def test_hd8_models_on_exact_scores_hold_the_f32_products(Cq, Ck, q_off,
                                                          k_off, causal,
                                                          fresh):
    """With q, k in {-1, 0, 1} every score is the same bits in the models
    and the plain version, so m, l, o and dv (p's f32 products as f32
    FMAs, summed per thread and then over the quad) hold the plain
    version within EXACT_TOL."""
    q, k, v, do, m, l, o = _block(81, 2, Cq, Ck, 2, 8, torch.bfloat16)
    rng = np.random.default_rng(83)
    q, k = (torch.from_numpy(rng.integers(-1, 2, t.shape).astype(
        np.float32)).to(torch.bfloat16) for t in (q, k))
    if fresh:
        m, l, o = _fresh(m, l, o)
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                      causal, 0.125)
    got = list(fold_model_hd8(q, k, v, m, l, o, q_off, k_off, causal,
                              0.125))
    got.append(dkdv_model_hd8(q, k, v, do, lse, delta, q_off, k_off, causal,
                              0.125)[1])
    for g, w in zip(got, want[:3] + [want[5]]):
        torch.testing.assert_close(g, w, **EXACT_TOL)


def _exact_f64(q, k, v, do, state, lse, q_off, k_off, causal, scale):
    """[m, l, o, dv] of one block with every sum in f64, from the bf16
    scores scaled in f32 (the kernels' and the plain version's bits),
    the f32 state, and dv from the given lse."""
    s = scores_plain(q, k, q_off, k_off, causal, scale).double()
    m, l, o = (t.double() for t in state)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    big_p = torch.exp(s - lse.double()[..., None])
    return [m_new, l * alpha + p.sum(-1),
            o * alpha[..., None] + torch.einsum("bhcd,bdhk->bhck", p,
                                                v.double()),
            torch.einsum("bhcd,bchk->bhdk", big_p, do.double())]


def test_hd8_models_on_exact_scores_over_1024_keys_hold_f64():
    """Over 1024 keys at hd 8 the plain version's own sums of f32
    products are no nearer the fold in f64 than the kernels' order, so
    there the hd-8 orders of work are held to the fold in f64 instead,
    within EXACT_TOL: m, l, o and dv (from the plain fold's lse); p
    rounded once to bf16 (the control) leaves it."""
    q, k, v, do, m, l, o = _block(85, 2, 1024, 1024, 4, 8, torch.bfloat16)
    rng = np.random.default_rng(87)
    q, k = (torch.from_numpy(rng.integers(-1, 2, t.shape).astype(
        np.float32)).to(torch.bfloat16) for t in (q, k))
    state = _fresh(m, l, o)
    scale = 8 ** -0.5
    want, (lse, delta) = _plain_block(q, k, v, do, *state, 0, 0, True,
                                      scale)
    exact = _exact_f64(q, k, v, do, state, lse, 0, 0, True, scale)
    got = list(fold_model_hd8(q, k, v, *state, 0, 0, True, scale))
    got.append(dkdv_model_hd8(q, k, v, do, lse, delta, 0, 0, True,
                              scale)[1])
    for g, w in zip(got, exact):
        torch.testing.assert_close(g.double(), w, **EXACT_TOL)
    s = scores_plain(q, k, 0, 0, True, scale)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    control = torch.einsum("bhcd,bdhk->bhck",
                           p.to(torch.bfloat16).float(), v.float())
    with pytest.raises(AssertionError):
        torch.testing.assert_close(control.double(), exact[2], **EXACT_TOL)


@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal",
                         BLOCKS + [(200, 130, 0, 100, True)])
def test_hd8_bf16_dq_model_matches_plain(Cq, Ck, q_off, k_off, causal):
    """The hd-8 bf16 dq's order of work against the plain version on the
    small blocks (a state from an earlier fold, a block whose first rows
    see no key), within the bf16 rule, from zeros and added into a
    carried dq."""
    q, k, v, do, m, l, o = _block(91, 1, Cq, Ck, 2, 8, torch.bfloat16)
    scale = 8 ** -0.5
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                      causal, scale)
    got = dq_model_hd8(q, k, v, do, lse, delta, q_off, k_off, causal, scale)
    _close([got], want[3:4], torch.bfloat16)
    carried = torch.from_numpy(_draw(93, (1, 2, Cq, 8))[0])
    more = carried.clone()
    ring_fold_bwd_dq_plain(q, k, v, do, lse, delta, more, q_off, k_off,
                           causal, scale)
    got = dq_model_hd8(q, k, v, do, lse, delta, q_off, k_off, causal, scale,
                       dq=carried)
    assert not torch.equal(got, carried)
    _close([got], [more], torch.bfloat16)


@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal",
                         BLOCKS + [(200, 130, 0, 100, True)])
def test_hd8_f32_dkdv_model_matches_plain(Cq, Ck, q_off, k_off, causal):
    """The hd-8 f32 dk/dv's order of work (per-owner sums, a tree of 8)
    against the plain version on the small blocks within CARD_TOL, from
    zeros and added into carried dk, dv."""
    q, k, v, do, m, l, o = _block(95, 1, Cq, Ck, 2, 8, torch.float32)
    scale = 8 ** -0.5
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                      causal, scale)
    got = dkdv_model_f32_hd8(q, k, v, do, lse, delta, q_off, k_off, causal,
                             scale)
    _close(got, want[4:], torch.float32)
    carried = [torch.from_numpy(a) for a in _draw(97, *[(1, 2, Ck, 8)] * 2)]
    more = [t.clone() for t in carried]
    ring_fold_bwd_dkdv_plain(q, k, v, do, lse, delta, *more, q_off, k_off,
                             causal, scale)
    got = dkdv_model_f32_hd8(q, k, v, do, lse, delta, q_off, k_off, causal,
                             scale, *carried)
    assert not any(torch.equal(g, c) for g, c in zip(got, carried))
    _close(got, more, torch.float32)


def test_hd8_dq_model_skipping_every_masked_tile_fails_a_fresh_block():
    """Rows 0..63 at q_off 0 see no key at k_off 64: from a fresh state
    their lse is about -1e30 and the reference weighs their masked
    scores by exp(0) = 1, so the dq kernel's rule visits every key tile
    there; skipping the masked tiles regardless leaves the plain dq."""
    q, k, v, do, m, l, o = _block(99, 1, 128, 128, 2, 8, torch.bfloat16)
    want, (lse, delta) = _plain_block(q, k, v, do, *_fresh(m, l, o), 0, 64,
                                      True, 8 ** -0.5)
    assert _degenerate(lse[:, :, :64])
    args = (q, k, v, do, lse, delta, 0, 64, True, 8 ** -0.5)
    _close([dq_model_hd8(*args)], want[3:4], torch.bfloat16)
    with pytest.raises(AssertionError):
        _close([dq_model_hd8(*args, skip_always=True)], want[3:4],
               torch.bfloat16)


@pytest.mark.parametrize("case", ["fresh", "carried", "off_diagonal"])
def test_hd8_bf16_dq_model_holds_plain_and_jax_grad_over_1024(case):
    """At C = 1024, hd 8, bf16: the dq model (from the plain fold's lse
    and D) against the plain version and jax.vjp of the reference's fold
    in bf16, normalised, within the bf16 rule."""
    import jax
    import jax.numpy as jnp
    q, k, v, do, state, q_off, k_off = _c1024_hd8(case, 101)
    scale = 8 ** -0.5
    want, (lse, delta) = _plain_block(q, k, v, do, *state, q_off, k_off,
                                      True, scale)
    got = dq_model_hd8(q, k, v, do, lse, delta, q_off, k_off, True, scale)
    _close([got], want[3:4], torch.bfloat16)

    def out(q, k, v):
        _, l2, o2 = _jnp_fold(q, k, v,
                              *(jnp.array(t.numpy()) for t in state),
                              q_off, k_off, True, scale)
        return o2 / l2[..., None]
    _, pull = jax.vjp(out, *(_jnp_bf16(t) for t in (q, k, v)))
    dq = pull(jnp.asarray(do.float().numpy().transpose(0, 2, 1, 3)))[0]
    _close([got], [torch.from_numpy(np.array(
        dq.astype(jnp.float32)).transpose(0, 2, 1, 3))], torch.bfloat16)


@pytest.mark.parametrize("case", ["fresh", "carried", "off_diagonal"])
def test_hd8_f32_dkdv_model_holds_plain_and_jax_grad_over_1024(case):
    """At C = 1024, hd 8, f32: the dk/dv model (from the plain fold's lse
    and D) within CARD_TOL of ring_fold_bwd_dkdv_plain and of jax.vjp of
    the reference's fold, normalised."""
    q, k, v, do, state, q_off, k_off = _c1024_case(case, 103, hd=8)
    scale = 8 ** -0.5
    want, (lse, delta) = _plain_block(q, k, v, do, *state, q_off, k_off,
                                      True, scale)
    got = dkdv_model_f32_hd8(q, k, v, do, lse, delta, q_off, k_off, True,
                             scale)
    _close(got, want[4:], torch.float32)
    _close(got, _jnp_fold_grads(q, k, v, do, *state, q_off, k_off, True,
                                scale)[1:], torch.float32)


@pytest.mark.parametrize("wide", [False, True], ids=["unit", "wide"])
@pytest.mark.parametrize("C", [1000, 1024])
def test_hd8_f32_dkdv_model_is_as_exact_as_plain_against_f64(C, wide):
    """The hd-8 f32 dk/dv's order (a ring's first, diagonal block, from
    the plain f32 fold's lse and D) against the fold and backward in f64
    throughout, at unit scale and at a wide range (q, k x 2, v x 8): its
    largest error at most WIDE_ERR_RATIO times the plain version's, as
    the card leg holds the kernel."""
    q, k, v, do, m, l, o = _wide_block(105, 1, C, 2, 8, wide)
    scale = 8 ** -0.5
    plain, (lse, delta) = _plain_block(q, k, v, do, m, l, o, 0, 0, True,
                                       scale)
    got = dkdv_model_f32_hd8(q, k, v, do, lse, delta, 0, 0, True, scale)
    exact = _f64_bwd(q, k, v, do, m, l, o, 0, 0, True, scale)[1:]
    for name, g, p, e in zip(("dk", "dv"), got, plain[4:], exact):
        err = float((g.double() - e).abs().max())
        plain_err = float((p.double() - e).abs().max())
        assert err <= WIDE_ERR_RATIO * plain_err, (name, err, plain_err)


@pytest.mark.parametrize("fresh", [False, True], ids=["carried", "fresh"])
@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal",
                         BLOCKS + [(200, 130, 0, 100, True)])
def test_hd8_f32_fold_and_dq_models_match_plain(Cq, Ck, q_off, k_off,
                                                causal, fresh):
    """The hd-8 f32 forward's order of work (one pass, 8 owners a row, a
    tree of 8) against the plain fold, from a state of an earlier fold and
    from a fresh one (a block whose first rows see no key weighs their
    masked scores by 1), and the hd-8 f32 dq's (bwd_model: the SIMT
    kernel's order) against the plain dq from zeros and into a carried
    dq, within CARD_TOL."""
    q, k, v, do, m, l, o = _block(123, 1, Cq, Ck, 2, 8, torch.float32)
    if fresh:
        m, l, o = _fresh(m, l, o)
    scale = 8 ** -0.5
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                      causal, scale)
    got = list(fold_model_f32_hd8(q, k, v, m, l, o, q_off, k_off, causal,
                                  scale))
    got.append(bwd_model(q, k, v, do, lse, delta, q_off, k_off, causal,
                         scale)[0])
    _close(got, want[:4], torch.float32)
    carried = torch.from_numpy(_draw(125, (1, 2, Cq, 8))[0])
    more = carried.clone()
    ring_fold_bwd_dq_plain(q, k, v, do, lse, delta, more, q_off, k_off,
                           causal, scale)
    got = bwd_model(q, k, v, do, lse, delta, q_off, k_off, causal, scale,
                    dq=carried)[0]
    assert not torch.equal(got, carried)
    _close([got], [more], torch.float32)


@pytest.mark.parametrize("case", ["fresh", "carried", "off_diagonal"])
def test_hd8_f32_models_hold_plain_jnp_and_jax_grad_over_1024(case):
    """At C = 1024 (16 key tiles, so the running max rises past the first
    tile in many rows), hd 8, f32, within CARD_TOL: the forward's order
    against the reference's jnp fold and the fold in f64 (m, l, o), and
    the plain fold (m, l, and the output as attention reads it, o / l:
    the plain version's own unnormalised o lies near CARD_TOL from the
    f64 fold here, several times farther than the model's); the dq's
    order (from the plain fold's lse and D) against the plain dq and
    jax.vjp of the reference's fold, normalised."""
    import jax.numpy as jnp
    q, k, v, do, state, q_off, k_off = _c1024_case(case, 127, hd=8)
    scale = 8 ** -0.5
    want, (lse, delta) = _plain_block(q, k, v, do, *state, q_off, k_off,
                                      True, scale)
    got = fold_model_f32_hd8(q, k, v, *state, q_off, k_off, True, scale)
    jnp_fold = _jnp_fold(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                         *(jnp.array(t.numpy()) for t in state),
                         q_off, k_off, True, scale)
    _close(got, [torch.from_numpy(np.array(w)) for w in jnp_fold],
           torch.float32)
    _close(got, _f64_fold(q, k, v, *state, q_off, k_off, True, scale),
           torch.float32)
    _close([*got[:2], got[2] / got[1][..., None]],
           [*want[:2], want[2] / want[1][..., None]], torch.float32)
    assert not torch.equal(got[2], want[2])    # another order of sums
    dq = bwd_model(q, k, v, do, lse, delta, q_off, k_off, True, scale)[0]
    _close([dq], want[3:4], torch.float32)
    _close([dq], _jnp_fold_grads(q, k, v, do, *state, q_off, k_off, True,
                                 scale)[:1], torch.float32)


@pytest.mark.parametrize("wide", [False, True], ids=["unit", "wide"])
@pytest.mark.parametrize("C", [1000, 1024])
def test_hd8_f32_fold_model_is_as_exact_as_plain_against_f64(C, wide):
    """The hd-8 f32 forward's order (a ring's first, diagonal block from a
    fresh state, and the same block on a carried state) against the fold
    in f64 throughout, at unit scale and at a wide range (q, k x 2, v x
    8): its largest error in m, l and o at most WIDE_ERR_RATIO times the
    plain version's, as the card leg holds the kernel."""
    q, k, v, _, m, l, o = _wide_block(129, 1, C, 2, 8, wide)
    scale = 8 ** -0.5
    carried = _block(131, 1, C, C, 2, 8, torch.float32)[4:]
    for state in ((m, l, o), carried):
        got = fold_model_f32_hd8(q, k, v, *state, 0, 0, True, scale)
        plain = [t.clone() for t in state]
        ring_fold_plain(q, k, v, *plain, 0, 0, True, scale)
        exact = _f64_fold(q, k, v, *state, 0, 0, True, scale)
        for name, g, p, e in zip("mlo", got, plain, exact):
            err = float((g.double() - e).abs().max())
            plain_err = float((p.double() - e).abs().max())
            assert err <= WIDE_ERR_RATIO * plain_err, (name, err, plain_err)


def test_hd8_f32_fold_model_on_exact_scores_over_1024_keys_holds_f64():
    """With q and k in {-1, 0, 1} every score is the same bits in the
    model and the plain version.  Over 1024 keys the hd-8 f32 forward's
    order (each tile's p . v summed apart, the row sum compensated) holds
    m, l and o within EXACT_TOL of the same sums in f64, as the card's
    exact-score case holds the kernel (the plain version's own f32 sums
    are no nearer them); p rounded once to bf16 (the control) leaves
    it."""
    q, k, v, do, m, l, o = _block(85, 2, 1024, 1024, 8, 8, torch.float32)
    rng = np.random.default_rng(87)
    q, k = (torch.from_numpy(rng.integers(-1, 2, t.shape).astype(
        np.float32)) for t in (q, k))
    state = _fresh(m, l, o)
    scale = 8 ** -0.5
    _, (lse, _) = _plain_block(q, k, v, do, *state, 0, 0, True, scale)
    exact = _exact_f64(q, k, v, do, state, lse, 0, 0, True, scale)[:3]
    got = fold_model_f32_hd8(q, k, v, *state, 0, 0, True, scale)
    for g, w in zip(got, exact):
        torch.testing.assert_close(g.double(), w, **EXACT_TOL)
    s = scores_plain(q, k, 0, 0, True, scale)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    control = torch.einsum("bhcd,bdhk->bhck", p.to(torch.bfloat16).float(),
                           v)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(control.double(), exact[2], **EXACT_TOL)


def test_hd8_f32_fold_model_skipping_every_masked_tile_fails_a_fresh_block():
    """Rows 0..63 at q_off 0 see no key at k_off 64: from m = -1e30 the
    reference weighs their masked scores by exp(0) = 1, so the hd-8 f32
    forward's up-front rule visits every key tile there; skipping the
    masked tiles regardless leaves the plain fold."""
    q, k, v, _, m, l, o = _block(133, 1, 128, 128, 2, 8, torch.float32)
    state = _fresh(m, l, o)
    want = [t.clone() for t in state]
    ring_fold_plain(q, k, v, *want, 0, 64, True, 8 ** -0.5)
    assert float(want[1][:, :, :64].min()) == 128.0    # p = 1 on every key
    args = (q, k, v, *state, 0, 64, True, 8 ** -0.5)
    _close(fold_model_f32_hd8(*args), want, torch.float32)
    with pytest.raises(AssertionError):
        _close(fold_model_f32_hd8(*args, skip_always=True), want,
               torch.float32)


def _integer_block(seed, B, Cq, Ck, H, device="cpu"):
    """A bf16 block at hd 8 whose q, k, v and dO have entries in {-1, 0,
    1}, and a fresh state."""
    q, k, v, do, m, l, o = _block(seed, B, Cq, Ck, H, 8, torch.bfloat16,
                                  device)
    rng = np.random.default_rng(seed + 2)
    return [torch.from_numpy(rng.integers(-1, 2, t.shape).astype(
        np.float32)).to(device, torch.bfloat16) for t in (q, k, v, do)] + \
        list(_fresh(m, l, o))


def test_hd8_dq_model_on_integer_inputs_over_1024_keys_holds_f64():
    """With q, k, v and dO in {-1, 0, 1}, every score, dP and so every P
    and dS is the same bits in the model and the plain version; dq is
    then a sum of exact products, and the model's (per 16-key chunk, in
    key order) holds the same sum in f64 within EXACT_TOL over 1024
    keys, as the plain version's does; dS left unrounded (the control)
    leaves it."""
    q, k, v, do, m, l, o = _integer_block(107, 2, 1024, 1024, 2)
    scale = 8 ** -0.5
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, 0, 0, True,
                                      scale)
    from brpc_tpu_torch.ops.ring_fold import _p_ds
    p, ds = _p_ds(q, k, v, do, lse, delta, 0, 0, True, scale)
    exact = torch.einsum("bhcd,bdhk->bhck", ds.double(), k.double())
    got = dq_model_hd8(q, k, v, do, lse, delta, 0, 0, True, scale)
    for g in (got, want[3]):
        torch.testing.assert_close(g.double(), exact, **EXACT_TOL)
    dp = torch.einsum("bchk,bdhk->bhcd", do.float(), v.float())
    unrounded = p * (dp - delta[..., None]) * scale
    control = torch.einsum("bhcd,bdhk->bhck", unrounded.double(), k.double())
    with pytest.raises(AssertionError):
        torch.testing.assert_close(control, exact, **EXACT_TOL)


# ---------------------------------------------------------------------------
# the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc for the kernels")


CARD_BLOCKS = BLOCKS + [(1, 1, 0, 0, True), (1000, 1000, 1000, 0, True),
                        (256, 256, 512, 512, True), (256, 256, 768, 256,
                                                     False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal", CARD_BLOCKS)
def test_kernels_match_plain_on_the_card(Cq, Ck, q_off, k_off, causal, hd,
                                         dtype):
    """Every kernel against the plain version: in bf16 at hd 16, 64 and
    128 the tensor-core kernels of ring_fold_sm90.cu, at hd 8 those of
    ring_fold_hd8.cu; in f32 the CUDA-core kernels of ring_fold_f32.cu,
    at hd 8 those of ring_fold_f32_hd8.cu."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, m, l, o = _block(17, 2, Cq, Ck, 3, hd, dtype, "cuda")
    scale = 1.0 / math.sqrt(hd)
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                      causal, scale)
    before = [w.launches for w in (ring_fold_forward, ring_fold_backward_dq,
                                   ring_fold_backward_dkdv)]
    got = [t.clone() for t in (m, l, o)]
    ring_fold_forward(q, k, v, *got, q_off, k_off, causal, scale)
    B, _, H, _ = q.shape   # the backward from the plain fold's lse and D
    dq = torch.zeros(B, H, Cq, hd, device="cuda")
    dk = torch.zeros(B, H, Ck, hd, device="cuda")
    dv = torch.zeros_like(dk)
    ring_fold_backward_dq(q, k, v, do, lse, delta, dq, q_off, k_off, causal,
                          scale)
    ring_fold_backward_dkdv(q, k, v, do, lse, delta, dk, dv, q_off, k_off,
                            causal, scale)
    torch.cuda.synchronize()
    assert [w.launches for w in (ring_fold_forward, ring_fold_backward_dq,
                                 ring_fold_backward_dkdv)] == \
        [n + 1 for n in before]
    if dtype == torch.float32:
        # the f32 forward's order of sums is not the plain version's f32
        # GEMM's, and over 1000 keys that GEMM is itself up to 1.20x
        # CARD_TOL from the exact fold (causal_attention_ab.py on an
        # H100): the state is held to the fold in f64 instead, within the
        # same tolerance
        _close(got, _f64_fold(q, k, v, m, l, o, q_off, k_off, causal, scale),
               dtype)
        _close([dq, dk, dv], want[3:], dtype)
    else:
        _close(got + [dq, dk, dv], want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kernels_read_strided_inputs_and_repeat_their_bits(dtype):
    """q, k, v as views of one fused [B, C, 3, H, hd] projection and a
    transposed dO give the bits of contiguous copies, twice."""
    _strided_and_repeated(dtype, 64)


@pytest.mark.cuda
def test_hd8_kernels_read_strided_inputs_and_repeat_their_bits():
    """The same at hd 8 in bf16: the tensor-core forward, dq and dk/dv of
    ring_fold_hd8.cu."""
    _strided_and_repeated(torch.bfloat16, 8)


@pytest.mark.cuda
def test_hd8_f32_kernels_read_strided_inputs_and_repeat_their_bits():
    """The same at hd 8 in f32: the CUDA-core forward, dq and dk/dv of
    ring_fold_f32_hd8.cu (16-byte copies and loads of q, k, v and dO; the
    fused projection's strides are 16-byte multiples)."""
    _strided_and_repeated(torch.float32, 8)


def _strided_and_repeated(dtype, hd):
    _card()
    g = torch.Generator(device="cuda").manual_seed(19)
    B, C, H = 2, 200, 4
    qkv = torch.randn(B, C, 3, H, hd, generator=g, device="cuda").to(dtype)
    q, k, v = (qkv[:, :, i] for i in range(3))
    do = torch.randn(B, H, C, hd, generator=g,
                     device="cuda").to(dtype).transpose(1, 2)

    def run(q, k, v, do):
        m = torch.full((B, H, C), NEG, device="cuda")
        l = torch.zeros(B, H, C, device="cuda")
        o = torch.zeros(B, H, C, hd, device="cuda")
        ring_fold_forward(q, k, v, m, l, o, 200, 200, True, 0.125)
        lse, delta = _lse_delta(m, l, o, do)
        dq = torch.zeros_like(o)
        dk, dv = torch.zeros_like(o), torch.zeros_like(o)
        ring_fold_backward_dq(q, k, v, do, lse, delta, dq, 200, 200, True,
                              0.125)
        ring_fold_backward_dkdv(q, k, v, do, lse, delta, dk, dv, 200, 200,
                                True, 0.125)
        return [m, l, o, dq, dk, dv]

    strided = run(q, k, v, do)
    contiguous = run(*(t.contiguous() for t in (q, k, v, do)))
    again = run(q, k, v, do)
    torch.cuda.synchronize()
    for a, b, c in zip(strided, contiguous, again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_a_wholly_future_block_launches_nothing_on_the_card():
    _card()
    q, k, v, do, m, l, o = _block(21, 2, 256, 256, 2, 64, torch.bfloat16,
                                  "cuda")
    launches = ring_fold_forward.launches
    state = [t.clone() for t in (m, l, o)]
    assert not ring_fold_forward(q, k, v, *state, 256, 768, True, 0.125)
    torch.cuda.synchronize()
    assert ring_fold_forward.launches == launches
    assert all(torch.equal(a, b) for a, b in zip(state, (m, l, o)))


@pytest.mark.cuda
def test_no_fallback_a_head_dim_the_kernels_lack_raises():
    _card()
    q, k, v, do, m, l, o = _block(23, 1, 64, 64, 2, 32, torch.float32,
                                  "cuda")
    launches = ring_fold_forward.launches
    with pytest.raises(ValueError, match="head_dim"):
        ring_fold_forward(q, k, v, m, l, o, 0, 0, True, 0.2)
    with pytest.raises(ValueError, match="head_dim"):
        ring_fold_backward_dq(q, k, v, do, m, l, o, 0, 0, True, 0.2)
    assert ring_fold_forward.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_one_fold_attention_on_the_card_matches_plain_autograd(dtype,
                                                               causal):
    """RingAttention on one block (Ulysses' local attention) through the
    kernels against autograd of the plain `_dense_local` on the card."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = _draw(25, *[(2, 300, 4, 64)] * 4)

    def dense_plain(q, k, v):
        s = scores_plain(q, k, 0, 0, causal, 0.125)
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bhcd,bdhk->bchk", w, v.float()).to(q.dtype)

    def fold(q, k, v):
        return RingAttention.apply(q, k, v, None, "sp", causal, 0.125)

    got = _local_grads(fold, arrays, dtype, "cuda")
    want = _local_grads(dense_plain, arrays, dtype, "cuda")
    torch.cuda.synchronize()
    _close(got, want, dtype)


@pytest.mark.cuda
def test_tensor_core_kernels_copy_an_unaligned_view():
    """A bf16 k whose base is off 16 bytes (TMA's rule) is copied by the
    wrapper: the forward, dq and dk/dv give the bits of a contiguous k."""
    _unaligned_k_copied(64)


@pytest.mark.cuda
def test_hd8_kernels_copy_an_unaligned_view():
    """The same at hd 8, where the forward, dq and dk/dv copy a 16-byte
    row at a time with cp.async."""
    _unaligned_k_copied(8)


@pytest.mark.cuda
def test_hd8_f32_kernels_copy_an_unaligned_view():
    """The same at hd 8 in f32 (a k off by 4 bytes), where the forward
    and dq copy k's rows 16 bytes at a time and the dk/dv loads them so:
    the forward, dq and dk/dv give the bits of a contiguous k."""
    _unaligned_k_copied(8, torch.float32)


def _unaligned_k_copied(hd, dtype=torch.bfloat16):
    _card()
    q, k, v, do, m, l, o = _block(33, 2, 130, 130, 3, hd, dtype, "cuda")
    flat = torch.empty(k.numel() + 1, dtype=k.dtype, device="cuda")
    k_odd = flat[1:].view(k.shape)         # base off by one element
    k_odd.copy_(k)
    lse, delta = _lse_delta(m, l, o, do)
    outs = []
    for kk in (k_odd, k):
        state = [t.clone() for t in (m, l, o)]
        ring_fold_forward(q, kk, v, *state, 130, 130, True, 0.125)
        dq, dk, dv = (torch.zeros_like(o) for _ in range(3))
        ring_fold_backward_dq(q, kk, v, do, lse, delta, dq, 130, 130, True,
                              0.125)
        ring_fold_backward_dkdv(q, kk, v, do, lse, delta, dk, dv, 130, 130,
                                True, 0.125)
        outs.append(state + [dq, dk, dv])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_takes_the_tensor_cores_and_f32_and_hd8_the_simt_kernels():
    """The route, read from the device's kernel names under
    torch.profiler: bf16 at hd 16, 64 and 128 launches the tensor-core
    forward, dq and dk/dv; f32 there the CUDA-core forward, dq and dk/dv
    (ring_fold_fwd_f32_kernel, ring_fold_dq_f32_kernel,
    ring_fold_dkdv_f32_kernel); hd 8 in bf16 the tensor-core forward, dq
    and dk/dv of ring_fold_hd8.cu (ring_fold_fwd_hd8_kernel,
    ring_fold_dq_hd8_kernel, ring_fold_dkdv_hd8_kernel), and in f32 the
    CUDA-core forward, dq and dk/dv of ring_fold_f32_hd8.cu
    (ring_fold_fwd_f32_hd8_kernel, ring_fold_dq_f32_hd8_kernel,
    ring_fold_dkdv_f32_hd8_kernel)."""
    _card()
    from torch.profiler import ProfilerActivity, profile
    names = {}
    for case, dtype, hd in (("bf16", torch.bfloat16, 64),
                            ("bf16_hd16", torch.bfloat16, 16),
                            ("bf16_hd128", torch.bfloat16, 128),
                            ("f32", torch.float32, 64),
                            ("f32_hd16", torch.float32, 16),
                            ("f32_hd128", torch.float32, 128),
                            ("f32_hd8", torch.float32, 8),
                            ("bf16_hd8", torch.bfloat16, 8)):
        q, k, v, do, m, l, o = _block(35, 1, 130, 130, 2, hd, dtype, "cuda")
        lse, delta = _lse_delta(m, l, o, do)
        acc = [torch.zeros_like(o) for _ in range(3)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ring_fold_forward(q, k, v, m, l, o, 130, 130, True, 0.125)
            ring_fold_backward_dq(q, k, v, do, lse, delta, acc[0], 130, 130,
                                  True, 0.125)
            ring_fold_backward_dkdv(q, k, v, do, lse, delta, *acc[1:], 130,
                                    130, True, 0.125)
            torch.cuda.synchronize()
        names[case] = sorted({m.group(0) for e in prof.events() for m in
                              [re.search(r"ring_fold_\w+_kernel", e.name)]
                              if m})
    sm90 = ["ring_fold_dkdv_sm90_kernel", "ring_fold_dq_sm90_kernel",
            "ring_fold_fwd_sm90_kernel"]
    assert names["bf16"] == names["bf16_hd16"] == names["bf16_hd128"] == \
        sm90, names
    f32 = ["ring_fold_dkdv_f32_kernel", "ring_fold_dq_f32_kernel",
           "ring_fold_fwd_f32_kernel"]
    assert names["f32"] == names["f32_hd16"] == names["f32_hd128"] == f32, \
        names
    f32_hd8 = ["ring_fold_dkdv_f32_hd8_kernel", "ring_fold_dq_f32_hd8_kernel",
               "ring_fold_fwd_f32_hd8_kernel"]
    hd8 = ["ring_fold_dkdv_hd8_kernel", "ring_fold_dq_hd8_kernel",
           "ring_fold_fwd_hd8_kernel"]
    assert names["f32_hd8"] == f32_hd8 and names["bf16_hd8"] == hd8, names


@pytest.mark.cuda
@pytest.mark.parametrize("hd", (8, 16, 64, 128))
def test_f32_forward_copies_an_unaligned_view_and_repeats_its_bits(hd):
    """An f32 k whose base is off 16 bytes (the rule of the f32 forward's
    16-byte cp.async copies) is copied by the wrapper: m, l and o are the
    bits of a contiguous k, and a second run gives the same bits; on a
    carried state, a fresh one, and a block whose first rows see no key."""
    _card()
    for q_off, k_off, fresh in ((130, 130, False), (130, 130, True),
                                (0, 64, True)):
        q, k, v, do, m, l, o = _block(53, 2, 130, 130, 3, hd, torch.float32,
                                      "cuda")
        if fresh:
            m, l, o = _fresh(m, l, o)
        flat = torch.empty(k.numel() + 1, device="cuda")
        k_odd = flat[1:].view(k.shape)               # base off by 4 bytes
        k_odd.copy_(k)
        outs = []
        for kk in (k_odd, k, k):
            state = [t.clone() for t in (m, l, o)]
            ring_fold_forward(q, kk, v, *state, q_off, k_off, True,
                              hd ** -0.5)
            outs.append(state)
        torch.cuda.synchronize()
        for a, b, c in zip(*outs):
            assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["unit", "wide"])
@pytest.mark.parametrize("C", [1000, 1024])
def test_f32_hd8_forward_at_a_wide_range_is_as_exact_as_plain(C, wide):
    """m, l and o of the hd-8 f32 forward (ring_fold_f32_hd8.cu: one pass,
    each row's keys split over 8 owners) against the fold in f64, on a
    ring's first, diagonal block from a fresh state and from a carried
    one, at unit scale and at a wide range (q, k x 2, v x 8): its largest
    error at most WIDE_ERR_RATIO times the plain version's."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _, m, l, o = _wide_block(115, 2, C, 3, 8, wide, "cuda")
    scale = 8 ** -0.5
    carried = _block(117, 2, C, C, 3, 8, torch.float32, "cuda")[4:]
    for state in ((m, l, o), carried):
        got = [t.clone() for t in state]
        ring_fold_forward(q, k, v, *got, 0, 0, True, scale)
        plain = [t.clone() for t in state]
        ring_fold_plain(q, k, v, *plain, 0, 0, True, scale)
        exact = _f64_fold(q, k, v, *state, 0, 0, True, scale)
        torch.cuda.synchronize()
        for name, g, p, e in zip("mlo", got, plain, exact):
            err = float((g.double() - e).abs().max())
            plain_err = float((p.double() - e).abs().max())
            assert err <= WIDE_ERR_RATIO * plain_err, (name, err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("Cq,Ck,q_off,k_off", [(130, 130, 130, 130),
                                               (1000, 1000, 1000, 0)])
def test_dq_kernel_adds_into_a_carried_dq_on_the_card(Cq, Ck, q_off, k_off,
                                                      hd, dtype):
    """dq carried over earlier blocks: the kernel adds the block's sum to
    it once, within the tolerance and flip rule of the plain version's
    dq += dS . k from the same dq, twice to the same bits."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, m, l, o = _block(45, 2, Cq, Ck, 3, hd, dtype, "cuda")
    scale = 1.0 / math.sqrt(hd)
    _, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off, True,
                                   scale)
    carried = torch.randn(2, 3, Cq, hd, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(
                              47))
    want = carried.clone()
    ring_fold_bwd_dq_plain(q, k, v, do, lse, delta, want, q_off, k_off, True,
                           scale)
    got = [carried.clone() for _ in range(2)]
    for dq in got:
        ring_fold_backward_dq(q, k, v, do, lse, delta, dq, q_off, k_off, True,
                              scale)
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    _close([got[0]], [want], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", (8, 16, 64, 128))
@pytest.mark.parametrize("C", [65, 200, 1000, 1024])
def test_f32_dkdv_matches_plain_on_the_card(C, hd):
    """The f32 dk/dv kernel (at hd 8 ring_fold_f32_hd8.cu's) on a causal
    diagonal block of a carried state, adding into dk and dv carried
    over earlier blocks: within CARD_TOL of ring_fold_bwd_dkdv_plain
    from the same dk, dv, one launch."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, m, l, o = _block(63, 2, C, C, 3, hd, torch.float32, "cuda")
    scale = 1.0 / math.sqrt(hd)
    _, (lse, delta) = _plain_block(q, k, v, do, m, l, o, C, C, True, scale)
    g = torch.Generator(device="cuda").manual_seed(65)
    carried = [torch.randn(2, 3, C, hd, generator=g, device="cuda")
               for _ in range(2)]
    want = [t.clone() for t in carried]
    ring_fold_bwd_dkdv_plain(q, k, v, do, lse, delta, *want, C, C, True,
                             scale)
    got = [t.clone() for t in carried]
    launches = ring_fold_backward_dkdv.launches
    ring_fold_backward_dkdv(q, k, v, do, lse, delta, *got, C, C, True, scale)
    torch.cuda.synchronize()
    assert ring_fold_backward_dkdv.launches == launches + 1
    _close(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["unit", "wide"])
@pytest.mark.parametrize("hd", (8, 16, 64, 128))
@pytest.mark.parametrize("C", [1000, 1024])
def test_f32_dkdv_at_a_wide_range_is_as_exact_as_plain(C, hd, wide):
    """dk and dv of the f32 dk/dv kernel (a ring's first, diagonal block)
    against the fold and backward in f64 throughout, at unit scale and at
    a wide range (q, k x 2, v x 8, where the plain dk lies up to 15x
    CARD_TOL from f64; CPU leg test_plain_f32_dkdv_against_f64): the
    kernel's largest error at most WIDE_ERR_RATIO times the plain
    version's, both from the plain f32 fold's lse and D."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, m, l, o = _wide_block(67, 2, C, 3, hd, wide, "cuda")
    scale = hd ** -0.5
    plain, (lse, delta) = _plain_block(q, k, v, do, m, l, o, 0, 0, True,
                                       scale)
    got = [torch.zeros_like(t) for t in plain[4:]]
    ring_fold_backward_dkdv(q, k, v, do, lse, delta, *got, 0, 0, True, scale)
    exact = _f64_bwd(q, k, v, do, m, l, o, 0, 0, True, scale)[1:]
    torch.cuda.synchronize()
    for name, g, p, e in zip(("dk", "dv"), got, plain[4:], exact):
        err = float((g.double() - e).abs().max())
        plain_err = float((p.double() - e).abs().max())
        assert err <= WIDE_ERR_RATIO * plain_err, (name, err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", (8, 16, 64, 128))
def test_f32_dkdv_copies_an_unaligned_view_and_repeats_its_bits(hd):
    """An f32 q and dO whose bases are off 16 bytes (the f32 dk/dv's
    16-byte cp.async copies) are copied by the wrapper: dk and dv are the
    bits of contiguous ones, and a second run gives the same bits; on a
    carried state and on a block whose first rows see no key (every
    tile pair visited)."""
    _card()
    for q_off, k_off, fresh in ((130, 130, False), (0, 64, True)):
        q, k, v, do, m, l, o = _block(69, 2, 130, 130, 3, hd, torch.float32,
                                      "cuda")
        if fresh:
            m, l, o = _fresh(m, l, o)
        scale = hd ** -0.5
        _, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                       True, scale)
        odd = []
        for t in (q, do):
            flat = torch.empty(t.numel() + 1, device="cuda")
            odd.append(flat[1:].view(t.shape))       # base off by 4 bytes
            odd[-1].copy_(t)
        outs = []
        for qq, dd in ((odd[0], odd[1]), (q, do), (q, do)):
            acc = [torch.zeros(2, 3, 130, hd, device="cuda")
                   for _ in range(2)]
            ring_fold_backward_dkdv(qq, k, v, dd, lse, delta, *acc, q_off,
                                    k_off, True, scale)
            outs.append(acc)
        torch.cuda.synchronize()
        for a, b, c in zip(*outs):
            assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", (8, 16, 64, 128))
@pytest.mark.parametrize("C", [65, 200, 1000, 1024])
def test_f32_dq_matches_plain_on_the_card(C, hd):
    """The f32 dq kernel (at hd 8 ring_fold_f32_hd8.cu's) on a causal
    diagonal block of a carried state,
    adding into a dq carried over earlier blocks: within CARD_TOL of
    ring_fold_bwd_dq_plain from the same dq, one launch."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, m, l, o = _block(73, 2, C, C, 3, hd, torch.float32, "cuda")
    scale = 1.0 / math.sqrt(hd)
    _, (lse, delta) = _plain_block(q, k, v, do, m, l, o, C, C, True, scale)
    g = torch.Generator(device="cuda").manual_seed(75)
    carried = torch.randn(2, 3, C, hd, generator=g, device="cuda")
    want = carried.clone()
    ring_fold_bwd_dq_plain(q, k, v, do, lse, delta, want, C, C, True, scale)
    got = carried.clone()
    launches = ring_fold_backward_dq.launches
    ring_fold_backward_dq(q, k, v, do, lse, delta, got, C, C, True, scale)
    torch.cuda.synchronize()
    assert ring_fold_backward_dq.launches == launches + 1
    _close([got], [want], torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["unit", "wide"])
@pytest.mark.parametrize("hd", (8, 16, 64, 128))
@pytest.mark.parametrize("C", [1000, 1024])
def test_f32_dq_at_a_wide_range_is_as_exact_as_plain(C, hd, wide):
    """dq of the f32 dq kernel (a ring's first, diagonal block) against
    the fold and backward in f64 throughout, at unit scale and at a wide
    range (q, k x 2, v x 8, where the plain dq lies up to 4.2x CARD_TOL
    from f64; CPU leg test_plain_f32_dq_against_f64): the kernel's
    largest error at most WIDE_ERR_RATIO times the plain version's, both
    from the plain f32 fold's lse and D."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, m, l, o = _wide_block(77, 2, C, 3, hd, wide, "cuda")
    scale = hd ** -0.5
    plain, (lse, delta) = _plain_block(q, k, v, do, m, l, o, 0, 0, True,
                                       scale)
    got = torch.zeros_like(plain[3])
    ring_fold_backward_dq(q, k, v, do, lse, delta, got, 0, 0, True, scale)
    exact = _f64_bwd(q, k, v, do, m, l, o, 0, 0, True, scale)[0]
    torch.cuda.synchronize()
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain[3].double() - exact).abs().max())
    assert err <= WIDE_ERR_RATIO * plain_err, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", (8, 16, 64, 128))
def test_f32_dq_copies_an_unaligned_view_and_repeats_its_bits(hd):
    """An f32 k and dO whose bases are off 16 bytes (the f32 dq's 16-byte
    cp.async copies) are copied by the wrapper: dq, added to the same
    carried dq, is the bits of contiguous ones, and a second run gives
    the same bits; on a carried state and on a block whose first rows see
    no key (every key tile visited)."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(81)
    for q_off, k_off, fresh in ((130, 130, False), (0, 64, True)):
        q, k, v, do, m, l, o = _block(79, 2, 130, 130, 3, hd, torch.float32,
                                      "cuda")
        if fresh:
            m, l, o = _fresh(m, l, o)
        scale = hd ** -0.5
        _, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                       True, scale)
        odd = []
        for t in (k, do):
            flat = torch.empty(t.numel() + 1, device="cuda")
            odd.append(flat[1:].view(t.shape))       # base off by 4 bytes
            odd[-1].copy_(t)
        carried = torch.randn(2, 3, 130, hd, generator=g, device="cuda")
        outs = []
        for kk, dd in ((odd[0], odd[1]), (k, do), (k, do)):
            dq = carried.clone()
            ring_fold_backward_dq(q, kk, v, dd, lse, delta, dq, q_off, k_off,
                                  True, scale)
            outs.append(dq)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


def _fresh(m, l, o):
    """The state before a ring's first fold."""
    return torch.full_like(m, NEG), torch.zeros_like(l), torch.zeros_like(o)


def _exact_inputs(seed, B, Cq, Ck, H, hd, fresh):
    """bf16 q and k with entries in {-1, 0, 1}: q . k is an integer that
    bf16 holds, so every score is the same bits in the kernels and the
    plain version; v, dO unit normal; a fresh state or one from an
    earlier fold."""
    q, k, v, do, m, l, o = _block(seed, B, Cq, Ck, H, hd, torch.bfloat16,
                                  "cuda")
    rng = np.random.default_rng(seed + 2)
    q, k = (torch.from_numpy(rng.integers(-1, 2, t.shape).astype(
        np.float32)).to("cuda", torch.bfloat16) for t in (q, k))
    return [q, k, v, do] + list(_fresh(m, l, o) if fresh else (m, l, o))


def _fold_p_bf16(q, k, v, do, m, l, o, q_off, k_off, causal, scale):
    """Control: the plain fold and dv with p (P) rounded once to bf16 in
    their products: [o, dv]."""
    s = scores_plain(q, k, q_off, k_off, causal, scale)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    o = o * torch.exp(m - m_new)[..., None] + torch.einsum(
        "bhcd,bdhk->bhck", p.to(torch.bfloat16).float(), v.float())
    l_new = l * torch.exp(m - m_new) + p.sum(-1)
    lse, _ = _lse_delta(m_new, l_new, o, do)
    pb = torch.exp(s - lse[..., None]).to(torch.bfloat16).float()
    return [o, torch.einsum("bhcd,bchk->bhdk", pb, do.float())]


# (Cq, Ck, q_off, k_off, causal, fresh): the first block of a ring, a
# past block on an earlier state, a fresh block whose first 64 rows see
# no key, a ragged block without the mask, and a full-length block
# (1024 keys: p's products summed by wgmma, through split_bf16x3, left o
# 1.6-5x past EXACT_TOL there on an H100)
EXACT_BLOCKS = [(256, 256, 256, 256, True, True),
                (130, 130, 260, 0, True, False),
                (128, 128, 0, 64, True, True),
                (200, 70, 0, 0, False, False),
                (1024, 1024, 0, 0, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal,fresh", EXACT_BLOCKS)
def test_exact_scores_hold_the_f32_products_of_p(Cq, Ck, q_off, k_off,
                                                 causal, fresh):
    """On exact scores the bf16 kernels' m, l, o and dv (p's f32 products
    as f32 FMAs) match the plain version within EXACT_TOL; the plain fold
    with p rounded once to bf16 does not."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, m, l, o = _exact_inputs(37, 2, Cq, Ck, 4, 64, fresh)
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                      causal, 0.125)
    got = [t.clone() for t in (m, l, o)]
    ring_fold_forward(q, k, v, *got, q_off, k_off, causal, 0.125)
    dk, dv = torch.zeros_like(want[4]), torch.zeros_like(want[5])
    ring_fold_backward_dkdv(q, k, v, do, lse, delta, dk, dv, q_off, k_off,
                            causal, 0.125)
    control = _fold_p_bf16(q, k, v, do, m, l, o, q_off, k_off, causal,
                           0.125)
    torch.cuda.synchronize()
    for g, w in zip(got + [dv], want[:3] + [want[5]]):
        torch.testing.assert_close(g, w, **EXACT_TOL)
    for c, w in zip(control, (want[2], want[5])):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(c, w, **EXACT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal,fresh", EXACT_BLOCKS)
def test_exact_scores_at_hd8_hold_the_f32_products_of_p(Cq, Ck, q_off,
                                                        k_off, causal,
                                                        fresh):
    """The hd-8 bf16 forward and dk/dv (ring_fold_hd8.cu) on exact
    scores: m, l, o and dv within EXACT_TOL of the plain version, and
    over 1024 keys, where the plain version's own f32 sums leave
    EXACT_TOL of the f64 fold, of the same in f64; p rounded once to bf16
    leaves it."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, m, l, o = _exact_inputs(89, 2, Cq, Ck, 4, 8, fresh)
    scale = 8 ** -0.5
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                      causal, scale)
    want = want[:3] + [want[5]]
    if Ck == 1024:
        want = _exact_f64(q, k, v, do, (m, l, o), lse, q_off, k_off, causal,
                          scale)
    got = [t.clone() for t in (m, l, o)]
    ring_fold_forward(q, k, v, *got, q_off, k_off, causal, scale)
    dk, dv = (torch.zeros(2, 4, Ck, 8, device="cuda") for _ in range(2))
    ring_fold_backward_dkdv(q, k, v, do, lse, delta, dk, dv, q_off, k_off,
                            causal, scale)
    control = _fold_p_bf16(q, k, v, do, m, l, o, q_off, k_off, causal,
                           scale)
    torch.cuda.synchronize()
    for g, w in zip(got + [dv], want):
        torch.testing.assert_close(g.double(), w.double(), **EXACT_TOL)
    for c, w in zip(control, (want[2], want[3])):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(c.double(), w.double(), **EXACT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal,fresh", EXACT_BLOCKS)
def test_exact_inputs_at_hd8_hold_the_bf16_dq_and_f32_dkdv(Cq, Ck, q_off,
                                                            k_off, causal,
                                                            fresh):
    """The hd-8 bf16 dq (ring_fold_dq_hd8_kernel) with q, k, v and dO in
    {-1, 0, 1}: every P and dS is the plain version's bits, so dq, a sum
    of exact products on the tensor cores, holds the plain version's
    within EXACT_TOL (over 1024 keys the same sum in f64); dS left
    unrounded (the control) leaves it.  The hd-8 f32 dk/dv
    (ring_fold_dkdv_f32_hd8_kernel) with integer q and k: dk and dv
    within EXACT_TOL of the plain version's (over 1024 queries of the
    same in f64 from the plain lse and D); dS and P rounded once to bf16
    (the control) leave it."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from brpc_tpu_torch.ops.ring_fold import _p_ds
    scale = 8 ** -0.5
    args = (q_off, k_off, causal, scale)
    q, k, v, do, m, l, o = _integer_block(109, 2, Cq, Ck, 4, "cuda")
    if not fresh:
        m, l, o = _block(111, 2, Cq, Ck, 4, 8, torch.float32, "cuda")[4:]
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, *args)
    p, ds = _p_ds(q, k, v, do, lse, delta, *args)
    dq = torch.zeros_like(want[3])
    ring_fold_backward_dq(q, k, v, do, lse, delta, dq, *args)
    ref = want[3].double()
    if Ck == 1024:
        ref = torch.einsum("bhcd,bdhk->bhck", ds.double(), k.double())
    dp = torch.einsum("bchk,bdhk->bhcd", do.float(), v.float())
    control = torch.einsum("bhcd,bdhk->bhck",
                           p * (dp - delta[..., None]) * scale, k.float())
    torch.cuda.synchronize()
    torch.testing.assert_close(dq.double(), ref, **EXACT_TOL)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(control.double(), ref, **EXACT_TOL)

    q, k, v, do = (t.float() for t in (q, k, v, do))
    g = torch.Generator(device="cuda").manual_seed(113)
    v, do = (torch.randn(t.shape, generator=g, device="cuda") for t in (v, do))
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, *args)
    p, ds = _p_ds(q, k, v, do, lse, delta, *args)
    dk, dv = torch.zeros_like(want[4]), torch.zeros_like(want[5])
    ring_fold_backward_dkdv(q, k, v, do, lse, delta, dk, dv, *args)
    refs = [want[4].double(), want[5].double()]
    if Cq == 1024:
        s = scores_plain(q, k, *args).double()
        p64 = torch.exp(s - lse.double()[..., None])
        dp64 = torch.einsum("bchk,bdhk->bhcd", do.double(), v.double())
        ds64 = p64 * (dp64 - delta.double()[..., None]) * scale
        refs = [torch.einsum("bhcd,bchk->bhdk", ds64, q.double()),
                torch.einsum("bhcd,bchk->bhdk", p64, do.double())]
    controls = [torch.einsum("bhcd,bchk->bhdk",
                             x.to(torch.bfloat16).float(), y)
                for x, y in ((ds, q), (p, do))]
    torch.cuda.synchronize()
    for got, ref, control in zip((dk, dv), refs, controls):
        torch.testing.assert_close(got.double(), ref, **EXACT_TOL)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(control.double(), ref, **EXACT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Cq,Ck,q_off,k_off,causal,fresh", EXACT_BLOCKS)
def test_exact_scores_at_hd8_hold_the_f32_forward(Cq, Ck, q_off, k_off,
                                                  causal, fresh):
    """The hd-8 f32 forward (ring_fold_fwd_f32_hd8_kernel) with q and k in
    {-1, 0, 1}: every score is the same bits in the kernel and the plain
    version, so m, l and o (p's products summed by 8 owners a row) hold
    the plain version's within EXACT_TOL, and over 1024 keys, where the
    plain version's own f32 sums are no nearer the truth, the same sums
    in f64; p rounded once to bf16 (the control) leaves it."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, _, do, m, l, o = _exact_inputs(119, 2, Cq, Ck, 4, 8, fresh)
    q, k = q.float(), k.float()
    v = torch.randn(2, Ck, 4, 8, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(121))
    scale = 8 ** -0.5
    want = [t.clone() for t in (m, l, o)]
    ring_fold_plain(q, k, v, *want, q_off, k_off, causal, scale)
    if Ck == 1024:
        want = _exact_f64(q, k, v, do, (m, l, o), m, q_off, k_off, causal,
                          scale)[:3]
    got = [t.clone() for t in (m, l, o)]
    ring_fold_forward(q, k, v, *got, q_off, k_off, causal, scale)
    control = _fold_p_bf16(q, k, v, do, m, l, o, q_off, k_off, causal,
                           scale)[0]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w.double(), **EXACT_TOL)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(control.double(), want[2].double(),
                                   **EXACT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("Cq,Ck,q_off,k_off", [(128, 128, 0, 64),
                                               (100, 200, 0, 90)])
def test_rows_that_have_seen_no_key_match_plain_on_the_card(Cq, Ck, q_off,
                                                            k_off, hd,
                                                            dtype):
    """A ring's first fold of a block that its first rows see nothing of:
    from m = -1e30 the reference weighs their masked scores by exp(0) = 1,
    so the kernels may skip no masked tile pair there."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, m, l, o = _block(39, 2, Cq, Ck, 3, hd, dtype, "cuda")
    m, l, o = _fresh(m, l, o)
    scale = 1.0 / math.sqrt(hd)
    want, (lse, delta) = _plain_block(q, k, v, do, m, l, o, q_off, k_off,
                                      True, scale)
    assert float(want[1][:, :, 0].min()) == float(Ck)   # p = 1 on every key
    got = [t.clone() for t in (m, l, o)]
    ring_fold_forward(q, k, v, *got, q_off, k_off, True, scale)
    acc = [torch.zeros_like(t) for t in want[3:]]
    ring_fold_backward_dq(q, k, v, do, lse, delta, acc[0], q_off, k_off,
                          True, scale)
    ring_fold_backward_dkdv(q, k, v, do, lse, delta, *acc[1:], q_off, k_off,
                            True, scale)
    torch.cuda.synchronize()
    _close(got + acc, want, dtype)
