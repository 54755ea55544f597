"""The port's model and decode (brpc_tpu_torch/models/, ops/) against the
JAX reference (brpc_tpu/models/) on the CPU.

One parameter tree, drawn by the reference's ``transformer.init`` and
carried into the port with ``weights.params_from_jax``; inputs from numpy
seeds.  The reference runs in-process on jax-CPU (pure jnp; no native
library is loaded), the port with ``device="cpu"``.

Tolerances (f32 end to end, only the order of the sums differs):
logits atol 1e-4 / rtol 1e-5, K/V and attention outputs atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import decode as ref_decode
from brpc_tpu.models import transformer as ref_tf
from brpc_tpu_torch.models import decode as D
from brpc_tpu_torch.models import transformer as T
from brpc_tpu_torch.ops.decode_attention import (decode_attention,
                                                 decode_attention_plain)
from brpc_tpu_torch.weights import params_from_jax

LOGITS_TOL = dict(atol=1e-4, rtol=1e-5)
KV_TOL = dict(atol=1e-5, rtol=0)

SHAPE = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64, n_experts=0)


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_tf.ModelConfig(dtype=jnp.float32, **SHAPE)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_tf.init(jax.random.PRNGKey(0), ref_cfg))
    cfg = T.ModelConfig(dtype=torch.float32, **SHAPE)
    return ref_cfg, tree, cfg, params_from_jax(tree, cfg, device="cpu")


def _tokens(seed, shape, vocab=SHAPE["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def test_params_keep_the_reference_tree(models):
    _, tree, _, model = models
    names = dict(model.named_parameters())
    assert names["blocks.wq"].shape == tree["blocks"]["wq"].shape
    assert names["blocks.wo"].shape == tree["blocks"]["wo"].shape
    np.testing.assert_array_equal(names["ln_f.g"].detach().numpy(),
                                  tree["ln_f"]["g"])
    np.testing.assert_array_equal(names["embed"].detach().numpy(),
                                  tree["embed"])


def test_apply_matches_reference(models):
    ref_cfg, tree, cfg, model = models
    toks = _tokens(1, (2, 24))
    want = ref_tf.apply(tree, jnp.asarray(toks), ref_cfg)
    got = T.apply(model, torch.from_numpy(toks), cfg).detach()
    _close(got, want, LOGITS_TOL)


def test_prefill_logits_and_kv_match_reference(models):
    ref_cfg, tree, cfg, model = models
    toks = _tokens(2, (2, 17))
    wl, wk, wv = ref_decode.prefill(tree, jnp.asarray(toks), ref_cfg)
    gl, gk, gv = D.prefill(model, torch.from_numpy(toks), cfg)
    _close(gl, wl, LOGITS_TOL)
    _close(gk, wk, KV_TOL)
    _close(gv, wv, KV_TOL)


def test_erf_gelu_would_fail_the_prefill_tolerance(models, monkeypatch):
    """The GELU trap: jax.nn.gelu is the tanh form.  With PyTorch's erf
    default the same prefill leaves the logits tolerance."""
    ref_cfg, tree, cfg, model = models
    toks = _tokens(3, (1, 20))
    wl, _, _ = ref_decode.prefill(tree, jnp.asarray(toks), ref_cfg)
    monkeypatch.setattr(T, "_gelu", torch.nn.functional.gelu)
    gl, _, _ = D.prefill(model, torch.from_numpy(toks), cfg)
    gap = np.abs(np.asarray(gl) - np.asarray(wl))
    bound = LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * np.abs(np.asarray(wl))
    assert (gap > bound).any(), gap.max()


def test_decode_steps_with_mixed_slots_match_reference(models):
    """Three slots, two of them holding prefilled sequences and one idle:
    logits, both caches and pos after each of four steps.  The idle slot
    still writes its K/V at min(pos, S-1) and does not advance."""
    ref_cfg, tree, cfg, model = models
    slots, S = 3, 32
    rc = ref_decode.init_cache(ref_cfg, slots, S)
    pc = D.init_cache(cfg, slots, S, device="cpu")
    for slot, (seed, plen) in {0: (4, 9), 2: (5, 14)}.items():
        toks = _tokens(seed, (1, plen))
        _, k, v = ref_decode.prefill(tree, jnp.asarray(toks), ref_cfg)
        k, v = np.asarray(k[:, 0]), np.asarray(v[:, 0])
        rc = ref_decode.install(rc, slot, k, v, plen)
        D.install(pc, slot, k, v, plen)
    active = np.array([True, False, True])
    tokens = _tokens(6, (slots,))
    for _ in range(4):
        wl, rc = ref_decode.decode_step(tree, rc, jnp.asarray(tokens),
                                        jnp.asarray(active), ref_cfg)
        gl, pc = D.decode_step(model, pc, torch.from_numpy(tokens),
                               torch.from_numpy(active), cfg)
        _close(gl, wl, LOGITS_TOL)
        _close(pc["k"], rc["k"], KV_TOL)
        _close(pc["v"], rc["v"], KV_TOL)
        np.testing.assert_array_equal(pc["pos"].numpy(),
                                      np.asarray(rc["pos"]))
        tokens = np.asarray(jnp.argmax(wl, axis=-1)).astype(np.int32)
    assert pc["pos"].tolist() == [13, 0, 18]


def test_install_and_reset_slot_match_reference(models):
    ref_cfg, _, cfg, _ = models
    rng = np.random.default_rng(7)
    k = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    rc = ref_decode.install(ref_decode.init_cache(ref_cfg, 2, 8), 1, k, v, 5)
    pc = D.install(D.init_cache(cfg, 2, 8, device="cpu"), 1, k, v, 5)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(pc[key].numpy(), np.asarray(rc[key]))
    rc = ref_decode.reset_slot(rc, 1)
    D.reset_slot(pc, 1)
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(rc["pos"]))


def test_kv_wire_bytes_match_reference_and_round_trip(models):
    _, _, cfg, _ = models
    rng = np.random.default_rng(8)
    k = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    data = D.kv_to_bytes(torch.from_numpy(k), torch.from_numpy(v))
    assert data == ref_decode.kv_to_bytes(jnp.asarray(k), jnp.asarray(v))
    assert len(data) == 6 * D.kv_bytes_per_token(cfg)
    k2, v2 = D.kv_from_bytes(data, cfg, 6)
    np.testing.assert_array_equal(k2, k)
    np.testing.assert_array_equal(v2, v)


def _jnp_fragment(q, k_new, v_new, kc, vc, p):
    """decode.py:178-186 for one layer, as the reference writes it."""
    N, S = kc.shape[0], kc.shape[1]
    rows = jnp.arange(N)
    kc = kc.at[rows, p].set(k_new)
    vc = vc.at[rows, p].set(v_new)
    valid = jnp.arange(S)[None, :] <= p[:, None]
    scores = jnp.einsum("nhk,nshk->nhs", q, kc) / np.sqrt(q.shape[-1])
    scores = jnp.where(valid[:, None, :], scores.astype(jnp.float32), -1e30)
    w = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    return jnp.einsum("nhs,nshk->nhk", w, vc), kc, vc


@pytest.mark.parametrize("p", [[0, 31, 7, 18], [31, 31, 0, 0]])
def test_plain_decode_attention_matches_the_jnp_fragment(p):
    rng = np.random.default_rng(9)
    N, S, H, hd = 4, 32, 4, 16
    q, kn, vn = (rng.standard_normal((N, H, hd)).astype(np.float32)
                 for _ in range(3))
    kc, vc = (rng.standard_normal((N, S, H, hd)).astype(np.float32)
              for _ in range(2))
    pa = np.array(p, np.int32)
    wo, wk, wv = _jnp_fragment(*(jnp.asarray(a) for a in
                                 (q, kn, vn, kc, vc, pa)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    args = (torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
            tk, tv, torch.from_numpy(pa))
    before = decode_attention.launches
    got = decode_attention(*args)   # a CPU tensor: the plain version
    assert decode_attention.launches == before
    _close(got, wo, KV_TOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    tk2, tv2 = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    again = decode_attention_plain(args[0], args[1], args[2], tk2, tv2,
                                   args[5])
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_decode_attention_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 4, 16)
    kc = torch.zeros(2, 8, 4, 16)
    p = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        decode_attention(q.half(), q.half(), q.half(), kc.half(), kc.half(), p)
    with pytest.raises(ValueError):
        decode_attention(q, q, q, kc, kc, p.long())
    with pytest.raises(ValueError):
        decode_attention(q, q, q, torch.zeros(2, 8, 4, 32)[..., ::2], kc, p)


def test_unported_options_raise():
    """The decode path is dense-only, as the reference's
    (decode.py:37-39: ValueError)."""
    moe = T.ModelConfig(n_experts=2, **{
        k: v for k, v in SHAPE.items() if k != "n_experts"})
    model = T.init(torch.Generator().manual_seed(0), moe, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="dense-only"):
        D.init_cache(moe, 1, 8, "cpu")
    with pytest.raises(ValueError, match="dense-only"):
        D.prefill(model, toks, moe)
    with pytest.raises(ValueError, match="dense-only"):
        D.decode_step(model, {}, toks[0, :1], torch.ones(1, dtype=torch.bool),
                      moe)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_config_without_a_mesh_matches_reference(models,
                                                                   impl):
    """The reference takes the ring/Ulysses route only on a mesh with an
    sp axis larger than 1 (transformer.py:_attention) and its decode
    ignores attn_impl, so with no mesh such a config gives the gather
    model's logits, prefill and decode steps; so does the port."""
    ref_cfg, tree, cfg, _ = models
    ref_cfg = dataclasses.replace(ref_cfg, attn_impl=impl)
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    model = params_from_jax(tree, cfg, device="cpu")
    toks = _tokens(11, (2, 20))
    _close(T.apply(model, torch.from_numpy(toks), cfg).detach(),
           ref_tf.apply(tree, jnp.asarray(toks), ref_cfg), LOGITS_TOL)
    slots, S = 2, 32
    rc = ref_decode.init_cache(ref_cfg, slots, S)
    pc = D.init_cache(cfg, slots, S, device="cpu")
    for slot in range(slots):
        wl, k, v = ref_decode.prefill(tree, jnp.asarray(toks[slot:slot + 1]),
                                      ref_cfg)
        gl, _, _ = D.prefill(model, torch.from_numpy(toks[slot:slot + 1]),
                             cfg)
        _close(gl, wl, LOGITS_TOL)
        k, v = np.asarray(k[:, 0]), np.asarray(v[:, 0])
        rc = ref_decode.install(rc, slot, k, v, toks.shape[1])
        D.install(pc, slot, k, v, toks.shape[1])
    active = np.array([True, True])
    tokens = _tokens(12, (slots,))
    for _ in range(3):
        wl, rc = ref_decode.decode_step(tree, rc, jnp.asarray(tokens),
                                        jnp.asarray(active), ref_cfg)
        gl, pc = D.decode_step(model, pc, torch.from_numpy(tokens),
                               torch.from_numpy(active), cfg)
        _close(gl, wl, LOGITS_TOL)
        _close(pc["k"], rc["k"], KV_TOL)
        _close(pc["v"], rc["v"], KV_TOL)
        tokens = np.asarray(jnp.argmax(wl, axis=-1)).astype(np.int32)


def test_plain_decode_attention_bf16_rounds_scores_first():
    """The score-rounding trap, in bf16: the reference rounds q.k to bf16
    and divides in f32 before the f32 softmax.  The port's plain version
    does the same (atol 1e-2, under one bf16 step at these magnitudes);
    scores kept in f32 instead would leave that tolerance."""
    rng = np.random.default_rng(10)
    N, S, H, hd = 4, 64, 4, 16

    def draw(*shape):
        return (2 * rng.standard_normal(shape)).astype(np.float32)

    q, kn, vn = draw(N, H, hd), draw(N, H, hd), draw(N, H, hd)
    kc, vc = draw(N, S, H, hd), draw(N, S, H, hd)
    pa = np.array([0, 63, 17, 40], np.int32)
    wo, _, _ = _jnp_fragment(*(jnp.asarray(a, jnp.bfloat16)
                               for a in (q, kn, vn, kc, vc)),
                             jnp.asarray(pa))
    want = np.asarray(wo.astype(jnp.float32))

    def bf(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    got = decode_attention_plain(bf(q), bf(kn), bf(vn), bf(kc), bf(vc),
                                 torch.from_numpy(pa))
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=0)

    tk, tv = bf(kc), bf(vc)
    rows = torch.arange(N)
    tk[rows, pa] = bf(kn)
    tv[rows, pa] = bf(vn)
    scores = torch.einsum("nhk,nshk->nhs", bf(q).float(), tk.float()) / 4.0
    valid = torch.arange(S)[None] <= torch.from_numpy(pa).long()[:, None]
    scores = torch.where(valid[:, None], scores, torch.tensor(-1e30))
    w = torch.softmax(scores, dim=-1).to(torch.bfloat16)
    unrounded = torch.einsum("nhs,nshk->nhk", w, tv).float().numpy()
    assert np.abs(unrounded - want).max() > 1e-2
