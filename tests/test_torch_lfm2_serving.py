"""Serving the lfm2 family (brpc_tpu_torch/models/decode.py, lfm2.py,
ops/decode_attention.py, serving/): a KV cache of the attention layers
at the KV heads beside a conv state of each conv layer, the routed
experts in the step and the prefill, grouped-query decode attention, the
state's route through the KV block plane, and the step's and prefill's
CUDA graphs.

On the CPU, at a tiny size in f32, against the benchmark's plain
reference (perfbench/reference/lfm2_moe.py, the full forward of the same
tokens): prefill and then decode through the cache give its logits
within atol 1e-4 / rtol 1e-5 (tests/test_torch_lfm2_moe.py's rule: the
same equations in another order of sums), prompts shorter than the
conv width included; the engine's served tokens are the reference's
greedy ones, and its counters count every token's assignments once; the
conv state crosses kv_to_bytes, the plane and install bit for bit (a
subprocess over the fake libcuda); a slot whose conv state is left stale
fails the comparison and reset_slot clears it; padded prefill rows
route to no expert and change no valid row; the plain decode attention
at KV < H is the repeated-KV attention and at KV == H the MHA formula
bit for bit; the product weights held in bf16 give the bits of the cast
at each use.

The ``cuda`` legs run the GQA kernel against its plain version, the
lfm2 ``StepGraphs`` and ``PrefillGraphs`` against their segments run
eagerly (bit for bit), and one graphed step under
``set_sync_debug_mode("error")``.  On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_lfm2_serving.py``.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from brpc_tpu_torch import _native
from brpc_tpu_torch.models import decode as D
from brpc_tpu_torch.models import lfm2
from brpc_tpu_torch.models import transformer as T
from brpc_tpu_torch.ops.decode_attention import (decode_attention,
                                                 decode_attention_plain)
from brpc_tpu_torch.serving.lockstep import Lockstep
from perfbench.reference import lfm2_moe as R
from perfbench.reference import lfm2_served

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(family="lfm2", vocab=128, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=5, layer_kinds=("conv", "attn", "conv", "attn", "conv"),
             n_dense_layers=1, d_ff=96, d_expert=32, n_experts=8,
             experts_held=8, expert_first=0, moe_topk=2, routed_scale=1.0,
             norm_eps=1e-5, rope_theta=1e6, conv_width=3, max_seq=64)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-5)
# (slot, prompt length): 1 and 2 are shorter than the conv width
PROMPTS = ((0, 1), (1, 2), (2, 9))
# bf16 at hd 64 on the card (the kernel's head dims): 5 layers, 2 of them
# attention, 8 experts top-2
CARD = dict(MODEL, vocab=512, d_model=256, d_ff=384, d_expert=128,
            max_seq=256)


def _cfg(dtype=torch.float32, **over):
    return T.ModelConfig(dtype=dtype, **dict(MODEL, **over))


def _model(cfg, seed=0, dev="cpu"):
    return T.init(torch.Generator().manual_seed(seed), cfg, dev)


def _m(cfg):
    """The reference's "model" group of a ModelConfig."""
    keys = ("vocab", "d_model", "n_heads", "n_kv_heads", "n_layers",
            "n_dense_layers", "d_ff", "d_expert", "n_experts",
            "experts_held", "expert_first", "moe_topk", "routed_scale",
            "norm_eps", "rope_theta", "conv_width")
    return dict({k: getattr(cfg, k) for k in keys},
                layer_kinds=list(cfg.layer_kinds))


def _weights(model):
    return {k: v.detach().float().clone()
            for k, v in model.state_dict().items()}


def _sequences(cfg, n, length, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (n, length), generator=gen)


def _reference(model, cfg, seqs):
    with R.exact_f32():
        return R.forward(_weights(model), seqs, _m(cfg))


def _served_cache(model, cfg, seqs, prompts=PROMPTS, slots=3):
    cache = D.init_cache(cfg, slots, cfg.max_seq, "cpu")
    first = {}
    for slot, plen in prompts:
        logits, k, v, conv = D.prefill(model, seqs[slot:slot + 1, :plen], cfg)
        D.install(cache, slot, k[:, 0], v[:, 0], plen, conv=conv[:, 0])
        first[slot] = logits[0]
    return cache, first


def test_prefill_then_steps_match_the_reference_full_forward():
    """Three slots at prompts of 1, 2 and 9 tokens, then 12 steps each
    fed its sequence's next token: every prefill's and step's logits are
    the reference's full forward of the same tokens."""
    cfg = _cfg()
    model = _model(cfg)
    seqs = _sequences(cfg, 3, 24, 1)
    ref = _reference(model, cfg, seqs)
    cache, first = _served_cache(model, cfg, seqs)
    active = torch.ones(3, dtype=torch.bool)
    for slot, plen in PROMPTS:
        torch.testing.assert_close(first[slot], ref[slot, plen - 1],
                                   **LOGITS_TOL)
    for t in range(12):
        at = [plen + t for _, plen in PROMPTS]
        logits, _ = D.decode_step(model, cache, seqs[[0, 1, 2], at], active,
                                  cfg)
        for slot in range(3):
            torch.testing.assert_close(logits[slot], ref[slot, at[slot]],
                                       **LOGITS_TOL)
    assert cache["pos"].tolist() == [plen + 12 for _, plen in PROMPTS]


def test_a_stale_conv_state_fails_and_reset_clears_it():
    """A slot reused with the last sequence's conv state left in place
    (K/V and pos installed, the state not) decodes away from the
    reference; ``reset_slot`` zeroes the slot's state and its position,
    and a whole install then decodes the new sequence as the reference
    does."""
    cfg = _cfg()
    model = _model(cfg, seed=3)
    seqs = _sequences(cfg, 2, 20, 4)
    ref = _reference(model, cfg, seqs)
    cache, _ = _served_cache(model, cfg, seqs, prompts=((0, 6),), slots=2)
    active = torch.tensor([True, False])
    for t in range(4):
        D.decode_step(model, cache, seqs[[0, 1], [6 + t, 0]], active, cfg)
    stale = cache["conv"][:, 0].clone()
    assert stale.abs().sum() > 0
    _, k, v, conv = D.prefill(model, seqs[1:2, :7], cfg)

    def next_logits():
        logits, _ = D.decode_step(model, cache, seqs[[1, 0], [7, 0]],
                                  active, cfg)
        return logits[0]
    D.install(cache, 0, k[:, 0], v[:, 0], 7, conv=conv[:, 0])
    cache["conv"][:, 0].copy_(stale)             # the state not replaced
    gap = (next_logits() - ref[1, 7]).abs().max()
    assert gap > 1e-2, float(gap)

    D.reset_slot(cache, 0)
    assert int(cache["pos"][0]) == 0
    assert torch.count_nonzero(cache["conv"][:, 0]) == 0
    D.install(cache, 0, k[:, 0], v[:, 0], 7, conv=conv[:, 0])
    torch.testing.assert_close(next_logits(), ref[1, 7], **LOGITS_TOL)
    with pytest.raises(ValueError, match="conv state"):
        D.install(cache, 1, k[:, 0], v[:, 0], 7)


@pytest.mark.parametrize("n", [1, 2, 37, 128, 129, 200])
def test_padded_prefill_rows_route_nowhere_and_change_no_valid_row(n):
    """The prefill's segments at the padded length of n (max_seq 256:
    lengths 128 and 256), the causal attention at n: the logits, the
    K/V's n rows and the conv state are ``prefill``'s, other content in
    every static buffer changes no bit of them, and each MoE layer
    counts n x top-k assignments, none for a padded row."""
    cfg = _cfg(max_seq=256)
    model = _model(cfg, seed=n)
    tokens = _sequences(cfg, 1, n, n)[0]
    bufs = D.prefill_buffers(model, cfg, cfg.max_seq)
    model.reset_stats()
    got = _padded_prefill(model, cfg, tokens, bufs)
    counts = model.stats()["moe_assignments"]
    assert [sum(c) for c in counts] == [n * cfg.moe_topk] * 4
    want = D.prefill(model, tokens[None], cfg)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    got = [t.clone() for t in got]
    gen = torch.Generator().manual_seed(0)
    bufs["tokens"].copy_(torch.randint(0, 7, bufs["tokens"].shape,
                                       generator=gen))
    for name in ("x", "q", "o", "k", "v", "kr", "vr", "conv"):
        bufs[name].copy_(torch.randn(bufs[name].shape, generator=gen))
    for g, a in zip(got, _padded_prefill(model, cfg, tokens, bufs)):
        assert torch.equal(g, a)


@torch.no_grad()
def _padded_prefill(model, cfg, tokens, bufs):
    """``PrefillGraphs.run``'s order of work run eagerly on `bufs`."""
    n = tokens.numel()
    S = D.prefill_bucket(n, bufs["tokens"].shape[1])
    segs = D._padded_segments(model, cfg, bufs, S)
    bufs["tokens"][0, :n].copy_(tokens)
    bufs["row"].fill_(n - 1)
    q, o = bufs["q"][:, :n], bufs["o"][:, :n]
    segs[0]()
    for i, (k, v) in enumerate(D._attention_inputs(cfg, bufs, n)):
        o.copy_(T._causal_attention(q, k, v))
        out = segs[i + 1]()
    return (out, bufs["k"][:, :, :n], bufs["v"][:, :, :n], bufs["conv"])


def test_segments_built_once_give_the_steps_bits_on_the_cpu():
    """The graphs' use of the step's segments: built once over static
    tokens, active and o, warmed up with active all 0 (which moves no
    slot's pos or conv state), then refilled and run in order each step,
    decode_attention between them: decode_step's bits on a twin cache,
    an install and a reset between steps included."""
    cfg = _cfg()
    model = _model(cfg, seed=14)
    seqs = _sequences(cfg, 4, 20, 15)
    cache, _ = _served_cache(model, cfg, seqs, slots=4)
    twin = {key: t.clone() for key, t in cache.items()}
    tokens = torch.zeros(4, dtype=torch.int64)
    active = torch.zeros(4, dtype=torch.int32)
    o = torch.zeros((4, cfg.n_heads, cfg.head_dim))
    segs = D._step_segments(model, cache, cfg, tokens, active, o)
    outs = ()
    for seg in segs:                       # the warm-up
        outs = seg(*outs)
    for key in twin:
        assert torch.equal(cache[key], twin[key]), key
    on = torch.tensor([True, True, True, False])
    for step in range(6):
        if step == 3:
            _, k, v, conv = D.prefill(model, seqs[3:4, :4], cfg)
            for c in (cache, twin):
                D.install(c, 3, k[:, 0], v[:, 0], 4, conv=conv[:, 0])
                D.reset_slot(c, 0)
            on = torch.tensor([False, True, True, True])
        tokens.copy_(seqs[:, 10 + step])
        active.copy_(on)
        outs = segs[0]()
        p = outs[4]
        for a in range(cache["k"].shape[0]):
            _, q, k_new, v_new = outs[:4]
            o.copy_(decode_attention(q, k_new, v_new, cache["k"][a],
                                     cache["v"][a], p))
            outs = segs[a + 1](*outs)
        want, _ = D.decode_step(model, twin, seqs[:, 10 + step], on, cfg)
        assert torch.equal(outs, want), step
        for key in twin:
            assert torch.equal(cache[key], twin[key]), (step, key)


def test_inactive_slots_route_to_no_expert():
    """A step with one of three slots active counts top-k assignments a
    MoE layer, and its logits for that slot are those of the step with
    every slot active (up to the products' rounding at another row
    count)."""
    cfg = _cfg()
    model = _model(cfg, seed=5)
    seqs = _sequences(cfg, 3, 12, 6)
    cache, _ = _served_cache(model, cfg, seqs)
    twin = {key: t.clone() for key, t in cache.items()}
    model.reset_stats()
    one, _ = D.decode_step(model, cache, seqs[:, 9],
                           torch.tensor([False, True, False]), cfg)
    assert [sum(c) for c in model.stats()["moe_assignments"]] == \
        [cfg.moe_topk] * 4
    every, _ = D.decode_step(model, twin, seqs[:, 9],
                             torch.ones(3, dtype=torch.bool), cfg)
    torch.testing.assert_close(one[1], every[1], atol=1e-5, rtol=1e-5)
    assert cache["pos"].tolist() == [1, 3, 9]


def test_held_bf16_products_give_the_bits_of_the_cast_at_each_use():
    """In bf16, ``lfm2.hold_products`` casts every product weight once and
    holds the tied head as the embedding's bf16 cast (the embedding table
    itself, the norm gains, routers and expert bias stay f32): prefill
    and a step give the same bits as the f32-held model that casts at
    each use."""
    cfg = _cfg(dtype=torch.bfloat16)
    model, held = _model(cfg, seed=7), _model(cfg, seed=7)
    lfm2.hold_products(held, cfg)
    for name, p in held.named_parameters():
        leaf = name.split(".")[-1]
        want = (torch.bfloat16 if leaf in lfm2.PRODUCT_LEAVES
                else torch.float32)
        assert p.dtype == want, name
    assert torch.equal(held.head, held.embed.to(torch.bfloat16))
    assert all(b.dtype == torch.float32 for name, b in held.named_buffers()
               if name != "head")
    seqs = _sequences(cfg, 3, 12, 8)
    outs = []
    for m in (model, held):
        cache, first = _served_cache(m, cfg, seqs)
        step, _ = D.decode_step(m, cache, seqs[:, 9],
                                torch.ones(3, dtype=torch.bool), cfg)
        outs.append([first[s] for s in range(3)] + [step, cache["conv"],
                                                     cache["k"]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_decode_attention_plain_at_kv_below_h_is_repeated_kv():
    """At 8 query heads over 2 KV heads the plain version appends at the
    KV heads and attends as the MHA formula over each KV head's rows
    repeated to its 4 query heads; at KV == H it is the MHA formula bit
    for bit."""
    gen = torch.Generator().manual_seed(9)
    N, S, H, KV, hd = 3, 20, 8, 2, 16
    q = torch.randn(N, H, hd, generator=gen)
    kn, vn = (torch.randn(N, KV, hd, generator=gen) for _ in range(2))
    kc, vc = (torch.randn(N, S, KV, hd, generator=gen) for _ in range(2))
    p = torch.tensor([0, 7, S - 1], dtype=torch.int32)
    k2, v2 = kc.clone(), vc.clone()
    got = decode_attention(q, kn, vn, k2, v2, p)
    rows = torch.arange(N)
    for c, new, t in ((kc, kn, k2), (vc, vn, v2)):
        want = c.clone()
        want[rows, p.long()] = new
        assert torch.equal(t, want)
    r = H // KV
    kr, vr = k2.repeat_interleave(r, 2), v2.repeat_interleave(r, 2)
    want = _mha(q, kr, vr, p)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    for h in range(H):          # query head h reads KV head h // r
        one = _mha(q[:, h:h + 1], k2[:, :, h // r:h // r + 1],
                   v2[:, :, h // r:h // r + 1], p)
        torch.testing.assert_close(got[:, h:h + 1], one, atol=1e-6,
                                   rtol=1e-6)
    kr2, vr2 = kr.clone(), vr.clone()
    knr, vnr = kn.repeat_interleave(r, 1), vn.repeat_interleave(r, 1)
    mha = decode_attention(q, knr, vnr, kr2, vr2, p)
    assert torch.equal(mha, _mha(q, kr2, vr2, p))


def _mha(q, kc, vc, p):
    """The MHA formula of decode_attention_plain before grouped-query
    attention, on caches that already hold row p."""
    S = kc.shape[1]
    scores = (torch.einsum("nhk,nshk->nhs", q, kc).float()
              / math.sqrt(q.shape[-1]))
    valid = torch.arange(S)[None, :] <= p.long()[:, None]
    scores = torch.where(valid[:, None, :], scores, torch.tensor(-1e30))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("nhs,nshk->nhk", w, vc)


def test_decode_attention_refuses_heads_that_do_not_share():
    q = torch.zeros(2, 6, 16)
    kv = torch.zeros(2, 4, 16)
    cache = torch.zeros(2, 8, 4, 16)
    with pytest.raises(ValueError, match="do not share"):
        decode_attention(q, kv, kv, cache, cache.clone(),
                         torch.zeros(2, dtype=torch.int32))


def test_the_prefill_ladder_pads_under_an_eighth_above_1024():
    """LFM2's prompts run to 6,144: 28 padded lengths, 128 apart up to
    1,024 and an eighth of the power of two below them above it; the
    padding is at most 127 rows up to 1,024 and under 12.5% of the
    prompt's rows above."""
    ladder = D.prefill_buckets(6144)
    assert ladder[:9] == [128 * i for i in range(1, 9)] + [1152]
    assert ladder[-4:] == [4608, 5120, 5632, 6144] and len(ladder) == 28
    assert D.prefill_buckets(8192)[-1] == 8192
    for n in range(1, 6145):
        S = D.prefill_bucket(n, 6144)
        assert S in ladder and S >= n
        assert S - n <= 127 if n <= 1024 else (S - n) / n < 0.125
    assert D.prefill_bucket(6145, 6144) is None


def test_the_full_configuration_routes_its_state_in_one_block():
    """LFM2-8B-A1B: a token's K/V on the wire is 24,576 bytes (6
    attention layers, 8 KV heads of 64), a 16-token block 393,216, and
    the conv state (18 layers x 2 rows x 2,048 f32) 294,912: one more
    block a sequence."""
    kinds = ["conv" if i not in (2, 6, 10, 14, 18, 21) else "attn"
             for i in range(24)]
    cfg = T.ModelConfig(**dict(MODEL, vocab=65536, d_model=2048,
                               n_heads=32, n_kv_heads=8, n_layers=24,
                               layer_kinds=tuple(kinds), n_dense_layers=2,
                               d_ff=7168, d_expert=1792, n_experts=32,
                               experts_held=32, moe_topk=4, max_seq=8192))
    assert D.kv_bytes_per_token(cfg) == 24576
    assert 16 * D.kv_bytes_per_token(cfg) == 393216
    assert D.conv_state_bytes(cfg) == 294912 < 393216


def test_lockstep_on_the_cpu_serves_lfm2_eagerly():
    cfg = _cfg()
    params = _model(cfg)
    ls = Lockstep(params, cfg, 2, cfg.max_seq, torch.device("cpu"))
    assert ls.graphs is None and ls.prefill_graphs is None
    assert set(ls.cache) == {"k", "v", "pos", "conv"}
    logits, k, v, conv = ls.prefill(list(range(5)))
    ls.install(1, k[:, 0], v[:, 0], 5, conv[:, 0])
    assert ls.step([0, 3], [False, True]).shape == (2,)
    assert ls.cache["pos"].tolist() == [0, 6]


def test_lfm2_serving_refuses_a_mesh():
    cfg = _cfg()
    with pytest.raises(ValueError, match="one device"):
        D.init_cache(cfg, 2, 8, "cpu", mesh=object())


ENGINE_CODE = r"""
import json, sys
import torch
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch.models import decode as D
from brpc_tpu_torch.models import transformer as T
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.server import Server, ServerOptions
from brpc_tpu_torch.serving import ServingEngine
from brpc_tpu_torch.serving.kv_cache import KvBlockPlane

model, prompts, news = json.loads(sys.argv[1])
cfg = T.ModelConfig(dtype=torch.float32, **dict(model, layer_kinds=tuple(
    model["layer_kinds"])))
assert tpu_plane.init(), tpu_plane.error()
block = 16 * D.kv_bytes_per_token(cfg)
engine = ServingEngine(cfg=cfg, device="cpu", n_slots=2, max_waiting=4,
                       kv=KvBlockPlane(block_bytes=block, n_blocks=64))
server = Server(ServerOptions(
    method_max_concurrency={"LLM.Generate": engine.method_cap}))
engine.register(server)
addr = f"127.0.0.1:{server.start('127.0.0.1:0')}"
engine.start()
ch = Channel(addr, ChannelOptions(timeout_ms=60000, max_retry=0))
served = []
for prompt, new in zip(prompts, news):
    _, st = ch.create_stream("LLM.Generate", json.dumps(
        {"prompt": prompt, "max_new_tokens": new}).encode())
    toks = []
    while True:
        b = st.read(timeout_s=60)
        if b is None:
            break
        toks.append(int.from_bytes(b, "little"))
    st.destroy()
    served.append(toks)
ch.close()
stats = engine.stats()
engine.stop()
engine.assert_drained()
server.destroy()
print("RESULT " + json.dumps({"served": served, "stats": stats}))
"""

ROUTE_CODE = r"""
import json, sys
import numpy as np
import torch
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch.models import decode as D
from brpc_tpu_torch.models import transformer as T
from brpc_tpu_torch.serving.kv_cache import KvBlockPlane

model = json.loads(sys.argv[1])
cfg = T.ModelConfig(dtype=torch.bfloat16, **dict(model, layer_kinds=tuple(
    model["layer_kinds"])))
assert tpu_plane.init(), tpu_plane.error()
params = T.init(torch.Generator().manual_seed(2), cfg, "cpu")
toks = torch.arange(23)[None] % cfg.vocab
_, k, v, conv = D.prefill(params, toks, cfg)
k, v, conv = k[:, 0], v[:, 0], conv[:, 0]
out = {}
for route in ("device", "host"):
    kv = KvBlockPlane(block_bytes=4096, n_blocks=64, decode_device=0)
    assert kv.device_route("cpu")   # the fake's blocks are host memory
    wire = D.kv_to_bytes(k, v, "cpu" if route == "device" else None, conv)
    assert len(wire) == 23 * D.kv_bytes_per_token(cfg) + \
        D.conv_state_bytes(cfg)
    kv.seq_alloc(1, wire)
    kv.seq_migrate(1)
    fetched = kv.seq_fetch(1)
    k2, v2, conv2 = D.kv_from_bytes(fetched, cfg, 23)
    cache = D.init_cache(cfg, 2, 32, "cpu")
    D.install(cache, 1, k2, v2, 23, conv=conv2)
    kv.seq_free(1)
    kv.assert_balanced()
    out[route] = (torch.equal(cache["conv"][:, 1], conv)
                  and torch.equal(cache["k"][:, 1, :23], k)
                  and torch.equal(cache["v"][:, 1, :23], v)
                  and int(cache["pos"][1]) == 23
                  and bool(cache["conv"][:, 1].abs().sum() > 0))
print("RESULT " + json.dumps(out))
"""


def _subprocess(code, *args, env=None):
    _native.build_core()
    env = dict(os.environ, TRPC_CUDA_DRIVER=_native.build_fake_driver(),
               **(env or {}))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code, *args], env=env,
                       capture_output=True, text=True, timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and lines, \
        f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-4000:]}"
    return json.loads(lines[-1][len("RESULT "):])


def _model_json(cfg_dict):
    return json.dumps(dict(cfg_dict, layer_kinds=list(
        cfg_dict["layer_kinds"])))


def test_the_engine_serves_the_reference_greedy_tokens():
    """Three requests through ``ServingEngine`` (two slots, so a slot is
    reused) on the CPU: every served token is the reference's greedy
    token teacher-forced on the prompt and the tokens before it (gap
    under 1e-4, f32's reordering), the counters count each token's
    top-k assignments once in every MoE layer (prefill rows and active
    slots alone) and drop none, and each admit routes one conv state."""
    cfg = _cfg()
    prompts = [[5, 9], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [42]]
    news = [6, 4, 9]
    out = _subprocess(ENGINE_CODE, json.dumps(
        [json.loads(_model_json(MODEL)), prompts, news]))
    model = _model(cfg)          # the engine's: seed 0
    w = _weights(model)
    for prompt, new, toks in zip(prompts, news, out["served"]):
        assert len(toks) == new
        gaps = lfm2_served.served_gaps(w, _m(cfg), prompt, toks)
        assert max(gaps) < 1e-4, gaps
    st = out["stats"]
    tokens = sum(len(p) for p in prompts) + sum(n - 1 for n in news)
    assert [sum(c) for c in st["moe_assignments"]] == \
        [tokens * cfg.moe_topk] * 4
    assert st["moe_dropped"] == 0
    assert st["conv_state_bytes"] == 3 * D.conv_state_bytes(cfg)
    assert st["prefills"] == 3 and st["prefill_graphed"] == 0


def test_the_conv_state_crosses_the_route_bit_for_bit():
    """A bf16 prefill's K/V and conv state through ``kv_to_bytes``, the
    plane's blocks (the device route over the fake's host memory, and
    the host route), ``kv_from_bytes`` and ``install``: the cache holds
    the prefill's bits (bf16 -> f32 -> bf16 is exact)."""
    out = _subprocess(ROUTE_CODE, _model_json(MODEL))
    assert out == {"device": True, "host": True}


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and its driver (libcuda.so.1)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("heads", [(32, 8), (8, 8), (4, 1)],
                         ids=["gqa32x8", "mha8", "mqa4"])
def test_gqa_kernel_matches_plain_on_the_card(dtype, heads):
    """The kernel at KV < H (and KV == H) against the plain version: o
    within the card tolerance of tests/test_torch_decode_attention.py,
    the caches bit for bit (one writer a row: the KV head's rows appended
    once, nothing else touched)."""
    _card()
    H, KV = heads
    N, S, hd = 6, 700, 64
    gen = torch.Generator().manual_seed(H + KV)
    q = torch.randn(N, H, hd, generator=gen)
    kn, vn = (torch.randn(N, KV, hd, generator=gen) for _ in range(2))
    kc, vc = (torch.randn(N, S, KV, hd, generator=gen) for _ in range(2))
    p = torch.tensor([0, 1, 63, 300, 698, S - 1], dtype=torch.int32)
    args = [t.to(dtype) for t in (q, kn, vn, kc, vc)] + [p]
    want_kc, want_vc = args[3].clone(), args[4].clone()
    want = decode_attention_plain(args[0], args[1], args[2], want_kc,
                                  want_vc, p)
    card = [t.cuda() for t in args]
    before = decode_attention.launches
    got = decode_attention(*card)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    tol = (dict(atol=4e-3, rtol=1e-2) if dtype == torch.bfloat16
           else dict(atol=1e-5, rtol=1e-5))
    torch.testing.assert_close(got.cpu().float(), want.float(), **tol)
    assert torch.equal(card[3].cpu(), want_kc)
    assert torch.equal(card[4].cpu(), want_vc)


def _card_cfg():
    return T.ModelConfig(dtype=torch.bfloat16, **CARD)


@pytest.mark.cuda
def test_lfm2_step_graphs_match_the_eager_step_on_the_card():
    """Eight graphed steps against the eager step on a twin cache: the
    same logits, pos, K/V and conv state bit for bit, an install and a
    reset between steps included; one decode-attention launch an
    attention layer a step; 3 graphs for 2 attention layers."""
    _card()
    cfg = _card_cfg()
    model = _model(cfg, dev="cuda")
    lfm2.hold_products(model, cfg)
    seqs = _sequences(cfg, 4, 40, 11).cuda()
    cache = D.init_cache(cfg, 4, cfg.max_seq, "cuda")
    for slot, plen in ((0, 1), (1, 17), (2, 30)):
        _, k, v, conv = D.prefill(model, seqs[slot:slot + 1, :plen], cfg)
        D.install(cache, slot, k[:, 0], v[:, 0], plen, conv=conv[:, 0])
    twin = {key: t.clone() for key, t in cache.items()}
    active = torch.tensor([True, True, True, False], device="cuda")
    graphs = D.StepGraphs(model, cache, cfg)
    assert len(graphs.graphs) == 3
    for step in range(8):
        if step == 4:          # slot 3 admitted, slot 1 retired
            _, k, v, conv = D.prefill(model, seqs[3:4, :5], cfg)
            for c in (cache, twin):
                D.install(c, 3, k[:, 0], v[:, 0], 5, conv=conv[:, 0])
                D.reset_slot(c, 1)
            active[3], active[1] = True, False
        tokens = seqs[:, 30 + step]
        before = decode_attention.launches
        got = graphs.run(tokens, active)
        assert decode_attention.launches == before + 2
        want, _ = D.decode_step(model, twin, tokens, active, cfg)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (step, float((got - want).abs().max()))
        for key in ("k", "v", "pos", "conv"):
            assert torch.equal(cache[key], twin[key]), (step, key)
    assert (graphs.captures, graphs.steps) == (1, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 127, 129, 200, 256])
def test_lfm2_prefill_graphs_match_their_segments_on_the_card(n):
    """The graphs of the padded length of n against the same segments run
    eagerly: logits, K/V and conv state bit for bit, whatever the padding
    holds; one causal launch an attention layer; within bf16's rounding
    of ``prefill`` at the prompt's own length."""
    _card()
    from brpc_tpu_torch.ops.causal_attention import causal_attention_forward
    cfg = _card_cfg()
    model = _model(cfg, seed=12, dev="cuda")
    lfm2.hold_products(model, cfg)
    graphs = D.PrefillGraphs(model, cfg, cfg.max_seq)
    tokens = _sequences(cfg, 1, n, n)[0].cuda()
    want = [t.clone() for t in _padded_prefill(
        model, cfg, tokens, D.prefill_buffers(model, cfg, cfg.max_seq))]
    for pad in range(2):
        if pad:
            graphs.bufs["tokens"].random_(0, 7)
            for name in ("x", "q", "o", "kr", "vr"):
                graphs.bufs[name].normal_()
        before = causal_attention_forward.launches
        got = graphs.run(tokens)
        assert causal_attention_forward.launches == before + 2
        torch.cuda.synchronize()
        assert len(got) == 4
        for g, w in zip(got, want):
            assert torch.equal(g, w), (pad, float((g.float() - w.float())
                                                  .abs().max()))
    eager = D.prefill(model, tokens[None], cfg)
    for g, w in zip(got, eager):
        torch.testing.assert_close(g.float(), w.float(), atol=3e-2,
                                   rtol=2e-2)


@pytest.mark.cuda
def test_one_graphed_lfm2_step_makes_no_host_sync():
    _card()
    cfg = _card_cfg()
    model = _model(cfg, seed=13, dev="cuda")
    lfm2.hold_products(model, cfg)
    cache = D.init_cache(cfg, 4, cfg.max_seq, "cuda")
    graphs = D.StepGraphs(model, cache, cfg)
    tokens = torch.arange(4, device="cuda")
    active = torch.ones(4, dtype=torch.bool, device="cuda")
    graphs.run(tokens, active)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = graphs.run(tokens, active)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(logits).all()
    assert cache["pos"].tolist() == [2] * 4
