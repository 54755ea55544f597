"""The decode step's and the prefill's CUDA graphs
(brpc_tpu_torch/models/decode.py).

``decode_step`` and ``prefill`` launch every operation from Python.
``StepGraphs`` is the same step for one cache on one card: its work
between the attention launches replayed as n_layers + 1 captured graphs,
with ``decode_attention`` launched from Python between them.
``PrefillGraphs`` is the same prefill, one set of graphs for each padded
length 128, 256, ... up to ``max_len``, the causal kernel launched
between them at the prompt's own length.  The serving engine's
``Lockstep`` holds one of each on a card without a mesh.

On the CPU: the split itself (``_segments`` run in order, the attention
between them, its output copied into the next one's input) gives
``decode_step``'s bits at tiny_config and at a bf16 hd-64 shape; the
prefill's padded lengths; the prefill's segments run eagerly at a padded
length, the attention at the prompt's, give ``prefill``'s rows, and the
padding's content changes no valid bit; a CPU ``Lockstep``, on one
device or a mesh of one, holds no graphs, counts no graphed step or
prefill and prefills with ``prefill``'s bits; the serving engine's
``stats()`` carries ``step_graphed``, ``step_captures``,
``prefill_graphed`` and ``prefill_captures`` (a subprocess over the fake
libcuda); and ``prefill``'s last-position logits are the training
forward's, the three paths sharing one block.

The ``cuda`` legs run ``StepGraphs`` on the card against ``decode_step``
on a twin cache, bit for bit (tokens, logits, ``pos``, cache rows), at
tiny_config (hd 16, f32) and at a 4-layer hd-64 GPT-2 shape in bf16, 8
slots with some inactive, an install and a reset between steps; they
count the kernel's launches, hold logits returned at one step through
the next, and give each Lockstep's cache, and each change of a weight's
address, its own capture.  The prefill's run ``PrefillGraphs`` at a
4-layer hd-64 bf16 shape with max_len 1024 against its segments run
eagerly at the same padded length, bit for bit, at prompts of 1, 127,
128, 129, 700 and 1023 tokens, whatever the padding holds, and against
``prefill`` within bf16's rounding; a prompt beyond the largest padded
length runs eagerly and is not counted; a moved weight recaptures; the
engine on the card counts every installed prefill as graphed.  On the
card:
``python -m pytest --noconftest -m cuda tests/test_torch_decode_graph.py``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from brpc_tpu_torch import _native
from brpc_tpu_torch.models import decode as D
from brpc_tpu_torch.models import transformer as T
from brpc_tpu_torch.models.transformer import ModelConfig
from brpc_tpu_torch.ops.causal_attention import causal_attention_forward
from brpc_tpu_torch.ops.decode_attention import decode_attention
from brpc_tpu_torch.parallel import make_mesh
from brpc_tpu_torch.serving.engine import tiny_config
from brpc_tpu_torch.serving.lockstep import Lockstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = 8
# (slot, prompt length) installed before the first step; slots 6 and 7
# stay empty, and slot 2 reaches p = S-1
PROMPTS = ((0, 1), (1, 9), (2, 60), (3, 17), (4, 30), (5, 3))
INACTIVE = (3, 6, 7)
CONFIGS = {
    "tiny_hd16": lambda: tiny_config(),
    "gpt2_hd64_bf16": lambda: ModelConfig(
        vocab=512, d_model=256, n_heads=4, n_layers=4, d_ff=1024,
        max_seq=64, n_experts=0, dtype=torch.bfloat16),
}
# the prefill's: two padded lengths (128, 256) on the CPU in f32, and
# gpt2-large's max_len of 1024 (eight) at a 4-layer bf16 shape on the card
PREFILL_CPU = lambda: tiny_config(max_seq=256)  # noqa: E731
PREFILL_CARD = lambda: ModelConfig(  # noqa: E731
    vocab=512, d_model=256, n_heads=4, n_layers=4, d_ff=1024, max_seq=1024,
    n_experts=0, dtype=torch.bfloat16)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and its driver (libcuda.so.1)")


def _served(cfg, dev, seed=0):
    """A model and a cache of SLOTS slots with PROMPTS installed, and the
    active mask."""
    gen = torch.Generator().manual_seed(seed)
    model = T.init(gen, cfg, dev)
    cache = D.init_cache(cfg, SLOTS, cfg.max_seq, dev)
    for slot, plen in PROMPTS:
        toks = torch.randint(0, cfg.vocab, (1, plen), generator=gen)
        _, k, v = D.prefill(model, toks, cfg)
        D.install(cache, slot, k[:, 0], v[:, 0], plen)
    active = torch.ones(SLOTS, dtype=torch.bool, device=dev)
    active[list(INACTIVE)] = False
    return model, cache, active, gen


def _twin(cache):
    return {key: t.clone() for key, t in cache.items()}


def _same_state(a, b):
    for key in ("k", "v", "pos"):
        assert torch.equal(a[key], b[key]), key


@torch.no_grad()
def _split_step(model, cache, tokens, active, cfg):
    """The graphs' order of work run eagerly: each segment of
    ``_segments`` in turn, ``decode_attention`` between them."""
    tokens_in = tokens.clone()
    active_in = active.to(torch.int32)
    _, N, _, H, hd = cache["k"].shape
    o = torch.zeros((N, H, hd), dtype=cfg.dtype)
    segs = D._segments(model, cache, cfg, tokens_in, active_in, o)
    outs = segs[0]()
    p = outs[4]
    for i in range(cfg.n_layers):
        _, q, k_new, v_new = outs[:4]
        o.copy_(decode_attention(q, k_new, v_new, cache["k"][i],
                                 cache["v"][i], p))
        outs = segs[i + 1](*outs)
    return outs


@torch.no_grad()
def _padded_prefill(model, cfg, tokens, bufs):
    """``PrefillGraphs.run``'s order of work run eagerly on `bufs`: the
    segments of the prompt's padded length in turn, the causal attention
    at the prompt's own length between them."""
    n = tokens.numel()
    S = D.prefill_bucket(n, bufs["tokens"].shape[1])
    segs = D._prefill_segments(model, cfg, bufs, S)
    bufs["tokens"][0, :n].copy_(tokens)
    bufs["row"].fill_(n - 1)
    q, o = bufs["q"][:, :n], bufs["o"][:, :n]
    k, v = bufs["k"][:, :, :n], bufs["v"][:, :, :n]
    segs[0]()
    for i in range(cfg.n_layers):
        o.copy_(T._causal_attention(q, k[i], v[i]))
        out = segs[i + 1]()
    return out, k, v


def _junk(bufs, gen):
    """Fill every static buffer with other content: random tokens, and
    random values where the segments write or read activations."""
    # ids below 7, which every model here has
    bufs["tokens"].copy_(torch.randint(0, 7, bufs["tokens"].shape,
                                       generator=gen))
    for name in ("x", "q", "o", "k", "v"):
        t = bufs[name]
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))


@pytest.mark.parametrize("max_len,want", [
    (1024, [128, 256, 384, 512, 640, 768, 896, 1024]),
    (1000, [128, 256, 384, 512, 640, 768, 896, 1000]),
    (256, [128, 256]),
    (128, [128]),
    (64, [64]),
])
def test_the_prefills_padded_lengths(max_len, want):
    assert D.prefill_buckets(max_len) == want


@pytest.mark.parametrize("n,max_len,want", [
    (1, 1024, 128), (127, 1024, 128), (128, 1024, 128), (129, 1024, 256),
    (700, 1024, 768), (1023, 1024, 1024), (1024, 1024, 1024),
    (1025, 1024, None), (896, 1000, 896), (897, 1000, 1000),
    (5, 64, 64), (64, 64, 64), (65, 64, None),
])
def test_a_prompt_takes_the_smallest_padded_length_that_holds_it(
        n, max_len, want):
    got = D.prefill_bucket(n, max_len)
    assert got == want
    if want is not None:
        assert got in D.prefill_buckets(max_len)


@pytest.mark.parametrize("n", [1, 37, 127, 128, 129, 200, 256])
def test_the_padded_segments_give_prefills_rows_on_the_cpu(n):
    """At a padded length, the attention at n: the last position's
    logits and the first n rows of every layer's K/V are ``prefill``'s
    (up to the products' rounding at another row count), and other
    content in every static buffer changes no bit of them."""
    cfg = PREFILL_CPU()
    gen = torch.Generator().manual_seed(n)
    model = T.init(gen, cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab, (n,), generator=gen)
    bufs = D.prefill_buffers(model, cfg, cfg.max_seq)
    got = _padded_prefill(model, cfg, tokens, bufs)
    want = D.prefill(model, tokens[None], cfg)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    got = [t.clone() for t in got]
    _junk(bufs, gen)
    again = _padded_prefill(model, cfg, tokens, bufs)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_padded_segments_at_each_config_on_the_cpu(name):
    """The serving configurations' single padded length (max_seq 64):
    ``prefill``'s logits and K/V, in f32 and in bf16 within its
    rounding."""
    cfg = CONFIGS[name]()
    gen = torch.Generator().manual_seed(5)
    model = T.init(gen, cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab, (23,), generator=gen)
    bufs = D.prefill_buffers(model, cfg, cfg.max_seq)
    _junk(bufs, gen)
    got = _padded_prefill(model, cfg, tokens, bufs)
    want = D.prefill(model, tokens[None], cfg)
    tol = (dict(atol=1e-5, rtol=1e-5) if cfg.dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **tol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_split_gives_the_eager_bits_on_the_cpu(name):
    cfg = CONFIGS[name]()
    model, cache, active, gen = _served(cfg, "cpu")
    twin = _twin(cache)
    for step in range(3):
        tokens = torch.randint(0, cfg.vocab, (SLOTS,), generator=gen)
        got = _split_step(model, cache, tokens, active, cfg)
        want, _ = D.decode_step(model, twin, tokens, active, cfg)
        assert torch.equal(got, want), step
        _same_state(cache, twin)


def test_the_cpu_step_never_captures():
    cfg = tiny_config()
    model, cache, active, gen = _served(cfg, "cpu")
    dev = Lockstep(model, cfg, SLOTS, cfg.max_seq, torch.device("cpu"))
    assert dev.graphs is None
    twin = _twin(cache)
    for _ in range(2):
        tokens = torch.randint(0, cfg.vocab, (SLOTS,), generator=gen)
        got, _ = D.decode_step(model, cache, tokens, active, cfg)
        want = _split_step(model, twin, tokens, active, cfg)
        assert torch.equal(got, want)
        _same_state(cache, twin)


@pytest.mark.parametrize("mesh", [False, True], ids=["one_device",
                                                     "mesh_of_one"])
def test_lockstep_on_the_cpu_counts_no_graphed_step(mesh):
    cfg = tiny_config()
    m = (make_mesh({"dp": 1, "tp": 1}, devices=[0], device_type="cpu")
         if mesh else None)
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu", m)
    dev = Lockstep(params, cfg, 4, cfg.max_seq, torch.device("cpu"), m)
    assert dev.ops["step_captures"] == 0
    for _ in range(3):
        dev.step([1, 2, 3, 4], [True, True, False, True])
    assert dev.ops["step"] == 3
    assert dev.ops["step_graphed"] == 0 and dev.ops["step_captures"] == 0
    assert dev.graphs is None
    assert dev.cache["pos"].tolist() == [3, 3, 0, 3]


@pytest.mark.parametrize("mesh", [False, True], ids=["one_device",
                                                     "mesh_of_one"])
def test_lockstep_on_the_cpu_prefills_eagerly(mesh):
    """No PrefillGraphs on the CPU: every prefill is ``prefill``'s, bit
    for bit, and none is counted as graphed."""
    cfg = tiny_config()
    m = (make_mesh({"dp": 1, "tp": 1}, devices=[0], device_type="cpu")
         if mesh else None)
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu", m)
    dev = Lockstep(params, cfg, 4, cfg.max_seq, torch.device("cpu"), m)
    assert dev.prefill_graphs is None
    gen = torch.Generator().manual_seed(1)
    for n in (1, 17, cfg.max_seq):
        prompt = torch.randint(0, cfg.vocab, (n,), generator=gen)
        got = dev.prefill(prompt.tolist())
        want = D.prefill(params, prompt[None], cfg, m)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert dev.prefill_replayed is False
    assert dev.ops["prefill"] == 3
    assert dev.ops["prefill_graphed"] == 0
    assert dev.ops["prefill_captures"] == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_gives_the_training_forwards_last_logits(name):
    """prefill, the training forward and the decode step share one GPT-2
    block: prefill's last-position logits are ``apply``'s."""
    cfg = CONFIGS[name]()
    gen = torch.Generator().manual_seed(3)
    model = T.init(gen, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 37), generator=gen)
    got, _, _ = D.prefill(model, toks, cfg)
    with torch.no_grad():
        want = T.apply(model, toks, cfg)[:, -1]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


ENGINE_CODE = r"""
import json, sys
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.server import Server, ServerOptions
from brpc_tpu_torch.serving import ServingEngine
from brpc_tpu_torch.serving.engine import tiny_config
from brpc_tpu_torch.serving.kv_cache import KvBlockPlane

device = sys.argv[1]
assert tpu_plane.init(), tpu_plane.error()
engine = ServingEngine(cfg=tiny_config(), device=device,
                       kv=KvBlockPlane(block_bytes=4096, n_blocks=32,
                                       decode_device=0 if device == "cuda"
                                       else None),
                       n_slots=2, max_waiting=4)
server = Server(ServerOptions(
    method_max_concurrency={"LLM.Generate": engine.method_cap}))
engine.register(server)
addr = f"127.0.0.1:{server.start('127.0.0.1:0')}"
engine.start()
before = engine.stats()
ch = Channel(addr, ChannelOptions(timeout_ms=60000, max_retry=0))
_, st = ch.create_stream("LLM.Generate", json.dumps(
    {"prompt_len": 6, "max_new_tokens": 5}).encode())
tokens = 0
while st.read(timeout_s=60) is not None:
    tokens += 1
st.destroy()
for plen in (3, 40):
    _, st = ch.create_stream("LLM.Generate", json.dumps(
        {"prompt_len": plen, "max_new_tokens": 2}).encode())
    while st.read(timeout_s=60) is not None:
        tokens += 1
    st.destroy()
ch.close()
engine.stop()
after = engine.stats()
server.destroy()
print("RESULT " + json.dumps({"before": before, "after": after,
                              "tokens": tokens}))
"""


def _engine_run(device, env):
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", ENGINE_CODE, device], env=env,
                       capture_output=True, text=True, timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and lines, \
        f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-4000:]}"
    out = json.loads(lines[-1][len("RESULT "):])
    assert out["tokens"] == 5 + 2 + 2
    assert out["after"]["prefills"] == 3
    assert out["after"]["steps"] >= 4
    return out


def test_the_engine_stats_carry_both_counters():
    _native.build_core()
    out = _engine_run("cpu", dict(
        os.environ, TRPC_CUDA_DRIVER=_native.build_fake_driver()))
    for when in ("before", "after"):
        for key in ("step_graphed", "step_captures", "prefill_graphed",
                    "prefill_captures"):
            assert out[when][key] == 0, (when, key)


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graphed_steps_match_the_eager_body_on_the_card(name):
    """Eight graphed steps against decode_step on a twin cache: the same
    logits, tokens, pos and cache rows, bit for bit; an install and a
    reset between steps reach the next replay; n_layers launches of the
    kernel a step; logits returned at one step survive the next."""
    _card()
    cfg = CONFIGS[name]()
    model, cache, active, gen = _served(cfg, "cuda")
    twin = _twin(cache)
    graphs = D.StepGraphs(model, cache, cfg)
    _same_state(cache, twin)        # the capture moves no state
    kept = None
    for step in range(8):
        if step == 4:      # a new sequence in slot 6, slot 1 retired
            toks = torch.randint(0, cfg.vocab, (1, 23), generator=gen)
            _, k, v = D.prefill(model, toks, cfg)
            for c in (cache, twin):
                D.install(c, 6, k[:, 0], v[:, 0], 23)
                D.reset_slot(c, 1)
            active[6], active[1] = True, False
        tokens = torch.randint(0, cfg.vocab, (SLOTS,), generator=gen)
        before = decode_attention.launches
        got = graphs.run(tokens, active)
        assert decode_attention.launches == before + cfg.n_layers
        want, _ = D.decode_step(model, twin, tokens, active, cfg)
        torch.cuda.synchronize()
        assert torch.equal(got, want), \
            (step, float((got - want).abs().max()))
        assert torch.equal(got.argmax(-1), want.argmax(-1)), step
        _same_state(cache, twin)
        if kept is not None:
            assert torch.equal(kept[0], kept[1]), step
        kept = (got, got.clone())
    assert (graphs.captures, graphs.steps) == (1, 8)


@pytest.mark.cuda
def test_each_cache_and_each_weight_address_gets_its_own_capture():
    """Two Locksteps on the card capture once each when built (the
    capture leaves pos at 0) and replay from their first step; moving a
    weight to a new address captures again, to decode_step's bits."""
    _card()
    cfg = CONFIGS["gpt2_hd64_bf16"]()
    params = T.init(torch.Generator().manual_seed(0), cfg, "cuda")
    dev = torch.device("cuda")
    a = Lockstep(params, cfg, SLOTS, cfg.max_seq, dev)
    b = Lockstep(params, cfg, SLOTS, cfg.max_seq, dev)
    assert a.graphs is not b.graphs
    for ls in (a, b):
        assert ls.ops["step_captures"] == 1 and ls.ops["step_graphed"] == 0
        assert int(ls.cache["pos"].abs().sum()) == 0
        assert (ls.graphs.captures, ls.graphs.steps) == (1, 0)
    tokens, active = [5] * SLOTS, [True] * (SLOTS - 1) + [False]
    twin = _twin(a.cache)
    nxt = a.step(tokens, active)
    b.step(tokens, active)
    for ls in (a, b):
        assert ls.ops["step_captures"] == 1 and ls.ops["step_graphed"] == 1
    want, _ = D.decode_step(params, twin, tokens, active, cfg)
    assert nxt.tolist() == want.argmax(-1).tolist()
    _same_state(a.cache, twin)

    params.blocks["w1"].data = params.blocks["w1"].data.clone()
    nxt = a.step(tokens, active)
    want, _ = D.decode_step(params, twin, tokens, active, cfg)
    assert a.ops["step_captures"] == 2 and a.ops["step_graphed"] == 2
    assert nxt.tolist() == want.argmax(-1).tolist()
    _same_state(a.cache, twin)


@pytest.fixture(scope="module")
def prefill_on_card():
    """A 4-layer bf16 model with max_seq 1024 on the card and its
    PrefillGraphs (eight padded lengths)."""
    _card()
    cfg = PREFILL_CARD()
    model = T.init(torch.Generator().manual_seed(11), cfg, "cuda")
    return cfg, model, D.PrefillGraphs(model, cfg, cfg.max_seq)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 128, 129, 700, 1023])
def test_graphed_prefill_matches_its_eager_twin_on_the_card(
        prefill_on_card, n):
    """The graphs against their segments run eagerly at the same padded
    length: the logits and the K/V's first n rows bit for bit, whatever
    the padding holds; L launches of the causal kernel, at n; within
    bf16's rounding of ``prefill`` at the prompt's own length."""
    cfg, model, graphs = prefill_on_card
    gen = torch.Generator().manual_seed(n)
    tokens = torch.randint(0, cfg.vocab, (n,), generator=gen).cuda()
    twin = D.prefill_buffers(model, cfg, cfg.max_seq)
    want = _padded_prefill(model, cfg, tokens, twin)
    for pad in range(2):
        if pad:         # other tokens and activations in every buffer
            _junk(graphs.bufs, gen)
        before = causal_attention_forward.launches
        got = graphs.run(tokens)
        assert causal_attention_forward.launches == before + cfg.n_layers
        torch.cuda.synchronize()
        assert got[0].shape == (1, cfg.vocab)
        assert got[1].shape == (cfg.n_layers, 1, n, cfg.n_heads, cfg.head_dim)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (pad, float((g.float() - w.float()
                                                   ).abs().max()))
    eager = D.prefill(model, tokens[None], cfg)
    for g, w in zip(got, eager):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), atol=3e-2,
                                   rtol=2e-2)
    assert graphs.captures == 1


@pytest.mark.cuda
def test_a_prompt_beyond_the_largest_padded_length_runs_eagerly():
    """A Lockstep whose max_len (256) is below the model's max_seq: a
    prompt of 300 tokens runs ``prefill`` and is not counted as graphed;
    one of 200 replays the graphs."""
    _card()
    cfg = PREFILL_CARD()
    params = T.init(torch.Generator().manual_seed(0), cfg, "cuda")
    ls = Lockstep(params, cfg, SLOTS, 256, torch.device("cuda"))
    assert ls.prefill_graphs.max_len == 256
    assert ls.ops["prefill_captures"] == 1
    gen = torch.Generator().manual_seed(2)
    long = torch.randint(0, cfg.vocab, (300,), generator=gen)
    got = ls.prefill(long.tolist())
    want = D.prefill(params, long[None].cuda(), cfg)
    assert ls.prefill_replayed is False
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (ls.ops["prefill"], ls.ops["prefill_graphed"]) == (1, 0)
    ls.prefill(long[:200].tolist())
    assert ls.prefill_replayed is True
    assert (ls.ops["prefill"], ls.ops["prefill_graphed"]) == (2, 1)


@pytest.mark.cuda
def test_a_moved_weight_recaptures_the_prefill():
    """Moving a weight to a new address captures every padded length
    again, and the replay reads the moved weight."""
    _card()
    cfg = PREFILL_CARD()
    model = T.init(torch.Generator().manual_seed(4), cfg, "cuda")
    graphs = D.PrefillGraphs(model, cfg, 256)
    tokens = torch.randint(0, cfg.vocab, (150,),
                           generator=torch.Generator().manual_seed(5)).cuda()
    graphs.run(tokens)
    model.blocks["w1"].data = model.blocks["w1"].data * 2
    got = [t.clone() for t in graphs.run(tokens)]
    assert (graphs.captures, graphs.prefills) == (2, 2)
    want = _padded_prefill(model, cfg, tokens,
                           D.prefill_buffers(model, cfg, 256))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_the_engine_on_the_card_graphs_every_prefill():
    _card()
    env = dict(os.environ)
    env.pop("TRPC_CUDA_DRIVER", None)
    out = _engine_run("cuda", env)
    after = out["after"]
    assert after["prefill_graphed"] == after["prefills"] == 3
    assert after["prefill_captures"] == out["before"]["prefill_captures"] == 1
    assert after["step_graphed"] == after["steps"]
