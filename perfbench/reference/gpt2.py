"""Plain GPT-2 in PyTorch, f32 with TF32 off: the yardstick the program's
outputs are judged by.

The block is GPT-2's as the port runs it: pre-LayerNorm (eps 1e-5),
learned positions, tanh GELU, an MLP of width d_ff, embeddings tied to
the output head, no biases (the port's departure from GPT-2, stated in
each configuration file), scores scaled by 1/sqrt(hd) under a causal
mask.  Written from that description with plain matmuls; it shares no
code with the program.

``fp8=True`` is the control: every product takes its two operands
rounded to float8 e4m3 (one scale per tensor, its largest magnitude at
448) and sums in f32, the next precision below the bf16 products the
configurations state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and convolutions while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 at one scale for the tensor; gradients pass
    straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def _mm(a, b, fp8: bool):
    if fp8:
        a, b = fp8_round(a), fp8_round(b)
    return a @ b


def _layernorm(x, g, b):
    m = x.mean(-1, keepdim=True)
    v = (x - m).pow(2).mean(-1, keepdim=True)
    return (x - m) / torch.sqrt(v + 1e-5) * g + b


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x.pow(3))))


def forward(w: Dict[str, torch.Tensor], tokens: torch.Tensor, m: Dict,
            fp8: bool = False) -> torch.Tensor:
    """tokens [B, T] -> f32 logits [B, T, vocab]."""
    B, T = tokens.shape
    D, H = m["d_model"], m["n_heads"]
    hd = D // H
    x = w["embed"][tokens] + w["pos"][:T]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for i in range(m["n_layers"]):
        h = _layernorm(x, w["blocks.ln1_g"][i], w["blocks.ln1_b"][i])
        q, k, v = (_mm(h, w[f"blocks.w{n}"][i].reshape(D, D), fp8)
                   .view(B, T, H, hd).transpose(1, 2) for n in "qkv")
        s = _mm(q, k.transpose(-1, -2), fp8) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        o = _mm(p, v, fp8).transpose(1, 2).reshape(B, T, D)
        x = x + _mm(o, w["blocks.wo"][i].reshape(D, D), fp8)
        h = _layernorm(x, w["blocks.ln2_g"][i], w["blocks.ln2_b"][i])
        x = x + _mm(_gelu(_mm(h, w["blocks.w1"][i], fp8)),
                    w["blocks.w2"][i], fp8)
    x = _layernorm(x, w["ln_f.g"], w["ln_f.b"])
    return _mm(x, w["embed"].t(), fp8)


# -- serving: served tokens, teacher-forced -----------------------------------


@torch.no_grad()
def served_gaps(w, m: Dict, prompt: Sequence[int], served: Sequence[int],
                control: bool = False) -> List[float]:
    """For each served token, by how much its logit lies below the
    reference's best at that position (0 where it is the reference's
    greedy token).  With ``control`` the token judged at each position
    is the one the fp8 control puts first, not the served one."""
    dev = w["embed"].device
    seq = torch.tensor(list(prompt) + list(served)[:-1], device=dev)[None]
    with exact_f32():
        ref = forward(w, seq, m)[0, len(prompt) - 1:]
        if control:
            pick = forward(w, seq, m, fp8=True)[0, len(prompt) - 1:]
            tok = pick.argmax(-1)
        else:
            tok = torch.tensor(list(served), device=dev)
    gaps = ref.max(-1).values - ref.gather(-1, tok[:, None])[:, 0]
    return gaps.tolist()


# -- training: three AdamW steps ----------------------------------------------


def train_steps(w: Dict[str, torch.Tensor], batches: Sequence[torch.Tensor],
                m: Dict, opt: Dict, rows: int, fp8: bool = False,
                keep_rows: Optional[int] = None,
                against: Optional[Dict[str, torch.Tensor]] = None,
                keep_grad1: bool = False) -> Dict:
    """AdamW steps from the weights `w` (updated in place) over
    `batches` [B, S+1]: next-token cross-entropy, the mean over B x S,
    worked out `rows` sequences at a time and summed.  Returns each
    step's loss, each leaf's gradient norm at the first step, and the
    norm of each leaf's change after the last; with `against` ({leaf:
    another first gradient}) also the norm of each leaf's difference
    from it (``grad1_diff``), and with ``keep_grad1`` the first
    gradient itself, on the host (``grad1_vec``).  ``keep_rows`` leaves
    the other rows out and takes the mean over the kept ones (a planted
    fault)."""
    b1, b2 = opt["betas"]
    lr, eps, wd = opt["lr"], opt["eps"], opt["weight_decay"]
    start = {k: v.detach().clone() for k, v in w.items()}
    params = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    m1 = {k: torch.zeros_like(v) for k, v in params.items()}
    m2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1, diff, vec = [], {}, {}, {}
    with exact_f32():
        for t, batch in enumerate(batches, start=1):
            if keep_rows is not None:
                batch = batch[:keep_rows]
            B, n = batch.shape[0], batch[:, 1:].numel()
            total = 0.0
            for r in range(0, B, rows):
                blk = batch[r:r + rows]
                logits = forward(params, blk[:, :-1], m, fp8)
                loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                       blk[:, 1:].reshape(-1),
                                       reduction="sum") / n
                loss.backward()
                total += float(loss.detach())
                del logits, loss
            losses.append(total)
            with torch.no_grad():
                for k, p in params.items():
                    g = p.grad
                    if t == 1:
                        grad1[k] = float(g.norm())
                        if against is not None:
                            diff[k] = float((g - against[k].to(g.device))
                                            .norm())
                        if keep_grad1:
                            vec[k] = g.detach().cpu()
                    m1[k].mul_(b1).add_(g, alpha=1 - b1)
                    m2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    p.mul_(1 - lr * wd)
                    denom = (m2[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                    p.addcdiv_(m1[k], denom, value=-lr / (1 - b1 ** t))
                    p.grad = None
    change = {k: float((params[k].detach() - start[k]).norm())
              for k in params}
    return {"losses": losses, "grad1": grad1, "change": change,
            "grad1_diff": diff, "grad1_vec": vec}
