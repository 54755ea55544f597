"""Served tokens of an lfm2 configuration scored by the plain reference
(``lfm2_moe.forward``, f32 with TF32 off), teacher-forced on the prompt
and the served tokens: what ``gpt2.served_gaps`` does for GPT-2.

The reference sees the whole sequence at once, with no cache, no conv
state and no batching; the program prefilled the prompt and decoded
each token through its slot's cache.  Each sequence is its own forward,
so that one sequence's logits [T, vocab] are all it holds at a time.

`correct` holds two means of the gaps (:func:`gap_numbers`), not their
largest: on random weights bf16 alone moves the greedy token at about
half the positions, and the largest gap over thousands of tokens sits
near the best logit whatever the fault.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from . import lfm2_moe
from .gpt2 import exact_f32, fp8_round
from .lfm2_moe import forward


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``fp8_round`` that passes an empty operand as it is: the control's
    routing can leave an expert no row of a sequence, and ``fp8_round``
    cannot take the scale of an empty tensor."""
    return x if x.numel() == 0 else fp8_round(x)


@torch.no_grad()
def served_gaps(w: Dict[str, torch.Tensor], m: Dict, prompt: Sequence[int],
                served: Sequence[int], control: bool = False) -> List[float]:
    """For each served token, by how much its logit lies below the
    reference's best at that position (0 where it is the reference's
    greedy token).  With ``control`` the token judged at each position
    is the one the fp8 control (every product's operands in float8
    e4m3) puts first, not the served one."""
    dev = w["embed"].device
    seq = torch.tensor(list(prompt) + list(served)[:-1], device=dev)[None]
    at = len(prompt) - 1
    with exact_f32():
        ref = forward(w, seq, m)[0, at:]
        if control:
            lfm2_moe.fp8_round = _fp8_round
            try:
                tok = forward(w, seq, m, fp8=True)[0, at:].argmax(-1)
            finally:
                lfm2_moe.fp8_round = fp8_round
        else:
            tok = torch.tensor(list(served), device=dev)
    gaps = ref.max(-1).values - ref.gather(-1, tok[:, None])[:, 0]
    return gaps.tolist()


def gap_numbers(streams: Sequence[Sequence[float]],
                conv_width: int) -> Dict[str, float]:
    """The numbers `correct` holds of the sample's streams of gaps
    (``served_gaps``'s, one list a stream; inf for none):

    * ``mean_gap``: the mean over every served token;
    * ``handoff_gap``: the mean over each stream's tokens 1 to
      conv_width - 1 (counted from 0), those of the decode steps whose
      convolution reads the conv state installed from the prefill (token
      0 comes from the prefill's own logits)."""
    every = [g for s in streams for g in s]
    handoff = [g for s in streams for g in s[1:conv_width]]
    return {"mean_gap": sum(every) / len(every) if every else math.inf,
            "handoff_gap": (sum(handoff) / len(handoff) if handoff
                            else math.inf)}
