"""The one traffic generator: it turns a mix file's parameters and a seed
into requests (serving) or the seeds of token batches (training).

Every seed gets the same requests in the same order: lengths at the
quantiles of the mix's distributions, each round paired and ordered by
a fixed generator; the seed draws only the token ids (and the weights).
A closed loop's window holds about two rounds of requests, and which
of them end inside it is set by their order: a seed that reordered them
changed the window's work by about 6% (PERF.md, the chat cell), so the
order is not the seed's, and a run's spread is the system's.

numpy and the standard library only: the load generator's process
imports this module and nothing of torch.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np

SEED_MASK = (1 << 63) - 1


def quantile_lengths(spec: Dict, n: int) -> List[int]:
    """n lengths at the quantiles (i + 1/2) / n of the spec's
    distribution, clipped to [min, max]: "lognormal" (median, sigma) or
    "uniform" (min, max)."""
    lo, hi = int(spec["min"]), int(spec["max"])
    out = []
    for i in range(n):
        q = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            x = spec["median"] * math.exp(spec["sigma"]
                                          * NormalDist().inv_cdf(q))
        elif spec["dist"] == "uniform":
            x = lo + q * (hi - lo)
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(min(hi, max(lo, int(round(x)))))
    return out


def serve_requests(mix: Dict) -> List[Dict]:
    """The mix's request pool in the order the clients send it: client c
    sends requests c, c + clients, c + 2 clients, ... one at a time.
    Each is {"index", "client", "prompt_len", "max_new_tokens"}.

    The pool is made of rounds, one request a client each, and every
    round holds the same lengths: the distributions' quantiles at
    (i + 1/2) / clients, prompts and outputs paired in another order
    each round.  The orders come from a fixed generator, the same for
    every seed, so every run fills its batch and refills its slots with
    the same lengths in the same order."""
    clients, n = int(mix["clients"]), int(mix["pool"])
    plens = np.array(quantile_lengths(mix["prompt_len"], clients))
    outs = np.array(quantile_lengths(mix["output_len"], clients))
    fixed = np.random.default_rng(0)
    cap = int(mix["max_total"])
    reqs = []
    for r in range(-(-n // clients)):
        po, oo = fixed.permutation(clients), fixed.permutation(clients)
        for c in range(clients):
            j = r * clients + c
            if j >= n:
                break
            p = int(plens[po[c]])
            reqs.append({"index": j, "client": c, "prompt_len": p,
                         "max_new_tokens": int(min(outs[oo[c]], cap - p))})
    return reqs


def prompt_tokens(seed: int, index: int, length: int, vocab: int
                  ) -> List[int]:
    """The token ids of request `index`: uniform over the vocabulary."""
    rng = np.random.default_rng([seed & SEED_MASK, 2, index])
    return rng.integers(0, vocab, length).tolist()


def check_sample(seed: int, finished: List[Dict], k: int) -> List[Dict]:
    """k of the finished requests drawn from the seed, the one that
    served most tokens always among them."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r["tokens"]), r["index"]))
    rest = sorted((r for r in finished if r is not longest),
                  key=lambda r: r["index"])
    rng = np.random.default_rng([seed & SEED_MASK, 3])
    pick = rng.permutation(len(rest))[:max(0, k - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


def stream_seed(seed: int, stream: int) -> int:
    """A seed for a torch generator, one per stream of draws (weights 0,
    token batches 1), so that the streams do not overlap."""
    return int(np.random.default_rng([seed & SEED_MASK, 4, stream])
               .integers(0, 1 << 62))
