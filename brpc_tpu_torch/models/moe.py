"""The routed expert layer: the one MoE path of every block family.

A layer is told which experts it holds, ``[e0, e0 + n_held)`` of the E
its router scores.  It routes every token over all E and computes only
its held experts' part of the result, for only the assignments routed to
them: on one device it holds all E; on an expert-parallel rank its ep
block, and the caller sums the ranks' parts; in a configuration that is
one rank's share, the other ranks' part is left out.

Dropless, with static shapes and no read on the host:

* dispatch: the T x k assignments are sorted by expert on the device,
  those outside the held range last (:func:`plan`); each held expert's
  rows are one group, its end found by ``searchsorted`` (a device
  tensor), and the rows are gathered in that order;
* the held experts' products: one grouped product per weight matrix
  (:func:`grouped_mm`: ``torch._grouped_mm`` with the group ends on the
  device, in bf16 on the card; a loop over the groups, the plain
  version, elsewhere);
* combine: each row times its routing weight, and each token sums its k
  rows by a gather through the inverse permutation (no atomics, the same
  bits every run).

The grouped product leaves the rows past the last group end unwritten,
so every use of them is masked.  :class:`HeldExperts` is the whole layer
under autograd: it keeps the two first products' outputs and gathers the
input again in the backward, and its backward runs the six grouped
products of the weight and input gradients.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function


class Plan(NamedTuple):
    """Where the assignments go: ``order`` [N] (N = T x k) the flat
    assignment at each sorted row, ``rows`` [N] its token, ``inv`` [N]
    the sorted row of each flat assignment, ``valid`` [N] whether the row
    is held, ``ends`` [n_held] int64 each held expert's group end, and
    ``n_inside`` the number of assignments that fell in the held range,
    counted apart from the sort (a 0-d device tensor)."""
    order: torch.Tensor
    rows: torch.Tensor
    inv: torch.Tensor
    valid: torch.Tensor
    ends: torch.Tensor
    n_inside: torch.Tensor

    def counts(self) -> torch.Tensor:
        """Assignments per held expert [n_held] int64."""
        return torch.diff(self.ends, prepend=self.ends.new_zeros(1))

    def dropped(self) -> torch.Tensor:
        """Held assignments that no group covers (0 for a dropless
        layer)."""
        return self.n_inside - self.ends[-1]


def plan(topi: torch.Tensor, e0: int, n_held: int) -> Plan:
    """The dispatch of top-k expert ids ``topi`` [T, k] (over all E) to
    the held experts ``[e0, e0 + n_held)``."""
    k = topi.shape[-1]
    local = topi.reshape(-1) - e0
    inside = (local >= 0) & (local < n_held)
    key = torch.where(inside, local, n_held)
    skey, order = torch.sort(key, stable=True)
    ends = torch.searchsorted(
        skey, torch.arange(n_held, device=skey.device, dtype=skey.dtype),
        right=True)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    return Plan(order, order // k, inv, skey < n_held, ends, inside.sum())


def grouped_mm(a: torch.Tensor, b: torch.Tensor, ends: torch.Tensor
               ) -> torch.Tensor:
    """One product per group.  ``a`` [N, K] by ``b`` [G, K, M] -> [N, M],
    the rows of group g (``ends[g-1]:ends[g]``) times ``b[g]``, rows past
    ``ends[-1]`` unspecified; or ``a`` [K, N] by ``b`` [N, M] -> [G, K, M],
    group g's columns of ``a`` times its rows of ``b`` (an empty group's
    result unspecified).  On the card in bf16: ``torch._grouped_mm``
    (no host read); elsewhere a loop over the groups, which reads
    ``ends`` on the host."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch._grouped_mm(a, b, offs=ends.to(torch.int32))
    bounds = [0] + ends.tolist()
    if b.dim() == 3:
        out = a.new_zeros((a.shape[0], b.shape[-1]))
        for g, (s, e) in enumerate(zip(bounds, bounds[1:])):
            out[s:e] = a[s:e] @ b[g]
        return out
    return torch.stack([a[:, s:e] @ b[s:e]
                        for s, e in zip(bounds, bounds[1:])])


def _rowmask(valid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x with the rows that are not held set to 0."""
    return torch.where(valid.view(-1, *([1] * (x.dim() - 1))), x,
                       x.new_zeros(()))


def _token_sum(rows: torch.Tensor, inv: torch.Tensor, k: int,
               dtype) -> torch.Tensor:
    """[N, ...] sorted rows -> [T, ...]: each token's k rows summed (f32
    accumulation), in ``dtype``."""
    return rows[inv].unflatten(0, (-1, k)).sum(1, dtype=torch.float32) \
        .to(dtype)


class HeldExperts(torch.autograd.Function):
    """x [T, D], routing weights topw [T, k] and a :class:`Plan` ->
    the held experts' weighted sum [T, D] in x's dtype.  An expert is
    ``act(x w1, x w3) w2``: ``w1``, ``w3`` [n_held, D, F], ``w2``
    [n_held, F, D] in x's dtype; ``w3`` None for an ungated expert
    (``act`` then takes one argument)."""

    @staticmethod
    def forward(ctx, x, topw, p: Plan, act: Callable, w1, w3, w2):
        k = topw.shape[-1]
        with record_function("moe_dispatch"):
            xs = x[p.rows]
        with record_function("moe_experts"):
            h1 = grouped_mm(xs, w1, p.ends)
            h3 = None if w3 is None else grouped_mm(xs, w3, p.ends)
            del xs
            a = act(h1) if h3 is None else act(h1, h3)
            y = grouped_mm(a, w2, p.ends)
            del a
        with record_function("moe_combine"):
            ws = _rowmask(p.valid, topw.reshape(-1)[p.order])
            out = _token_sum(_rowmask(p.valid, y * ws[:, None].to(y.dtype)),
                             p.inv, k, x.dtype)
        ctx.act, ctx.k, ctx.plan = act, k, p
        ctx.save_for_backward(x, ws, w1, w3, w2, h1, h3)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, ws, w1, w3, w2, h1, h3 = ctx.saved_tensors
        p, k, act = ctx.plan, ctx.k, ctx.act
        valid = p.valid
        with record_function("moe_combine"):
            dys = dout[p.rows]
            dy = dys * ws[:, None].to(dys.dtype)
        with record_function("moe_experts"):
            g = grouped_mm(dys, w2.transpose(-1, -2), p.ends)
            del dys
            with torch.enable_grad():
                h1 = h1.detach().requires_grad_()
                if h3 is not None:
                    h3 = h3.detach().requires_grad_()
                a = act(h1) if h3 is None else act(h1, h3)
            dws = _rowmask(valid, (g.float() * a.detach().float()).sum(-1))
            dw2 = grouped_mm(a.detach().t(), dy, p.ends)
            del dy
            hs = (h1,) if h3 is None else (h1, h3)
            dhs = torch.autograd.grad(a, hs, g * ws[:, None].to(g.dtype))
            del a, g
            xs = x[p.rows]
            dws_in = [grouped_mm(xs.t(), dh, p.ends) for dh in dhs]
            del xs
            dxs = grouped_mm(dhs[0], w1.transpose(-1, -2), p.ends)
            if h3 is not None:
                dxs = dxs + grouped_mm(dhs[1], w3.transpose(-1, -2), p.ends)
        with record_function("moe_dispatch"):
            dx = _token_sum(_rowmask(valid, dxs), p.inv, k, x.dtype)
            dtopw = dws[p.inv].view(-1, k)
            empty = (p.counts() == 0).view(-1, 1, 1)
            dw1 = dws_in[0].masked_fill(empty, 0)
            dw3 = None if h3 is None else dws_in[1].masked_fill(empty, 0)
            dw2 = dw2.masked_fill(empty, 0)
        return dx, dtopw.to(ws.dtype), None, None, dw1, dw3, dw2


def gelu(h):
    return F.gelu(h, approximate="tanh")


def swiglu(h1, h3):
    return F.silu(h1) * h3


def held_experts(x, topw, topi, e0: int, act: Callable, w1, w3, w2,
                 stats: Optional["ExpertStats"] = None, layer: int = 0):
    """The routed expert layer on x [T, D] in the products' dtype:
    ``topi`` [T, k] the chosen experts over all E, ``topw`` [T, k] their
    weights; the held experts ``e0 .. e0 + len(w1)``.  ``stats`` (if
    given) adds the layer's counts on the device."""
    with record_function("moe_dispatch"):
        p = plan(topi, e0, w1.shape[0])
    if stats is not None:
        stats.add(layer, p)
    return HeldExperts.apply(x, topw, p, act, w1, w3, w2)


class ExpertStats:
    """The held experts' assignments per MoE layer [n_layers, n_held] and
    the dropped assignments, summed on the device since the last reset
    (allocated at the first layer's plan, on its device); :meth:`read` is
    the only host read."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        self.counts: Optional[torch.Tensor] = None
        self.dropped: Optional[torch.Tensor] = None

    def add(self, layer: int, p: Plan) -> None:
        with torch.no_grad():
            if self.counts is None or self.counts.device != p.ends.device:
                self.counts = p.ends.new_zeros((self.n_layers,
                                                p.ends.numel()))
                self.dropped = p.ends.new_zeros(())
            self.counts[layer] += p.counts()
            self.dropped += p.dropped()

    def read(self) -> dict:
        if self.counts is None:
            return {"moe_assignments": [], "moe_dropped": 0}
        return {"moe_assignments": self.counts.tolist(),
                "moe_dropped": int(self.dropped)}

    def reset(self) -> None:
        self.counts = self.dropped = None
