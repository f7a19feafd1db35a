"""Mixture-of-Experts in PyTorch: a top-k router, capacity-bucketed index
dispatch, shared experts (deepseek) and the dense residual (arctic, in
``models.transformer``).

Counterpart of ``repro.models.moe``. Tokens get slots in an (E, C) table by
a cumsum over one-hot picks flattened token-major (token 0's k picks, then
token 1's: GShard's capacity rule), with C = max(min_capacity,
ceil(T k capacity_factor / E)); a pick past its expert's C slots is
dropped. The table gathers the tokens into (E, C, d) (empty and dropped
slots point at a zero padding row T), three batched expert matmuls run the
SwiGLU of every expert at once, and the gate-weighted outputs are
scatter-added back in f32 (``index_add_``; on a CUDA tensor it
accumulates with atomics, so that sum is not bit-reproducible run to run)
and cast to x's dtype. The router runs in f32 on ``x.float()`` and
carries the Switch load-balance loss on the top-1 proxy. Nothing here
waits on the host: the capacity comes from the shapes.

Parameter names are the reference's pytree keys (``router.w``, ``w_gate``,
``w_up``, ``w_down``, ``shared``); the reference's stacked shared experts
(a leading ``n_shared`` axis) are one ``SwiGLU`` each here, so
``shared.{j}.gate.w`` is row j of the reference's ``shared.gate.w``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import modules as M


class MoE(nn.Module):
    """``moe_init``'s tree: ``router.w`` (d, E) in f32 whatever ``dtype``
    is, the expert stacks ``w_gate``/``w_up`` (E, d, F) and ``w_down``
    (E, F, d) in ``dtype``, and ``shared``: ``n_shared`` SwiGLUs of width
    ``shared_d_ff`` (default ``d_ff``)."""

    def __init__(self, d_model: int, n_experts: int, d_ff: int, top_k: int,
                 *, n_shared: int = 0, shared_d_ff: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.router = M.Linear(d_model, n_experts, bias=False,
                               dtype=torch.float32)
        self.w_gate = nn.Parameter(torch.empty(n_experts, d_model, d_ff,
                                               dtype=dtype))
        self.w_up = nn.Parameter(torch.empty(n_experts, d_model, d_ff,
                                             dtype=dtype))
        self.w_down = nn.Parameter(torch.empty(n_experts, d_ff, d_model,
                                               dtype=dtype))
        self.shared = nn.ModuleList(
            M.SwiGLU(d_model, shared_d_ff or d_ff, dtype=dtype)
            for _ in range(n_shared))

    def reset_parameters(self, generator: torch.Generator):
        """Every leaf lecun-normal (N(0, 1/fan_in), fan_in the second-last
        axis). The expert stacks are drawn in their own dtype, so a bf16
        stack never exists in f32; the router and the shared experts'
        linears as ``Linear`` draws them."""
        with torch.no_grad():
            for w in (self.w_gate, self.w_up, self.w_down):
                w.normal_(0.0, 1.0 / math.sqrt(w.shape[-2]),
                          generator=generator)
        for mod in self.modules():
            if isinstance(mod, M.Linear):
                mod.reset_parameters(generator)


def _router(p: MoE, x_flat: torch.Tensor, top_k: int):
    """x_flat (T, d) -> gates (T, k) f32 renormalised to sum 1, expert ids
    (T, k), and the auxiliary loss E * sum_e f_e P_e with f_e the share of
    tokens whose top-1 pick is e and P_e the mean router probability."""
    logits = x_flat.float() @ p.router.w.float()            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    me = F.one_hot(top_i[:, 0], e).float().mean(0)
    pe = probs.mean(0)
    return top_p, top_i, e * torch.sum(me * pe)


def capacity_of(tokens: int, top_k: int, n_experts: int,
                capacity_factor: float, min_capacity: int = 4) -> int:
    """Slots an expert: max(min_capacity, ceil(T k factor / E))."""
    return max(min_capacity,
               int(math.ceil(tokens * top_k * capacity_factor / n_experts)))


def dispatch_table(top_p: torch.Tensor, top_i: torch.Tensor, n_experts: int,
                   capacity: int):
    """The slot assignment of T tokens' k picks, in the reference's order:
    a pick's slot is the number of earlier picks of its expert, counting
    token-major (``top_i.reshape(-1)``). Returns ``table`` (E, C) int64 of
    source token ids, T where the slot is empty, and ``gate`` (E, C) f32,
    0 there. Picks at slot >= C are dropped: they write into a column C
    that is cut off."""
    t, k = top_i.shape
    flat_e = top_i.reshape(-1)                               # (T k,)
    onehot = F.one_hot(flat_e, n_experts)
    pos_in_e = torch.cumsum(onehot, dim=0) - 1
    slot = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = slot < capacity
    token_src = torch.arange(t, device=top_i.device).repeat_interleave(k)
    safe_e = torch.where(keep, flat_e, 0)
    safe_s = torch.where(keep, slot, capacity)
    table = torch.full((n_experts, capacity + 1), t, dtype=torch.int64,
                       device=top_i.device)
    table[safe_e, safe_s] = torch.where(keep, token_src, t)
    gate = torch.zeros((n_experts, capacity + 1), dtype=torch.float32,
                       device=top_i.device)
    gate[safe_e, safe_s] = torch.where(keep, top_p.reshape(-1).float(), 0.0)
    return table[:, :capacity], gate[:, :capacity]


def _experts(p: MoE, x_e: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its slots: x_e (..., E, C, d) -> the
    same shape, in x_e's dtype with the weights cast to it."""
    w_gate, w_up, w_down = (w.to(x_e.dtype)
                            for w in (p.w_gate, p.w_up, p.w_down))
    h = M.silu(torch.matmul(x_e, w_gate)) * torch.matmul(x_e, w_up)
    return torch.matmul(h, w_down)


def _combine(y_e: torch.Tensor, table: torch.Tensor, gate: torch.Tensor,
             t: int) -> torch.Tensor:
    """Scatter-add the gate-weighted expert outputs (E, C, d) back to their
    T tokens, in f32; row T (empty and dropped slots) is thrown away."""
    d = y_e.shape[-1]
    y = torch.zeros((t + 1, d), dtype=torch.float32, device=y_e.device)
    y.index_add_(0, table.reshape(-1),
                 (y_e * gate[..., None]).reshape(-1, d).float())
    return y[:t]


def _shared(p: MoE, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Add the shared experts, summed from zero in x's dtype as the
    reference's scan over them does."""
    if len(p.shared) == 0:
        return out
    acc = torch.zeros_like(x)
    for layer in p.shared:
        acc = acc + layer(x)
    return out + acc


def moe_apply(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, min_capacity: int = 4,
              n_groups: int = 1):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux f32 0-d). With
    ``n_groups > 1`` the tokens route in G groups, each into its own
    capacity (``_moe_apply_grouped``)."""
    if n_groups > 1:
        return _moe_apply_grouped(p, x, top_k=top_k,
                                  capacity_factor=capacity_factor,
                                  min_capacity=min_capacity,
                                  n_groups=n_groups)
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    n_experts = p.w_gate.shape[0]
    top_p, top_i, aux = _router(p, xf, top_k)
    capacity = capacity_of(t, top_k, n_experts, capacity_factor,
                           min_capacity)
    table, gate = dispatch_table(top_p, top_i, n_experts, capacity)
    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    y_e = _experts(p, x_pad[table])                          # (E, C, d)
    out = _combine(y_e, table, gate, t).reshape(b, s, d).to(x.dtype)
    return _shared(p, x, out), aux


def _moe_apply_grouped(p: MoE, x: torch.Tensor, *, top_k: int,
                       capacity_factor: float, min_capacity: int,
                       n_groups: int):
    """GShard's grouped dispatch: the T tokens in G equal groups (in token
    order), each with its own table of capacity ceil(T/G k factor / E);
    the router and its aux loss over all T at once."""
    b, s, d = x.shape
    t = b * s
    if t % n_groups:
        raise ValueError(f"{t} tokens do not split into {n_groups} groups")
    tg = t // n_groups
    n_experts = p.w_gate.shape[0]
    capacity = capacity_of(tg, top_k, n_experts, capacity_factor,
                           min_capacity)
    top_p, top_i, aux = _router(p, x.reshape(t, d), top_k)
    xg = x.reshape(n_groups, tg, d)
    tables, gates, x_e = [], [], []
    for gi in range(n_groups):
        rows = slice(gi * tg, (gi + 1) * tg)
        table, gate = dispatch_table(top_p[rows], top_i[rows], n_experts,
                                     capacity)
        x_pad = torch.cat([xg[gi], xg.new_zeros((1, d))], dim=0)
        tables.append(table)
        gates.append(gate)
        x_e.append(x_pad[table])
    y_e = _experts(p, torch.stack(x_e))                      # (G, E, C, d)
    y = torch.stack([_combine(y_e[gi], tables[gi], gates[gi], tg)
                     for gi in range(n_groups)])
    out = y.reshape(b, s, d).to(x.dtype)
    return _shared(p, x, out), aux


def moe_ref(p: MoE, x: torch.Tensor, *, top_k: int):
    """The dense oracle (no capacity, nothing dropped): every expert over
    every token, then each token's k picks summed with their gates in f32.
    O(E) work: tests and checks only."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    top_p, top_i, aux = _router(p, xf, top_k)
    y_all = _experts(p, xf.expand(p.w_gate.shape[0], -1, -1))  # (E, T, d)
    rows = torch.arange(xf.shape[0], device=x.device)
    out = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for j in range(top_k):
        out = out + top_p[:, j:j + 1] * y_all[top_i[:, j], rows].float()
    return _shared(p, x, out.reshape(b, s, d).to(x.dtype)), aux
