"""FedAvg aggregation (paper Algorithm 3, line 19: theta_agg = mean_e theta_e).

Counterpart of the host part of ``repro.core.fedavg``, all in f32:

- ``fedavg``        a list of per-client param dicts -> (weighted) mean dict
- ``fedavg_mean``   a dict of client-stacked tensors -> mean over the axis
- ``fedavg_stack``  the same mean, broadcast back over the client axis
- ``stack_replicas`` the other way: ``n`` copies on a new client axis
- ``fedavg_stack_masked`` / ``fedavg_mean_masked`` the same over the
  ACTIVE rows of a (clients,) 0/1 mask (client dropout): dropped rows keep
  their stale value, an all-masked stack passes through, and the mean falls
  back to ``fallback`` (the incoming global model) when no client is active
- ``fedavg_modules_`` the in-place form the engines use: every module's
  parameters are replaced by the mean over the modules.
- the ``fedavg_pmean*`` family, for a rank of a ``torch.distributed`` data
  group (the shard_map engines): each rank holds its (local_clients, ...)
  rows of the client stack, and the global FedAvg is a local f32
  reduction composed with ONE ``all_reduce(SUM)`` over ``group`` (every
  leaf's local sums, and the active count under a mask, in one flat f32
  buffer). The arithmetic is the reference's: ``pmean`` is the sum of the
  ranks' local means over the group's size, the masked variants sum the
  masked rows and the active count globally, and an all-masked fleet keeps
  the fallback (stale rows). ``group=None`` is the single-rank mesh: every
  collective is the identity. ``lead`` leading axes (a Monte-Carlo seed
  axis) may come before the client axis; the mask then carries them too.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def fedavg(client_params: Sequence[dict],
           weights: Optional[Sequence[float]] = None) -> dict:
    n = len(client_params)
    if weights is None:
        w = [1.0 / n] * n
    else:
        tot = float(sum(weights))
        w = [float(x) / tot for x in weights]
    out = {}
    for name, first in client_params[0].items():
        acc = torch.zeros_like(first, dtype=torch.float32)
        for wi, params in zip(w, client_params):
            acc = acc + wi * params[name].float()
        out[name] = acc.to(first.dtype)
    return out


def fedavg_mean(stacked: dict) -> dict:
    """Mean over a leading client axis, dropping the axis."""
    return {k: v.float().mean(dim=0).to(v.dtype) for k, v in stacked.items()}


def fedavg_stack(stacked: dict) -> dict:
    """Mean over a leading client axis, rebroadcast to every client."""
    return {k: v.float().mean(dim=0, keepdim=True).expand_as(v).to(v.dtype)
            for k, v in stacked.items()}


def stack_replicas(params: dict, n: int) -> dict:
    """``n`` copies of every tensor on a leading client axis (the
    reference's ``api.runtime.stack_replicas``)."""
    return {k: v[None].expand((n,) + tuple(v.shape)).clone()
            for k, v in params.items()}


def _row_weights(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.float().reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def fedavg_stack_masked(stacked: dict, mask: torch.Tensor) -> dict:
    """FedAvg over the active rows of a leading client axis: active rows get
    the f32 mean of the active rows, dropped rows keep their stale value;
    when every client is masked the stack passes through unchanged."""
    total = torch.clamp(mask.float().sum(), min=1.0)
    out = {}
    for k, x in stacked.items():
        w = _row_weights(mask, x)
        xf = x.float()
        avg = (xf * w).sum(dim=0, keepdim=True) / total
        out[k] = torch.where(w > 0, avg.expand_as(xf), xf).to(x.dtype)
    return out


def fedavg_mean_masked(stacked: dict, mask: torch.Tensor,
                       fallback: dict) -> dict:
    """Mean over the active rows, dropping the client axis; ``fallback``
    (the incoming global model) when no client is active."""
    total = mask.float().sum()
    out = {}
    for k, x in stacked.items():
        w = _row_weights(mask, x)
        avg = (x.float() * w).sum(dim=0) / torch.clamp(total, min=1.0)
        out[k] = torch.where(total > 0, avg,
                             fallback[k].float()).to(x.dtype)
    return out


@torch.no_grad()
def fedavg_modules_(modules: Sequence[torch.nn.Module]):
    """Replace the parameters of every module (same architecture) by their
    f32 mean over the modules, in place."""
    for ps in zip(*(m.parameters() for m in modules)):
        mean = torch.stack([p.float() for p in ps]).mean(dim=0)
        for p in ps:
            p.copy_(mean.to(p.dtype))


# ---------------------------------------------------------------------------
# the pmean family: one rank's rows of the client stack, one all_reduce
# ---------------------------------------------------------------------------

def _group_size(group) -> int:
    """The ranks of ``group``; 1 for the single-rank mesh (None)."""
    return 1 if group is None else dist.get_world_size(group)


def psum_flat(tensors: Sequence[torch.Tensor], group) -> list:
    """The ``group``-wide sums of ``tensors`` in f32, in ONE
    ``all_reduce(SUM)`` of their concatenation (each back in its own shape,
    f32); the identity when ``group`` is None."""
    if group is None:
        return [t.float() for t in tensors]
    flat = torch.cat([t.float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def _lead_weights(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (lead..., local_clients) mask shaped to broadcast against ``x``."""
    return mask.float().reshape(tuple(mask.shape)
                                + (1,) * (x.dim() - mask.dim()))


def fedavg_pmean(stacked: dict, group, *, lead: int = 0) -> dict:
    """``fedavg_mean`` over the whole data group: each leaf's f32 mean of
    the local rows, summed over the ranks and divided by their number (the
    reference's ``lax.pmean`` of the local mean), dropping the client axis.
    Equal local client counts per rank (``fleet.engine.validate_fleet_mesh``)
    make it the global mean."""
    means = psum_flat([v.float().mean(dim=lead) for v in stacked.values()],
                      group)
    size = _group_size(group)
    return {k: (m / size).to(v.dtype)
            for (k, v), m in zip(stacked.items(), means)}


def fedavg_pmean_masked(stacked: dict, mask: torch.Tensor, fallback: dict,
                        group, *, lead: int = 0) -> dict:
    """``fedavg_mean_masked`` over the data group: the masked sums of the
    local rows and the active count are summed over the ranks, so every
    rank gets the global mean of the ACTIVE rows; ``fallback`` (the
    incoming global model) when no client anywhere is active."""
    sums = psum_flat([(v.float() * _lead_weights(mask, v)).sum(dim=lead)
                      for v in stacked.values()]
                     + [mask.float().sum(dim=-1)], group)
    total = sums.pop()
    out = {}
    for (k, x), s in zip(stacked.items(), sums):
        t = total.reshape(tuple(total.shape) + (1,) * (s.dim() - total.dim()))
        avg = s / torch.clamp(t, min=1.0)
        out[k] = torch.where(t > 0, avg, fallback[k].float()).to(x.dtype)
    return out


def fedavg_pmean_stack(stacked: dict, group, *, lead: int = 0) -> dict:
    """``fedavg_stack`` over the data group: the global mean (local mean,
    summed over the ranks, over their number), broadcast to every local
    row."""
    means = psum_flat([v.float().mean(dim=lead, keepdim=True)
                       for v in stacked.values()], group)
    size = _group_size(group)
    return {k: (m / size).expand_as(v).to(v.dtype)
            for (k, v), m in zip(stacked.items(), means)}


def fedavg_pmean_stack_masked(stacked: dict, mask: torch.Tensor, group, *,
                              lead: int = 0) -> dict:
    """``fedavg_stack_masked`` over the data group: active rows get the
    global mean of all active rows (masked sums and the active count summed
    over the ranks), dropped rows keep their stale value; an all-masked
    fleet passes through unchanged."""
    sums = psum_flat([(v.float() * _lead_weights(mask, v)).sum(
        dim=lead, keepdim=True) for v in stacked.values()]
        + [mask.float().sum(dim=-1)], group)
    total = torch.clamp(sums.pop(), min=1.0)
    out = {}
    for (k, x), s in zip(stacked.items(), sums):
        w = _lead_weights(mask, x)
        xf = x.float()
        avg = s / total.reshape(tuple(total.shape)
                                + (1,) * (s.dim() - total.dim()))
        out[k] = torch.where(w > 0, avg.expand_as(xf), xf).to(x.dtype)
    return out
