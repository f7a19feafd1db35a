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
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


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
