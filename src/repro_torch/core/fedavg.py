"""FedAvg aggregation (paper Algorithm 3, line 19: theta_agg = mean_e theta_e).

Counterpart of the host part of ``repro.core.fedavg``, all in f32:

- ``fedavg``        a list of per-client param dicts -> (weighted) mean dict
- ``fedavg_mean``   a dict of client-stacked tensors -> mean over the axis
- ``fedavg_stack``  the same mean, broadcast back over the client axis
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


@torch.no_grad()
def fedavg_modules_(modules: Sequence[torch.nn.Module]):
    """Replace the parameters of every module (same architecture) by their
    f32 mean over the modules, in place."""
    for ps in zip(*(m.parameters() for m in modules)):
        mean = torch.stack([p.float() for p in ps]).mean(dim=0)
        for p in ps:
            p.copy_(mean.to(p.dtype))
