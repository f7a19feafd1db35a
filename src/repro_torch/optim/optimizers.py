"""AdamW and SGD exactly as the reference's ``repro.optim.optimizers``.

Not ``torch.optim.AdamW``: that adds eps after dividing by the bias
correction's square root and decays the weights before the step, so its
numbers differ. This one repeats ``optimizers.py:79-98`` op for op, in f32:

    m  = b1*m + (1-b1)*g            v  = b2*v + (1-b2)*g*g
    mh = m / (1 - b1**t)            vh = v / (1 - b2**t)
    p  = p + (-lr) * (mh / (sqrt(vh) + eps) + wd * p)

with one step counter per optimizer (the reference's ``OptState.step``).
"""
from __future__ import annotations

import torch


class AdamW(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            eps, wd = group["eps"], group["weight_decay"]
            group["t"] = t = group.get("t", 0) + 1
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            f32 = dict(dtype=torch.float32, device=params[0].device)
            tf = torch.tensor(float(t), **f32)
            b1c = 1 - torch.tensor(b1, **f32) ** tf
            b2c = 1 - torch.tensor(b2, **f32) ** tf
            lr = torch.tensor(group["lr"], **f32)
            for p in params:
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p, dtype=torch.float32)
                    st["nu"] = torch.zeros_like(p, dtype=torch.float32)
                g = p.grad.float()
                m = b1 * st["mu"] + (1 - b1) * g
                v = b2 * st["nu"] + (1 - b2) * g * g
                delta = (m / b1c) / (torch.sqrt(v / b2c) + eps) + wd * p.float()
                st["mu"], st["nu"] = m, v
                p.add_((-lr * delta).to(p.dtype))


class SGD(torch.optim.Optimizer):
    """Momentum SGD as the reference's ``sgd``: m = momentum*m + g, step
    ``-lr * (g + momentum*m if nesterov else m)``."""

    def __init__(self, params, lr: float = 1e-2, *, momentum: float = 0.9,
                 nesterov: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGD.step takes no closure")
        for group in self.param_groups:
            mom = group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p, dtype=torch.float32)
                g = p.grad.float()
                m = mom * st["mu"] + g
                d = g + mom * m if group["nesterov"] else m
                st["mu"] = m
                p.add_((-group["lr"] * d).to(p.dtype))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """``clip_by_global_norm``: scale every gradient by
    ``min(1, max_norm / (gnorm + 1e-12))``, with gnorm the f32 square root
    of the sum of all squares, computed in f32 and cast back to each
    gradient's dtype. ``grads`` is a list of tensors, updated in place
    (``None`` entries are skipped). Returns gnorm (an f32 0-d tensor)."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros(())
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    for g in grads:
        g.copy_((g.float() * scale).to(g.dtype))
    return gnorm


def adamw(lr: float = 1e-3, **kw):
    """Factory ``params -> AdamW`` (the reference's ``adamw(lr)`` builds an
    (init, update) pair; here the optimizer binds to its params)."""
    return lambda params: AdamW(params, lr, **kw)


def sgd(lr: float = 1e-2, **kw):
    return lambda params: SGD(params, lr, **kw)
