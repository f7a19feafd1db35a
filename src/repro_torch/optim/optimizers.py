"""AdamW and SGD exactly as the reference's ``repro.optim.optimizers``.

Not ``torch.optim.AdamW``: that adds eps after dividing by the bias
correction's square root and decays the weights before the step, so its
numbers differ. This one repeats ``optimizers.py:79-98`` op for op, in f32:

    m  = b1*m + (1-b1)*g            v  = b2*v + (1-b2)*g*g
    mh = m / (1 - b1**t)            vh = v / (1 - b2**t)
    p  = p + (-lr) * (mh / (sqrt(vh) + eps) + wd * p)

with one step counter per optimizer (the reference's ``OptState.step``).

The learning rate is a float or a schedule (``constant_schedule``,
``cosine_schedule``, ``warmup_cosine``, or any function of the f32 step
count on the device that returns an f32 tensor there, the reference's
``Schedule``): the schedules are the reference's ``optimizers.py:34-58``,
evaluated on the device in f32 from the step count each optimizer already
keeps there, in JAX's order of operations, so a scheduled step synchronizes
with the card no more than a constant one does.

The f32 scalars b1, b2 and lr are made on the device once (at an
optimizer's first step on that device) by a fill, and ``AdamW``'s f32 step
count lives there, set each step by a fill (the value a kernel argument,
not a copy), so no step, the first included, copies from the host or
synchronizes with the card: ``fl/scan`` makes a fresh optimizer for every
client every round. The values and the operations are the ones a
``torch.tensor(..., device=)`` a step gave (the f32 nearest each value).

Each step can hand out its applied update, ``(-lr * delta)`` in the
parameter's dtype (the reference's ``updates``, the metrics bus's
``update_norm`` source): ``AdamW.step(updates=[])`` appends one tensor a
parameter, ``FunctionalAdamW.update(..., updates={})`` fills one a key.
The arithmetic is the same with or without.

``AdamW`` updates its moments in place (``_adamw_leaf_``: the same
operations in the same order, fewer temporaries); ``FunctionalAdamW`` is
the same arithmetic over dicts of tensors, returning new tensors (the form ``torch.func.vmap`` engines need). Its state may carry
a leading client axis on every leaf, the step counter included
(``init_stacked``, the reference's ``optimizers.py:134-141``): each row then
has its own bias correction, so rows that sat a round out (client dropout)
keep their own count.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import torch

from ..core.fedavg import stack_replicas


Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant_schedule(v: float) -> Schedule:
    """``v`` in f32, shaped as the step count."""
    return lambda step: torch.full_like(step, v, dtype=torch.float32)


def cosine_schedule(peak: float, total_steps: int, *,
                    floor: float = 0.0) -> Schedule:
    """``floor + (peak - floor) / 2 (1 + cos(pi frac))``, frac the step over
    ``total_steps`` clipped to [0, 1]."""
    def sched(step):
        frac = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
    return sched


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int, *,
                  floor: float = 0.0) -> Schedule:
    """``peak * step / warmup_steps`` before ``warmup_steps``, then the cosine
    from ``peak`` to ``floor`` over the remaining steps."""
    def sched(step):
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def _scheduled_lr(lr, c: dict, step: torch.Tensor) -> torch.Tensor:
    """The step's f32 lr on the device: the made-once scalar for a float
    ``lr``, the schedule at ``step`` (the f32 step count) otherwise."""
    return lr(step) if callable(lr) else c["lr"]


def _scalars_of(lr, **values) -> dict:
    """The device scalars an optimizer makes once: ``values``, and ``lr``
    when it is a float."""
    return values if callable(lr) else dict(values, lr=lr)


def _adamw_leaf(p, g, mu, nu, b1c, b2c, *, b1, b2, eps, wd):
    """One leaf's AdamW arithmetic: the new moments and the update direction
    ``delta`` (the step is ``p + (-lr * delta)``). ``b1c``/``b2c`` are the
    bias corrections, 0-d or broadcast against ``p``'s leading axes."""
    g = g.float()
    m = b1 * mu + (1 - b1) * g
    v = b2 * nu + (1 - b2) * g * g
    delta = (m / b1c) / (torch.sqrt(v / b2c) + eps) + wd * p.float()
    return m, v, delta


def _adamw_leaf_(p, g, mu, nu, b1c, b2c, *, b1, b2, eps, wd):
    """``_adamw_leaf`` with the moments updated in place: the same
    operations in the same order, so the same bits, with two leaf-sized f32
    temporaries where the out-of-place form holds five (a 131,072 x 5120
    f32 head's step then needs 5 GiB above its state, not 12.5). Returns
    ``delta``, a new tensor."""
    g = g.float()
    t = (1 - b1) * g
    mu.mul_(b1).add_(t)
    torch.mul(g, 1 - b2, out=t)
    nu.mul_(b2).add_(t.mul_(g))
    t = torch.div(nu, b2c, out=t).sqrt_().add_(eps)
    delta = torch.div(mu, b1c).div_(t)
    return delta.add_(t.copy_(p).mul_(wd))


def _device_scalars(cache: dict, key, device, **values) -> dict:
    """``values`` as f32 0-d tensors on ``device``, made once for ``key``
    and those values and kept in ``cache`` (a changed lr makes new ones).
    Each is filled on the device: ``torch.tensor(v, device=)`` would copy
    it from the host, a copy that waits for the card."""
    key = (key, str(device)) + tuple(sorted(values.items()))
    if key not in cache:
        cache[key] = {k: torch.full((), v, dtype=torch.float32,
                                    device=device)
                      for k, v in values.items()}
    return cache[key]


class AdamW(torch.optim.Optimizer):
    def __init__(self, params, lr: Union[float, Schedule] = 1e-3, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self._scalars = {}

    @torch.no_grad()
    def step(self, closure=None, *, updates: Optional[list] = None):
        """One AdamW step of every parameter with a gradient; with
        ``updates`` each applied update is appended to it."""
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for i, group in enumerate(self.param_groups):
            b1, b2 = group["b1"], group["b2"]
            eps, wd = group["eps"], group["weight_decay"]
            group["t"] = group.get("t", 0) + 1
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            c = _device_scalars(self._scalars, i, params[0].device,
                                **_scalars_of(group["lr"], b1=b1, b2=b2,
                                              t=0.0))
            # the step count, written on the device by a fill (a kernel
            # argument, not a copy from the host; exact in f32)
            tf = c["t"].fill_(float(group["t"]))
            b1c = 1 - c["b1"] ** tf
            b2c = 1 - c["b2"] ** tf
            lr = _scheduled_lr(group["lr"], c, tf)
            for p in params:
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p, dtype=torch.float32)
                    st["nu"] = torch.zeros_like(p, dtype=torch.float32)
                delta = _adamw_leaf_(p, p.grad, st["mu"], st["nu"], b1c,
                                     b2c, b1=b1, b2=b2, eps=eps, wd=wd)
                up = delta.mul_(-lr).to(p.dtype)
                p.add_(up)
                if updates is not None:
                    updates.append(up)


@dataclasses.dataclass
class OptState:
    """The reference's ``OptState``: the int32 step counter and the f32
    moments, dicts keyed as the params. ``step`` is 0-d, or (clients,) for
    a client-stacked state."""
    step: torch.Tensor
    mu: dict
    nu: dict


class FunctionalAdamW:
    """``AdamW.step``'s arithmetic, op for op, over dicts of tensors.
    ``update(grads, state, params) -> (new_params, new_state)``; with a
    stacked state (step of shape (clients,)) every leaf's leading axis is
    the client axis and each row takes its own bias correction."""

    def __init__(self, lr: Union[float, Schedule] = 1e-3, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self._scalars = {}

    def init(self, params: dict) -> OptState:
        first = next(iter(params.values()))
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=first.device),
                        mu=zeros,
                        nu={k: z.clone() for k, z in zeros.items()})

    def init_stacked(self, params: dict, n: int) -> OptState:
        """State for ``n`` replicas of ``params`` (unstacked), every leaf,
        the step counter included, on a leading client axis."""
        st = self.init(params)
        return OptState(step=st.step.expand(n).clone(),
                        mu=stack_replicas(st.mu, n),
                        nu=stack_replicas(st.nu, n))

    @torch.no_grad()
    def update(self, grads: dict, state: OptState, params: dict, *,
               updates: Optional[dict] = None,
               updates_of: Optional[dict] = None):
        """``(new_params, new_state)``. With ``updates`` (a dict) each key's
        applied update is stored in it; with ``updates_of`` too (gradients
        keyed as ``grads``) the update those gradients would take from the
        same state and constants is stored instead (the metrics bus's
        update of a masked client's row), beside the real step."""
        b1, b2 = self.b1, self.b2
        eps, wd = self.eps, self.weight_decay
        t = state.step + 1
        c = _device_scalars(self._scalars, 0, t.device,
                            **_scalars_of(self.lr, b1=b1, b2=b2))
        tf = t.float()
        b1c = 1 - c["b1"] ** tf
        b2c = 1 - c["b2"] ** tf
        lr_t = _scheduled_lr(self.lr, c, tf)
        new_p, mu, nu = {}, {}, {}
        for k, p in params.items():
            shape = tuple(t.shape) + (1,) * (p.dim() - t.dim())
            # a schedule of a stacked count gives each row its own lr
            lr = lr_t.reshape(shape) if lr_t.dim() else lr_t
            mu[k], nu[k], delta = _adamw_leaf(
                p, grads[k], state.mu[k], state.nu[k], b1c.reshape(shape),
                b2c.reshape(shape), b1=b1, b2=b2, eps=eps, wd=wd)
            up = (-lr * delta).to(p.dtype)
            new_p[k] = p + up
            if updates is not None:
                if updates_of is not None:
                    _, _, delta = _adamw_leaf(
                        p, updates_of[k], state.mu[k], state.nu[k],
                        b1c.reshape(shape), b2c.reshape(shape), b1=b1,
                        b2=b2, eps=eps, wd=wd)
                    up = (-lr * delta).to(p.dtype)
                updates[k] = up
        return new_p, OptState(step=t, mu=mu, nu=nu)


class SGD(torch.optim.Optimizer):
    """Momentum SGD as the reference's ``sgd``: m = momentum*m + g, step
    ``-lr * (g + momentum*m if nesterov else m)``."""

    def __init__(self, params, lr: Union[float, Schedule] = 1e-2, *,
                 momentum: float = 0.9, nesterov: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      nesterov=nesterov))
        self._scalars = {}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGD.step takes no closure")
        for i, group in enumerate(self.param_groups):
            mom, lr = group["momentum"], group["lr"]
            group["t"] = group.get("t", 0) + 1
            params = [p for p in group["params"] if p.grad is not None]
            if params and callable(lr):
                # a schedule: the f32 step count filled on the device
                c = _device_scalars(self._scalars, i, params[0].device,
                                    t=0.0)
                lr = lr(c["t"].fill_(float(group["t"])))
            for p in params:
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p, dtype=torch.float32)
                g = p.grad.float()
                m = mom * st["mu"] + g
                d = g + mom * m if group["nesterov"] else m
                st["mu"] = m
                p.add_((-lr * d).to(p.dtype))


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


def adamw(lr: Union[float, Schedule] = 1e-3, **kw):
    """Factory ``params -> AdamW`` (the reference's ``adamw(lr)`` builds an
    (init, update) pair; here the optimizer binds to its params). ``lr`` is
    a float or a schedule."""
    return lambda params: AdamW(params, lr, **kw)


def sgd(lr: Union[float, Schedule] = 1e-2, **kw):
    return lambda params: SGD(params, lr, **kw)
