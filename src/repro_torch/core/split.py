"""Split learning core — paper Algorithm 3 (SplitFed pattern) in PyTorch.

Counterpart of ``repro.core.split``. A CNN is a list of ``Stage`` modules;
``partition_stages`` cuts it into a client prefix and a server suffix at a
layer fraction. A transformer stack is an ``nn.ModuleList`` of blocks;
``stack_cut_index`` places its cut and ``split_stack`` slices it there.

The split train step is one autograd graph, as the reference's one
differentiable program: client forward -> link boundary (straight-through
int8 compressor, or nothing) -> server forward + loss; one ``backward``
fills the client and server gradients, which is exactly the distributed
backward of Algorithm 3 (the cut gradient flows back through the link).

The round builders are plain Python loops where the reference has
``lax.scan``: sequential Algorithm 3 (local steps outside, clients inside,
one shared server updated per client visit, FedAvg of the client prefixes
at the end) and the FL baseline (each client from the global model with a
fresh optimizer, FedAvg at the end). Losses stay on the device until the
round ends, so a round syncs with the host once. ``make_fl_seeds_round``
is the FL round over a leading seed axis, in functional form, for the
Monte-Carlo sweeps whose seeds train apart.

The fleet engines (``fleet.engine``) take the functional forms instead:
``tier_call`` makes a function of both tiers' parameter dicts out of the
modules (``torch.func.functional_call``), and ``make_split_loss`` is the
split step's loss as ``(params_c, params_s, batch) -> loss`` for
``torch.func.vmap``.

Metrics-bus taps (``repro_torch.obs.metrics``): a ``SplitStep`` with
``taps`` computes the smashed-tensor channels inside ``loss_fn`` (into
``aux["taps"]``), and the round builders given ``taps`` also return a
dict of float32 tap stacks in the loss layout, each value read from the
gradients and the optimizer's own update tensors of the step that ran. With
no taps the builders run exactly the tap-free operations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call, vmap

from ..obs.metrics import smashed_tap_values, stack_taps, step_taps
from .fedavg import fedavg_mean, fedavg_modules_


class Stage(nn.Module):
    """One cut-able unit of a backbone. ``body`` holds the parameters under
    the reference's pytree keys; ``depth`` is the number of paper-layers it
    stands for (the weight of cut placement)."""

    def __init__(self, name: str, body: nn.Module, depth: int = 1):
        super().__init__()
        self.name, self.depth = name, depth
        self.body = body

    def forward(self, x):
        return self.body(x)


def init_stages(generator: torch.Generator, stages: Sequence[Stage]):
    """Initialize every stage's parameters in place from ``generator``, in
    module order (he-normal convs, lecun-normal linears, zero biases, unit
    GroupNorm scales). The reference draws from threefry, so the values
    differ from ``repro``'s; parity runs import the reference's instead."""
    for stage in stages:
        for mod in stage.modules():
            reset = getattr(mod, "reset_parameters", None)
            if reset is not None:
                reset(generator)


def to_port_layout(x_nhwc: torch.Tensor) -> torch.Tensor:
    """NHWC input (the reference's layout) -> NCHW in channels_last memory.
    For a contiguous NHWC tensor this is a free view."""
    return x_nhwc.permute(0, 3, 1, 2)


def apply_stages(stages: Sequence[nn.Module], x: torch.Tensor) -> torch.Tensor:
    for s in stages:
        x = s(x)
    return x


def cut_index_for_fraction(stages: Sequence[Stage], client_fraction: float) -> int:
    """Smallest prefix whose depth-share >= client_fraction (paper's SL_{a,b}:
    client holds a% of layers). Always leaves >=1 stage per side."""
    total = sum(s.depth for s in stages)
    acc = 0
    for i, s in enumerate(stages):
        acc += s.depth
        if acc / total >= client_fraction - 1e-9:
            return min(max(i + 1, 1), len(stages) - 1)
    return len(stages) - 1


def partition_stages(stages: Sequence[Stage], client_fraction: float
                     ) -> tuple[list, list, int]:
    """Returns (client_stages, server_stages, k)."""
    k = cut_index_for_fraction(stages, client_fraction)
    return list(stages[:k]), list(stages[k:]), k


def stack_cut_index(n_layers: int, client_fraction: float) -> int:
    """Cut index for a homogeneous stack: ceil(fraction * n_layers), kept in
    [1, n_layers - 1]."""
    return max(1, min(n_layers - 1, int(math.ceil(client_fraction * n_layers))))


def split_stack(blocks: nn.ModuleList, k: int
                ) -> tuple[nn.ModuleList, nn.ModuleList]:
    """The first ``k`` blocks and the rest (the same module objects)."""
    return nn.ModuleList(blocks[:k]), nn.ModuleList(blocks[k:])


@dataclasses.dataclass(frozen=True)
class SplitStep:
    """One split-learning step over a client and a server module (the
    reference's vanilla variant: labels are consumed server-side).

    client_fwd(client, inputs)             -> smashed
    server_loss(server, smashed, targets)  -> (loss, aux)
    """
    client_fwd: Callable
    server_loss: Callable
    link_constraint: Optional[Callable] = None   # smashed -> smashed
    # metrics-bus channels computed inside the step (they need the smashed
    # tensor): a subset of {"smashed_mean", "smashed_std",
    # "smashed_absmax", "quant_error"}, returned in aux["taps"]
    taps: tuple = ()

    def loss_fn(self, client, server, batch):
        inputs, targets = batch["inputs"], batch["targets"]
        raw = smashed = self.client_fwd(client, inputs)
        if self.link_constraint is not None:
            smashed = self.link_constraint(smashed)
        loss, aux = self.server_loss(server, smashed, targets)
        aux = dict(aux)
        aux["smashed_elems"] = smashed.numel()
        if self.taps:
            aux["taps"] = smashed_tap_values(self.taps, raw, smashed)
        return loss, aux

    def grads(self, client, server, batch):
        """Forward + one joint backward; the gradients land in ``.grad`` of
        both modules' parameters. Returns (detached loss, aux)."""
        client.zero_grad(set_to_none=True)
        server.zero_grad(set_to_none=True)
        loss, aux = self.loss_fn(client, server, batch)
        loss.backward()
        return loss.detach(), aux


def _grads(module: nn.Module) -> list:
    return [p.grad for p in module.parameters() if p.grad is not None]


def make_split_train_step(step: SplitStep, taps: tuple = ()):
    """f(client, server, opt_c, opt_s, batch) -> metrics dict; with
    ``taps`` the dict's ``"taps"`` is the step's tap dict (0-d tensors)."""

    def train_step(client, server, opt_c, opt_s, batch):
        loss, aux = step.grads(client, server, batch)
        if not taps:
            opt_c.step()
            opt_s.step()
            return {"loss": loss, **aux}
        up_c, up_s = [], []
        opt_c.step(updates=up_c)
        opt_s.step(updates=up_s)
        aux["taps"] = step_taps(taps, loss=loss, aux_taps=aux.get("taps"),
                                g_c=_grads(client), g_s=_grads(server),
                                up_c=up_c, up_s=up_s)
        return {"loss": loss, **aux}

    return train_step


def make_multi_client_round(step: SplitStep, *, local_rounds: int,
                            taps: tuple = ()):
    """One global round of Algorithm 3 over ``len(clients)`` clients.

    ``clients``/``client_opts`` are per-client prefix modules and their
    optimizers; ``server``/``server_opt`` the one shared server model,
    updated once per client visit (the UAV visits clients one at a time).
    ``batches`` holds tensors with leading (clients, local_rounds) axes.
    Returns the losses, a (local_rounds, clients) tensor; the client
    prefixes are FedAvg'd in place at the end (optimizer states stay per
    client, as in the reference). With ``taps`` (engine tap channels) the
    round returns ``(losses, taps)``, every tap (local_rounds, clients):
    the server updates once a client visit here, so its channels are per
    client too."""
    train_step = make_split_train_step(step, taps)

    def global_round(clients, server, client_opts, server_opt, batches):
        losses, tap_rows = [], []
        for r in range(local_rounds):
            row, tap_row = [], []
            for c, (client, opt_c) in enumerate(zip(clients, client_opts)):
                batch = {k: v[c, r] for k, v in batches.items()}
                out = train_step(client, server, opt_c, server_opt, batch)
                row.append(out["loss"])
                if taps:
                    tap_row.append(out["taps"])
            losses.append(torch.stack(row))
            if taps:
                tap_rows.append(stack_taps(tap_row))
        fedavg_modules_(clients)
        if taps:
            return torch.stack(losses), stack_taps(tap_rows)
        return torch.stack(losses)

    return global_round


def make_fl_round(loss_fn: Callable, make_opt: Callable, *,
                  taps: tuple = ()):
    """One global round of the FL baseline.

    ``loss_fn(model, bx, by) -> loss``; ``make_opt(params)`` builds a fresh
    optimizer. Every client starts from the global params held by ``model``
    with a fresh optimizer state, runs its local minibatches, and the round
    ends with the FedAvg of the client models written back into ``model``.
    ``batches`` is ``(bx, by)`` with leading (clients, local_steps) axes.
    Returns the losses, a (clients, local_steps) tensor; with ``taps``
    (engine tap channels: FL has one tier, so the client-side ones)
    ``(losses, taps)``, every tap (clients, local_steps)."""

    def global_round(model: nn.Module, batches):
        bx, by = batches
        params = list(model.parameters())
        global_params = [p.detach().clone() for p in params]
        client_params = []
        losses, tap_rows = [], []
        for c in range(bx.shape[0]):
            with torch.no_grad():
                for p, g in zip(params, global_params):
                    p.copy_(g)
            opt = make_opt(params)
            row, tap_row = [], []
            for s in range(bx.shape[1]):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(model, bx[c, s], by[c, s])
                loss.backward()
                if taps:
                    up = []
                    opt.step(updates=up)
                    tap_row.append(step_taps(
                        taps, loss=loss.detach(), g_c=_grads(model),
                        up_c=up))
                else:
                    opt.step()
                row.append(loss.detach())
            losses.append(torch.stack(row))
            if taps:
                tap_rows.append(stack_taps(tap_row))
            client_params.append([p.detach().clone() for p in params])
        mean = fedavg_mean({i: torch.stack([cp[i] for cp in client_params])
                            for i in range(len(params))})
        with torch.no_grad():
            for i, p in enumerate(params):
                p.copy_(mean[i])
        if taps:
            return torch.stack(losses), stack_taps(tap_rows)
        return torch.stack(losses)

    return global_round


def make_fl_seeds_round(seed_loss: Callable, opt, *, taps: tuple = ()):
    """``make_fl_round`` over a leading seed axis, in functional form: the
    round of a Monte-Carlo sweep whose seeds train apart (``fl/scan`` under
    a population, each seed its own cohort). ``f(global_params, batches)
    -> (new_global_params, losses)``.

    ``seed_loss(params, bx, by) -> loss`` is one seed's loss, ``params`` a
    dict keyed as the model's parameters; ``opt`` a ``FunctionalAdamW``.
    Every leaf of ``global_params`` carries a leading seed axis, and
    ``batches`` is ``(bx, by)`` with leading (seeds, clients, local_steps)
    axes. The clients run one after another as in ``make_fl_round``, each
    from its seed's global params with a fresh optimizer state
    (``opt.init``). A local step is one ``vmap`` over seeds of the forward
    and one backward of the seeds' summed losses, which gives each seed the
    gradient of its own loss in its own rows. Each seed's round ends with
    the FedAvg of its clients. The losses are (seeds, clients,
    local_steps); with ``taps`` each tap stack (``step_taps`` of the
    step, seed by seed) is laid out like them."""
    per_seed = vmap(seed_loss)
    seed_taps = vmap(lambda loss, g, up: step_taps(taps, loss=loss, g_c=g,
                                                   up_c=up))

    def global_round(global_params: dict, batches):
        bx, by = batches
        client_params, losses, tap_rows = [], [], []
        for c in range(bx.shape[1]):
            params, state = global_params, opt.init(global_params)
            row, tap_row = [], []
            for s in range(bx.shape[2]):
                with torch.enable_grad():
                    leaves = {k: v.detach().requires_grad_()
                              for k, v in params.items()}
                    loss = per_seed(leaves, bx[:, c, s], by[:, c, s])
                    grads = dict(zip(leaves, torch.autograd.grad(
                        loss.sum(), list(leaves.values()))))
                loss = loss.detach()
                up = {} if taps else None
                params, state = opt.update(grads, state, params, updates=up)
                row.append(loss)
                if taps:
                    tap_row.append(seed_taps(loss, grads, up))
            client_params.append(params)
            losses.append(torch.stack(row, dim=-1))
            if taps:
                tap_rows.append(stack_taps(tap_row, dim=-1))
        mean = fedavg_mean({k: torch.stack([p[k] for p in client_params])
                            for k in global_params})
        out = (mean, torch.stack(losses, dim=1))
        return out + (stack_taps(tap_rows, dim=1),) if taps else out

    return global_round


# ---------------------------------------------------------------------------
# functional forms for the fleet engines (torch.func)
# ---------------------------------------------------------------------------

class _TierCall(nn.Module):
    """``fn(client, server, *args)`` as a module, so that one
    ``functional_call`` binds both tiers' parameters (``client.*``,
    ``server.*``)."""

    def __init__(self, fn: Callable, client: nn.Module, server: nn.Module):
        super().__init__()
        self.fn = fn
        self.client, self.server = client, server

    def forward(self, *args):
        return self.fn(self.client, self.server, *args)


def tier_params(params: Sequence[dict], device=None) -> dict:
    """Per-stage parameter dicts (a plan's ``params0`` form, keyed as each
    stage's ``body``) -> one dict keyed as ``nn.Sequential(*those
    stages)``'s parameters, on ``device`` when one is given."""
    return {f"{i}.body.{key}": v if device is None else v.to(device)
            for i, p in enumerate(params) for key, v in p.items()}


def tier_call(fn: Callable, client: nn.Module, server: nn.Module):
    """``fn(client, server, *args)`` as a pure function of the tiers'
    parameters: ``f(params_c, params_s, *args)``, each a dict keyed as the
    module's ``named_parameters()``. The modules are templates: their own
    parameters are not used."""
    holder = _TierCall(fn, client, server)

    def call(params_c: dict, params_s: dict, *args):
        params = {f"client.{k}": v for k, v in params_c.items()}
        params.update({f"server.{k}": v for k, v in params_s.items()})
        return functional_call(holder, params, args)
    return call


def make_split_loss(step: SplitStep, client: nn.Module, server: nn.Module):
    """The split step's loss as a function the fleet engines vmap:
    ``(params_c, params_s, batch) -> loss``, the client forward, the link
    boundary and the server loss in one function (``SplitStep.loss_fn``),
    differentiated by the engine's one backward. A step with ``taps``
    gives ``(loss, taps)``, its smashed-tensor tap dict."""
    if step.taps:
        def loss_and_taps(c, s, batch):
            loss, aux = step.loss_fn(c, s, batch)
            return loss, aux["taps"]
        return tier_call(loss_and_taps, client, server)
    return tier_call(lambda c, s, batch: step.loss_fn(c, s, batch)[0],
                     client, server)
