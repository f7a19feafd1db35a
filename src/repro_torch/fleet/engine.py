"""Fleet rounds: the client axis batched with ``torch.func.vmap``, on one
device (``client_axis="vmap"``) or spread over a data group
(``client_axis="shard_map"``).

Counterpart of ``repro.fleet.engine``. Every
per-client quantity (params, AdamW moments and step counters, minibatches)
carries a leading client axis. Per local step the per-client loss runs
forward once for the whole fleet under ``torch.func.vmap``, and ONE plain
autograd backward of the (mask-weighted) sum of the clients' losses gives
every client its own gradient in its row of a client-stacked leaf, and a
leaf the clients share (the server suffix, a shared client tier) the sum
over clients, reduced inside the backward's own products: no per-client
copy of a shared gradient is made. The link boundary's int8 kernel and the
flash kernel have ``vmap`` rules that fold the client axis into their own
batch, so each is one launch for all clients.

  * FL — ``make_fleet_fl_round``: clients are independent until FedAvg
    (the plain or masked mean).
  * SL — ``make_fleet_sl_round``: Efficient *Parallel* Split Learning (Lin
    et al., arXiv:2303.15991). Per local step every client's prefix runs
    forward and backward against the shared server suffix, the clients
    update their own prefixes, and the server takes ONE update on the mean
    (or sum) of the clients' server gradients; the prefixes are FedAvg'd at
    the end of the round. A deliberate variant of Algorithm 3, not equal to
    the sequential engine.

Client dropout (``client_dropout=True``): the round takes a trailing
(clients,) 0/1 mask. Masked clients still execute (the batch shape is
fixed) but keep their params and optimizer state (step counter included),
add nothing to the server's gradient (their loss has weight 0 in the
backward), and are left out of FedAvg; a fully-masked round changes no
state. The reference's ``lax.scan`` over the local steps is a Python loop
here.

``client_axis="shard_map"`` (the reference's explicit-collective engines):
the ``data`` axis of a ``launch.mesh.FleetMesh`` is a ``torch.distributed``
process group, and each rank runs the same vmapped body over its own
``clients / size`` rows of the batches, the mask and the stacked client
state (``data.pipeline.shard_batch``). The collective schedule is pinned in
the program: per local step ONE ``all_reduce(SUM)`` of the server's
gradient (and a shared client tier's) as one flat f32 buffer, the rank's
summed rows, divided by the global cohort size after it; at the end of
the round ONE ``fedavg_pmean*`` all-reduce, and ONE ``all_gather`` of
every rank's rows of the stacked state, the losses and the per-slot taps.
State stays replicated: every rank enters and leaves a round with the
whole fleet's state, as the ``vmap`` engine's. The mask comes whole to
every rank, so the active count needs no collective. On the single-rank
mesh (no group) every collective is the identity and the round equals the
``vmap`` engine's bit for bit.

Seed axis (``seed_axis=True``, the Monte-Carlo sweeps of
``sim.monte_carlo``): one more ``vmap`` level, outermost, over scenario
seeds, the counterpart of the reference's ``vmap`` over seeds of one
rollout. Every leaf of the state carries a leading seed axis (each seed its
own server suffix, shared client tier and optimizer states), batches are
(seeds, clients, steps, ...) and the mask (seeds, clients). The one
backward of the summed mask-weighted losses gives each (seed, client) row
its own gradient and each seed's server the sum over its own clients;
the server reduction, the all-masked guard, FedAvg and the AdamW step
counters run per seed. The int8 and flash ``vmap`` rules fold both levels
into their batch, so each kernel stays one launch for all seeds and
clients.

Metrics-bus taps (``taps``, ``repro_torch.obs.metrics``): the round also
returns a dict of float32 tap stacks in the reference's layouts, riding the
loss stack. The reference forms every client's gradients of its own loss
(``vmap(step.grads)``) and reduces them; here the one backward of the
summed losses gives per-client rows only for stacked leaves. When a tap
needs them (``grad_norm_server``, ``grad_norm_client`` on a shared tier or
under a mask, ``nonfinite``) the graph is kept for a second backward of
the clients' losses, ``torch.func.vmap``ped over identity cotangents,
which gives each client's own gradients of the leaves asked for; the
updates still come from the first backward, so training is the same with
taps as without.
The update-norm channels are the norms of the optimizer's own update
tensors; a masked client's row is the update its own gradient would take
(the reference's raw per-slot computation).

A ``vmap`` round given a mesh (``compile_experiment`` gives one to a
``vmap`` plan over more than one rank, the reference's GSPMD placement of
the client axis over ``data``) runs the same rank-local program as
``shard_map``: the reference's contract is shard_map == vmap.

The server sub-mesh (``server_placements``, the reference's
``server_pspecs``): the SL server suffix's params and both AdamW moments
live at rest as DTensors on the mesh's ``(fsdp, tp)`` sub-mesh
(``shard_server_state``; placements from ``launch.steps.
fleet_server_pspecs``), the step counter replicated. The round's compute
stays on plain tensors (``torch.func.vmap`` and the hand-written kernels
take no DTensor): each local step gathers the server params
(``full_tensor``), runs the body above, reduces the server gradient over
``data``, takes the rank's own slice of it and updates its shards. AdamW
is elementwise, so a shard's update is the slice of the unsharded one;
every whole-tree reduction (the nonfinite guard, the norm taps) sees the
whole gradient, before the slice. The compute is replicated over
``fsdp * tp``; the state's memory a rank is the reference's. Under the
seed axis every server leaf is seed-stacked: its placements shift by one
dim (``shift_placements``: ``Shard(d)`` becomes ``Shard(d + 1)``, the seed
axis unsharded, as the reference's ``vmap`` leaves it), the step counter
is a replicated (seeds,) tensor, and each local step gathers every seed's
server at once; the per-seed guards and taps see each seed's whole
gradient before the slice.

``FLEET_EQUIV_ATOL`` is the reference's loosened bound for vmapped rounds
against sequential ones (batched convolutions reassociate f32 sums); the
port's fleet rounds are held to it against the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import vmap

from ..core.fedavg import (fedavg_mean, fedavg_mean_masked, fedavg_pmean,
                           fedavg_pmean_masked, fedavg_pmean_stack,
                           fedavg_pmean_stack_masked, fedavg_stack,
                           fedavg_stack_masked, psum_flat, stack_replicas)
from ..data.pipeline import shard_batch
from ..launch.mesh import (DATA_AXIS, FleetMesh, all_gather_rows,
                           single_device_fleet_mesh)
from ..obs.metrics import stack_taps, tree_nonfinite, tree_norm
from ..optim.optimizers import OptState

FLEET_EQUIV_ATOL = 1e-3

CLIENT_AXES = ("vmap", "shard_map")


def _check_client_axis(client_axis: str) -> None:
    if client_axis not in CLIENT_AXES:
        raise ValueError(f"fleet client_axis must be one of {CLIENT_AXES}, "
                         f"got {client_axis!r} (the sequential engine is "
                         f"core.split's client_axis='scan')")


def validate_fleet_mesh(mesh, num_clients: int) -> None:
    """The client axis must divide evenly over ``data`` — no silent
    padding (the reference's message)."""
    if mesh is None:
        return
    data = mesh.shape.get(DATA_AXIS, 1)
    if num_clients % data:
        raise ValueError(
            f"{num_clients} clients do not divide over data={data}; pick a "
            f"fleet size divisible by the mesh's data axis (launch.mesh."
            f"make_fleet_mesh chooses one automatically)")


def _resolve_shard_map_mesh(mesh):
    """A shard_map engine always needs a concrete mesh: default to the
    single-rank fleet mesh (collectives become the identity) so the
    explicit-collective path runs anywhere."""
    if mesh is None:
        return single_device_fleet_mesh()
    if not isinstance(mesh, FleetMesh):
        raise ValueError(f"fleet shard_map mesh needs a '{DATA_AXIS}' "
                         f"axis, got {type(mesh).__name__}")
    return mesh


def shift_placements(placements, by: int) -> tuple:
    """A server leaf's placements with ``by`` leading dims added (or, for
    ``by`` < 0, taken away): ``Shard(d)`` becomes ``Shard(d + by)``. A
    seed axis is a new leading dim and never sharded, as the reference's
    ``vmap`` over a sharded leaf leaves its new axis unsharded."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(p.dim + by) if p.is_shard() else p
                 for p in placements)


def _dtensor(local: torch.Tensor, sub, placements):
    """A DTensor on ``sub`` of this rank's slice ``local`` (even shards:
    each sharded dim is the local one times its mesh dim's size)."""
    from torch.distributed.tensor import DTensor
    shape = list(local.shape)
    for mdim, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] *= sub.size(mdim)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, sub, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class ServerShards:
    """The server suffix on ``mesh``'s ``(fsdp, tp)`` sub-mesh:
    ``placements`` a dict of DTensor placements (one a sub-mesh dim) by
    parameter name, shifted by ``lead`` leading (seed) dims
    (``shift_placements``). ``shard`` takes this rank's slices of whole
    tensors, ``wrap`` makes DTensors of them and ``gather`` the whole
    tensors back; an ``OptState``'s step counter (a (seeds,) tensor under
    a seed axis) is replicated. Every axis runs the same code, of size 1
    or not."""

    def __init__(self, mesh, placements: dict, *, lead: int = 0):
        sub = None if mesh is None else mesh.server_mesh
        if sub is None:
            raise ValueError("server placements need a fleet mesh with a "
                             "(data, fsdp, tp) DeviceMesh (launch.mesh."
                             "make_fleet_mesh or fleet_mesh_of)")
        self.sub = sub
        self.placements = {k: shift_placements(pl, lead)
                           for k, pl in placements.items()}
        self.coord = tuple(sub.get_coordinate())
        self.sizes = tuple(sub.shape)

    def _slice(self, t: torch.Tensor, k: str) -> torch.Tensor:
        for mdim, p in enumerate(self.placements[k]):
            if p.is_shard():
                n, d = self.sizes[mdim], p.dim
                if t.shape[d] % n:
                    raise ValueError(f"{k}: dim {d} of {tuple(t.shape)} does "
                                     f"not divide over {n} ranks")
                w = t.shape[d] // n
                t = t.narrow(d, self.coord[mdim] * w, w)
        return t

    def shard(self, tree: dict) -> dict:
        """This rank's slice of each whole tensor of ``tree``."""
        return {k: self._slice(v, k) for k, v in tree.items()}

    def wrap(self, local: dict) -> dict:
        """DTensors of this rank's slices."""
        return {k: _dtensor(v, self.sub, self.placements[k])
                for k, v in local.items()}

    def gather(self, local: dict) -> dict:
        """The whole tensors of this rank's slices (one all-gather over the
        sub-mesh a sharded dim)."""
        return {k: v.full_tensor() for k, v in self.wrap(local).items()}

    def wrap_state(self, st: OptState) -> OptState:
        from torch.distributed.tensor import Replicate
        return OptState(step=_dtensor(st.step, self.sub, (Replicate(),) * 2),
                        mu=self.wrap(st.mu), nu=self.wrap(st.nu))


def _to_local(tree):
    """The local tensors of a dict or ``OptState`` of DTensors."""
    if isinstance(tree, OptState):
        return OptState(*(_to_local(getattr(tree, f))
                          for f in ("step", "mu", "nu")))
    if isinstance(tree, dict):
        return {k: _to_local(v) for k, v in tree.items()}
    return tree.to_local()


def shard_server_state(tree, mesh, placements: Optional[dict]):
    """Place the server suffix (a params dict, or its ``OptState``: the
    step counter replicated, ``mu`` and ``nu`` by ``placements``) onto
    ``mesh``'s ``(fsdp, tp)`` sub-mesh as DTensors (the reference's
    ``shard_server_state``). Every rank holds the whole tensors (the same
    seed made them) and keeps its own slices: no collective. The tree as
    it is without ``placements``; its seed-stacked form is
    ``stack_seeds`` of the placed tree."""
    if placements is None:
        return tree
    shards = ServerShards(mesh, placements)
    if isinstance(tree, OptState):
        return shards.wrap_state(OptState(step=tree.step,
                                          mu=shards.shard(tree.mu),
                                          nu=shards.shard(tree.nu)))
    return shards.wrap(shards.shard(tree))


def gather_server_state(tree):
    """The whole tensors of a server state placed by
    ``shard_server_state`` (a dict or ``OptState``; plain leaves as they
    are)."""
    if isinstance(tree, OptState):
        return OptState(*(gather_server_state(getattr(tree, f))
                          for f in ("step", "mu", "nu")))
    if isinstance(tree, dict):
        return {k: gather_server_state(v) for k, v in tree.items()}
    full = getattr(tree, "full_tensor", None)
    return tree if full is None else full()


def _local_state(st: OptState, mesh, lead: int) -> OptState:
    return OptState(*(shard_batch(getattr(st, f), mesh, dim=lead)
                      for f in ("step", "mu", "nu")))


def _reduce_grads(pairs, group) -> list:
    """The group-wide sum of each summed gradient dict of ``pairs`` (a
    ``(grads, n)`` list; every leaf in ONE f32 all-reduce), divided by
    ``n`` (the cohort size, a tensor per seed, or None for a sum) in f32
    and cast back to each leaf's dtype. With ``group`` None it is
    ``_mean`` (or the dict as it is, for a sum)."""
    if group is None:
        return [g if n is None else _mean(g, n) for g, n in pairs]
    flat = psum_flat([v for g, _ in pairs for v in g.values()], group)
    out, at = [], 0
    for g, n in pairs:
        d = {}
        for k, v in g.items():
            s = flat[at]
            at += 1
            if n is not None:
                s = s / (_lead(n, s) if torch.is_tensor(n) else n)
            d[k] = s.to(v.dtype)
        out.append(d)
    return out


def _lead(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` (a mask or flag over ``x``'s leading axes) shaped to broadcast
    against ``x``."""
    return t.reshape(tuple(t.shape) + (1,) * (x.dim() - t.dim()))


def _keep_masked_rows(mask: torch.Tensor, new: dict, old: dict) -> dict:
    """Masked clients' leading-axis rows keep their old value."""
    return {k: torch.where(_lead(mask, v) > 0, v, old[k])
            for k, v in new.items()}


def _keep_masked_state(mask, new: OptState, old: OptState) -> OptState:
    return OptState(step=torch.where(mask > 0, new.step, old.step),
                    mu=_keep_masked_rows(mask, new.mu, old.mu),
                    nu=_keep_masked_rows(mask, new.nu, old.nu))


def _guard(active: torch.Tensor, new: dict, old: dict) -> dict:
    """``new`` when any client is active, else ``old`` (on the device);
    per seed when ``active`` is (seeds,)."""
    return {k: torch.where(_lead(active, v), v, old[k])
            for k, v in new.items()}


def _guard_state(active, new: OptState, old: OptState) -> OptState:
    return OptState(step=torch.where(active, new.step, old.step),
                    mu=_guard(active, new.mu, old.mu),
                    nu=_guard(active, new.nu, old.nu))


def _losses_and_grads(per_client: Callable, params: tuple, batch,
                      weights: Optional[torch.Tensor] = None, *,
                      rows: Optional[dict] = None, lead: int = 0):
    """One vmapped forward and one backward: the (clients,) losses of
    ``per_client(*params, batch)`` (with the step's tap dict when it
    returns ``(loss, taps)``) and the gradients of their sum (each loss
    times its weight, when ``weights`` is given) with respect to every
    dict in ``params``. Returns (losses, step taps, grads, per-client
    rows).

    With ``rows`` (``{index into params: stacked}``; ``stacked`` when the
    dict's leaves carry the client axis) the graph is kept for each
    client's own gradients of the dicts named: one more backward of the
    (unweighted) losses, ``vmap``ped over identity cotangents, one a
    client; each row dict has the client axis after the ``lead`` seed
    axes."""
    with torch.enable_grad():
        leaves = tuple({k: v.detach().requires_grad_() for k, v in p.items()}
                       for p in params)
        out = per_client(*leaves, batch)
        losses, aux = out if isinstance(out, tuple) else (out, {})
        total = (losses if weights is None else losses * weights).sum()
        flat = iter(torch.autograd.grad(
            total, [v for p in leaves for v in p.values()],
            retain_graph=bool(rows)))
        grads = tuple({k: next(flat) for k in p} for p in leaves)
        per_row = {}
        if rows:
            n = losses.shape[-1]
            eye = torch.eye(n, dtype=losses.dtype, device=losses.device)
            cot = eye.reshape((n,) + (1,) * (losses.dim() - 1) + (n,)
                              ).expand((n,) + tuple(losses.shape))
            wanted = [(i, k) for i in rows for k in leaves[i]]
            inputs = [leaves[i][k] for i, k in wanted]
            # one client's cotangent at a time: the peak grows by one
            # client's gradients, not the fleet's
            batched = vmap(lambda v: torch.autograd.grad(
                losses, inputs, v, retain_graph=True), chunk_size=1)(cot)
            for (i, k), g in zip(wanted, batched):
                if rows[i]:
                    # row c of client c's own gradient: the diagonal
                    g = torch.diagonal(g, dim1=0, dim2=lead + 1
                                       ).movedim(-1, lead)
                else:
                    g = g.movedim(0, lead)
                per_row.setdefault(i, {})[k] = g
    aux = {k: v.detach() for k, v in aux.items()}
    return losses.detach(), aux, grads, per_row


def _nonfinite(losses: torch.Tensor, taps: dict, trees: tuple,
               lead: int, shared: tuple = ()) -> torch.Tensor:
    """The per-(seed,) client nonfinite flag: the loss, then each
    (grad-norm channel, per-client gradient rows) pair — a tapped norm
    doubles as the guard, an untapped tier pays the elementwise pass.

    The rows of the channels in ``shared`` (leaves the clients share, from
    the batched backward) see every client's saved activations: the
    reduction of a shared weight's gradient multiplies another client's
    NaN or inf activations by its zero cotangent, and 0 x NaN is NaN. A
    client's shared rows are therefore not counted at a step where another
    client's loss is nonfinite (such activations reach that loss); its own
    loss and stacked rows still are."""
    loss_bad = (~torch.isfinite(losses)).float()
    others_bad = (loss_bad.sum(dim=-1, keepdim=True) - loss_bad) > 0
    bad = loss_bad
    for k, rows in trees:
        if rows is None:
            continue
        flag = ((~torch.isfinite(taps[k])).float() if k in taps
                else tree_nonfinite(rows, lead + 1))
        if k in shared:
            flag = flag.masked_fill(others_bad, 0.0)
        bad = torch.maximum(bad, flag)
    return bad


def _mean(g: dict, n) -> dict:
    """The cohort mean of a summed gradient: ``g / n`` in f32, back in each
    leaf's dtype (``n`` per seed when it is a (seeds,) tensor)."""
    return {k: (v.float() / (_lead(n, v) if torch.is_tensor(n) else n)
                ).to(v.dtype) for k, v in g.items()}


def _replicate(params: dict, n: int, seed_axis: bool) -> dict:
    """``n`` copies of every leaf on a new client axis, after the seed axis
    when there is one."""
    if not seed_axis:
        return stack_replicas(params, n)
    return {k: v[:, None].expand((v.shape[0], n) + tuple(v.shape[1:])).clone()
            for k, v in params.items()}


def stack_seeds(tree, num_seeds: int):
    """A fresh copy of an engine state (dicts, tuples, lists and
    ``OptState``s of tensors) on a new leading seed axis. A DTensor of the
    server suffix stays one: each rank stacks its own slices, and the
    placements shift by the seed axis (``shift_placements``)."""
    if _is_dtensor(tree):
        return _dtensor(stack_seeds(tree.to_local(), num_seeds),
                        tree.device_mesh, shift_placements(tree.placements,
                                                           1))
    if isinstance(tree, torch.Tensor):
        return tree[None].expand((num_seeds,) + tuple(tree.shape)).clone()
    if isinstance(tree, OptState):
        return OptState(*(stack_seeds(getattr(tree, f), num_seeds)
                          for f in ("step", "mu", "nu")))
    if isinstance(tree, dict):
        return {k: stack_seeds(v, num_seeds) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(stack_seeds(v, num_seeds) for v in tree)
    raise TypeError(f"cannot stack {type(tree).__name__} over seeds")


def seed_row(tree, i: int):
    """Seed ``i``'s slice of a seed-stacked engine state (views; a
    DTensor's local rows, its placements shifted back)."""
    if _is_dtensor(tree):
        return _dtensor(tree.to_local()[i], tree.device_mesh,
                        shift_placements(tree.placements, -1))
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, OptState):
        return OptState(*(seed_row(getattr(tree, f), i)
                          for f in ("step", "mu", "nu")))
    if isinstance(tree, dict):
        return {k: seed_row(v, i) for k, v in tree.items()}
    return type(tree)(seed_row(v, i) for v in tree)


# ---------------------------------------------------------------------------
# FL rounds
# ---------------------------------------------------------------------------

def make_fleet_fl_round(loss_fn: Callable, opt, *,
                        client_dropout: bool = False,
                        seed_axis: bool = False, taps: tuple = (),
                        client_axis: str = "vmap", mesh=None):
    """FL baseline round with the client axis batched (the reference's
    ``make_fleet_fl_round`` on ``make_fl_round(..., client_axis="vmap")``):
    ``f(global_params, batches[, client_mask]) -> (new_global_params,
    losses (clients, local_steps))``.

    ``loss_fn(params, batch) -> loss`` on the full model, params a dict;
    ``opt`` a ``FunctionalAdamW``; ``batches`` ``(bx, by)`` with leading
    (clients, local_steps) axes. Every client starts the round from
    ``global_params`` with a fresh optimizer state and runs its local
    minibatches; the round ends with the FedAvg of the clients' models.
    With ``client_dropout`` the masked clients still train but are left
    out of FedAvg; a round with no active client returns the incoming
    global params. With ``seed_axis`` every tensor has a leading seed axis
    (the module docstring): global params (seeds, ...), batches (seeds,
    clients, local_steps, ...), the mask (seeds, clients), losses (seeds,
    clients, local_steps). With ``taps`` the round also returns the tap
    stacks, each laid out like the losses (every client's gradient is its
    own row here, dropout or not: the loss is not mask-weighted).

    ``client_axis="shard_map"``: each rank of ``mesh``'s data group (the
    single-rank mesh when None) trains its own rows of the clients, the
    round closes with ``fedavg_pmean`` (``fedavg_pmean_masked`` under a
    mask, the incoming global params its fallback), and the losses and
    taps of every rank are gathered; the arguments and results are the
    ``vmap`` round's, whole on every rank. A ``vmap`` round given a
    ``mesh`` runs the same rank-local program."""
    _check_client_axis(client_axis)
    if client_axis == "shard_map":
        mesh = _resolve_shard_map_mesh(mesh)
    per_client = vmap(loss_fn)
    mean, mean_masked = fedavg_mean, fedavg_mean_masked
    if seed_axis:
        per_client = vmap(per_client)
        mean, mean_masked = vmap(fedavg_mean), vmap(fedavg_mean_masked)
    lead = 1 if seed_axis else 0

    def clients_round(global_params: dict, batches):
        bx, by = batches
        n, steps = bx.shape[lead], bx.shape[lead + 1]
        params = _replicate(global_params, n, seed_axis)
        # per-row AdamW state: zero moments, a step counter a (seed, client)
        state = dataclasses.replace(
            opt.init(params), step=torch.zeros(bx.shape[:lead + 1],
                                               dtype=torch.int32,
                                               device=bx.device))
        losses, tap_rows = [], []
        for s in range(steps):
            loss, _, (grads,), _ = _losses_and_grads(
                per_client, (params,),
                (bx.select(lead + 1, s), by.select(lead + 1, s)))
            up = {} if taps else None
            params, state = opt.update(grads, state, params, updates=up)
            losses.append(loss)
            if not taps:
                continue
            t = {}
            if "grad_norm_client" in taps:
                t["grad_norm_client"] = tree_norm(grads, lead + 1)
            if "update_norm_client" in taps:
                t["update_norm_client"] = tree_norm(up, lead + 1)
            if "nonfinite" in taps:
                t["nonfinite"] = _nonfinite(
                    loss, t, (("grad_norm_client", grads),), lead)
            tap_rows.append(t)
        out = (params, torch.stack(losses, dim=-1))
        return out + (stack_taps(tap_rows, dim=-1),) if taps else out

    if mesh is not None:
        group = mesh.group

        def sharded_round(global_params, batches, mask):
            validate_fleet_mesh(mesh, batches[0].shape[lead])
            stack, *out = clients_round(global_params,
                                        shard_batch(batches, mesh, dim=lead))
            if mask is None:
                new = fedavg_pmean(stack, group, lead=lead)
            else:
                new = fedavg_pmean_masked(
                    stack, shard_batch(mask, mesh, dim=lead), global_params,
                    group, lead=lead)
            # losses and taps (seeds?, clients, steps): every rank's rows
            outs = [out[0]] + ([out[1][k] for k in taps] if taps else [])
            full = all_gather_rows(mesh, [(t, lead) for t in outs])
            res = (new, full[0])
            return res + (dict(zip(taps, full[1:])),) if taps else res

        if not client_dropout:
            return lambda global_params, batches: sharded_round(
                global_params, batches, None)
        return lambda global_params, batches, client_mask: sharded_round(
            global_params, batches, client_mask.to(torch.float32))

    if not client_dropout:
        def global_round(global_params, batches):
            stack, *out = clients_round(global_params, batches)
            return (mean(stack), *out)
        return global_round

    def global_round_masked(global_params, batches, client_mask):
        stack, *out = clients_round(global_params, batches)
        mask = client_mask.to(torch.float32)
        return (mean_masked(stack, mask, global_params), *out)

    return global_round_masked


# ---------------------------------------------------------------------------
# parallel-SL rounds
# ---------------------------------------------------------------------------

def make_fleet_sl_round(loss: Callable, opt_c, opt_s, *, local_rounds: int,
                        server_reduce: str = "mean",
                        client_dropout: bool = False,
                        client_tier: str = "stacked",
                        seed_axis: bool = False, taps: tuple = (),
                        client_axis: str = "vmap", mesh=None,
                        server_placements: Optional[dict] = None):
    """One global round of parallel split learning over the fleet.

    ``loss(params_c, params_s, batch) -> loss`` is the split step's loss,
    the link boundary inside (``core.split.make_split_loss``); ``opt_c``,
    ``opt_s`` ``FunctionalAdamW``s. The round is ``f(params_c, params_s,
    oc, os_, batches[, client_mask]) -> (params_c, params_s, oc, os_,
    losses)`` with ``batches`` a dict of (clients, local_rounds, ...)
    tensors and losses (local_rounds, clients).

    ``client_tier``:
      "stacked" — per-client prefixes and optimizer states on the leading
                  client axis (``vmap(loss, in_dims=(0, None, 0))``), one
                  update per client, ONE server update on the
                  ``server_reduce`` of the server gradients; the (masked)
                  FedAvg of the prefixes at the end.
      "shared"  — EPSL cohort mode: ONE client model and optimizer state
                  broadcast over the cohort (``in_dims=(None, None, 0)``),
                  updated like the server on the (masked) cohort-MEAN
                  gradient; no closing FedAvg. The tier of a sampled
                  cohort (``api.plan`` with population > num_clients).

    ``seed_axis``: every tensor carries a leading seed axis (the module
    docstring); batches (seeds, clients, local_rounds, ...), the mask
    (seeds, clients), losses (seeds, local_rounds, clients).

    ``taps`` (engine tap channels; ``loss`` then returns ``(loss, step
    taps)`` when the step computes smashed channels): the round also
    returns the tap stacks, per-slot channels (local_rounds, clients) like
    the losses, the one-update-a-step channels (local_rounds,):
    ``update_norm_server``, and ``update_norm_client`` on the shared tier.
    Masked clients still execute; their rows are left out of the state
    but are on the bus, from their own gradients.

    ``client_axis="shard_map"``: each rank of ``mesh``'s data group (the
    single-rank mesh when None) runs its own rows of the clients; per
    local step the server's summed gradient (and a shared client tier's)
    is all-reduced once, the closing FedAvg is ``fedavg_pmean_stack``
    (``_masked``), and every rank's rows of the stacked client state, the
    losses and the per-slot taps are gathered at the end. The arguments
    and results are the ``vmap`` round's, whole on every rank. A ``vmap``
    round given a ``mesh`` runs the same rank-local program.

    ``server_placements`` (``launch.steps.server_placements`` of
    ``fleet_server_pspecs``; needs a ``mesh`` with a ``DeviceMesh``):
    ``params_s`` and ``os_`` come in and go out as DTensors on the mesh's
    ``(fsdp, tp)`` sub-mesh (``shard_server_state``; with ``seed_axis``
    seed-stacked, the placements shifted by one dim); each local step
    gathers the params, and the rank updates its own slices on its slice
    of the whole reduced gradient (the module docstring).
    """
    if server_reduce not in ("mean", "sum"):
        raise ValueError(server_reduce)
    if client_tier not in ("stacked", "shared"):
        raise ValueError(f"client_tier must be 'stacked' or 'shared', "
                         f"got {client_tier!r}")
    _check_client_axis(client_axis)
    if client_axis == "shard_map":
        mesh = _resolve_shard_map_mesh(mesh)
    group = None if mesh is None else mesh.group
    lead = 1 if seed_axis else 0
    server = (None if server_placements is None
              else ServerShards(mesh, server_placements, lead=lead))
    shared = client_tier == "shared"
    per_client = vmap(loss, in_dims=(None if shared else 0, None, 0))
    fedavg, fedavg_masked = fedavg_stack, fedavg_stack_masked
    if seed_axis:
        # each seed its own server (and shared client tier): batched on the
        # seed level, unbatched on the client level
        per_client = vmap(per_client)
        fedavg, fedavg_masked = vmap(fedavg_stack), vmap(fedavg_stack_masked)

    # per-client gradients a tap needs: {index into (params_c, params_s):
    # stacked}, by whether a mask is given (a masked row of the weighted
    # backward is zero, not the client's own gradient)
    nan_guard = "nonfinite" in taps
    want_s = nan_guard or "grad_norm_server" in taps
    want_c = nan_guard or "grad_norm_client" in taps
    rows_of = {}
    for masked in (False, True):
        rows = {}
        if shared:
            if want_c:
                rows[0] = False
        elif masked and (want_c or "update_norm_client" in taps):
            rows[0] = True
        if want_s:
            rows[1] = False
        rows_of[masked] = rows

    def round_taps(loss_r, aux, g_c, rows, up_c, up_s):
        t = dict(aux)
        c_rows = rows.get(0, None if shared else g_c)
        s_rows = rows.get(1)
        if "grad_norm_client" in taps:
            t["grad_norm_client"] = tree_norm(c_rows, lead + 1)
        if "grad_norm_server" in taps:
            t["grad_norm_server"] = tree_norm(s_rows, lead + 1)
        if "update_norm_client" in taps:
            # EPSL: ONE shared client update a step -> a scalar channel
            t["update_norm_client"] = tree_norm(up_c,
                                                lead + (0 if shared else 1))
        if "update_norm_server" in taps:
            t["update_norm_server"] = tree_norm(up_s, lead)
        if nan_guard:
            t["nonfinite"] = _nonfinite(
                loss_r, t, (("grad_norm_client", c_rows),
                            ("grad_norm_server", s_rows)), lead,
                shared=(("grad_norm_client", "grad_norm_server") if shared
                        else ("grad_norm_server",)))
        return t

    @torch.no_grad()
    def run_round(params_c, params_s, oc, os_, batches, mask):
        n_active = active = None
        n = next(iter(batches.values())).shape[lead]
        if mask is not None:
            total = mask.sum(dim=-1)
            n_active = torch.clamp(total, min=1.0)
            active = total > 0
        cohort = n if mask is None else n_active
        if mesh is not None:
            # the rank's rows; the counts above stay the fleet's
            validate_fleet_mesh(mesh, n)
            batches = shard_batch(batches, mesh, dim=lead)
            mask = None if mask is None else shard_batch(mask, mesh,
                                                         dim=lead)
            if not shared:
                params_c = shard_batch(params_c, mesh, dim=lead)
                oc = _local_state(oc, mesh, lead)
        if server is not None:
            # the rank's own slices; gathered whole for each step's compute
            params_s, os_ = _to_local(params_s), _to_local(os_)
        losses, tap_rows = [], []
        up_c = up_s = raw_c = None
        for r in range(local_rounds):
            batch = {k: v.select(lead + 1, r) for k, v in batches.items()}
            # masked clients' losses weigh 0: their rows' gradients are 0
            # (and dropped below), and they add nothing to the server's
            ps_full = params_s if server is None else server.gather(params_s)
            loss_r, aux, (g_c, g_s), rows = _losses_and_grads(
                per_client, (params_c, ps_full), batch, mask,
                rows=rows_of[mask is not None], lead=lead)
            if taps:
                up_c, up_s = {}, {}
                raw_c = None if shared or mask is None else rows.get(0)
            losses.append(loss_r)
            # the fleet's reduction of the summed gradients: one
            # all-reduce a step under shard_map
            s_mean = cohort if server_reduce == "mean" else None
            if shared:
                g_c, g_s = _reduce_grads([(g_c, cohort), (g_s, s_mean)],
                                         group)
                pc_new, oc_new = opt_c.update(g_c, oc, params_c,
                                              updates=up_c)
            else:
                (g_s,) = _reduce_grads([(g_s, s_mean)], group)
                pc_new, oc_new = opt_c.update(g_c, oc, params_c,
                                              updates=up_c, updates_of=raw_c)
                if mask is not None:
                    pc_new = _keep_masked_rows(mask, pc_new, params_c)
                    oc_new = _keep_masked_state(mask, oc_new, oc)
            if server is not None:
                # AdamW is elementwise: the update of the rank's slices is
                # the slice of the whole update
                g_s = server.shard(g_s)
            ps_new, os_new = opt_s.update(g_s, os_, params_s, updates=up_s)
            if server is not None and "update_norm_server" in taps:
                up_s = server.gather(up_s)
            if taps:
                tap_rows.append(round_taps(loss_r, aux, g_c, rows, up_c,
                                           up_s))
            if mask is not None:
                # no active client: the server (and a shared client tier)
                # sits the round out
                ps_new = _guard(active, ps_new, params_s)
                os_new = _guard_state(active, os_new, os_)
                if shared:
                    pc_new = _guard(active, pc_new, params_c)
                    oc_new = _guard_state(active, oc_new, oc)
            params_c, oc, params_s, os_ = pc_new, oc_new, ps_new, os_new
        tap_stack = stack_taps(tap_rows, dim=lead) if taps else None
        losses = torch.stack(losses, dim=lead)
        if mesh is None:
            if not shared:
                params_c = (fedavg(params_c) if mask is None
                            else fedavg_masked(params_c, mask))
        else:
            if not shared:
                params_c = (fedavg_pmean_stack(params_c, group, lead=lead)
                            if mask is None else fedavg_pmean_stack_masked(
                                params_c, mask, group, lead=lead))
            params_c, oc, losses, tap_stack = _gather_round(
                mesh, shared, lead, params_c, oc, losses, tap_stack)
        if server is not None:
            params_s, os_ = server.wrap(params_s), server.wrap_state(os_)
        out = (params_c, params_s, oc, os_, losses)
        return out + (tap_stack,) if taps else out

    if client_dropout:
        def global_round_masked(params_c, params_s, oc, os_, batches,
                                client_mask):
            return run_round(params_c, params_s, oc, os_, batches,
                             client_mask.to(torch.float32))
        return global_round_masked

    def global_round(params_c, params_s, oc, os_, batches):
        return run_round(params_c, params_s, oc, os_, batches, None)
    return global_round


def _gather_round(mesh, shared: bool, lead: int, params_c, oc, losses,
                  tap_stack):
    """Every rank's rows of a shard_map SL round's outputs, in ONE
    all-gather: the stacked client params and optimizer state (client axis
    ``lead``), the losses and the per-slot taps (client axis ``lead + 1``;
    the one-update-a-step channels, the same on every rank, stay)."""
    items = [(losses, lead + 1)]
    slot = [k for k, v in (tap_stack or {}).items()
            if v.dim() > lead + 1]
    items += [(tap_stack[k], lead + 1) for k in slot]
    if not shared:
        items += [(v, lead) for v in params_c.values()]
        items += [(oc.step, lead)]
        items += [(v, lead) for v in oc.mu.values()]
        items += [(v, lead) for v in oc.nu.values()]
    full = iter(all_gather_rows(mesh, items))
    losses = next(full)
    if tap_stack is not None:
        tap_stack = dict(tap_stack)
        for k in slot:
            tap_stack[k] = next(full)
    if not shared:
        params_c = {k: next(full) for k in params_c}
        step = next(full)
        oc = OptState(step=step, mu={k: next(full) for k in oc.mu},
                      nu={k: next(full) for k in oc.nu})
    return params_c, oc, losses, tap_stack


def fleet_state(params_c: dict, params_s: dict, opt_c, opt_s, n: int,
                client_tier: str = "stacked", *, mesh=None,
                server_placements: Optional[dict] = None) -> tuple:
    """Initial engine state ``(params_c, params_s, oc, os_)``: the client
    params and optimizer state stacked ``n`` times ("stacked") or single
    ("shared"), as the reference's ``init_state`` builds them; with
    ``server_placements`` the server params and optimizer state placed on
    ``mesh``'s ``(fsdp, tp)`` sub-mesh (``shard_server_state``)."""
    os_ = shard_server_state(opt_s.init(params_s), mesh, server_placements)
    params_s = shard_server_state(dict(params_s), mesh, server_placements)
    if client_tier == "shared":
        return dict(params_c), params_s, opt_c.init(params_c), os_
    return (stack_replicas(params_c, n), params_s,
            opt_c.init_stacked(params_c, n), os_)
