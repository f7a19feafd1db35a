"""Per-client cuts in buckets, and the split language model.

Counterpart of ``repro.fleet.hetero``.

**Per-client cuts** (the CNN half). Heterogeneous edge fleets (P3SL,
arXiv:2507.17228) do not share one best cut: a Jetson-class client wants a
deeper prefix than a microcontroller-class one, and a starved link moves
the optimum toward smaller smashed tensors. Every client gets its own cut
from ``core.adaptive_cut.select_cut`` on its own (hardware, link) profile
(``assign_cuts_cnn``), clients are grouped into cut buckets
(``bucket_by_cut``), and ``HeteroFleet`` runs one ``fleet.engine.
make_fleet_sl_round`` a bucket, each with its own server suffix: the
bucket, not the client, is the unit of a program. A bucket's
``SplitProgram`` holds the stage modules as ``functional_call`` templates
(``cnn_split_program``); the parameters live in the buckets' state dicts.
The transformer half: ``assign_cuts_transformer`` (the analytic profile
of ``core.adaptive_cut.profile_cuts_transformer``), and
``stack_split_program`` over an ``nn.ModuleList`` stack cut by
``core.split.split_stack``, each tier running its blocks in turn;
``arch_split_program`` builds one from an ``ArchConfig``'s dense
attention stack (``transformer_block_apply``). No spec path reaches them:
both packages refuse adaptive transformer cuts in a spec.

**The split language model**: a transformer ``ArchConfig`` stack cut at
layer k (``transformer_block_apply``, ``lm_split_program``). The client
tier holds the token embedding and the first k blocks (raw tokens never
cross the link); the server tier holds the other blocks and the output
head, and closes with next-token cross entropy. The smashed tensor is the
(B, S, d_model) residual stream at the cut. The step is a ``SplitStep``
over the two modules, so ``core.split.make_multi_client_round`` drives it
as it drives the CNNs. The trained step's loss (``chunked_lm_loss``) runs
over chunks of tokens and never holds the whole (tokens, vocab) logits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.adaptive_cut import (profile_cuts_cnn,
                                 profile_cuts_transformer, select_cut)
from ..core.energy import HardwareProfile
from ..core.link import LinkConfig
from ..core.split import (SplitStep, Stage, make_split_loss, split_stack,
                          tier_params, to_port_layout)
from ..models.transformer import AttnLayer, GroupSpec, group_apply, group_init
from ..launch.mesh import server_only_mesh
from .engine import fleet_state, make_fleet_sl_round, validate_fleet_mesh


# ---------------------------------------------------------------------------
# cut assignment + bucketing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CutBucket:
    cut_index: int
    client_ids: tuple[int, ...]   # global client indices, ascending


def bucket_by_cut(cut_indices: Sequence[int]) -> list[CutBucket]:
    """Group clients by cut index, ascending cut then ascending client id:
    the buckets partition the fleet, every client exactly once."""
    by_cut: dict[int, list[int]] = {}
    for cid, k in enumerate(cut_indices):
        by_cut.setdefault(int(k), []).append(cid)
    return [CutBucket(k, tuple(ids)) for k, ids in sorted(by_cut.items())]


def _assign_cuts(profile_fn: Callable, edges: Sequence[HardwareProfile],
                 links: Optional[Sequence[LinkConfig]],
                 max_link_s: Optional[float]) -> list[int]:
    """Per-client selection: ``profile_fn(edge, link)`` gives one profile's
    cut choices, evaluated once a distinct (hardware, link) pair."""
    links = list(links) if links is not None else [LinkConfig()] * len(edges)
    if len(links) != len(edges):
        raise ValueError("edges and links must be per-client (same length)")
    cache: dict[tuple, int] = {}
    cuts = []
    for edge, link in zip(edges, links):
        key = (edge, link)
        if key not in cache:
            cache[key] = select_cut(profile_fn(edge, link),
                                    max_link_s=max_link_s).cut_index
        cuts.append(cache[key])
    return cuts


def assign_cuts_cnn(stages: Sequence[Stage], sample_x: torch.Tensor, *,
                    edges: Sequence[HardwareProfile],
                    links: Optional[Sequence[LinkConfig]] = None,
                    min_client_layers: int = 1,
                    max_link_s: Optional[float] = None) -> list[int]:
    """Per-client minimum-energy cut of a CNN stage list on the NHWC batch
    ``sample_x`` (its shape and dtype); ``edges`` (and ``links``) give each
    client its profile."""
    return _assign_cuts(
        lambda edge, link: profile_cuts_cnn(
            stages, sample_x, edge=edge, link=link,
            min_client_layers=min_client_layers),
        edges, links, max_link_s)


def assign_cuts_transformer(cfg: ArchConfig, *, batch: int, seq: int,
                            edges: Sequence[HardwareProfile],
                            links: Optional[Sequence[LinkConfig]] = None,
                            max_link_s: Optional[float] = None) -> list[int]:
    """Per-client minimum-energy cut of a transformer ``ArchConfig``'s
    stack at ``batch`` x ``seq`` tokens; ``edges`` (and ``links``) give
    each client its profile."""
    return _assign_cuts(
        lambda edge, link: profile_cuts_transformer(
            cfg, batch=batch, seq=seq, edge=edge, link=link),
        edges, links, max_link_s)


# ---------------------------------------------------------------------------
# split programs: one cut of a model as a SplitStep, templates and inits
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SplitProgram:
    """A model split at one cut: the step over two template modules (their
    own parameters are never used: ``core.split.make_split_loss`` binds
    a state's), and each tier's initial parameters, keyed as the
    templates' ``named_parameters()`` (every client of a bucket starts
    from the same prefix)."""
    step: SplitStep
    client: nn.Module             # stages[:k] (or blocks[:k])
    server: nn.Module             # stages[k:] (or blocks[k:])
    params_c0: dict
    params_s0: dict
    cut_index: int


def cnn_split_program(stages: Sequence[Stage], params: Sequence[dict],
                      k: int, *, loss_fn: Callable,
                      link_boundary: Optional[Callable] = None,
                      taps: tuple = ()) -> SplitProgram:
    """Split a CNN stage list at stage index ``k``. ``params`` are the
    per-stage parameter dicts (a plan's ``params0``); ``loss_fn(logits,
    targets) -> scalar`` closes the server side; ``link_boundary`` is the
    NCHW boundary (``FleetLink.boundary("nchw")``) or None; ``taps`` are
    the step-level metrics-bus channels (``SplitStep.taps``)."""
    if not 1 <= k <= len(stages) - 1:
        raise ValueError(f"cut {k} outside (0, {len(stages)})")
    step = SplitStep(
        client_fwd=lambda client, xx: client(to_port_layout(xx)),
        server_loss=lambda server, sm, yy: (loss_fn(server(sm), yy), {}),
        link_constraint=link_boundary, taps=taps)
    return SplitProgram(step=step, client=nn.Sequential(*stages[:k]),
                        server=nn.Sequential(*stages[k:]),
                        params_c0=tier_params(params[:k]),
                        params_s0=tier_params(params[k:]), cut_index=k)


def _initial(module: nn.Module) -> dict:
    """A module's parameters as a fresh state dict (its
    ``named_parameters()`` keys), detached from the module."""
    return {key: p.detach().clone() for key, p in module.named_parameters()}


def stack_split_program(blocks: nn.ModuleList, k: int, *,
                        block_apply: Callable, loss_fn: Callable,
                        link_boundary: Optional[Callable] = None,
                        taps: tuple = ()) -> SplitProgram:
    """Split a block stack at layer ``k`` (``core.split.split_stack``).

    ``block_apply(block, h) -> h`` applies ONE block module; ``loss_fn(h,
    targets) -> scalar`` closes the server side on the last hidden state.
    Each tier runs its blocks in turn, so ``step.client_fwd`` is the same
    function on either tier (``client_fwd(prog.server, smashed)`` runs the
    server's blocks); the initial parameters are the blocks' own."""
    client, server = split_stack(blocks, k)

    def run_blocks(stack: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
        for block in stack:
            h = block_apply(block, h)
        return h

    step = SplitStep(
        client_fwd=run_blocks,
        server_loss=lambda srv, sm, yy: (loss_fn(run_blocks(srv, sm), yy),
                                         {}),
        link_constraint=link_boundary, taps=taps)
    return SplitProgram(step=step, client=client, server=server,
                        params_c0=_initial(client), params_s0=_initial(server),
                        cut_index=k)


def arch_split_program(cfg: ArchConfig, generator: torch.Generator, k: int,
                       *, loss_fn: Callable,
                       link_boundary: Optional[Callable] = None,
                       window="cfg", attn_impl: str = "xla") -> SplitProgram:
    """Split a transformer ``ArchConfig`` at layer ``k`` through the
    stacked-block interface: one dense attention stack drawn from
    ``generator`` on its device (``models.transformer.group_init``), cut
    at ``k``, each block run by ``transformer_block_apply`` (which refuses
    MoE stacks, as the reference's does). The smashed tensor is the
    (batch, seq, d_model) residual stream at the cut, the paper's
    transformer SL boundary."""
    if not 1 <= k <= cfg.n_layers - 1:
        raise ValueError(f"cut {k} outside (0, {cfg.n_layers})")
    block_apply = transformer_block_apply(cfg, window=window,
                                          attn_impl=attn_impl)
    blocks = group_init(generator, cfg, GroupSpec("attn", cfg.n_layers, 0))
    return stack_split_program(blocks, k, block_apply=block_apply,
                               loss_fn=loss_fn, link_boundary=link_boundary)


# ---------------------------------------------------------------------------
# bucketed dispatch
# ---------------------------------------------------------------------------

class HeteroFleet:
    """Per-cut-bucket fleet engines over one client population.

    ``build_program(k) -> SplitProgram`` specializes the model to a cut;
    each bucket owns a ``make_fleet_sl_round`` (its own server suffix: a
    cut group is also a server-model group) and the client-stacked state
    of its clients. ``run_round(batches)`` takes each bucket's rows of the
    global (clients, local_steps, ...) batch dict on the device, runs the
    buckets one after another, and puts their losses back into
    (local_steps, clients). ``client_axis`` (``"vmap"`` or
    ``"shard_map"``) and ``mesh`` pass through to each bucket's round: a
    bucket whose size divides the mesh's ``data`` axis shards its clients
    over it, any other takes ``launch.mesh.server_only_mesh`` (its clients
    on every data rank, the same ``fsdp`` x ``tp`` server sub-mesh).
    ``server_pspecs_fn(params_s, mesh)`` (``launch.steps.
    fleet_server_pspecs``) gives a bucket's server suffix its specs on
    that sub-mesh; its params and AdamW moments are then DTensors.
    ``taps`` (engine metrics-bus channels; ``build_program`` gives steps
    with the matching ``SplitStep.taps``) makes each round also return
    the tap stacks, put back into global (local_steps, clients) tensors:
    a bucket's one-update-a-step channels fill its clients' columns."""

    def __init__(self, build_program: Callable[[int], SplitProgram],
                 cut_indices: Sequence[int], opt_c, opt_s, *,
                 local_rounds: int, client_dropout: bool = False,
                 server_reduce: str = "mean", client_axis: str = "vmap",
                 mesh=None, server_pspecs_fn: Optional[Callable] = None,
                 taps: tuple = ()):
        if client_axis not in ("vmap", "shard_map"):
            raise ValueError(f"client_axis must be 'vmap' or 'shard_map', "
                             f"got {client_axis!r}")
        from ..launch.steps import server_placements
        self.taps = tuple(taps)
        self.buckets = bucket_by_cut(cut_indices)
        self.local_rounds = local_rounds
        self.num_clients = len(cut_indices)
        self.client_dropout = client_dropout
        self.opt_c, self.opt_s = opt_c, opt_s
        self.programs: dict[int, SplitProgram] = {}
        self._rounds = []
        # each bucket's (mesh, server placements)
        self._layouts = []
        for bucket in self.buckets:
            prog = build_program(bucket.cut_index)
            if prog.cut_index != bucket.cut_index:
                raise ValueError("build_program returned a different cut")
            self.programs[bucket.cut_index] = prog
            b_mesh = mesh
            try:
                validate_fleet_mesh(b_mesh, len(bucket.client_ids))
            except ValueError:
                b_mesh = server_only_mesh(mesh)
            placements = (server_placements(server_pspecs_fn(
                prog.params_s0, b_mesh))
                if server_pspecs_fn is not None and b_mesh is not None
                else None)
            self._layouts.append((b_mesh, placements))
            self._rounds.append(make_fleet_sl_round(
                make_split_loss(prog.step, prog.client, prog.server),
                opt_c, opt_s, local_rounds=local_rounds,
                server_reduce=server_reduce, client_dropout=client_dropout,
                client_axis=client_axis, mesh=b_mesh,
                server_placements=placements, taps=self.taps))
        # the fleet's own live state (the run_round / bucket_state surface),
        # made on first use: callers that thread state through
        # init_states() / run_round_on never pay for it
        self._states = None

    def init_states(self, tiers: Optional[Callable[[int], tuple]] = None
                    ) -> list[tuple]:
        """Fresh per-bucket states ``(params_c, params_s, oc, os_)``, new
        tensors on every call: each bucket's clients stacked from its
        program's initial parameters, or from ``tiers(k) -> (params_c,
        params_s)``."""
        states = []
        for bucket, (b_mesh, placements) in zip(self.buckets,
                                                self._layouts):
            k = bucket.cut_index
            params_c, params_s = (
                tiers(k) if tiers is not None
                else (self.programs[k].params_c0, self.programs[k].params_s0))
            states.append(fleet_state(
                params_c, {key: v.clone() for key, v in params_s.items()},
                self.opt_c, self.opt_s, len(bucket.client_ids),
                mesh=b_mesh, server_placements=placements))
        return states

    def reset(self) -> None:
        """Re-initialize every bucket's live state, so one fleet can run
        several independent experiments."""
        self._states = self.init_states()

    def _live_states(self) -> list[tuple]:
        if self._states is None:
            self._states = self.init_states()
        return self._states

    @property
    def cut_of_client(self) -> list[int]:
        cuts = [0] * self.num_clients
        for bucket in self.buckets:
            for cid in bucket.client_ids:
                cuts[cid] = bucket.cut_index
        return cuts

    def bucket_state(self, i: int) -> tuple:
        """(params_c stack, params_s, oc stack, os_) of bucket ``i``."""
        return self._live_states()[i]

    def run_round(self, batches: dict, client_mask=None):
        """One global round on the fleet's own state: ``batches`` a dict of
        (clients, local_steps, ...) tensors; returns the (local_steps,
        clients) losses, every client's column filled once (and the tap
        dict with ``taps``). ``client_mask`` (a (clients,) 0/1 vector)
        needs ``client_dropout=True``."""
        self._states, *out = self.run_round_on(self._live_states(),
                                               batches, client_mask)
        return tuple(out) if self.taps else out[0]

    def run_round_on(self, states: list[tuple], batches: dict,
                     client_mask=None) -> tuple:
        """``run_round`` over caller-owned per-bucket states (from
        ``init_states``): returns ``(new_states, losses)``, and the tap dict
        third with ``taps``. A bucket whose clients are all masked keeps its
        state (the engine's all-masked guard)."""
        if client_mask is not None and not self.client_dropout:
            raise ValueError("client_mask needs HeteroFleet("
                             "client_dropout=True)")
        device = next(iter(batches.values())).device
        if client_mask is not None:
            client_mask = torch.as_tensor(client_mask, dtype=torch.float32,
                                          device=device)
        losses = torch.zeros((self.local_rounds, self.num_clients),
                             dtype=torch.float32, device=device)
        tap_out = {name: torch.zeros_like(losses) for name in self.taps}
        new_states = list(states)
        for i, bucket in enumerate(self.buckets):
            ids = torch.as_tensor(bucket.client_ids, device=device)
            sub = {key: v.index_select(0, ids) for key, v in batches.items()}
            mask = ()
            if self.client_dropout:
                mask = ((torch.ones(len(ids), device=device),)
                        if client_mask is None
                        else (client_mask.index_select(0, ids),))
            out = self._rounds[i](*states[i], sub, *mask)
            new_states[i] = tuple(out[:4])
            losses[:, ids] = out[4]
            if self.taps:
                for name, v in out[5].items():
                    # a (local_steps,) channel is the bucket's one update
                    # a step, the same for each of its clients
                    tap_out[name][:, ids] = v if v.dim() == 2 else v[:, None]
        if self.taps:
            return new_states, losses, tap_out
        return new_states, losses


# ---------------------------------------------------------------------------
# the split language model
# ---------------------------------------------------------------------------

EMBED_SCALE = 0.02      # embedding and head init scale (the reference's)


def transformer_block_apply(cfg: ArchConfig, *, window="cfg",
                            attn_impl: str = "xla") -> Callable:
    """``block_apply(block, h) -> h``: ONE attention layer of the stack
    through ``models.transformer.group_apply``, positions 0..S-1. Dense
    attention stacks only, as in the reference."""
    if cfg.n_experts:
        raise ValueError("transformer_block_apply serves dense attention "
                         "stacks; MoE groups need the aux-carrying "
                         "launch-layer forward")
    g = GroupSpec("attn", 1, 0)
    win = cfg.swa_window if window == "cfg" else window

    def block_apply(block: AttnLayer, h: torch.Tensor) -> torch.Tensor:
        b, s = h.shape[0], h.shape[1]
        positions = torch.arange(s, device=h.device).expand(b, s)
        h, _ = group_apply(cfg, g, [block], h, 0.0, positions=positions,
                           window=win, attn_impl=attn_impl)
        return h

    return block_apply


class LMClient(nn.Module):
    """Client tier: token embedding (V, d) in f32 + the first k blocks."""

    def __init__(self, cfg: ArchConfig, blocks: nn.ModuleList):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model))
        self.blocks = blocks


class LMServer(nn.Module):
    """Server tier: the remaining blocks + the output head (d, V) in f32."""

    def __init__(self, cfg: ArchConfig, blocks: nn.ModuleList):
        super().__init__()
        self.blocks = blocks
        self.head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab))


def lm_modules(cfg: ArchConfig, k: int) -> tuple[LMClient, LMServer]:
    """The two tiers' modules, parameters uninitialized (for shapes, e.g.
    on the meta device)."""
    blocks = nn.ModuleList(AttnLayer(cfg) for _ in range(cfg.n_layers))
    blocks_c, blocks_s = split_stack(blocks, k)
    return LMClient(cfg, blocks_c), LMServer(cfg, blocks_s)


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood over every position."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None].long()).mean()


# the chunked loss takes this many bytes of f32 logits at a time: 2,730
# token rows at SmolLM's vocabulary of 49,152
LOSS_CHUNK_BYTES = 512 * 2 ** 20


def loss_chunk_rows(vocab: int) -> int:
    """Token rows a chunk of the chunked loss holds (``LOSS_CHUNK_BYTES``
    of f32 logits)."""
    return max(1, LOSS_CHUNK_BYTES // (4 * vocab))


class _ChunkedLMLoss(torch.autograd.Function):
    """``groups`` next-token losses over the rows of ``h`` (rows, d), the
    rows split evenly into the groups, each the mean over its rows of
    ``lse(h @ head) - (h @ head)[target]``, and the gradients of each
    group's loss, formed in the forward chunk by chunk of ``chunk`` rows:
    ``p = softmax(logits)``, ``p[target] -= 1``, ``dh = p @ head^T / n``,
    ``dhead_g += h^T @ p / n``. No (rows, vocab) tensor beyond one chunk is
    held, forward or backward; the backward scales the saved gradients by
    the incoming ones, the head's as ``sum_g grad_g * dhead_g``.

    ``torch.func``-ready (``forward`` without ``ctx``, ``setup_context``, a
    ``vmap`` rule that folds the vmapped axis into the groups: the clients'
    token rows go through one call, each client keeps its own mean and its
    own head gradient; a vmapped head, a Monte-Carlo seed's own server,
    takes one call a seed). Without ``grad_enabled`` (the caller's grad mode),
    or when neither ``h`` nor ``head`` requires a gradient, the gradient
    work is skipped."""

    @staticmethod
    def forward(h, head, targets, groups, chunk, grad_enabled):
        want_h = grad_enabled and h.requires_grad
        want_head = grad_enabled and head.requires_grad
        rows = h.shape[0]
        per_group = rows // groups
        head32 = head.float()
        nll = torch.zeros(groups, dtype=torch.float32, device=h.device)
        dh = dhead = None
        if want_h:
            dh = torch.empty(rows, h.shape[1], dtype=torch.float32,
                             device=h.device)
        if want_head:
            dhead = torch.zeros(groups, *head.shape, dtype=torch.float32,
                                device=h.device)
        # chunks of even size, at most ``chunk`` rows
        chunk = -(-per_group // -(-per_group // chunk))
        for g in range(groups):
            for r0 in range(g * per_group, (g + 1) * per_group, chunk):
                r1 = min(r0 + chunk, (g + 1) * per_group)
                h_c = h[r0:r1].float()
                t_c = targets[r0:r1, None].long()
                logits = h_c @ head32
                lse = torch.logsumexp(logits, dim=-1)
                nll[g] += (lse - logits.gather(-1, t_c)[:, 0]).sum()
                if not (want_h or want_head):
                    continue
                p = logits.sub_(lse[:, None]).exp_()
                p.scatter_add_(-1, t_c, torch.full_like(lse[:, None], -1.0))
                p.div_(per_group)
                if want_h:
                    torch.mm(p, head32.t(), out=dh[r0:r1])
                if want_head:
                    dhead[g] += h_c.t() @ p
        return nll / per_group, dh, dhead

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, head = inputs[0], inputs[1]
        _, dh, dhead = output
        ctx.mark_non_differentiable(*(t for t in (dh, dhead)
                                      if t is not None))
        ctx.save_for_backward(dh, dhead)
        ctx.dtypes = (h.dtype, head.dtype)

    @staticmethod
    def backward(ctx, g_loss, _g_dh, _g_dhead):
        dh, dhead = ctx.saved_tensors
        want_h, want_head = ctx.needs_input_grad[:2]
        if (want_h and dh is None) or (want_head and dhead is None):
            raise RuntimeError("the chunked LM loss formed no gradient in "
                               "its forward (grad mode off, or the input "
                               "required none) and cannot be "
                               "differentiated")
        g_loss = g_loss.float()
        g_h = g_head = None
        if want_h:
            scale = g_loss.repeat_interleave(dh.shape[0] // g_loss.shape[0])
            g_h = (dh * scale[:, None]).to(ctx.dtypes[0])
        if want_head:
            g_head = (g_loss[:, None, None] * dhead).sum(0).to(
                ctx.dtypes[1])
        return g_h, g_head, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, h, head, targets, groups, chunk, grad_enabled):
        n = info.batch_size
        h = (h.movedim(in_dims[0], 0) if in_dims[0] is not None
             else h.expand(n, *h.shape))
        targets = (targets.movedim(in_dims[2], 0) if in_dims[2] is not None
                   else targets.expand(n, *targets.shape))
        if in_dims[1] is not None:
            # a head of its own at each index (a Monte-Carlo seed's server):
            # one call an index, each folding its own groups
            head = head.movedim(in_dims[1], 0)
            outs = [_ChunkedLMLoss.apply(h[i], head[i], targets[i], groups,
                                         chunk, grad_enabled)
                    for i in range(n)]
            loss, dh, dhead = (
                None if outs[0][j] is None
                else torch.stack([o[j] for o in outs]) for j in range(3))
            return (loss, dh, dhead), (0, None if dh is None else 0,
                                       None if dhead is None else 0)
        out = _ChunkedLMLoss.apply(h.reshape(-1, h.shape[-1]), head,
                                   targets.reshape(-1), n * groups, chunk,
                                   grad_enabled)
        loss, dh, dhead = out
        return ((loss.reshape(n, groups),
                 None if dh is None else dh.reshape(n, -1, dh.shape[-1]),
                 None if dhead is None
                 else dhead.reshape(n, groups, *dhead.shape[1:])),
                (0, None if dh is None else 0, None if dhead is None else 0))


def chunked_lm_loss(h: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor, *,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """``lm_loss(h @ head, targets)`` without the (tokens, vocab) logits:
    the same f32 arithmetic a row (logits ``h @ head``, their log-sum-exp,
    ``nll = lse - logit[target]``), the mean summed chunk by chunk of
    ``chunk`` token rows (default ``loss_chunk_rows(vocab)``), the
    gradients of ``h`` and ``head`` formed in the forward. ``h`` is
    (..., d), ``targets`` (...)."""
    chunk = loss_chunk_rows(head.shape[-1]) if chunk is None else chunk
    loss, _, _ = _ChunkedLMLoss.apply(h.reshape(-1, h.shape[-1]), head,
                                      targets.reshape(-1), 1, chunk,
                                      torch.is_grad_enabled())
    return loss[0]


def lm_split_step(cfg: ArchConfig, *,
                  link_boundary: Optional[Callable] = None, window="cfg",
                  attn_impl: str = "xla", chunked_loss: bool = False,
                  taps: tuple = ()) -> tuple[SplitStep, Callable]:
    """The split LM's ``SplitStep`` over (LMClient, LMServer) and its
    ``server_logits(server, smashed) -> (B, S, V)``. The server's loss is
    ``lm_loss`` of the whole logits, the reference's form, or with
    ``chunked_loss`` ``chunked_lm_loss``, which never holds them (the
    programs the engines train)."""
    block_apply = transformer_block_apply(cfg, window=window,
                                          attn_impl=attn_impl)

    def run_blocks(blocks, h):
        for block in blocks:
            h = block_apply(block, h)
        return h

    def client_fwd(client: LMClient, tokens):
        return run_blocks(client.blocks, client.embed[tokens.long()])

    def server_logits(server: LMServer, smashed):
        return run_blocks(server.blocks, smashed) @ server.head

    def server_loss(server: LMServer, smashed, targets):
        if chunked_loss:
            return chunked_lm_loss(run_blocks(server.blocks, smashed),
                                   server.head, targets), {}
        return lm_loss(server_logits(server, smashed), targets), {}

    step = SplitStep(client_fwd=client_fwd, server_loss=server_loss,
                     link_constraint=link_boundary, taps=taps)
    return step, server_logits


@dataclasses.dataclass(frozen=True)
class LMSplitProgram:
    """A trainable split language model: the step, the two tiers' initial
    modules, the cut, and the full forward for held-out evaluation."""
    step: SplitStep
    client: LMClient              # embed + blocks[:k]
    server: LMServer              # blocks[k:] + head
    cut_index: int
    server_logits: Callable       # (server, smashed) -> (B, S, V)


def lm_split_program(cfg: ArchConfig, generator: torch.Generator, k: int, *,
                     link_boundary: Optional[Callable] = None, window="cfg",
                     attn_impl: str = "xla",
                     taps: tuple = ()) -> LMSplitProgram:
    """Split a next-token LM built on ``cfg``'s dense attention stack at
    layer ``k``. The embedding, the blocks and the head are drawn in that
    order from ``generator`` (embedding and head N(0, 0.02^2) in f32). Its
    step trains on ``chunked_lm_loss``; ``taps`` are its metrics-bus
    channels (``SplitStep.taps``)."""
    if not 1 <= k <= cfg.n_layers - 1:
        raise ValueError(f"cut {k} outside (0, {cfg.n_layers})")
    embed = EMBED_SCALE * torch.randn(cfg.vocab, cfg.d_model,
                                      generator=generator)
    blocks = group_init(generator, cfg, GroupSpec("attn", cfg.n_layers, 0))
    head = EMBED_SCALE * torch.randn(cfg.d_model, cfg.vocab,
                                     generator=generator)
    blocks_c, blocks_s = split_stack(blocks, k)
    client, server = LMClient(cfg, blocks_c), LMServer(cfg, blocks_s)
    with torch.no_grad():
        client.embed.copy_(embed)
        server.head.copy_(head)
    step, server_logits = lm_split_step(cfg, link_boundary=link_boundary,
                                        window=window, attn_impl=attn_impl,
                                        chunked_loss=True, taps=taps)
    return LMSplitProgram(step=step, client=client, server=server,
                          cut_index=k, server_logits=server_logits)
