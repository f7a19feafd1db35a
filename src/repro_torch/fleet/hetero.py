"""The split language model: a transformer ``ArchConfig`` stack cut at layer k.

Counterpart of the transformer half of ``repro.fleet.hetero``
(``transformer_block_apply``, ``lm_split_program``). The client tier holds
the token embedding and the first k blocks (raw tokens never cross the
link); the server tier holds the other blocks and the output head, and
closes with next-token cross entropy. The smashed tensor is the (B, S,
d_model) residual stream at the cut. The step is a ``SplitStep`` over the
two modules, so ``core.split.make_multi_client_round`` drives it as it
drives the CNNs. The trained step's loss (``chunked_lm_loss``) runs over
chunks of tokens and never holds the whole (tokens, vocab) logits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.split import SplitStep, split_stack
from ..models.transformer import AttnLayer, GroupSpec, group_apply, group_init

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
    own head gradient). Without ``grad_enabled`` (the caller's grad mode),
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
        if in_dims[1] is not None:
            raise ValueError("the chunked LM loss takes one head shared by "
                             "the vmapped axis (in_dims None for head)")
        n = info.batch_size
        h = (h.movedim(in_dims[0], 0) if in_dims[0] is not None
             else h.expand(n, *h.shape))
        targets = (targets.movedim(in_dims[2], 0) if in_dims[2] is not None
                   else targets.expand(n, *targets.shape))
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
                  attn_impl: str = "xla", chunked_loss: bool = False
                  ) -> tuple[SplitStep, Callable]:
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
                     link_constraint=link_boundary)
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
                     attn_impl: str = "xla") -> LMSplitProgram:
    """Split a next-token LM built on ``cfg``'s dense attention stack at
    layer ``k``. The embedding, the blocks and the head are drawn in that
    order from ``generator`` (embedding and head N(0, 0.02^2) in f32). Its
    step trains on ``chunked_lm_loss``."""
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
                                        chunked_loss=True)
    return LMSplitProgram(step=step, client=client, server=server,
                          cut_index=k, server_logits=server_logits)
