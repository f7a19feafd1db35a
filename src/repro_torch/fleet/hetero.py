"""The split language model: a transformer ``ArchConfig`` stack cut at layer k.

Counterpart of the transformer half of ``repro.fleet.hetero``
(``transformer_block_apply``, ``lm_split_program``). The client tier holds
the token embedding and the first k blocks (raw tokens never cross the
link); the server tier holds the other blocks and the output head, and
closes with next-token cross entropy. The smashed tensor is the (B, S,
d_model) residual stream at the cut. The step is a ``SplitStep`` over the
two modules, so ``core.split.make_multi_client_round`` drives it as it
drives the CNNs.
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


def lm_split_step(cfg: ArchConfig, *,
                  link_boundary: Optional[Callable] = None, window="cfg",
                  attn_impl: str = "xla") -> tuple[SplitStep, Callable]:
    """The split LM's ``SplitStep`` over (LMClient, LMServer) and its
    ``server_logits(server, smashed) -> (B, S, V)``."""
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
    order from ``generator`` (embedding and head N(0, 0.02^2) in f32)."""
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
                                        window=window, attn_impl=attn_impl)
    return LMSplitProgram(step=step, client=client, server=server,
                          cut_index=k, server_logits=server_logits)
