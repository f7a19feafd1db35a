"""Transformer layer groups: the dense ``"attn"`` kind, in PyTorch.

Counterpart of the ``"attn"`` part of ``repro.models.transformer``. A group
is a homogeneous run of layers; where the reference stacks each leaf on a
leading layer axis and scans, the port keeps one ``AttnLayer`` module per
layer in an ``nn.ModuleList`` and loops. Parameter names are the
reference's pytree paths (``ln1.scale``, ``attn.wq.w``, ``ffn.gate.w``, ...)
so ``repro_torch.convert.lm_from_reference`` maps one onto the other.

The other group kinds (``rwkv``, ``jamba``, ``enc``, ``xdec``) and MoE FFNs
are not ported yet: they raise ``NotImplementedError`` (ROADMAP queue 1
item 17). The reference's ``shard_act`` has no counterpart on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.attn.ops import attention
from . import modules as M
from .attention import chunked_causal_attention


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    kind: str                 # attn | rwkv | jamba | enc | xdec
    count: int                # layers (or super-blocks for jamba)
    layer_offset: int         # first absolute layer index
    moe: bool = False         # FFN is MoE (attn groups)
    tier: str = "server"      # client | server  (split-learning tier)


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to repro_torch yet "
                              f"(ROADMAP queue 1 item 17)")


def _check_group(g: GroupSpec):
    if g.kind != "attn":
        _not_ported(f"the {g.kind!r} layer group")
    if g.moe:
        _not_ported("the MoE FFN")


def _norm(cfg: ArchConfig) -> nn.Module:
    if cfg.norm == "layernorm":
        return M.LayerNorm(cfg.d_model, dtype=cfg.param_dtype)
    return M.RMSNorm(cfg.d_model, dtype=cfg.param_dtype)


class AttnLayer(nn.Module):
    """[norm -> GQA attention -> residual] + [norm -> FFN -> residual]."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        dt, d, hd = cfg.param_dtype, cfg.d_model, cfg.hd
        self.ln1 = _norm(cfg)
        self.attn = nn.ModuleDict({
            "wq": M.Linear(d, cfg.n_heads * hd, bias=cfg.qkv_bias, dtype=dt),
            "wk": M.Linear(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                           dtype=dt),
            "wv": M.Linear(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                           dtype=dt),
            "wo": M.Linear(cfg.n_heads * hd, d, bias=False, dtype=dt),
        })
        self.ln2 = _norm(cfg)
        self.ffn = (M.GeluFFN if cfg.ffn == "gelu" else M.SwiGLU)(
            d, cfg.d_ff, dtype=dt)


def group_init(generator: torch.Generator, cfg: ArchConfig,
               g: GroupSpec) -> nn.ModuleList:
    """``g.count`` fresh layers, initialized in order from ``generator``
    (lecun-normal weights drawn in f32 and stored in ``cfg.param_dtype``,
    unit norm scales, zero biases). The reference draws from threefry, so
    the values differ from ``repro``'s; parity runs import the reference's
    instead."""
    _check_group(g)
    layers = nn.ModuleList(AttnLayer(cfg) for _ in range(g.count))
    for mod in layers.modules():
        if isinstance(mod, M.Linear):
            mod.reset_parameters(generator)
    return layers


def _attn_block(cfg: ArchConfig, p: AttnLayer, x: torch.Tensor, positions,
                *, window, causal: bool = True, attn_impl: str = "xla"):
    """One attention sublayer (pre-norm residual). ``attn_impl`` is the
    kernel seam: ``"xla"`` the chunked plain path, ``"pallas"`` the flash
    kernel (its plain version on a CPU tensor), ``"ref"`` the O(S^2)
    oracle, the last two through ``kernels.attn.ops.attention``."""
    h = p.ln1(x)
    b, s, _ = h.shape
    q = p.attn["wq"](h).reshape(b, s, cfg.n_heads, cfg.hd)
    k = p.attn["wk"](h).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = p.attn["wv"](h).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if causal:
        q = M.apply_rope(q, positions, theta=cfg.rope_theta)
        k = M.apply_rope(k, positions, theta=cfg.rope_theta)
    if attn_impl == "xla":
        out = chunked_causal_attention(q, k, v, window=window, causal=causal)
    elif attn_impl in ("pallas", "ref"):
        out = attention(q, k, v, causal=causal, window=window,
                        use_kernel=attn_impl == "pallas")
    else:
        raise ValueError(f"attn_impl must be resolved to 'xla', 'pallas' or "
                         f"'ref', got {attn_impl!r}")
    out = p.attn["wo"](out.reshape(b, s, cfg.n_heads * cfg.hd))
    return x + out


def _ffn_block(cfg: ArchConfig, p: AttnLayer, x: torch.Tensor, aux,
               moe: bool = False):
    if moe:
        _not_ported("the MoE FFN")
    return x + p.ffn(p.ln2(x)), aux


def group_apply(cfg: ArchConfig, g: GroupSpec, layers, x: torch.Tensor, aux,
                *, positions, window: Optional[int],
                attn_impl: str = "xla"):
    """Full-sequence pass (train/prefill) over the group's layers.
    Returns (x, aux)."""
    _check_group(g)
    for layer in layers:
        x = _attn_block(cfg, layer, x, positions, window=window,
                        attn_impl=attn_impl)
        x, aux = _ffn_block(cfg, layer, x, aux, moe=g.moe)
    return x, aux
