"""Transformer layer groups and the whole model, in PyTorch.

Counterpart of ``repro.models.transformer`` for every group kind: ``"attn"``
(dense or MoE FFNs, with arctic's dense residual), ``"rwkv"`` (RWKV-6),
``"jamba"`` (Mamba and attention sub-layers, dense and MoE FFNs), and the
encoder-decoder's ``"enc"`` (bidirectional attention, no RoPE) and
``"xdec"`` (self-attention, cross-attention over the encoder's output,
FFN): the group plan (``build_groups``, ``_split_at``,
``default_cut_layer``), one module per layer (a ``JambaBlock`` is one
super-block of ``attn_period`` sub-layers), the model (``model_init``:
embedding, groups tagged client or server, final norm, the encoder's norm
``enc_norm`` for an enc-dec config, a head only when the embedding is not
tied), the modality frontends (``patch_embed``: patch embeddings prepended
to the text; ``audio_frames``: the encoder's frames plus a sinusoidal
table), the full-sequence ``model_forward`` / ``lm_loss`` (the routers'
auxiliary loss summed over the MoE FFNs; the patch positions' logits
skipped), and the decode path: ``decode_state_init`` (KV caches, plain or
int8, the cross-attention's K/V, RWKV states and Mamba states, in the
reference's layout) and ``model_decode_step`` (one token through every
decoder group). A group is a homogeneous run of layers; where the reference
stacks each leaf on a leading layer axis and scans, the port keeps one
layer module per layer in an ``nn.ModuleList`` and loops. Parameter names
are the reference's pytree paths (``ln1.scale``, ``attn.wq.w``,
``xattn.wk.w``, ``mix.w_lora_a``, ``moe.w_gate``, ``sub0.mamba.A_log``,
...) so ``repro_torch.convert`` maps one onto the other.

``remat`` (``group_apply``, ``model_forward``, ``lm_loss``) recomputes each
layer's body in the backward pass (``torch.utils.checkpoint``, not
reentrant), the reference's ``jax.checkpoint`` of its scanned layer: only
the residual stream between layers is kept. The reference's activation
specs are kept at its five places (each layer's output, the embedding's,
the decode step's embedding) through ``parallel.sharding.shard_act``,
which redistributes a DTensor activation under a policy (the dry run's)
and leaves a plain tensor as it is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..kernels.attn.ops import attention
from ..parallel.sharding import shard_act
from . import modules as M
from .attention import (chunked_causal_attention, decode_attention,
                        qkv_project, update_kv_cache)
from .moe import MoE, moe_apply
from .ssm import (Mamba, RWKV6ChannelMix, RWKV6TimeMix, mamba_apply,
                  mamba_step, rwkv6_apply, rwkv6_ffn_apply, rwkv6_step)


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    kind: str                 # attn | rwkv | jamba | enc | xdec
    count: int                # layers (or super-blocks for jamba)
    layer_offset: int         # first absolute layer index
    moe: bool = False         # FFN is MoE (attn groups)
    tier: str = "server"      # client | server  (split-learning tier)


def build_groups(cfg: ArchConfig, *,
                 cut_layer: Optional[int] = None) -> list[GroupSpec]:
    """Homogeneous layer groups; optionally split at ``cut_layer``. The
    reference's plan for every config (ported kinds or not)."""
    groups: list[GroupSpec] = []
    if cfg.enc_dec:
        groups.append(GroupSpec("enc", cfg.n_enc_layers, 0))
        groups.append(GroupSpec("xdec", cfg.n_layers, cfg.n_enc_layers))
    elif cfg.ssm_kind == "rwkv6" and cfg.attn_period == 0:
        groups.append(GroupSpec("rwkv", cfg.n_layers, 0))
    elif cfg.ssm_kind == "mamba" and cfg.attn_period > 0:
        if cfg.n_layers % cfg.attn_period:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                             f"attn_period {cfg.attn_period}")
        groups.append(GroupSpec("jamba", cfg.n_layers // cfg.attn_period, 0))
    else:
        # attention stack; break where the moe-ness changes (deepseek layer 0)
        flags = [cfg.is_moe_layer(i) for i in range(cfg.n_layers)]
        start = 0
        for i in range(1, cfg.n_layers + 1):
            if i == cfg.n_layers or flags[i] != flags[start]:
                groups.append(GroupSpec("attn", i - start, start,
                                        moe=flags[start]))
                start = i
    if cut_layer is not None:
        groups = _split_at(groups, cut_layer, cfg)
    return groups


def _split_at(groups: list[GroupSpec], cut_layer: int,
              cfg: ArchConfig) -> list[GroupSpec]:
    """Split the group list at an absolute layer index and tag tiers. For
    enc-dec the cut lives in the encoder; for jamba it snaps to a
    super-block boundary."""
    out: list[GroupSpec] = []
    for g in groups:
        per = cfg.attn_period if g.kind == "jamba" else 1
        lo, hi = g.layer_offset, g.layer_offset + g.count * per
        if cut_layer <= lo:
            out.append(dataclasses.replace(g, tier="server"))
        elif cut_layer >= hi:
            out.append(dataclasses.replace(g, tier="client"))
        else:
            k = max(1, round((cut_layer - lo) / per))
            k = min(k, g.count - 1) if g.count > 1 else g.count
            if k > 0:
                out.append(dataclasses.replace(g, count=k, tier="client"))
            if g.count - k > 0:
                out.append(dataclasses.replace(
                    g, count=g.count - k, layer_offset=lo + k * per,
                    tier="server"))
    return out


def default_cut_layer(cfg: ArchConfig, client_fraction: float) -> int:
    """Paper SL_{a,b}: the client holds a fraction of the layers. MoE archs
    clamp the cut at the first MoE layer (experts stay server-side), except
    where every layer is MoE."""
    n = cfg.n_enc_layers if cfg.enc_dec else cfg.n_layers
    k = max(1, min(n - 1, int(math.ceil(client_fraction * n))))
    if cfg.n_experts and not cfg.enc_dec:
        fm = next((i for i in range(cfg.n_layers) if cfg.is_moe_layer(i)), n)
        if fm == 0:
            return k
        k = min(k, fm)
    return k


def _norm(cfg: ArchConfig) -> nn.Module:
    if cfg.norm == "layernorm":
        return M.LayerNorm(cfg.d_model, dtype=cfg.param_dtype)
    return M.RMSNorm(cfg.d_model, dtype=cfg.param_dtype)


def _ffn(cfg: ArchConfig) -> nn.Module:
    return (M.GeluFFN if cfg.ffn == "gelu" else M.SwiGLU)(
        cfg.d_model, cfg.d_ff, dtype=cfg.param_dtype)


def _moe(cfg: ArchConfig) -> MoE:
    """``_moe_init``: experts of width ``moe_d_ff`` (default ``d_ff``),
    the shared ones too."""
    d_ff = cfg.moe_d_ff or cfg.d_ff
    return MoE(cfg.d_model, cfg.n_experts, d_ff, cfg.top_k,
               n_shared=cfg.n_shared_experts, shared_d_ff=d_ff,
               dtype=cfg.param_dtype)


def _attn(cfg: ArchConfig, qkv_bias: bool) -> nn.ModuleDict:
    """``attn_init``: ``wq`` (d, H hd), ``wk``/``wv`` (d, Kh hd), ``wo``."""
    dt, d, hd = cfg.param_dtype, cfg.d_model, cfg.hd
    return nn.ModuleDict({
        "wq": M.Linear(d, cfg.n_heads * hd, bias=qkv_bias, dtype=dt),
        "wk": M.Linear(d, cfg.n_kv_heads * hd, bias=qkv_bias, dtype=dt),
        "wv": M.Linear(d, cfg.n_kv_heads * hd, bias=qkv_bias, dtype=dt),
        "wo": M.Linear(cfg.n_heads * hd, d, bias=False, dtype=dt),
    })


def _reset(module: nn.Module, generator: torch.Generator):
    """Draw a layer's parameters: each ``MoE`` and ``Mamba`` by its own
    ``reset_parameters``, every other ``Linear`` directly; norms keep
    their unit scales and zero biases."""
    inner = set()
    for mod in module.modules():
        if mod in inner:
            continue
        if isinstance(mod, (MoE, Mamba)):
            mod.reset_parameters(generator)
            inner.update(mod.modules())
        elif isinstance(mod, M.Linear):
            mod.reset_parameters(generator)


class AttnLayer(nn.Module):
    """[norm -> GQA attention -> residual] + [norm -> FFN -> residual]; with
    ``moe`` the FFN is an ``MoE`` (``moe``), plus a dense ``ffn`` beside it
    under ``cfg.dense_residual`` (arctic). With ``cross`` (an ``xdec``
    layer, ``_attn_layer_init(cross=True)``) it also holds the
    cross-attention's norm ``lnx`` and projections ``xattn`` (no biases)."""

    def __init__(self, cfg: ArchConfig, moe: bool = False,
                 cross: bool = False):
        super().__init__()
        self.ln1 = _norm(cfg)
        self.attn = _attn(cfg, cfg.qkv_bias)
        self.ln2 = _norm(cfg)
        self.lnx = _norm(cfg) if cross else None
        self.xattn = _attn(cfg, False) if cross else None
        self.moe = _moe(cfg) if moe else None
        self.ffn = _ffn(cfg) if not moe or cfg.dense_residual else None

    def reset_parameters(self, generator: torch.Generator):
        _reset(self, generator)


class RWKVLayer(nn.Module):
    """[ln1 -> RWKV-6 time mix -> residual] + [ln2 -> channel mix ->
    residual] (``_rwkv_layer_init``)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        dt = cfg.param_dtype
        self.ln1 = _norm(cfg)
        self.mix = RWKV6TimeMix(cfg.d_model, head_size=cfg.hd, dtype=dt)
        self.ln2 = _norm(cfg)
        self.ffn = RWKV6ChannelMix(cfg.d_model, cfg.d_ff, dtype=dt)

    def reset_parameters(self, generator: torch.Generator):
        self.mix.reset_parameters(generator)
        self.ffn.reset_parameters(generator)


class JambaSub(nn.Module):
    """Sub-layer i of a super-block of P: ``ln1``, then ``attn`` (i = P - 1)
    or ``mamba``; ``ln2``, then ``moe`` where i % moe_layer_period ==
    moe_layer_period - 1, else a dense ``ffn``."""

    def __init__(self, cfg: ArchConfig, i: int):
        super().__init__()
        is_attn = i == cfg.attn_period - 1
        is_moe = cfg.n_experts > 0 and (
            i % cfg.moe_layer_period == cfg.moe_layer_period - 1)
        self.ln1 = _norm(cfg)
        self.ln2 = _norm(cfg)
        self.attn = _attn(cfg, False) if is_attn else None
        self.mamba = None if is_attn else Mamba(
            cfg.d_model, expand=cfg.ssm_expand, state_dim=cfg.ssm_state_dim,
            conv_width=cfg.ssm_conv_width, dtype=cfg.param_dtype)
        self.moe = _moe(cfg) if is_moe else None
        self.ffn = None if is_moe else _ffn(cfg)


class JambaBlock(nn.Module):
    """``_jamba_super_init``: one super-block, ``sub0`` ... ``sub{P-1}``
    (P = ``attn_period``): P - 1 Mamba sub-layers, then attention."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.period = cfg.attn_period
        for i in range(cfg.attn_period):
            self.add_module(f"sub{i}", JambaSub(cfg, i))

    def subs(self) -> list[JambaSub]:
        return [getattr(self, f"sub{i}") for i in range(self.period)]

    def reset_parameters(self, generator: torch.Generator):
        _reset(self, generator)


LAYERS = {"attn": AttnLayer, "enc": AttnLayer, "xdec": AttnLayer,
          "rwkv": RWKVLayer, "jamba": JambaBlock}


def group_init(generator: torch.Generator, cfg: ArchConfig,
               g: GroupSpec) -> nn.ModuleList:
    """``g.count`` fresh layers of ``g.kind``, created on the generator's
    device and initialized in order from ``generator`` (weights drawn in
    f32 and stored in ``cfg.param_dtype``, unit norm scales, zero biases).
    The reference draws from threefry, so the values differ from
    ``repro``'s; parity runs import the reference's instead."""
    with torch.device(generator.device):
        layers = group_modules(cfg, g)
    for layer in layers:
        layer.reset_parameters(generator)
    return layers


def group_modules(cfg: ArchConfig, g: GroupSpec) -> nn.ModuleList:
    """``g.count`` layers of ``g.kind`` on the current default device,
    parameters uninitialized (``group_init`` draws them; on the meta device
    they give shapes)."""
    if g.kind not in LAYERS:
        raise ValueError(f"unknown layer group kind {g.kind!r}")
    if LAYERS[g.kind] is AttnLayer:
        return nn.ModuleList(AttnLayer(cfg, moe=g.moe, cross=g.kind == "xdec")
                             for _ in range(g.count))
    return nn.ModuleList(LAYERS[g.kind](cfg) for _ in range(g.count))


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


def _ffn_block(cfg: ArchConfig, p, x: torch.Tensor, aux,
               moe_groups: int = 1):
    """[norm -> FFN -> residual]: ``p.moe`` (with ``p.ffn`` added under
    ``cfg.dense_residual``) when the layer has one, its router's auxiliary
    loss added to ``aux``; else the dense ``p.ffn``."""
    h = p.ln2(x)
    if p.moe is not None:
        y, a = moe_apply(p.moe, h, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor,
                         n_groups=moe_groups)
        aux = aux + a
        if cfg.dense_residual:
            y = y + p.ffn(h)
    else:
        y = p.ffn(h)
    return x + y, aux


def group_apply(cfg: ArchConfig, g: GroupSpec, layers, x: torch.Tensor, aux,
                *, positions, window: Optional[int], enc_out=None,
                attn_impl: str = "xla", moe_groups: int = 1,
                remat: bool = False, act_spec=("dp", None, None)):
    """Full-sequence pass (train/prefill) over the group's layers.
    Returns (x, aux). RWKV layers start from the zero state: the time mix's
    new state is dropped, and the channel mix's ``x_prev`` is zero; so do
    a jamba block's Mamba sub-layers. An ``enc`` group attends both ways
    and rotates nothing (``positions`` unused); an ``xdec`` layer attends
    over ``enc_out`` (B, Senc, d) after its self-attention. ``moe_groups``
    is the MoE FFNs' grouped dispatch (``moe_apply(n_groups=)``). With
    ``remat`` each layer's body is recomputed in the backward pass; each
    layer's output (a jamba block's sub-layers' each) goes through
    ``shard_act(act_spec)``."""
    if g.kind not in LAYERS:
        raise ValueError(f"unknown layer group kind {g.kind!r}")
    if g.kind == "rwkv":
        def body(layer, x, aux):
            mix, _ = rwkv6_apply(layer.mix, layer.ln1(x), head_size=cfg.hd)
            x = x + mix
            hf = layer.ln2(x)
            x = x + rwkv6_ffn_apply(layer.ffn, hf, torch.zeros_like(hf[:, 0]))
            return shard_act(x, act_spec), aux
    elif g.kind == "jamba":
        def body(block, x, aux):
            for sub in block.subs():
                if sub.attn is not None:
                    x = _attn_block(cfg, sub, x, positions, window=window,
                                    attn_impl=attn_impl)
                else:
                    x = x + mamba_apply(sub.mamba, sub.ln1(x),
                                        expand=cfg.ssm_expand,
                                        state_dim=cfg.ssm_state_dim,
                                        conv_width=cfg.ssm_conv_width)[0]
                x, aux = _ffn_block(cfg, sub, x, aux, moe_groups)
                x = shard_act(x, act_spec)
            return x, aux
    else:                                            # attn, enc, xdec
        def body(layer, x, aux):
            x = _attn_block(cfg, layer, x, positions, window=window,
                            causal=g.kind != "enc", attn_impl=attn_impl)
            if g.kind == "xdec":
                x = x + _x_cross(cfg, layer, x, enc_out)
            x, aux = _ffn_block(cfg, layer, x, aux, moe_groups)
            return shard_act(x, act_spec), aux
    for layer in layers:
        if remat:
            # the model draws no random numbers: no RNG state to keep
            x, aux = checkpoint(body, layer, x, aux, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = body(layer, x, aux)
    return x, aux


def _x_cross(cfg: ArchConfig, layer: AttnLayer, h: torch.Tensor,
             enc_out: torch.Tensor) -> torch.Tensor:
    """The cross-attention sublayer of a whisper decoder layer: ``lnx``, q
    from the decoder, k and v from the encoder's output, no RoPE, no mask,
    through the chunked plain path (no kernel, as in the reference)."""
    q_in = layer.lnx(h)
    b, s, _ = q_in.shape
    sk = enc_out.shape[1]
    xp = layer.xattn
    q = xp["wq"](q_in).reshape(b, s, cfg.n_heads, cfg.hd)
    k = xp["wk"](enc_out).reshape(b, sk, cfg.n_kv_heads, cfg.hd)
    v = xp["wv"](enc_out).reshape(b, sk, cfg.n_kv_heads, cfg.hd)
    out = chunked_causal_attention(q, k, v, window=None, causal=False)
    return xp["wo"](out.reshape(b, s, cfg.n_heads * cfg.hd))


# ---------------------------------------------------------------------------
# model assembly
# ---------------------------------------------------------------------------

def vocab_padded(cfg: ArchConfig) -> int:
    """The vocab padded to a multiple of 16 (whisper's 51865 -> 51872), as
    the reference shards it. Padded ids never appear as labels."""
    return -(-cfg.vocab // 16) * 16


class Model(nn.Module):
    """``model_init``'s tree as a module: ``embed.table`` (V_pad, d),
    ``final_norm``, ``groups`` (one ``ModuleList`` of layers per
    ``GroupSpec`` of ``build_groups(cfg, cut_layer)``, in order; their
    tiers are in ``specs``), ``enc_norm`` for an enc-dec config and, when
    the embedding is not tied, ``head.w`` (d, V_pad). Given a
    ``generator``, the embedding, then each group's layers
    (``group_init``), then the head are drawn from it in that order; without
    one the parameters stay uninitialized (``convert`` builds the model so
    on the meta device, for shapes)."""

    def __init__(self, cfg: ArchConfig, specs: list[GroupSpec],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.specs = list(specs)
        self.embed = M.Embed(vocab_padded(cfg), cfg.d_model,
                             dtype=cfg.param_dtype)
        if generator is not None:
            self.embed.reset_parameters(generator)
        self.final_norm = _norm(cfg)
        self.enc_norm = _norm(cfg) if cfg.enc_dec else None
        self.groups = nn.ModuleList(
            group_modules(cfg, g) if generator is None
            else group_init(generator, cfg, g) for g in self.specs)
        self.head = (None if cfg.tie_embeddings else
                     M.Linear(cfg.d_model, vocab_padded(cfg), bias=False,
                              dtype=cfg.param_dtype))
        if generator is not None and self.head is not None:
            self.head.reset_parameters(generator)


def model_init(cfg: ArchConfig, generator: torch.Generator, *,
               cut_layer: Optional[int] = None, device=None) -> Model:
    """``model_init``: the model of ``cfg`` cut at ``cut_layer``, drawn
    from ``generator`` on its own device (a CUDA generator draws on the
    card), then moved to ``device`` when one is given."""
    with torch.device(generator.device):
        model = Model(cfg, build_groups(cfg, cut_layer=cut_layer), generator)
    return model if device is None else model.to(device)


def _sinusoids(length: int, d: int, device=None) -> torch.Tensor:
    """The encoder's (length, d) f32 position table: [sin | cos] of
    pos / 10000^(2i/d) for i < d/2 (``_embed_inputs``)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_inputs(cfg: ArchConfig, model: Model, batch: dict):
    """Token embedding (+ frontend). ``patch_embed``: the batch's
    ``patch_embeds`` (B, Np, d) in the embedding's dtype, prepended to the
    text, positions over Np + S. Enc-dec: the encoder's input, the batch's
    ``frames`` (B, Senc, d) in the embedding's dtype plus ``_sinusoids``
    cast to it. Returns (x, positions, enc_x), enc_x None without an
    encoder."""
    x = model.embed(batch["tokens"])
    if cfg.frontend == "patch_embed":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)
    enc_x = None
    if cfg.enc_dec:
        enc_x = batch["frames"].to(x.dtype)
        enc_x = enc_x + _sinusoids(enc_x.shape[1], cfg.d_model,
                                  device=x.device).to(enc_x.dtype)
    return x, positions, enc_x


def model_forward(cfg: ArchConfig, model: Model, batch: dict, *,
                  window="cfg", cut_layer: Optional[int] = None,
                  moe_groups: int = 1, remat: bool = False,
                  seq_parallel_tiers: tuple = (), attn_impl: str = "xla"):
    """Full-sequence forward. Returns (logits (B, S, V_pad), aux: the MoE
    routers' auxiliary losses summed, f32); S counts the patch positions of
    a ``patch_embed`` config. The encoder groups run first, over the
    frames; ``enc_norm`` of the last one's output is what every ``xdec``
    group attends to. Attention takes the chunked plain path
    (``attn_impl="xla"``), as the reference's ``model_forward`` does
    (``"ref"``, the O(S^2) oracle, is the dry run's); RWKV groups the WKV
    kernel. A decoder group whose tier is in ``seq_parallel_tiers`` keeps
    its activations split over ``tp`` on the sequence (``shard_act``)."""
    if window == "cfg":
        window = cfg.swa_window
    specs = build_groups(cfg, cut_layer=cut_layer)
    if specs != model.specs:
        raise ValueError(f"the model was built for groups {model.specs}, "
                         f"not {specs} (cut_layer={cut_layer})")
    x, positions, enc_x = _embed_inputs(cfg, model, batch)
    x = shard_act(x, ("dp", None, None))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_enc = sum(g.kind == "enc" for g in specs)
    enc_out = None
    for i, (g, layers) in enumerate(zip(specs, model.groups)):
        if g.kind == "enc":
            enc_x, aux = group_apply(cfg, g, layers, enc_x, aux,
                                     positions=None, window=None,
                                     attn_impl=attn_impl, remat=remat)
            if i == n_enc - 1:
                enc_out = model.enc_norm(enc_x)
        else:
            act = (("dp", "tp", None) if g.tier in seq_parallel_tiers
                   else ("dp", None, None))
            x, aux = group_apply(cfg, g, layers, x, aux, positions=positions,
                                 window=window, enc_out=enc_out,
                                 moe_groups=moe_groups, attn_impl=attn_impl,
                                 remat=remat, act_spec=act)
    x = model.final_norm(x)
    logits = (model.embed.logits(x) if model.head is None
              else model.head(x))
    return logits, aux


def lm_loss(cfg: ArchConfig, model: Model, batch: dict, *, window="cfg",
            cut_layer: Optional[int] = None, moe_groups: int = 1,
            remat: bool = False, seq_parallel_tiers: tuple = (),
            attn_impl: str = "xla"):
    """Next-token cross entropy (+ ``router_aux_coef`` x the router aux):
    f32 log-softmax over the padded vocab, on the text positions only (a
    ``patch_embed`` config's first Np logits are skipped). Returns (loss,
    {"ce", "aux"})."""
    logits, aux = model_forward(cfg, model, batch, window=window,
                                cut_layer=cut_layer, moe_groups=moe_groups,
                                remat=remat,
                                seq_parallel_tiers=seq_parallel_tiers,
                                attn_impl=attn_impl)
    if cfg.frontend == "patch_embed":
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp[:, :-1], -1, labels[:, 1:, None])[..., 0]
    ce = -ll.mean()
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode: state init + one-token step
# ---------------------------------------------------------------------------

def decode_state_init(cfg: ArchConfig, batch_size: int, max_len: int, *,
                      window="cfg", cut_layer: Optional[int] = None,
                      dtype: Optional[torch.dtype] = None,
                      kv_dtype: str = "param", device=None) -> list[dict]:
    """The decode state of each group of ``build_groups(cfg, cut_layer)``,
    zero, in the reference's layout: every leaf has a leading layer axis of
    ``g.count``. An ``attn`` group holds ``k``/``v`` (count, B, C, Kh, hd)
    in ``dtype`` (default ``cfg.param_dtype``), C = min(window, max_len)
    under a sliding window and max_len without, or int8 codes with f32
    ``k_scale``/``v_scale`` (count, B, C, Kh) when ``kv_dtype="int8"``; an
    ``rwkv`` group holds ``S`` (count, B, H, hd, hd) f32 and the two token
    shifts ``x_prev``/``ffn_x_prev`` (count, B, d) in ``dtype``; an ``enc``
    group nothing; an ``xdec`` group ``k``/``v`` (count, B, max_len, Kh,
    hd) and the cross-attention's ``ck``/``cv`` (count, B, enc_seq_len,
    Kh, hd), all in ``dtype`` whatever ``kv_dtype`` and window (the
    reference's layout; ``launch.serve.transcribe`` fills ``ck``/``cv``)."""
    if window == "cfg":
        window = cfg.swa_window
    dtype = dtype or cfg.param_dtype
    cache_len = min(window, max_len) if window else max_len
    state = []
    for g in build_groups(cfg, cut_layer=cut_layer):
        def zeros(*shape, dt=dtype):
            return torch.zeros((g.count, batch_size) + shape, dtype=dt,
                               device=device)

        def kv_cache(suffix=""):
            kv = (cache_len, cfg.n_kv_heads, cfg.hd)
            kdt = torch.int8 if kv_dtype == "int8" else dtype
            st = {f"k{suffix}": zeros(*kv, dt=kdt),
                  f"v{suffix}": zeros(*kv, dt=kdt)}
            if kv_dtype == "int8":
                st[f"k{suffix}_scale"] = zeros(*kv[:2], dt=torch.float32)
                st[f"v{suffix}_scale"] = zeros(*kv[:2], dt=torch.float32)
            return st

        if g.kind == "attn":
            st = kv_cache()
        elif g.kind == "jamba":
            d_inner = cfg.ssm_expand * cfg.d_model
            st = {}
            for i in range(cfg.attn_period - 1):
                st[f"h{i}"] = zeros(d_inner, cfg.ssm_state_dim,
                                    dt=torch.float32)
                st[f"c{i}"] = zeros(cfg.ssm_conv_width - 1, d_inner)
            st.update(kv_cache(cfg.attn_period - 1))
        elif g.kind == "rwkv":
            st = {"S": zeros(cfg.d_model // cfg.hd, cfg.hd, cfg.hd,
                             dt=torch.float32),
                  "x_prev": zeros(cfg.d_model),
                  "ffn_x_prev": zeros(cfg.d_model)}
        elif g.kind == "enc":
            st = {}
        elif g.kind == "xdec":
            kv = (cfg.n_kv_heads, cfg.hd)
            st = {"k": zeros(max_len, *kv), "v": zeros(max_len, *kv),
                  "ck": zeros(cfg.enc_seq_len, *kv),
                  "cv": zeros(cfg.enc_seq_len, *kv)}
        else:
            raise ValueError(f"unknown layer group kind {g.kind!r}")
        state.append(st)
    return state


def _quant_kv(x: torch.Tensor):
    """(B, 1, Kh, hd) -> int8 codes and the per-(B, 1, Kh) f32 scale
    absmax / 127 (at least 1e-8), codes rounded half to even."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def _decode_attn_sub(cfg: ArchConfig, p_attn, h: torch.Tensor, pos: int,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                     window, scales=None):
    """One token's attention against a (possibly ring) cache, which it
    writes in place: h (B, 1, d); caches (B, C, Kh, hd) in the compute
    dtype, or int8 with ``scales`` ``{"k", "v"}`` (B, C, Kh) f32. Under a
    window the token goes to the ring slot ``pos % C``. Returns the
    attention's output (B, 1, d)."""
    b = h.shape[0]
    posb = torch.full((b, 1), pos, dtype=torch.int64, device=h.device)
    q, k, v = qkv_project(p_attn, h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          posb, rope_theta=cfg.rope_theta)
    cache_size = cache_k.shape[1]
    slot = pos % cache_size if window else pos
    if scales is not None:                      # the int8 KV cache
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        update_kv_cache(cache_k, cache_v, kq, vq, slot)
        scales["k"][:, slot:slot + 1] = ks
        scales["v"][:, slot:slot + 1] = vs
        # dequantized straight to the compute dtype, as the reference does
        k_eff = cache_k.to(q.dtype) * scales["k"][..., None].to(q.dtype)
        v_eff = cache_v.to(q.dtype) * scales["v"][..., None].to(q.dtype)
    else:
        update_kv_cache(cache_k, cache_v, k, v, slot)
        k_eff, v_eff = cache_k, cache_v
    out = decode_attention(q, k_eff, v_eff, min(pos + 1, cache_size))
    return p_attn["wo"](out.reshape(b, 1, cfg.n_heads * cfg.hd))


def _kv_scales(gstate: dict, li: int, suffix=""):
    if f"k{suffix}_scale" not in gstate:
        return None
    return {"k": gstate[f"k{suffix}_scale"][li],
            "v": gstate[f"v{suffix}_scale"][li]}


def _group_decode(cfg: ArchConfig, g: GroupSpec, layers, gstate: dict,
                  x: torch.Tensor, pos: int, *, window):
    """One token through the group's layers, each reading and writing its
    row of the group's state in place. Returns x. An MoE FFN routes the
    step's B tokens (capacity max(4, ceil(B k factor / E)): nothing drops
    at decode) and its router's aux is dropped. An ``xdec`` layer's token
    attends, after its self-attention, over the whole of its ``ck``/``cv``
    (the encoder's length), which it leaves as they are."""
    if g.kind in ("attn", "xdec"):
        for li, layer in enumerate(layers):
            x = x + _decode_attn_sub(
                cfg, layer.attn, layer.ln1(x), pos, gstate["k"][li],
                gstate["v"][li], window=window,
                scales=_kv_scales(gstate, li))
            if g.kind == "xdec":
                b = x.shape[0]
                q = layer.xattn["wq"](layer.lnx(x)).reshape(
                    b, 1, cfg.n_heads, cfg.hd)
                ck = gstate["ck"][li]
                xo = decode_attention(q, ck, gstate["cv"][li], ck.shape[1])
                x = x + layer.xattn["wo"](xo.reshape(b, 1,
                                                     cfg.n_heads * cfg.hd))
            x, _ = _ffn_block(cfg, layer, x, 0.0)
        return x
    if g.kind == "jamba":
        for li, block in enumerate(layers):
            for i, sub in enumerate(block.subs()):
                if sub.attn is not None:
                    x = x + _decode_attn_sub(
                        cfg, sub.attn, sub.ln1(x), pos, gstate[f"k{i}"][li],
                        gstate[f"v{i}"][li], window=window,
                        scales=_kv_scales(gstate, li, i))
                else:
                    h, conv = gstate[f"h{i}"][li], gstate[f"c{i}"][li]
                    y, ms = mamba_step(sub.mamba, sub.ln1(x),
                                       {"h": h, "conv": conv})
                    x = x + y
                    h.copy_(ms["h"])
                    conv.copy_(ms["conv"])
                x, _ = _ffn_block(cfg, sub, x, 0.0)
        return x
    if g.kind != "rwkv":
        raise ValueError(f"no decode step for the {g.kind!r} group")
    for li, layer in enumerate(layers):
        mix, mst = rwkv6_step(layer.mix, layer.ln1(x),
                              {"S": gstate["S"][li],
                               "x_prev": gstate["x_prev"][li]},
                              head_size=cfg.hd)
        x = x + mix
        hf = layer.ln2(x)
        x = x + rwkv6_ffn_apply(layer.ffn, hf, gstate["ffn_x_prev"][li])
        gstate["S"][li].copy_(mst["S"])
        gstate["x_prev"][li].copy_(mst["x_prev"])
        gstate["ffn_x_prev"][li].copy_(hf[:, -1, :])
    return x


def model_decode_step(cfg: ArchConfig, model: Model, state: list,
                      token: torch.Tensor, pos: int, *, window="cfg",
                      cut_layer: Optional[int] = None):
    """One decode step: token (B, 1) ids at position ``pos`` (an int: the
    tokens so far) through every decoder group (``enc`` groups are passed
    by; a ``patch_embed`` config decodes text only), from ``state``
    (``decode_state_init``), which it updates in place. Returns (logits
    (B, 1, V_pad), state). Call it under ``torch.no_grad()``: the WKV
    kernel then keeps no checkpoints and nothing keeps a graph."""
    if window == "cfg":
        window = cfg.swa_window
    specs = build_groups(cfg, cut_layer=cut_layer)
    if specs != model.specs:
        raise ValueError(f"the model was built for groups {model.specs}, "
                         f"not {specs} (cut_layer={cut_layer})")
    pos = int(pos)
    x = shard_act(model.embed(token), (None, None, "tp"))
    for g, layers, gs in zip(specs, model.groups, state):
        if g.kind != "enc":
            x = _group_decode(cfg, g, layers, gs, x, pos, window=window)
    x = model.final_norm(x)
    logits = (model.embed.logits(x) if model.head is None
              else model.head(x))
    return logits, state
