"""Step builders: (train | prefill | decode) x (arch x input shape x mesh)
(counterpart of ``repro.launch.steps``).

Each builder returns a ``BuiltStep``: the step as a plain callable over
live tensors, meta-device stand-ins for its arguments (``args_sds``: no
memory behind them) and a tree of ``parallel.sharding.P`` specs for every
input and output (``in_shardings``/``out_shardings``; ``to_placements``
turns one into DTensor placements on a ``DeviceMesh``). The dry run
(``launch.dryrun``) makes DTensors of those stand-ins on a fake mesh and
traces the step; a launcher on a one-rank mesh feeds it the live tensors,
where every spec is replicated.

Split learning is first-class, as in the reference: every step is built
around the ``SplitConfig`` cut, client groups get data-parallel-only specs,
server groups 2D (fsdp x tp).

The port's model is a module: a step's ``params`` is a dict keyed by the
``Model``'s parameter names (``groups.0.3.attn.wq.w``, ...), bound to a
meta-device skeleton of the model for the whole step, forward and
backward (a recomputed layer reads them in the backward); its
specs are ``parallel.sharding.model_pspecs``, the reference's
``param_pspecs`` leaf for leaf with the stacked layer axis dropped. The
optimizer state is ``optim.OptState`` (the reference's, with dicts keyed
as the params), updated by ``optim.FunctionalAdamW``. ``attn_impl``
(``"xla"``, the chunked plain path, by default) is the port's own option:
the dry run traces the O(S^2) oracle (``"ref"``) instead (its docstring
says why). ``fleet_server_pspecs`` gives the fleet engines' server suffix
its specs on the ``fsdp`` x ``tp`` sub-mesh (``server_placements`` turns
them into DTensor placements). The reference's
``PerfOptions.donate`` and ``BuiltStep.donate_argnums`` have no
counterpart: a PyTorch step donates no buffer (the decode step writes its
state in place, the train step returns new tensors).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Optional

import torch
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module

from ..checkpoint.ckpt import tree_flatten_with_paths, tree_unflatten_like
from ..configs.base import INPUT_SHAPES, ArchConfig, InputShape, SplitConfig
from ..models.transformer import (Model, _group_decode, build_groups,
                                  decode_state_init, default_cut_layer,
                                  group_apply, group_modules, lm_loss,
                                  model_decode_step, model_forward,
                                  vocab_padded)
from ..optim import FunctionalAdamW, OptState
from ..parallel.sharding import (TP_AXIS, P, ShardingPolicy, axis_names,
                                 mesh_axis_sizes, model_pspecs, set_policy,
                                 to_placements)

# long-context variant for full-attention archs: block-sparse sliding window
LONG_CONTEXT_WINDOW = 8192


@dataclasses.dataclass(frozen=True)
class PerfOptions:
    """Beyond-paper performance levers (the reference's).

    seq_parallel_client: shard the sequence over the idle 'model' axis
        during the client-tier phase (weights stay replicated -> still
        faithful to 'edge devices cannot do TP').
    seq_parallel_server: same for the server tier (Megatron-SP).
    moe_groups: GShard-style grouped MoE dispatch (1 = global).
    kv_dtype: 'param' | 'int8' — quantized KV cache for decode.
    """
    seq_parallel_client: bool = False
    seq_parallel_server: bool = False
    moe_groups: int = 1
    kv_dtype: str = "param"
    client_expert_dp: bool = False  # expert-parallel client tier over 'data'

    @property
    def tiers(self) -> tuple:
        t = ()
        if self.seq_parallel_client:
            t += ("client",)
        if self.seq_parallel_server:
            t += ("server",)
        return t


@dataclasses.dataclass(frozen=True)
class BuiltStep:
    name: str
    fn: Any                    # a plain callable over live tensors
    args_sds: tuple            # meta-device stand-ins (trees)
    in_shardings: tuple        # P trees
    out_shardings: Any
    meta: dict


def _dp_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    return axes if len(axes) > 1 else axes[0]


def _dp_size(mesh) -> int:
    shape = mesh_axis_sizes(mesh)
    return shape.get("pod", 1) * shape.get("data", 1)


def effective_window(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    """cfg window, or the block-sparse SWA variant for long_500k on
    full-attention archs."""
    if cfg.swa_window:
        return cfg.swa_window
    if shape.name == "long_500k":
        return LONG_CONTEXT_WINDOW
    return None


def shape_supported(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    if cfg.enc_dec and shape.name == "long_500k":
        return False, ("whisper's decoder family tops out at ~448 tokens / "
                       "30s windows; 524k decode is out of family range "
                       "(DESIGN.md skip)")
    return True, ""


def tier_fn_for(cfg: ArchConfig, cut_layer: Optional[int], *,
                client_name: str = "client"):
    """Maps a param path 'groups/<i>/...' to its split tier."""
    if cut_layer is None:
        return lambda path: "server"
    groups = build_groups(cfg, cut_layer=cut_layer)
    tiers = [g.tier for g in groups]

    def fn(path: str) -> str:
        m = re.match(r"groups/(\d+)/", path)
        if m:
            t = tiers[int(m.group(1))]
            return client_name if t == "client" else t
        if path.startswith("embed"):
            return client_name   # embedding feeds the client prefix
        return "server"

    return fn


# ---------------------------------------------------------------------------
# batch / state specs
# ---------------------------------------------------------------------------

def _sds(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_sds(cfg: ArchConfig, shape: InputShape, *, with_labels: bool):
    b, s = shape.global_batch, shape.seq_len
    d = {}
    if cfg.frontend == "patch_embed":
        s_text = s - cfg.frontend_tokens
        d["tokens"] = _sds((b, s_text), torch.int32)
        d["patch_embeds"] = _sds((b, cfg.frontend_tokens, cfg.d_model),
                                 cfg.param_dtype)
    else:
        d["tokens"] = _sds((b, s), torch.int32)
    if cfg.enc_dec:
        d["frames"] = _sds((b, cfg.enc_seq_len, cfg.d_model),
                           cfg.param_dtype)
    if with_labels:
        d["labels"] = _sds(tuple(d["tokens"].shape), torch.int32)
    return d


def batch_pspecs(cfg: ArchConfig, shape: InputShape, mesh, *,
                 with_labels: bool):
    dp = _dp_axes(mesh)
    dpn = _dp_size(mesh)
    bspec = dp if shape.global_batch % dpn == 0 else None
    d = {"tokens": P(bspec, None)}
    if cfg.frontend == "patch_embed":
        d["patch_embeds"] = P(bspec, None, None)
    if cfg.enc_dec:
        d["frames"] = P(bspec, None, None)
    if with_labels:
        d["labels"] = P(bspec, None)
    return d


_STATE_RULES = [
    (r"(k|v)(\d+)?_scale$", "cache_scale"),   # (n,B,C,Kh):    B->data, C->model
    (r"(^|/)(k|v|k\d+|v\d+)$", "cache"),     # (n,B,C,Kh,hd): B->data, C->model
    (r"(^|/)(ck|cv)$", "cache"),
    (r"(^|/)S$", "rwkv_S"),                  # (n,B,H,hd,hd): B->data, H->model
    (r"(^|/)h\d+$", "mamba_h"),              # (n,B,di,N):   B->data, di->model
    (r"(^|/)c\d+$", "mamba_conv"),           # (n,B,cw-1,di): B->data, di->model
    (r"x_prev$", "vec"),                     # (n,B,D):      B->data, D->model
]


def state_pspecs(state_sds, mesh):
    """A ``P`` tree for a decode state (``decode_state_init``'s list of
    per-group dicts) by the reference's rules."""
    shape_of = mesh_axis_sizes(mesh)
    dsz, msz = shape_of.get("data", 1), shape_of.get("model", 1)

    def guard(dim, size, ax):
        return ax if (size > 1 and dim % size == 0) else None

    def spec_for(path: str, shp: tuple) -> P:
        for pat, kind in _STATE_RULES:
            if re.search(pat, path):
                if kind == "cache":
                    return P(None, guard(shp[1], dsz, "data"),
                             guard(shp[2], msz, "model"), None, None)
                if kind == "cache_scale":
                    return P(None, guard(shp[1], dsz, "data"),
                             guard(shp[2], msz, "model"), None)
                if kind == "rwkv_S":
                    return P(None, guard(shp[1], dsz, "data"),
                             guard(shp[2], msz, "model"), None, None)
                if kind == "mamba_h":
                    return P(None, guard(shp[1], dsz, "data"),
                             guard(shp[2], msz, "model"), None)
                if kind == "mamba_conv":
                    return P(None, guard(shp[1], dsz, "data"), None,
                             guard(shp[3], msz, "model"))
                if kind == "vec":
                    return P(None, guard(shp[1], dsz, "data"),
                             guard(shp[2], msz, "model"))
        return P()

    flat = tree_flatten_with_paths(state_sds)
    return tree_unflatten_like(state_sds, {
        path: spec_for(path, tuple(leaf.shape)) for path, leaf in flat.items()})


# ---------------------------------------------------------------------------
# binding a step's parameter dict to a meta-device skeleton
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _bound(module: nn.Module, params: dict):
    """``module`` (a skeleton) holding ``params`` (keyed as its
    ``named_parameters()``) for the block: ``functional_call``'s binding,
    held over the backward too, where remat recomputes the layers."""
    with _reparametrize_module(module, params):
        yield module


def _skeleton(cfg: ArchConfig, cut: Optional[int]) -> Model:
    with torch.device("meta"):
        return Model(cfg, build_groups(cfg, cut_layer=cut))


def _params_sds(module: nn.Module) -> dict:
    return {k: v.detach() for k, v in module.named_parameters()}


def _setup(cfg, shape, mesh, split, opts):
    split = split or SplitConfig()
    opts = opts or PerfOptions()
    cut = default_cut_layer(cfg, split.client_fraction)
    tier = tier_fn_for(cfg, cut, client_name=(
        "client_edp" if opts.client_expert_dp else "client"))
    model = _skeleton(cfg, cut)
    return (opts, cut, effective_window(cfg, shape), ShardingPolicy(mesh),
            model, model_pspecs(model, mesh, tier_fn=tier))


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def build_train_step(cfg: ArchConfig, shape: InputShape, mesh, *,
                     split: Optional[SplitConfig] = None,
                     remat: bool = True, lr: float = 1e-4,
                     opts: Optional[PerfOptions] = None,
                     attn_impl: str = "xla") -> BuiltStep:
    """``fn(params, opt_state, batch) -> (new_params, new_opt_state,
    metrics)``: ``lm_loss`` (``remat`` on by default) -> its gradient ->
    ``FunctionalAdamW(lr, weight_decay=0.01)``, no clip, as the
    reference's. ``fn(..., grads_out={})`` also hands out the gradients,
    keyed as the params."""
    opts, cut, window, policy, model, pspecs = _setup(cfg, shape, mesh,
                                                      split, opts)
    opt = FunctionalAdamW(lr, weight_decay=0.01)

    def step(params, opt_state, batch, *, grads_out: Optional[dict] = None):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        with set_policy(policy), _bound(model, live):
            loss, metrics = lm_loss(
                cfg, model, batch, window=window, cut_layer=cut,
                remat=remat, seq_parallel_tiers=opts.tiers,
                moe_groups=opts.moe_groups, attn_impl=attn_impl)
            grads = dict(zip(live, torch.autograd.grad(
                loss, list(live.values()))))
        if grads_out is not None:
            grads_out.update(grads)
        new_params, new_opt = opt.update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        return new_params, new_opt, metrics

    params_sds = _params_sds(model)
    opt_sds = OptState(
        step=_sds((), torch.int32),
        mu={k: _sds(tuple(v.shape), torch.float32)
            for k, v in params_sds.items()},
        nu={k: _sds(tuple(v.shape), torch.float32)
            for k, v in params_sds.items()})
    b_sds = batch_sds(cfg, shape, with_labels=True)
    # optimizer moments follow the param specs; step counter replicated
    ospecs = OptState(step=P(), mu=dict(pspecs), nu=dict(pspecs))
    bspecs = batch_pspecs(cfg, shape, mesh, with_labels=True)
    return BuiltStep(name="train_step", fn=step,
                     args_sds=(params_sds, opt_sds, b_sds),
                     in_shardings=(pspecs, ospecs, bspecs),
                     out_shardings=(pspecs, ospecs, None),
                     meta={"cut_layer": cut, "window": window,
                           "kind": "train"})


def build_prefill_step(cfg: ArchConfig, shape: InputShape, mesh, *,
                       split: Optional[SplitConfig] = None,
                       opts: Optional[PerfOptions] = None,
                       attn_impl: str = "xla") -> BuiltStep:
    """``fn(params, batch) -> logits``: ``model_forward`` without a
    graph."""
    opts, cut, window, policy, model, pspecs = _setup(cfg, shape, mesh,
                                                      split, opts)

    @torch.no_grad()
    def step(params, batch):
        with set_policy(policy), _bound(model, params):
            return model_forward(
                cfg, model, batch, window=window, cut_layer=cut,
                seq_parallel_tiers=opts.tiers, moe_groups=opts.moe_groups,
                attn_impl=attn_impl)[0]

    bspecs = batch_pspecs(cfg, shape, mesh, with_labels=False)
    dp = _dp_axes(mesh)
    out_spec = P(dp if shape.global_batch % _dp_size(mesh) == 0 else None,
                 None, TP_AXIS if vocab_padded(cfg) % 16 == 0 else None)
    return BuiltStep(name="prefill_step", fn=step,
                     args_sds=(_params_sds(model),
                               batch_sds(cfg, shape, with_labels=False)),
                     in_shardings=(pspecs, bspecs),
                     out_shardings=out_spec,
                     meta={"cut_layer": cut, "window": window,
                           "kind": "prefill"})


def build_decode_step(cfg: ArchConfig, shape: InputShape, mesh, *,
                      split: Optional[SplitConfig] = None,
                      opts: Optional[PerfOptions] = None) -> BuiltStep:
    """``fn(params, state, token, pos) -> (logits, state)``: one
    ``model_decode_step`` without a graph, writing ``state`` in place;
    ``pos`` an int or a 0-d tensor."""
    opts, cut, window, policy, model, pspecs = _setup(cfg, shape, mesh,
                                                      split, opts)
    b = shape.global_batch

    @torch.no_grad()
    def step(params, state, token, pos):
        with set_policy(policy), _bound(model, params):
            return model_decode_step(cfg, model, state, token, int(pos),
                                     window=window, cut_layer=cut)

    state_sds = decode_state_init(cfg, b, shape.seq_len, window=window,
                                  cut_layer=cut, kv_dtype=opts.kv_dtype,
                                  device="meta")
    sspecs = state_pspecs(state_sds, mesh)
    dpn = _dp_size(mesh)
    dp = _dp_axes(mesh)
    tok_spec = P(dp if b % dpn == 0 else ("data" if b % 16 == 0 else None),
                 None)
    logit_spec = P(tok_spec[0], None, TP_AXIS)
    return BuiltStep(name="serve_step", fn=step,
                     args_sds=(_params_sds(model), state_sds,
                               _sds((b, 1), torch.int32),
                               _sds((), torch.int32)),
                     in_shardings=(pspecs, sspecs, tok_spec, P()),
                     out_shardings=(logit_spec, sspecs),
                     meta={"cut_layer": cut, "window": window,
                           "kind": "decode"})


def build_step(cfg: ArchConfig, shape_name: str, mesh, *,
               split: Optional[SplitConfig] = None,
               opts: Optional[PerfOptions] = None, attn_impl: str = "xla",
               **kw) -> BuiltStep:
    shape = INPUT_SHAPES[shape_name]
    ok, why = shape_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape_name}: {why}")
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, split=split, opts=opts,
                                attn_impl=attn_impl, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, split=split, opts=opts,
                                  attn_impl=attn_impl)
    return build_decode_step(cfg, shape, mesh, split=split, opts=opts)


# the port's dim of each of the reference's dims: a conv kernel is HWIO
# there and OIHW here (``convert._to_port``); every other leaf keeps its
# layout (a linear ``w`` is (in, out) in both)
_HWIO_TO_OIHW = (2, 3, 1, 0)


def reference_dims(ndim: int) -> tuple:
    """The port's dim of each of the reference's dims of an ``ndim`` leaf
    of a CNN tier."""
    return _HWIO_TO_OIHW if ndim == 4 else tuple(range(ndim))


def fleet_server_pspecs(server_params: dict, mesh) -> dict:
    """Server-tier specs for the fleet engines on the ``('data', 'fsdp',
    'tp')`` fleet mesh (``launch.mesh.make_fleet_mesh``; any mesh whose
    axis sizes ``mesh_axis_sizes`` reads), the reference's rule on the
    reference's dims: matrix-like leaves shard their last two dims
    ``(fsdp, tp)``, vectors their output channel over ``tp``, every dim
    guarded by divisibility against its axis size. Computed on the
    reference's layout (``reference_dims``) and returned in the port's:
    a port leaf's shard holds the elements of the reference's shard."""
    sizes = mesh_axis_sizes(mesh)
    f, t = sizes.get("fsdp", 1), sizes.get("tp", 1)

    def spec(leaf) -> P:
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        dims = reference_dims(len(shape))
        ref_shape = [shape[d] for d in dims]
        axes = [None] * len(shape)
        if t > 1 and ref_shape[-1] % t == 0:
            axes[dims[-1]] = "tp"
        if len(shape) >= 2 and f > 1 and ref_shape[-2] % f == 0:
            axes[dims[-2]] = "fsdp"
        return P(*axes)

    return {k: spec(v) for k, v in server_params.items()}


def server_placements(pspecs: dict) -> dict:
    """Each spec of ``fleet_server_pspecs`` as the DTensor placements of its
    leaf on the ``(fsdp, tp)`` sub-mesh, one a mesh dim."""
    from ..parallel.sharding import AbstractMesh
    sub = AbstractMesh((1, 1), ("fsdp", "tp"))
    return {k: tuple(to_placements(s, sub)) for k, s in pspecs.items()}


# ---------------------------------------------------------------------------
# per-group body probes: one layer of each group with the step's specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BodyProbe:
    group_index: int
    kind: str
    count: int                  # multiplicity in the real model
    fn: Any
    args_sds: tuple
    in_shardings: tuple


def _layer_pspecs(layers: nn.ModuleList, mesh, tier: str) -> dict:
    """Specs of one layer's parameters (keyed as ``layers``'), by the rules
    on the reference's group-relative paths."""
    holder = nn.Module()
    holder.groups = nn.ModuleList([layers])
    return {k[len("groups.0."):]: v
            for k, v in model_pspecs(holder, mesh, tier=tier).items()}


def build_body_probes(cfg: ArchConfig, shape: InputShape, mesh, *,
                      split: Optional[SplitConfig] = None,
                      opts: Optional[PerfOptions] = None,
                      attn_impl: str = "xla") -> list[BodyProbe]:
    """One ``BodyProbe`` a group (a decode step skips ``enc`` groups): the
    group's layer (count 1) as a step of its own, ``fn(params, x, *enc)``
    giving the gradients of its params and input (train, under remat) or
    its output (prefill), or ``fn(params, state, x, pos) -> (y, state)``
    for decode. The reference lowers each to correct its scanned layers;
    the port's layers run unrolled, and the dry run records the probes'
    counts beside the whole step's."""
    split = split or SplitConfig()
    opts = opts or PerfOptions()
    cut = default_cut_layer(cfg, split.client_fraction)
    window = effective_window(cfg, shape)
    groups = build_groups(cfg, cut_layer=cut)
    policy = ShardingPolicy(mesh)
    dp = _dp_axes(mesh)
    dpn = _dp_size(mesh)
    b = shape.global_batch
    bspec = dp if b % dpn == 0 else None

    probes = []
    state_sds_all = None
    if shape.kind == "decode":
        state_sds_all = decode_state_init(
            cfg, b, shape.seq_len, window=window, cut_layer=cut,
            kv_dtype=opts.kv_dtype, device="meta")

    for gi, g in enumerate(groups):
        g1 = dataclasses.replace(g, count=1)
        with torch.device("meta"):
            layers = group_modules(cfg, g1)
        params_sds = _params_sds(layers)
        probe_tier = g.tier
        if probe_tier == "client" and opts.client_expert_dp:
            probe_tier = "client_edp"
        pspecs = _layer_pspecs(layers, mesh, probe_tier)
        seq = cfg.enc_seq_len if g.kind == "enc" else shape.seq_len
        act = (("dp", "tp", None) if g1.tier in opts.tiers
               else ("dp", None, None))

        if shape.kind in ("train", "prefill"):
            x_sds = _sds((b, seq, cfg.d_model), cfg.param_dtype)
            extra, extra_sh = (), ()
            if g.kind == "xdec":
                extra = (_sds((b, cfg.enc_seq_len, cfg.d_model),
                              cfg.param_dtype),)
                extra_sh = (P(bspec, None, None),)

            def apply(x, enc, g1=g1, layers=layers, act=act, seq=seq,
                      remat=shape.kind == "train"):
                return group_apply(
                    cfg, g1, layers, x,
                    torch.zeros((), dtype=torch.float32, device=x.device),
                    positions=torch.arange(seq, device=x.device).expand(
                        b, seq), window=window,
                    enc_out=enc[0] if enc else None, attn_impl=attn_impl,
                    remat=remat, act_spec=act, moe_groups=opts.moe_groups)

            if shape.kind == "train":
                def fn(gp, x, *enc, apply=apply, layers=layers):
                    live = {k: v.detach().requires_grad_()
                            for k, v in gp.items()}
                    x = x.detach().requires_grad_()
                    with set_policy(policy), _bound(layers, live):
                        # a view: a module tracker's hooks refuse a leaf
                        y, aux = apply(x.view_as(x), enc)
                        return torch.autograd.grad(
                            y.float().sum() + aux, [*live.values(), x])
            else:
                @torch.no_grad()
                def fn(gp, x, *enc, apply=apply, layers=layers):
                    with set_policy(policy), _bound(layers, gp):
                        return apply(x, enc)[0]
            probes.append(BodyProbe(
                group_index=gi, kind=g.kind, count=g.count, fn=fn,
                args_sds=(params_sds, x_sds) + extra,
                in_shardings=(pspecs, P(bspec, None, None)) + extra_sh))
        else:  # decode
            if g.kind == "enc":
                continue
            st_g = {k: _sds((1,) + tuple(s.shape[1:]), s.dtype)
                    for k, s in state_sds_all[gi].items()}
            sspecs = state_pspecs(st_g, mesh)

            @torch.no_grad()
            def fn(gp, st, x, pos, g1=g1, layers=layers):
                with set_policy(policy), _bound(layers, gp):
                    return _group_decode(cfg, g1, layers, st, x, int(pos),
                                         window=window), st
            probes.append(BodyProbe(
                group_index=gi, kind=g.kind, count=g.count, fn=fn,
                args_sds=(params_sds, st_g,
                          _sds((b, 1, cfg.d_model), cfg.param_dtype),
                          _sds((), torch.int32)),
                in_shardings=(pspecs, sspecs, P(bspec, None, None), P())))
    return probes
