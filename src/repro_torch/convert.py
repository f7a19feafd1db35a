"""Carry the reference's parameters over to the port.

CNNs: ``from_reference``. The split LM: ``lm_from_reference``. The whole
transformer model of ``models.transformer`` (the trainer's and the
server's): ``model_from_reference``; its decode state:
``decode_state_from_reference``; one layer's tree (an MoE FFN, a Mamba
mixer, ...): ``module_from_reference``.

``from_reference`` takes ``Plan.params0`` of a ``repro`` CNN plan as numpy
(one nested dict per stage, e.g. ``jax.tree_util.tree_map(np.asarray,
plan.params0)``) and returns the port's ``params0``: one flat dict per stage
keyed by the reference's pytree path (``"conv.w"``, ``"gn.scale"``, ...).

- conv kernels, HWIO -> OIHW (depthwise ``(3, 3, 1, C)`` -> ``(C, 1, 3, 3)``);
- linear ``w`` stays (in, out): the port's ``Linear`` computes ``x @ w``;
- GroupNorm ``scale``/``bias`` and biases as they are.

The result is checked against the port's model of ``model_name``: every
stage must get exactly the keys and shapes the port's stage has.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.cnn import CNN_BUILDERS

# numpy has no bfloat16; jax's arrays of it come as ml_dtypes' type, whose
# bits are moved as int16 and viewed as torch.bfloat16
_BF16_NAME = "bfloat16"


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, path + ".")
        else:
            yield path, v


def _to_port(a) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    if a.ndim == 4:                       # HWIO -> OIHW
        a = a.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.array(a, copy=True))


def from_reference(stages_params, model_name: str) -> list[dict]:
    """Reference per-stage param pytrees (numpy) -> port ``params0``."""
    params = [{k: _to_port(v) for k, v in _flatten(p)} for p in stages_params]
    linear_w = [v for v in params[-1].values() if v.dim() == 2]
    if len(linear_w) != 1:
        raise ValueError("the last stage must hold exactly one linear head")
    stages = CNN_BUILDERS[model_name](linear_w[0].shape[1])
    if len(stages) != len(params):
        raise ValueError(f"{model_name} has {len(stages)} stages, the "
                         f"reference params {len(params)}")
    for stage, p in zip(stages, params):
        want = {k: tuple(v.shape) for k, v in stage.body.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in p.items()}
        if want != got:
            raise ValueError(f"stage {stage.name}: reference params {got} do "
                             f"not match the port's {want}")
    return params


def _leaf(a) -> torch.Tensor:
    """A reference leaf as a torch tensor of the same dtype (bf16 kept)."""
    a = np.asarray(a)
    if a.dtype.name == _BF16_NAME:
        return torch.from_numpy(np.array(a.view(np.int16),
                                         copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _unstack(tree) -> dict:
    """``{"blocks": stacked, **rest}`` -> flat state dict with the layer
    axis unstacked into ``blocks.{i}.<path>``."""
    out = {}
    for path, a in _flatten(tree):
        if path.startswith("blocks."):
            for i, row in enumerate(np.asarray(a)):
                out[f"blocks.{i}.{path[len('blocks.'):]}"] = _leaf(row)
        else:
            out[path] = _leaf(a)
    return out


def lm_from_reference(params_c0, params_s0, cfg) -> tuple[dict, dict]:
    """The reference's split-LM params (``Plan.params0`` of a transformer
    plan, as numpy: ``({"embed", "blocks"}, {"blocks", "head"})`` with the
    blocks stacked on a leading layer axis) -> the port's ``params0``: the
    (client, server) state dicts of ``fleet.hetero.LMClient`` /
    ``LMServer``, every leaf in its own dtype. Checked against the port's
    modules for ``cfg``: the same keys, shapes and dtypes."""
    from .fleet.hetero import lm_modules
    port = (_unstack(params_c0), _unstack(params_s0))
    k = sum(1 for key in port[0] if key.endswith(".ln1.scale"))
    with torch.device("meta"):
        modules = lm_modules(cfg, k)
    for name, module, got in zip(("client", "server"), modules, port):
        want = {key: (tuple(v.shape), v.dtype)
                for key, v in module.state_dict().items()}
        have = {key: (tuple(v.shape), v.dtype) for key, v in got.items()}
        if want != have:
            raise ValueError(f"{name} tier: reference params {have} do not "
                             f"match the port's {want}")
    return port


def _layer_leaves(path: str, row):
    """One layer's leaf -> (port path, tensor) pairs. The MoE's shared
    experts are stacked on a leading ``n_shared`` axis in the reference
    (``shared.gate.w`` (n_shared, d, F)); the port holds one SwiGLU each
    (``shared.{j}.gate.w``)."""
    parts = path.split(".")
    if "shared" not in parts:
        yield path, _leaf(row)
        return
    i = parts.index("shared") + 1
    for j, expert in enumerate(np.asarray(row)):
        yield ".".join(parts[:i] + [str(j)] + parts[i:]), _leaf(expert)


def _load_checked(module, flat: dict, what: str):
    """Load ``flat`` into ``module`` (built on the meta device: the tensors
    are assigned) after checking it has exactly the module's keys, shapes
    and dtypes."""
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in module.state_dict().items()}
    have = {k: (tuple(v.shape), v.dtype) for k, v in flat.items()}
    if want != have:
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        wrong = sorted(k for k in set(want) & set(have) if want[k] != have[k])
        raise ValueError(f"reference params do not match the port's {what}: "
                         f"missing {missing[:8]}, extra {extra[:8]}, shape "
                         f"or dtype differs at "
                         f"{[(k, have[k], want[k]) for k in wrong[:8]]}")
    module.load_state_dict(flat, assign=True)
    return module


def module_from_reference(tree, module):
    """One layer's reference tree (e.g. ``moe_init``'s or ``mamba_init``'s,
    as numpy, no layer axis) -> ``module`` (a ``models.moe.MoE``,
    ``models.ssm.Mamba``, ... built on the meta device) holding those
    leaves in their own dtypes; the shared experts' stack unstacked.
    Checked as ``model_from_reference`` checks."""
    flat = dict(kv for path, a in _flatten(tree)
                for kv in _layer_leaves(path, a))
    return _load_checked(module, flat, type(module).__name__)


def model_from_reference(params, cfg, cut_layer=None):
    """The reference's ``model_init(cfg, key, cut_layer=cut_layer)`` tree,
    as numpy (``{"embed": {"table"}, "final_norm", "groups": [one tree per
    group, every leaf stacked on a leading layer axis], "head"}`` with the
    head only when the embedding is not tied) -> the port's
    ``models.transformer.Model``, each leaf in its own dtype (bf16 kept;
    the MoE router's f32), the layers unstacked into
    ``groups.{g}.{layer}.<path>`` (a jamba super-block's sub-layers
    ``sub{i}.*`` as they are, the shared experts' stack unstacked into
    ``moe.shared.{j}.*``). Checked against the port's model of ``cfg``: the
    same keys, shapes and dtypes."""
    from .models.transformer import Model, build_groups
    flat = {}
    for key, tree in params.items():
        if key == "groups":
            for gi, group in enumerate(tree):
                for path, a in _flatten(group):
                    for li, row in enumerate(np.asarray(a)):
                        for port_path, leaf in _layer_leaves(path, row):
                            flat[f"groups.{gi}.{li}.{port_path}"] = leaf
        else:
            for path, a in _flatten(tree, key + "."):
                flat[path] = _leaf(a)
    with torch.device("meta"):
        model = Model(cfg, build_groups(cfg, cut_layer=cut_layer))
    return _load_checked(model, flat, "model")


def decode_state_from_reference(state) -> list[dict]:
    """The reference's decode state (``decode_state_init`` /
    ``model_decode_step``'s list of per-group dicts, as numpy) -> the
    port's: the same list, keys and leading layer (or super-block) axis,
    every leaf a torch tensor of its own dtype (bf16 and int8 kept; a jamba
    group's ``h{i}``, ``c{i}``, ``k{P-1}``, ...). The layouts are the same,
    so nothing is reshuffled."""
    return [{key: _leaf(a) for key, a in group.items()} for group in state]
