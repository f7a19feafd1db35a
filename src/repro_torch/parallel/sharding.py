"""Sharding policy: logical -> physical axes, and name-rule parameter specs
(counterpart of ``repro.parallel.sharding``), over a ``torch.distributed``
``DeviceMesh`` and DTensor placements.

Mesh axes: ('data', 'model') single-pod, ('pod', 'data', 'model')
multi-pod. Logical axes used by the models and the spec rules:

  dp    batch axis: the ('pod', 'data') product when present
  tp    'model': tensor/expert parallel
  fsdp  'data': weight sharding across the data axis (ZeRO-style)

The split-learning tier rule is the reference's: client-tier parameters
use no tensor parallelism ('tp' -> replicated), server-tier parameters are
2D-sharded (fsdp x tp). Every spec is divisibility-guarded against the
leaf's shape: a dim that does not divide by its axis size is replicated.

A spec is a ``P``: one entry a tensor dim, each None, an axis name or a
tuple of axis names (the reference's ``PartitionSpec``); ``to_placements``
turns it into one DTensor placement a mesh dim (``Shard(dim)`` where the
dim is split over that axis, ``Replicate()`` elsewhere; a dim split over
two axes is split over the outer one first, as in JAX). The rules are
regexes on the reference's ``/``-joined parameter paths, whose stacked
layer axis (and a shared expert's stack) leads each leaf: ``param_pspecs``
takes the reference's tree (``convert.model_to_reference`` of a port
model), ``model_pspecs`` the port's ``Model``, whose per-layer leaves get
the same spec with the stacked entries dropped.

``shard_act`` is the identity with no policy set, or on a plain tensor:
only a DTensor activation (the device-free dry run's) is redistributed,
so every path on plain tensors runs as it did.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Optional, Sequence

TP_AXIS = "model"
FSDP_AXIS = "data"
DP_AXES = ("pod", "data")

_ACTIVE: list["ShardingPolicy"] = []


class P(tuple):
    """A partition spec: ``P(None, "data", ("pod", "data"))``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A device-free mesh: axis sizes and names, for specs alone (the
    reference's ``AbstractMesh``)."""
    sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_axis_sizes(mesh) -> dict:
    """axis_name -> size; works for a ``DeviceMesh``, an ``AbstractMesh``
    and a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def to_placements(spec: Sequence, mesh) -> list:
    """``spec`` as one DTensor placement a dim of ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        for a in ax if isinstance(ax, tuple) else (ax,):
            if a is not None:
                out[names.index(a)] = Shard(dim)
    return out


@dataclasses.dataclass
class ShardingPolicy:
    mesh: Any

    def resolve(self, logical: Sequence) -> P:
        names = axis_names(self.mesh)
        out = []
        for ax in logical:
            if ax is None:
                out.append(None)
            elif ax == "dp":
                axes = tuple(a for a in DP_AXES if a in names)
                out.append(axes if len(axes) > 1 else axes[0])
            elif ax == "tp":
                out.append(TP_AXIS)
            elif ax == "fsdp":
                out.append(FSDP_AXIS)
            else:
                out.append(ax)
        return P(*out)

    def constrain(self, x, logical: Sequence):
        """A DTensor ``x`` redistributed to ``logical``'s placements (the
        reference's ``with_sharding_constraint``); a plain tensor as it
        is."""
        if not hasattr(x, "redistribute"):
            return x
        return x.redistribute(self.mesh,
                              to_placements(self.resolve(logical),
                                            self.mesh))


@contextlib.contextmanager
def set_policy(policy: Optional[ShardingPolicy]):
    if policy is None:
        yield
        return
    _ACTIVE.append(policy)
    try:
        yield
    finally:
        _ACTIVE.pop()


def get_policy() -> Optional[ShardingPolicy]:
    return _ACTIVE[-1] if _ACTIVE else None


def shard_act(x, logical: Sequence):
    pol = get_policy()
    if pol is None:
        return x
    return pol.constrain(x, logical)


# ---------------------------------------------------------------------------
# parameter partition specs by path rules (2D: fsdp x tp)
# ---------------------------------------------------------------------------

# (regex on the /-joined path, logical spec for the *trailing* dims).
# Leading dims beyond the rule's length (layer-stack axes) get None.
_RULES: list[tuple[str, tuple]] = [
    (r"embed/table$", ("tp", "fsdp")),
    (r"head/w$", ("fsdp", "tp")),
    # column-parallel projections (output-feature sharded)
    (r"(wq|wk|wv|wg|gate|up|in_proj)/w$", ("fsdp", "tp")),
    (r"(wq|wk|wv|wg|gate|up|in_proj)/b$", ("tp",)),
    # row-parallel projections (input-feature sharded)
    (r"(wo|down|out_proj)/w$", ("tp", "fsdp")),
    (r"(wo|down|out_proj)/b$", (None,)),
    # MoE: expert-parallel on the leading expert axis, fsdp on d_model/d_ff
    (r"w_gate$|w_up$", ("tp", "fsdp", None)),
    (r"w_down$", ("tp", "fsdp", None)),
    (r"router/w$", (None, None)),
    # mamba
    (r"conv_w$", (None, "tp")),
    (r"conv_b$", ("tp",)),
    (r"w_dt_a$", ("tp", None)),
    (r"w_dt_b$", (None, "tp")),
    (r"dt_bias$", ("tp",)),
    (r"(w_B|w_C)/w$", ("tp", None)),
    (r"A_log$", ("tp", None)),
    (r"/D$", ("tp",)),
    # rwkv
    (r"/u$", ("tp", None)),
    (r"w_lora_a$", ("fsdp", None)),
    (r"w_lora_b$", (None, None)),
    (r"mix/(wr|wk|wv|wg)/w$", ("fsdp", "tp")),
    (r"mix/wo/w$", ("tp", "fsdp")),
    (r"ffn/wk/w$", ("fsdp", "tp")),
    (r"ffn/wv/w$", ("tp", "fsdp")),
    (r"ffn/wr/w$", ("fsdp", "tp")),
]


def _axis_size(mesh_shape: dict, logical: str) -> int:
    if logical == "tp":
        return mesh_shape.get(TP_AXIS, 1)
    if logical == "fsdp":
        return mesh_shape.get(FSDP_AXIS, 1)
    return 1


_EXPERT_PAT = re.compile(r"w_gate$|w_up$|w_down$")


def _spec_for(path: str, shape: tuple, mesh_shape: dict, tier: str) -> P:
    for pat, rule in _RULES:
        if re.search(pat, path):
            # client_edp: expert-parallel client tier, experts sharded over
            # the client-fleet ('data') axis
            if tier == "client_edp" and _EXPERT_PAT.search(path):
                e = shape[0] if len(shape) == 3 else None
                size = mesh_shape.get(FSDP_AXIS, 1)
                if e and size > 1 and e % size == 0:
                    return P(FSDP_AXIS, None, None)
            pad = (None,) * (len(shape) - len(rule))
            full = pad + tuple(rule)
            out = []
            for dim, ax in zip(shape, full):
                if ax is None:
                    out.append(None)
                    continue
                if tier in ("client", "client_edp") and ax == "tp":
                    out.append(None)        # client tier: no tensor parallelism
                    continue
                size = _axis_size(mesh_shape, ax)
                if size > 1 and dim % size == 0:
                    out.append(TP_AXIS if ax == "tp" else FSDP_AXIS)
                else:
                    out.append(None)        # divisibility guard
            return P(*out)
    return P()


def param_pspecs(params: Any, mesh, *, tier: str = "server",
                 tier_fn=None, prefix: str = "") -> Any:
    """A ``P`` tree for a parameter tree in the reference's layout (nested
    dicts and lists of anything with a ``shape``) by the name rules.
    ``tier_fn(path: str) -> str`` overrides the uniform tier (the split
    model's ``groups/<i>`` have different tiers)."""
    from ..checkpoint.ckpt import tree_flatten_with_paths, tree_unflatten_like
    mesh_shape = mesh_axis_sizes(mesh)
    specs = {}
    for key, leaf in tree_flatten_with_paths(params).items():
        name = prefix + key
        t = tier_fn(name) if tier_fn is not None else tier
        specs[key] = _spec_for(name, tuple(leaf.shape), mesh_shape, t)
    return tree_unflatten_like(params, specs)


def model_pspecs(model, mesh, *, tier: str = "server",
                 tier_fn=None) -> dict:
    """``{name: P}`` for each entry of the port's ``Model``'s state dict:
    the spec ``param_pspecs`` gives its leaf in the reference's stacked
    tree, without the stacked entries (layer, shared expert)."""
    from ..convert import reference_path
    rows: dict = {}
    for name, t in model.state_dict(keep_vars=True).items():
        path, idx = reference_path(name)
        rows.setdefault(path, []).append((name, idx, tuple(t.shape)))
    mesh_shape = mesh_axis_sizes(mesh)
    out = {}
    for path, members in rows.items():
        depth = len(members[0][1])
        lead = tuple(max(idx[k] for _, idx, _ in members) + 1
                     for k in range(depth))
        key = "/".join(path)
        t = tier_fn(key) if tier_fn is not None else tier
        spec = _spec_for(key, lead + members[0][2], mesh_shape, t)
        for name, _, _ in members:
            out[name] = P(*spec[depth:])
    return out
