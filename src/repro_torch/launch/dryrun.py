"""Device-free dry run: trace every (arch x input shape x mesh) step
(counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] \
        [--jobs 4] [--timeout 600]

Each combination is built by ``launch.steps.build_step`` and traced once
on the reference's production mesh, 16x16 ``('data', 'model')`` or
2x16x16 ``('pod', 'data', 'model')``, over ``torch.distributed``'s fake
backend (``launch.mesh.make_production_mesh``): every parameter, optimizer
moment, batch and decode-state leaf is a DTensor on that mesh, placed by
the step's specs, whose local shard is a meta-device tensor (shapes, no
memory), and the step runs on them, its collectives recorded as the
DTensors redistribute. Nothing runs on a device. (Meta shards, not
``FakeTensorMode``: under that mode DTensor's own index arithmetic for a
strided shard, which a matmul over heads split on one axis and batch on
another makes, becomes fake and fails as data-dependent.) The process's
default group is the fake one, so run this module in a process of its
own. A sweep (``--all``, or ``--arch`` or ``--shape`` left open) runs
each combination so, ``--jobs`` at a time, kills one that outlives
``--timeout`` seconds (its row reads ``not done``), keeps each process's
output beside its record (``.log``) and prints the status table
(``status_table``). Each record goes to
``results/dryrun/<arch>__<shape>__<mesh>.json``, with the reference's
``status`` (``ok``, ``skipped`` with its ``reason``, ``error`` with the
exception and its traceback: an op with no DTensor sharding rule, or one
DTensor refuses that ``ReshardOnRefusal`` cannot retry, such as an
in-place write with routed indices, lands there) and, for ``ok``:

- ``flops_global``: ``torch.utils.flop_counter.FlopCounterMode``'s count
  of the whole step (forward, backward with remat's recompute, optimizer),
  taken on the DTensor ops, whose shapes are global: the FLOPs summed over
  all ranks, not one device's as the reference's ``cost_analysis`` count
  is. A rank that holds a replicated operand does that work again; the
  count holds it once.
- ``flops_corrected`` equals ``flops_global``: the port runs its layers
  unrolled, so there is no scanned layer body counted once to correct.
  ``bodies`` still records ``build_body_probes``' one-layer steps, each
  traced the same way, beside each group's layer count.
- ``loops``: the long recurrences, the WKV scan's plain forward and
  backward and Mamba's scan, are Python loops of one step a token
  (``kernels.scan_loop``); traced on meta shards step by step they did
  not end in 600 s at 4,096 and 32,768 tokens. The trace runs them as
  ``ScaledLoops``: each loop's steps traced until they settle (the
  carry's placements repeat), the settled step counted once for each
  step it stands for: the reference's ``flops_corrected`` idea inside a
  layer. ``flops_global`` includes every step; at a short sequence it
  equals the fully unrolled trace's, collectives too. Each entry names
  the site, the steps (tokens, or the WKV backward's segments of 16),
  the calls (layers, and again under remat) and one settled step's FLOPs
  and collective bytes. Each loop's backward is a loop of its own (the
  WKV scan's ``rwkv6_scan_bwd_ref``, Mamba's ``mamba_inner_bwd``), scaled
  the same way.
  The reference's XLA count visits a ``lax.scan`` body once
  (``repro/models/ssm.py:106,207``, ``repro/kernels/rwkv/ref.py:24``), so
  for these combinations its count of each recurrence is 1/steps of the
  port's: lower by (steps - 1) x one step's FLOPs a call, a ratio of
  4,096 at train_4k and 32,768 at prefill_32k for the WKV forward and
  Mamba's scan (256 and 2,048 for the WKV backward's segments).
- ``argument_bytes_rank0`` / ``output_bytes_rank0``: the bytes of rank
  0's shards of the step's inputs and outputs, exact from the local
  shards (rank 0 holds the largest shard of an uneven split).
- ``collectives``: the reference's five op names, each ``{"count",
  "bytes"}`` (the bytes of the collectives' outputs on rank 0), from the
  functional collectives DTensor issues (the record of
  ``torch.distributed.tensor.debug.CommDebugMode``, kept by a mode of the
  same kind that also sizes their outputs). The mesh's device type is the
  CPU's, on which DTensor moves a shard to another dim by an all-gather
  and a chunk where a CUDA mesh would use an all-to-all.
- ``resharded``: the ops DTensor refused on their placements and
  ``ReshardOnRefusal`` retried, by how each ran (``gather_changed``,
  ``replicate``; on the 2x16x16 mesh ``gather_strided``, a view it took
  as refused, and ``strided_as_shard``, a view whose strided split it
  named a plain one), and the calls of the ops that ran on a rule
  ``add_missing_rules`` gave (``rule_added``); ``collectives_resharded``
  the retries' gathers, in the form of ``collectives`` and not in it;
  ``rules_added`` the ops this torch had no rule for that were given one.
  All three depend on torch's version: DTensor's rules differ (2.11
  refuses more than 2.13).
- ``peak_bytes_rank0_estimate`` / ``temp_bytes_rank0_estimate``: rank
  0's most live bytes over the step, arguments included, and that peak
  less the arguments, from ``BytesEstimate`` (each local output counted
  from its creation until its tensor dies; a scaled loop's untraced
  steps held as the plain loop's lists would hold them). Estimates:
  allocator rounding, caching and library workspaces are not counted,
  and the trace's lifetimes are eager autograd's (remat recomputes, the
  saved tensors live until the backward frees them). The reference's
  ``compiled.memory_analysis()`` counts XLA's buffer assignment instead.
- ``fits``: the arguments (``arguments_fit``) and the estimated peak
  (``peak_fits_estimate``) against the card's memory as ``nvidia-smi``
  names it (an H100 80GB HBM3's 81,559 MiB where there is no card).
- ``trace_s``: the seconds the trace took on the host; ``torch``: the
  version traced with (DTensor's rules, and so the collectives, differ
  between versions).

Attention is traced through the O(S^2) oracle (``attn_impl="ref"``), not
the chunked plain path the steps run on the card: that path is a Python
loop over 512 x 1024 block pairs, 2,048 of them a layer at 32k tokens,
each about 17 DTensor ops, which under this trace take seconds a layer.
Both paths multiply every query block by every kv block of the span
(``models.attention.chunked_causal_attention`` skips no block above the
diagonal), so their matmul FLOPs are equal where no window clips the
span; where one does (a ``swa_window`` config, or ``long_500k``'s) the
oracle's full S x Sk product is counted. The reference's parser of
partitioned HLO text (``_shape_bytes``, ``collective_bytes``) has no
counterpart: there is no HLO.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..checkpoint.ckpt import tree_flatten_with_paths, tree_unflatten_like
from ..configs import ARCHS, INPUT_SHAPES, SplitConfig
from ..configs.base import InputShape
from ..obs.timeline import fenced
from ..parallel.sharding import P, mesh_axis_sizes, to_placements
from .mesh import make_production_mesh
from .steps import (PerfOptions, build_body_probes, build_decode_step,
                    build_prefill_step, build_train_step, shape_supported)

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")
_FUNCOL = {"all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_coalesced": "all-gather",
           "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
           "reduce_scatter_tensor": "reduce-scatter",
           "reduce_scatter_tensor_coalesced": "reduce-scatter",
           "all_to_all_single": "all-to-all",
           "permute_tensor": "collective-permute"}
# what nvidia-smi names an H100 80GB HBM3's memory.total, for a host
# without a card
H100_MEMORY_MIB = 81559
ATTN_IMPL = "ref"
_RESHARDED = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
              torch.ops.aten.unbind.int)
# ops the port's models run that some torch versions give no DTensor
# sharding rule (2.11: native_group_norm; 2.11 and 2.13: its backward)
_MAY_LACK_A_RULE = (torch.ops.aten.native_group_norm.default,
                    torch.ops.aten.native_group_norm_backward.default)
_RULES_ADDED: list = []


def _has_rule(op) -> bool:
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    return any(op in getattr(prop, table, {}) for table in (
        "op_to_rules", "op_strategy_funcs", "op_single_dim_strategy_funcs"))


def add_missing_rules() -> list:
    """Give each op of ``_MAY_LACK_A_RULE`` that this torch has no sharding
    rule for one that replicates every input and output (GSPMD's gather
    and compute; the gathers are DTensor's own redistributions, which the
    counter records). Returns the ops given one, in this process so far:
    every record names them (``rules_added``) and counts their calls
    (``resharded``). Any other op without a rule ends its combination
    ``error``."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.experimental import register_sharding
    for op in _MAY_LACK_A_RULE:
        if str(op) in _RULES_ADDED or _has_rule(op):
            continue
        n_out = len(op._schema.returns)

        def replicated(*args, _n=n_out, **kwargs):
            return [([Replicate()] * _n,
                     [Replicate() if isinstance(a, DTensorSpec) else None
                      for a in args])]
        register_sharding(op)(replicated)
        _RULES_ADDED.append(str(op))
    return list(_RULES_ADDED)


class ReshardOnRefusal(TorchDispatchMode):
    """Where DTensor refuses an op on the placements it was given, GSPMD
    reshards; this mode retries the op (one that writes to no input) on
    its inputs gathered, in turn: a view's or an unbind's input with the
    shards of the dims it changes gathered (``"gather_changed"``: SmolLM's
    9 heads split unevenly over 16; on older torch any split, or a merge
    of batch and heads each split, as a batched matmul makes), then every
    input replicated (``"replicate"``). An op that no retry makes run (one
    with no sharding rule) raises DTensor's refusal. ``retries`` counts
    each retried op by how it ran, and its calls through a rule
    ``add_missing_rules`` gave (``"rule_added"``); the retries' gathers
    go to the counter's ``added``, apart from DTensor's own traffic.

    A view that merges dims whose inner one is split (batch and heads,
    as a batched matmul's view makes) is taken by newer torch with a
    ``_StridedShard`` on the merged dim. Every later op on it is priced by
    DTensor's graph-based redistribute planner, a search a candidate
    placement: milliseconds on two mesh dims (16x16), where the layout
    stays as DTensor chose it; on three (2x16x16) hundreds of candidates
    an op at 0.2-1.4 s each, so one op takes minutes. There no view's
    output keeps one (``_unstrided``). A split factor of 1 (the dims
    outside the inner one split to one row a rank: the batch over 'pod'
    and 'data', the heads over 'model') is a plain shard's layout and is
    named so (``"strided_as_shard"``: nothing moves). Above 1 (heads over
    'pod', batch over 'data', as ``models.attention.decode_attention``'s
    view makes) the mode takes the view as refused and runs it again on
    its input with the shards of the mesh dims that came out so gathered
    (``"gather_strided"``), so that the merged dim is split plainly, as
    older torch's refusal and ``"gather_changed"`` split it. The view that
    came out strided kept its input's placements: it moved nothing."""

    def __init__(self, counter: "CollectiveCounter"):
        super().__init__()
        self.counter = counter
        self.retries: dict = {}

    def _count(self, func, how: str) -> None:
        rec = self.retries.setdefault(str(func), {})
        rec[how] = rec.get(how, 0) + 1

    def _unstrided(self, func, args, kwargs, out):
        """View ``out`` of ``func(*args, **kwargs)``, which holds a
        ``_StridedShard``, without one: the view again on its input with
        the shards of the mesh dims whose split factor is above 1 gathered,
        until none is left; then each split factor of 1 named ``Shard``."""
        how, x = "strided_as_shard", args[0]
        with self.counter.adding():
            while True:
                wide = {i for i, f in _strided(out).items() if f != 1}
                if not wide:
                    break
                x = _gathered(x, mesh_dims=wide)
                out = func(x, *args[1:], **kwargs)
                how = "gather_strided"
        self._count(func, how)
        return _as_shards(out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types) \
                or func._schema.is_mutable:
            return func(*args, **kwargs)
        if str(func) in _RULES_ADDED:
            self._count(func, "rule_added")
        try:
            out = func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as refusal:
            error = refusal
        else:
            if func in _RESHARDED and _strided(out) \
                    and out.device_mesh.ndim > 2:
                return self._unstrided(func, args, kwargs, out)
            return out
        tries = []
        x = args[0] if args else None
        if isinstance(x, DTensor) and func in _RESHARDED:
            tries.append(("gather_changed", lambda: func(
                _gathered(x, _changed_dims(func, x, args)), *args[1:],
                **kwargs)))
        tries.append(("replicate", lambda: func(*_replicated(args),
                                                **_replicated(kwargs))))
        for how, attempt in tries:
            try:
                with self.counter.adding():
                    out = attempt()
            except (RuntimeError, NotImplementedError):
                continue
            self._count(func, how)
            # the refusal's traceback holds this frame: a cycle that would
            # keep the op's inputs alive until a collection, at a time
            # the bytes estimate cannot foresee
            del error
            return out
        raise error


def _changed_dims(func, x, args) -> set:
    """The dims of ``x`` a view (past its unchanged leading sizes) or an
    unbind changes."""
    if func is torch.ops.aten.unbind.int:
        return {args[1] % x.dim() if len(args) > 1 else 0}
    lead = 0
    for a, b in zip(x.shape, args[1]):
        if a != b:
            break
        lead += 1
    return set(range(lead, x.dim()))


def _strided(t) -> dict:
    """Mesh dim -> split factor of each ``_StridedShard`` of DTensor ``t``
    (none for anything else)."""
    from torch.distributed.tensor.placement_types import _StridedShard
    return {i: p.split_factor
            for i, p in enumerate(getattr(t, "placements", ()))
            if isinstance(p, _StridedShard)}


def _as_shards(t):
    """DTensor ``t`` with each ``_StridedShard`` of split factor 1 named
    ``Shard``: one group, split over its mesh dim as placements are
    applied, left to right, so the layout of a ``Shard``; the local shard
    is kept."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    strided = _strided(t)
    spec = DTensorSpec(t.device_mesh, tuple(
        Shard(p.dim) if i in strided else p
        for i, p in enumerate(t.placements)),
        tensor_meta=t._spec.tensor_meta)
    return DTensor(t._local_tensor, spec, requires_grad=t.requires_grad)


def _gathered(x, dims=None, mesh_dims=None):
    """DTensor ``x`` with its shards of ``dims`` on ``mesh_dims`` (all:
    None) replicated. Below autograd (a retry runs inside a dispatch
    mode), so not through ``DTensor.redistribute``'s autograd Function:
    under remat's saved-tensor hooks, torch 2.11's would ``detach_`` its
    output, an op DTensor has no rule for."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._redistribute import \
        redistribute_local_tensor
    spec = DTensorSpec(x.device_mesh, tuple(
        Replicate() if p.is_shard() and (dims is None or p.dim in dims)
        and (mesh_dims is None or i in mesh_dims)
        else p for i, p in enumerate(x.placements)),
        tensor_meta=x._spec.tensor_meta)
    local = redistribute_local_tensor(x._local_tensor, x._spec, spec)
    return DTensor(local, spec, requires_grad=x.requires_grad)


def _map_dtensors(tree, fn):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_dtensors(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_dtensors(v, fn) for k, v in tree.items()}
    return tree


def _replicated(tree):
    return _map_dtensors(tree, _gathered)


def _no_collectives() -> dict:
    return {op: {"count": 0, "bytes": 0} for op in COLLECTIVE_OPS}


def _summed(ops: dict) -> dict:
    out = {k: dict(v) for k, v in ops.items()}
    out["total_bytes"] = sum(v["bytes"] for v in ops.values())
    return out


class CollectiveCounter(TorchDispatchMode):
    """Counts the functional collectives DTensor issues and sums their
    outputs' bytes (this rank's), keyed by the reference's op names: in
    ``ops``, or in ``added`` for those ``ReshardOnRefusal``'s successful
    retries issue (inside ``adding``). Lets DTensor ops through
    (``NotImplemented``) so that it sees the collectives they lower to, as
    ``CommDebugMode`` does."""

    def __init__(self):
        super().__init__()
        self.ops = _no_collectives()
        self.added = _no_collectives()
        self._into = self.ops

    @contextlib.contextmanager
    def adding(self):
        """Counts the block's collectives in ``added`` if it returns, and
        nowhere if it raises (a retry that failed)."""
        into, self._into = self._into, _no_collectives()
        try:
            yield
            for op, rec in self._into.items():
                for k in rec:
                    self.added[op][k] += rec[k]
        finally:
            self._into = into

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = _FUNCOL.get(getattr(func, "__name__", "").split(".")[0])
        if name is not None:
            rec = self._into[name]
            rec["count"] += 1
            rec["bytes"] += sum(t.numel() * t.element_size()
                                for t in tree_flatten_with_paths(out).values()
                                if isinstance(t, torch.Tensor))
        return out

    def record(self) -> dict:
        return _summed(self.ops)

    def record_added(self) -> dict:
        return _summed(self.added)


def _local_bytes(t) -> int:
    """The bytes of rank 0's shard of ``t`` (the tensor's own off a
    mesh)."""
    local = t.to_local() if hasattr(t, "to_local") else t
    return local.numel() * local.element_size()


class BytesEstimate(TorchDispatchMode):
    """Rank 0's live bytes over a trace, an estimate: each local output an
    op makes (one its schema does not alias to an input: no view, no
    in-place write) counts its ``numel x element_size`` from its creation
    until its tensor dies (a ``weakref.finalize``; a tensor autograd saved
    lives on until the graph is freed). ``peak`` is the most live at once.
    Allocator rounding, caching and library workspaces are not counted,
    nor are the tensors DTensor's sharding propagation makes to learn an
    op's output (``counting_apart``: its caches keep some, which no rank
    would hold). ``hold`` / ``release`` count bytes no traced tensor holds
    (a scaled loop's other steps, ``ScaledLoops``). Lets DTensor ops
    through, as ``CollectiveCounter`` does, so that it sees their local
    ops."""

    # the propagator's entry points that run an op's rule: the cached one
    # (an attribute holding the uncached method, which patching that
    # method's name does not reach) and the uncached ones
    _PROPAGATION = ("propagate_op_sharding",
                    "propagate_op_sharding_non_cached",
                    "_propagate_tensor_meta_non_cached")

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.paused = 0

    @contextlib.contextmanager
    def counting_apart(self):
        """Leave out what DTensor's sharding propagator makes inside the
        block. Raises on a torch whose propagator has none of
        ``_PROPAGATION``: there the estimate would count the propagation
        on a cache miss and not on a hit, and so differ trace to trace."""
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        saved = {}

        def paused(real):
            def run(*args, **kwargs):
                self.paused += 1
                try:
                    return real(*args, **kwargs)
                finally:
                    self.paused -= 1
            return run

        for name in self._PROPAGATION:
            if hasattr(prop, name):
                saved[name] = prop.__dict__.get(name)
                setattr(prop, name, paused(getattr(prop, name)))
        if not saved:
            raise RuntimeError(
                f"torch {torch.__version__}: DTensor's sharding propagator "
                f"has none of {self._PROPAGATION}, so the bytes estimate "
                f"cannot leave its allocations out")
        try:
            yield self
        finally:
            for name, real in saved.items():
                if real is None:
                    delattr(prop, name)
                else:
                    setattr(prop, name, real)

    def hold(self, n: int) -> None:
        self.live += n
        self.peak = max(self.peak, self.live)

    def release(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        returns = func._schema.returns
        outs = (out,) if len(returns) == 1 else out
        for ret, o in zip(returns, outs):
            if ret.alias_info is not None:
                continue
            for t in (o if isinstance(o, (list, tuple)) else (o,)):
                if isinstance(t, torch.Tensor):
                    n = t.numel() * t.element_size()
                    self.hold(n)
                    weakref.finalize(t, self.release, n)
        return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)


def _placed(tree) -> tuple:
    """The shapes and DTensor placements of ``tree``'s tensors: two steps
    of a loop whose inputs agree in these run the same ops."""
    return tuple((tuple(t.shape), tuple(getattr(t, "placements", ())))
                 for t in _tensors(tree))


def _repeat(t, dim: int, n: int, flat: bool = False):
    """``n`` copies of ``t`` stacked along a new ``dim`` (a new tensor;
    with ``flat`` that dim merged into the next: ``n`` copies
    concatenated). A DTensor repeats its local shard, its placements
    kept (shards of later dims shifted by the new one), so that no copy
    moves a byte between ranks."""
    def repeat(x):
        shape = list(x.shape)
        shape.insert(dim, n)
        out = x.unsqueeze(dim).expand(shape).clone()
        return out.flatten(dim, dim + 1) if flat else out

    if not hasattr(t, "placements"):
        return repeat(t)
    from torch.distributed.tensor import DTensor, Shard
    shape = list(t.shape)
    if flat:
        shape[dim] *= n
    else:
        shape.insert(dim, n)
    placements = [Shard(p.dim + (not flat and p.dim >= dim))
                  if p.is_shard() else p for p in t.placements]
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(
        repeat(t.to_local()), t.device_mesh, placements, run_check=False,
        shape=torch.Size(shape), stride=tuple(stride))


class ScaledLoops:
    """The dry run's ``kernels.scan_loop.scan_loop`` (installed by
    ``kernels.scan_loop.scaled``). A loop's steps run the same ops when
    their inputs agree in shape and placements, and they do from the
    second or third step on: the carry's placements settle (a zero state
    starts replicated, the first step's output is sharded), and only a
    ragged last run of steps has other shapes. So the loop is traced step
    by step until a step's inputs repeat the step before's; that step's
    FLOPs, collectives and retries are then counted once more for each
    step of the run of same-shaped pieces it stands for, which is not
    traced. The steps' outputs are joined as the plain loop's ``stack`` /
    ``cat`` joins them: each run's output redistributed once to the
    placements the join follows (counted once a step) and repeated
    (``unsqueeze``, ``expand``, ``clone``) in the loop's shapes. The bytes
    estimate holds the untraced steps' outputs (and kept carries) until
    the join, as the plain loop's lists do. A loop's backward is a loop
    of its own (``rwkv6_scan_bwd_ref``, Mamba's ``_SelectiveScan``), so
    no loop runs under autograd here. ``records`` keeps, by (site,
    steps), the calls and one step's FLOPs and collective bytes (the
    settled step's)."""

    def __init__(self, flops, counter: "CollectiveCounter",
                 reshard: "ReshardOnRefusal",
                 estimate: Optional[BytesEstimate] = None):
        self.flops, self.counter, self.reshard = flops, counter, reshard
        self.estimate = estimate
        self.records: dict = {}

    # -- the counters ------------------------------------------------------

    def _counts(self) -> tuple:
        return ({m: dict(c) for m, c in self.flops.flop_counts.items()},
                {op: dict(r) for op, r in self.counter._into.items()},
                {op: dict(r) for op, r in self.counter.added.items()},
                {f: dict(h) for f, h in self.reshard.retries.items()})

    def _delta(self, before: tuple) -> tuple:
        """What was counted since ``before``."""
        after = self._counts()
        flops = {(m, op): n - before[0].get(m, {}).get(op, 0)
                 for m, ops in after[0].items() for op, n in ops.items()}
        colls = tuple({(op, k): v - b[op][k] for op, rec in a.items()
                       for k, v in rec.items()}
                      for b, a in ((before[1], after[1]),
                                   (before[2], after[2])))
        retries = {(f, how): n - before[3].get(f, {}).get(how, 0)
                   for f, hows in after[3].items() for how, n in hows.items()}
        return flops, colls, retries

    def _add(self, delta: tuple, times: int) -> None:
        """Count ``delta`` ``times`` times more (fewer, for < 0)."""
        flops, colls, retries = delta
        for (m, op), d in flops.items():
            self.flops.flop_counts[m][op] += d * times
        for live, d in zip((self.counter._into, self.counter.added), colls):
            for (op, k), v in d.items():
                live[op][k] += v * times
        for (f, how), d in retries.items():
            rec = self.reshard.retries.setdefault(f, {})
            rec[how] = rec.get(how, 0) + d * times

    def _record(self, site: str, steps: int, delta: tuple) -> None:
        flops = sum(d for (m, _), d in delta[0].items() if m == "Global")
        coll = sum(v for (_, k), v in delta[1][0].items() if k == "bytes")
        rec = self.records.setdefault((site, steps), {
            "site": site, "steps": steps, "calls": 0, "flops_step": 0,
            "coll_bytes_step": 0})
        rec["calls"] += 1
        rec["flops_step"], rec["coll_bytes_step"] = flops, coll

    def entries(self) -> list:
        """The records as a list."""
        return [dict(r) for r in self.records.values()]

    # -- the loop ----------------------------------------------------------

    def _steps(self, step, carry, order: list, piece, key,
               keep: bool = False):
        """Trace ``carry, y = step(carry, piece(at))`` over the positions of
        ``order``, a run of steps whose inputs repeat the last traced
        step's (``key(at)`` and the carry's placements) counted from it.
        Returns the last carry, ``[carry_in, y, count]`` a traced step, in
        ``order`` (``carry_in`` None unless ``keep``: the plain loop frees
        each carry after its step), and the last traced step's counts."""
        runs, last, delta = [], None, None
        i = 0
        while i < len(order):
            sig = (_placed(carry), key(order[i]))
            if sig == last:
                run = 1
                while i + run < len(order) and \
                        key(order[i + run]) == key(order[i]):
                    run += 1
                self._add(delta, run)
                runs[-1][2] += run
                i += run
                continue
            before = self._counts()
            out, y = step(carry, piece(order[i]))
            delta = self._delta(before)
            runs.append([carry if keep else None, y, 1])
            last, carry = sig, out
            i += 1
        return carry, runs, delta

    def _join(self, parts: list, dim: int, cat: bool):
        """``parts`` (``(value, count)``: a tensor or a tuple of them,
        repeated ``count`` times), in the pieces' order, joined along
        ``dim`` as ``torch.stack`` / ``torch.cat`` joins the list; the
        estimate holds the list's untraced entries until the join."""
        if not parts:
            return None
        if isinstance(parts[0][0], tuple):
            return tuple(self._join([(v[j], c) for v, c in parts], dim, cat)
                         for j in range(len(parts[0][0])))
        glue = torch.cat if cat else torch.stack
        follow = None
        if hasattr(parts[0][0], "placements"):
            # the placements the join follows: a join of each run's value
            # once (a run's repeats change no placement), not counted
            before = self._counts()
            probe = glue([v for v, _ in parts], dim=dim)
            follow = list(probe.placements)
            if not cat:
                from torch.distributed.tensor import Shard
                follow = [Shard(p.dim - (p.dim > dim)) if p.is_shard()
                          else p for p in follow]
            self._add(self._delta(before), -1)
            del probe
        held = sum((c - 1) * _local_bytes(v) for v, c in parts)
        if self.estimate is not None:
            self.estimate.hold(held)
        out = []
        for v, c in parts:
            if follow is not None and list(v.placements) != follow:
                before = self._counts()
                v = v.redistribute(v.device_mesh, follow)
                self._add(self._delta(before), c - 1)
            out.append(_repeat(v, dim, c, flat=cat))
        if self.estimate is not None:     # the repeats stand for the list
            self.estimate.release(held)
        return out[0] if len(out) == 1 else torch.cat(out, dim=dim)

    def __call__(self, step, carry, xs, *, dim, site, chunks, reverse,
                 keep_every):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in _tensors((carry, xs))):
            raise ValueError(
                f"the {site} loop runs under autograd: a scaled loop counts "
                f"no backward of its own (give the loop an explicit "
                f"backward loop, as the WKV scan and Mamba's scan have)")
        chunks = chunks or (None,) * len(xs)
        lengths = [_lengths(t.shape[dim], c) for t, c in zip(xs, chunks)]
        n = len(lengths[0])
        order = list(range(n - 1, -1, -1) if reverse else range(n))
        out, runs, delta = self._steps(
            step, carry, order,
            lambda at: tuple(_piece(t, dim, c, at)
                             for t, c in zip(xs, chunks)),
            lambda at: tuple(ls[at] for ls in lengths),
            keep=bool(keep_every))
        if delta is not None:
            self._record(site, n, delta)
        kept = None
        if keep_every:
            kept = self._join(_kept(runs, keep_every), dim, cat=False) \
                if n else []
        if reverse:
            runs.reverse()
        ys = self._join([(y, c) for _, y, c in runs], dim,
                        cat=chunks[0] is not None)
        return out, ys, kept


def _lengths(size: int, chunk) -> list:
    """The pieces' lengths of a dim of ``size``, as
    ``kernels.scan_loop`` cuts it."""
    if chunk is None:
        return [1] * size
    return [chunk] * (size // chunk) + ([size % chunk] if size % chunk
                                        else [])


def _piece(t, dim: int, chunk, i: int):
    """Piece ``i`` of ``t`` as ``kernels.scan_loop`` cuts it."""
    if chunk is None:
        return t.select(dim, i)
    return t.narrow(dim, i * chunk, min(chunk, t.shape[dim] - i * chunk))


def _kept(runs: list, every: int) -> list:
    """The carries before steps 0, ``every``, 2 ``every``, ... of a
    forward loop's runs, as ``(carry, count)`` parts."""
    parts, at = [], 0
    for carry, _, count in runs:
        kept = len(range(-(-at // every) * every, at + count, every))
        if kept:
            parts.append((carry, kept))
        at += count
    return parts


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _materialize(args_sds: tuple, specs: tuple, mesh) -> tuple:
    """Each meta stand-in of ``args_sds`` as a DTensor of meta local
    shards on ``mesh``, placed by its spec (none: replicated)."""
    from torch.distributed.tensor import distribute_tensor
    flat = tree_flatten_with_paths(args_sds)
    flat_specs = tree_flatten_with_paths(specs, is_leaf=_is_spec)
    out = {}
    for key, sds in flat.items():
        spec = flat_specs.get(key)
        spec = P() if spec is None else spec
        out[key] = distribute_tensor(
            torch.empty(tuple(sds.shape), dtype=sds.dtype, device="meta"),
            mesh, to_placements(spec, mesh))
    return tree_unflatten_like(args_sds, out)


def _rank0_bytes(tree) -> int:
    return sum(_local_bytes(t) for t in tree_flatten_with_paths(tree).values()
               if isinstance(t, torch.Tensor))


def _trace(fn, args: tuple, *, scale_loops: bool = True) -> dict:
    """Run ``fn(*args)`` on DTensors under the FLOP and collective
    counters and the bytes estimate. The FLOP counter is the outer mode: it
    sees each DTensor op (global shapes) and, inside its handler, the
    local ops DTensor runs reach only the collective counter (after
    ``ReshardOnRefusal``, whose gathers it counts apart) and the bytes
    estimate. The WKV scan takes its plain version on the meta shards;
    with ``scale_loops`` every ``kernels.scan_loop`` loop is traced one
    step and scaled (``ScaledLoops``), else unrolled."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels.scan_loop import scaled

    counter = CollectiveCounter()
    reshard = ReshardOnRefusal(counter)
    estimate = BytesEstimate()
    flops = FlopCounterMode(display=False)
    loops = ScaledLoops(flops, counter, reshard, estimate)

    def traced():
        with implicit_replication(), estimate.counting_apart(), estimate, \
                counter, reshard, flops, \
                (scaled(loops) if scale_loops else contextlib.nullcontext()):
            out = fn(*args)
            return out, flops.get_total_flops()

    # fenced on the outputs, whose shards are meta tensors: nothing waits
    (out, total_flops), trace_s = fenced(traced)
    return {"out": out, "trace_s": trace_s,
            "flops_global": float(total_flops),
            "collectives": counter.record(),
            "collectives_resharded": counter.record_added(),
            "resharded": reshard.retries, "loops": loops.entries(),
            "temp_bytes": estimate.peak}


def card_memory() -> dict:
    """The card's name and memory as ``nvidia-smi`` gives them, or the
    H100 80GB HBM3's where there is none."""
    if shutil.which("nvidia-smi"):
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,memory.total",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=60, check=True).stdout
            name, mib = out.strip().splitlines()[0].rsplit(",", 1)
            return {"name": name.strip(), "bytes": int(mib) * 2 ** 20,
                    "from": "nvidia-smi"}
        except (subprocess.SubprocessError, ValueError, IndexError):
            pass
    return {"name": "NVIDIA H100 80GB HBM3", "bytes": H100_MEMORY_MIB * 2 ** 20,
            "from": "no card here: an H100 80GB HBM3's memory.total"}


def _build(cfg, shape: InputShape, mesh, split, opts):
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, split=split, opts=opts,
                                attn_impl=ATTN_IMPL)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, split=split, opts=opts,
                                  attn_impl=ATTN_IMPL)
    return build_decode_step(cfg, shape, mesh, split=split, opts=opts)


def _decode_pos(shape: InputShape, args: tuple) -> tuple:
    """A decode step's ``pos`` as an int: the cache's last position."""
    if shape.kind != "decode":
        return args
    return args[:-1] + (shape.seq_len - 1,)


def run_one(arch: str, shape_name, *, multi_pod: bool = False,
            outdir: str = "results/dryrun",
            split: Optional[SplitConfig] = None, tag: str = "",
            opts: Optional[PerfOptions] = None, cfg=None,
            mesh=None) -> dict:
    """Trace one combination and write its record. ``cfg`` replaces
    ``ARCHS[arch]``, ``shape_name`` may be an ``InputShape`` and ``mesh``
    replaces the production mesh (a smaller fake mesh, say)."""
    cfg = cfg or ARCHS[arch]
    shape = (shape_name if isinstance(shape_name, InputShape)
             else INPUT_SHAPES[shape_name])
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if mesh is not None:
        mesh_name = "x".join(str(n) for n in mesh_axis_sizes(mesh).values())
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                 "tag": tag or "baseline", "attn_impl": ATTN_IMPL,
                 "torch": torch.__version__}
    if opts is not None:
        rec["opts"] = {k: getattr(opts, k) for k in
                       ("seq_parallel_client", "seq_parallel_server",
                        "moe_groups", "kv_dtype", "client_expert_dp")}
    ok, why = shape_supported(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        _save(rec, outdir)
        return rec

    try:
        mesh = mesh if mesh is not None else make_production_mesh(
            multi_pod=multi_pod)
        rules_added = add_missing_rules()
        built = _build(cfg, shape, mesh, split, opts)
        args = _materialize(built.args_sds, built.in_shardings, mesh)
        main = _trace(built.fn, _decode_pos(shape, args))
        bodies = []
        for probe in build_body_probes(cfg, shape, mesh, split=split,
                                       opts=opts, attn_impl=ATTN_IMPL):
            pargs = _materialize(probe.args_sds, probe.in_shardings, mesh)
            body = _trace(probe.fn, _decode_pos(shape, pargs))
            bodies.append({"group": probe.group_index, "kind": probe.kind,
                           "count": probe.count,
                           "flops_global": body["flops_global"],
                           "coll_bytes": body["collectives"]["total_bytes"],
                           "resharded": body["resharded"],
                           "trace_s": round(body["trace_s"], 2)})
        arg_bytes = _rank0_bytes(args)
        out_bytes = _rank0_bytes(main["out"])
        peak = arg_bytes + main["temp_bytes"]
        card = card_memory()
        rec.update({
            "status": "ok",
            "meta": built.meta,
            "trace_s": round(main["trace_s"], 2),
            "flops_global": main["flops_global"],
            "flops_corrected": main["flops_global"],
            "collectives": main["collectives"],
            "collectives_resharded": main["collectives_resharded"],
            "resharded": main["resharded"],
            "rules_added": rules_added,
            "loops": main["loops"],
            "argument_bytes_rank0": arg_bytes,
            "output_bytes_rank0": out_bytes,
            "peak_bytes_rank0_estimate": peak,
            "temp_bytes_rank0_estimate": main["temp_bytes"],
            "fits": {"card": card["name"], "card_bytes": card["bytes"],
                     "card_from": card["from"],
                     "arguments_fit": arg_bytes <= card["bytes"],
                     "peak_fits_estimate": peak <= card["bytes"]},
            "bodies": bodies,
        })
    except Exception as e:  # record failures: they are bugs to fix
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _save(rec, outdir)
    return rec


def _record_path(outdir: str, arch: str, shape: str, mesh: str,
                 tag: str = "") -> str:
    slug = f"{arch}__{shape}__{mesh}"
    if tag and tag != "baseline":
        slug += f"__{tag}"
    return os.path.join(outdir, slug.replace("/", "_") + ".json")


def _save(rec: dict, outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    path = _record_path(outdir, rec["arch"], rec["shape"], rec["mesh"],
                        rec.get("tag", ""))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    extra = ""
    if status == "ok":
        extra = (f" flops_global={rec['flops_global']:.3e} "
                 f"coll={rec['collectives']['total_bytes']:.3e}B "
                 f"args/rank={rec['argument_bytes_rank0']:.3e}B "
                 f"peak/rank~{rec['peak_bytes_rank0_estimate']:.3e}B "
                 f"trace={rec['trace_s']}s")
    elif status == "error":
        extra = " " + rec["error"].splitlines()[0][:120]
    print(f"[dryrun] {os.path.basename(path)[:-5]}: {status}{extra}",
          flush=True)


def _sweep(combos: list, child_args: list, outdir: str, jobs: int,
           timeout: float) -> dict:
    """Each ``(arch, shape, multi_pod)`` of ``combos`` traced by this
    module in a process of its own (each starts its own fake group),
    ``jobs`` at a time, its output in ``<outdir>/<record>.log``; a process
    that outlives ``timeout`` seconds is killed. Returns the combinations
    killed."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    os.makedirs(outdir, exist_ok=True)
    todo, running, killed = list(combos), [], set()
    while todo or running:
        while todo and len(running) < jobs:
            arch, shape, mp = combo = todo.pop(0)
            log = open(_record_path(outdir, arch, shape, _mesh_name(mp),
                                    _tag_of(child_args))[:-5] + ".log", "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--outdir", outdir,
                   *(["--multi-pod"] if mp else []), *child_args]
            started = time.perf_counter()  # repro: ignore[raw-timer] -- a child process's age: host work, no device
            running.append((combo, subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT), log,
                started))
        time.sleep(0.2)
        for entry in list(running):
            combo, proc, log, t0 = entry
            age = time.perf_counter() - t0  # repro: ignore[raw-timer] -- a child process's age: host work, no device
            if proc.poll() is None and age > timeout:
                proc.kill()
                proc.wait()
                killed.add(combo)
            if proc.poll() is not None:
                log.close()
                running.remove(entry)
    return killed


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _tag_of(child_args: list) -> str:
    return (child_args[child_args.index("--tag") + 1]
            if "--tag" in child_args else "")


def _loops_cell(rec: dict) -> str:
    return "; ".join(f"{r['site']} {r['steps']} x {r['calls']}"
                     for r in rec.get("loops", [])) or "-"


def status_table(combos: list, outdir: str, tag: str = "",
                 killed=()) -> tuple:
    """The records of ``combos`` in ``outdir`` as a markdown table, one row
    a combination: status, global FLOPs, rank 0's argument bytes and
    estimated peak, the collectives' bytes, the scaled loops (site, steps
    x calls) and the trace's host seconds. Returns ``(table, statuses)``,
    a record's status or ``not done`` (killed) or ``no record``."""
    rows = ["| arch | shape | mesh | status | flops_global | args B/rank "
            "| peak B/rank (est.) | collectives B | loops (site steps x "
            "calls) | trace s |", "|---|---|---|---|---|---|---|---|---|---|"]
    statuses = []
    for arch, shape, mp in combos:
        mesh = _mesh_name(mp)
        path = _record_path(outdir, arch, shape, mesh, tag)
        rec = None
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
        status = (rec["status"] if rec is not None
                  else "not done" if (arch, shape, mp) in killed
                  else "no record")
        statuses.append(status)
        head = f"| {arch} | {shape} | {mesh} | {status}"
        if status != "ok":
            why = "" if rec is None else (rec.get("reason")
                                          or rec.get("error", ""))
            why = why.splitlines()[0][:80] if why else ""
            rows.append(f"{head}{': ' + why if why else ''} "
                        f"| | | | | | |")
            continue
        rows.append(
            f"{head} | {rec['flops_global']:.4e} | "
            f"{rec['argument_bytes_rank0']:.4e} | "
            f"{rec['peak_bytes_rank0_estimate']:.4e} | "
            f"{rec['collectives']['total_bytes']:.4e} | {_loops_cell(rec)} | "
            f"{rec['trace_s']} |")
    return "\n".join(rows), statuses


def main(argv=None):
    ap = argparse.ArgumentParser(description=(
        "One combination is traced in this process; more (--all, or "
        "--arch or --shape left open) each in a process of its own, --jobs "
        "at a time, followed by the status table."))
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape (the default without --arch "
                         "and --shape)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--outdir", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--seq-parallel-client", action="store_true")
    ap.add_argument("--seq-parallel-server", action="store_true")
    ap.add_argument("--moe-groups", type=int, default=1)
    ap.add_argument("--kv-dtype", default="param")
    ap.add_argument("--donate", action="store_true")
    ap.add_argument("--jobs", type=int, default=4,
                    help="processes at a time in a sweep")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before a sweep's process is killed")
    args = ap.parse_args(argv)
    if args.donate:
        ap.error("--donate: a PyTorch step donates no buffer (the decode "
                 "step writes its state in place, the train step returns "
                 "new tensors), so there is no variant to trace")

    archs = [args.arch] if args.arch and not args.all else list(ARCHS)
    shapes = [args.shape] if args.shape and not args.all else list(
        INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    combos = [(a, sh, mp) for a in archs for sh in shapes for mp in meshes]
    if args.skip_existing:
        cached = [c for c in combos if os.path.exists(_record_path(
            args.outdir, c[0], c[1], _mesh_name(c[2]), args.tag))]
        for arch, shape, mp in cached:
            print(f"[dryrun] {arch}__{shape}__{_mesh_name(mp)}: cached",
                  flush=True)
    else:
        cached = []
    todo = [c for c in combos if c not in cached]

    if len(combos) == 1:
        opts = None
        if (args.seq_parallel_client or args.seq_parallel_server
                or args.moe_groups != 1 or args.kv_dtype != "param"):
            opts = PerfOptions(seq_parallel_client=args.seq_parallel_client,
                               seq_parallel_server=args.seq_parallel_server,
                               moe_groups=args.moe_groups,
                               kv_dtype=args.kv_dtype)
        for arch, shape, mp in todo:
            run_one(arch, shape, multi_pod=mp, outdir=args.outdir,
                    tag=args.tag, opts=opts)
        killed = set()
    else:
        child = [*(["--tag", args.tag] if args.tag else []),
                 *(["--seq-parallel-client"] if args.seq_parallel_client
                   else []),
                 *(["--seq-parallel-server"] if args.seq_parallel_server
                   else []),
                 "--moe-groups", str(args.moe_groups),
                 "--kv-dtype", args.kv_dtype]
        t0 = time.perf_counter()  # repro: ignore[raw-timer] -- the sweep's wall: host processes, no device
        killed = _sweep(todo, child, args.outdir, args.jobs, args.timeout)
        wall = time.perf_counter() - t0  # repro: ignore[raw-timer] -- the sweep's wall: host processes, no device
    table, statuses = status_table(combos, args.outdir, args.tag, killed)
    if len(combos) > 1:
        print(table)
        print(f"[dryrun] {len(todo)} combinations traced in {wall:.1f} s, "
              f"{args.jobs} at a time")
    count = {k: statuses.count(k) for k in ("ok", "error", "skipped")}
    left = len(statuses) - sum(count.values())
    print(f"[dryrun] done ok={count['ok']} err={count['error']} "
          f"skip={count['skipped']} not_done={left}")
    if count["error"] or left:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
