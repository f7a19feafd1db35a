"""Device-free dry run: trace every (arch x input shape x mesh) step
(counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

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
own. Each record goes to
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
  ``replicate``), and the calls of the ops that ran on a rule
  ``add_missing_rules`` gave (``rule_added``); ``collectives_resharded``
  the retries' gathers, in the form of ``collectives`` and not in it;
  ``rules_added`` the ops this torch had no rule for that were given one.
  All three depend on torch's version: DTensor's rules differ (2.11
  refuses more than 2.13).
- ``fits``: the arguments against the card's memory as ``nvidia-smi``
  names it (an H100 80GB HBM3's 81,559 MiB where there is no card). No
  peak: torch's memory tracker counts real storages, and meta shards have
  none, so activations are not in the verdict (``arguments_fit`` says so
  in its name).
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
import traceback
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
    go to the counter's ``added``, apart from DTensor's own traffic."""

    def __init__(self, counter: "CollectiveCounter"):
        super().__init__()
        self.counter = counter
        self.retries: dict = {}

    def _count(self, func, how: str) -> None:
        rec = self.retries.setdefault(str(func), {})
        rec[how] = rec.get(how, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types) \
                or func._schema.is_mutable:
            return func(*args, **kwargs)
        if str(func) in _RULES_ADDED:
            self._count(func, "rule_added")
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as refusal:
            error = refusal
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


def _gathered(x, dims=None):
    """DTensor ``x`` with its shards of ``dims`` (all: None) replicated."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard() and (dims is None or p.dim in dims)
        else p for p in x.placements])


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
    total = 0
    for t in tree_flatten_with_paths(tree).values():
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
    return total


def _trace(fn, args: tuple) -> dict:
    """Run ``fn(*args)`` on DTensors under the FLOP and collective
    counters. The FLOP counter is the outer mode: it sees each DTensor op
    (global shapes) and, inside its handler, the local ops DTensor runs
    reach only the collective counter (after ``ReshardOnRefusal``, whose
    gathers it counts apart). The WKV scan takes its plain version on the
    meta shards."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    counter = CollectiveCounter()
    reshard = ReshardOnRefusal(counter)

    def traced():
        with implicit_replication(), counter, reshard, \
                FlopCounterMode(display=False) as flops:
            return fn(*args), flops.get_total_flops()

    # fenced on the outputs, whose shards are meta tensors: nothing waits
    (out, total_flops), trace_s = fenced(traced)
    return {"out": out, "trace_s": trace_s,
            "flops_global": float(total_flops),
            "collectives": counter.record(),
            "collectives_resharded": counter.record_added(),
            "resharded": reshard.retries}


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
            "argument_bytes_rank0": arg_bytes,
            "output_bytes_rank0": out_bytes,
            "fits": {"card": card["name"], "card_bytes": card["bytes"],
                     "card_from": card["from"],
                     "arguments_fit": arg_bytes <= card["bytes"]},
            "bodies": bodies,
        })
    except Exception as e:  # record failures: they are bugs to fix
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _save(rec, outdir)
    return rec


def _save(rec: dict, outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    slug = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    if rec.get("tag") and rec["tag"] != "baseline":
        slug += f"__{rec['tag']}"
    path = os.path.join(outdir, slug.replace("/", "_") + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    extra = ""
    if status == "ok":
        extra = (f" flops_global={rec['flops_global']:.3e} "
                 f"coll={rec['collectives']['total_bytes']:.3e}B "
                 f"args/rank={rec['argument_bytes_rank0']:.3e}B "
                 f"trace={rec['trace_s']}s")
    elif status == "error":
        extra = " " + rec["error"].splitlines()[0][:120]
    print(f"[dryrun] {slug}: {status}{extra}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
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
    args = ap.parse_args(argv)
    if args.donate:
        ap.error("--donate: a PyTorch step donates no buffer (the decode "
                 "step writes its state in place, the train step returns "
                 "new tensors), so there is no variant to trace")

    opts = None
    if (args.seq_parallel_client or args.seq_parallel_server
            or args.moe_groups != 1 or args.kv_dtype != "param"):
        opts = PerfOptions(seq_parallel_client=args.seq_parallel_client,
                           seq_parallel_server=args.seq_parallel_server,
                           moe_groups=args.moe_groups,
                           kv_dtype=args.kv_dtype)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_err = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                if args.skip_existing:
                    slug = (f"{arch}__{shape}__"
                            f"{'pod2x16x16' if mp else 'pod16x16'}.json")
                    if os.path.exists(os.path.join(args.outdir, slug)):
                        print(f"[dryrun] {slug}: cached", flush=True)
                        n_ok += 1
                        continue
                rec = run_one(arch, shape, multi_pod=mp, outdir=args.outdir,
                              tag=args.tag, opts=opts)
                n_ok += rec["status"] == "ok"
                n_err += rec["status"] == "error"
                n_skip += rec["status"] == "skipped"
    print(f"[dryrun] done ok={n_ok} err={n_err} skip={n_skip}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
