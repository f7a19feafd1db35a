"""What a strided view costs DTensor's strategy search in the dry run: a
decode_32k body probe (one layer at the published widths,
``launch.steps.build_body_probes``) traced as ``launch.dryrun`` traces it:
SmolLM-135M's on the 2x16x16 mesh with views allowed to keep DTensor's
``_StridedShard`` (``keep-strided``, the dry run before it took such
views apart) and as the dry run is, and on the 16x16 mesh SmolLM-135M's
and rwkv6-7b's (whose WKV step merges batch and heads into a strided
split there, which the dry run keeps).

    PYTHONPATH=src python tests/dryrun_strided_probe.py [--budget 240]

Not collected by pytest. Each case runs in a process of its own (the dry
run starts a fake process group; DTensor's caches stay cold), the four
side by side, each stopped after ``--budget`` seconds. A case prints its
trace's seconds, or that it did not end, and for the first op that takes
an input with a ``_StridedShard``: its input specs, its candidate
strategies (``expand_to_full_mesh_op_strategy``'s, beside the strategies
a mesh dim they are expanded from), the redistribute plans it made and the
searches of DTensor's graph-based planner among them, with their seconds.
It imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


class _Stop(BaseException):
    """The budget's end: past DTensor's ``except Exception``."""


def _case(arch: str, mesh: str, keep_strided: bool, budget: float) -> None:
    sys.path.insert(0, SRC)
    import torch.distributed.tensor._ops as ops_pkg
    import torch.distributed.tensor._ops.utils as op_utils
    import torch.distributed.tensor._redistribute as redist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.placement_types import _StridedShard

    from repro_torch.configs import ARCHS, INPUT_SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_body_probes

    if keep_strided:
        dryrun.ReshardOnRefusal._unstrided = \
            lambda self, func, args, kwargs, out: out
    cfg = dataclasses.replace(ARCHS[arch], n_layers=1)
    shape = INPUT_SHAPES["decode_32k"]
    dev_mesh = make_production_mesh(multi_pod=mesh == "pod2x16x16")
    dryrun.add_missing_rules()
    probe = build_body_probes(cfg, shape, dev_mesh,
                              attn_impl=dryrun.ATTN_IMPL)[0]
    args = dryrun._materialize(probe.args_sds, probe.in_shardings, dev_mesh)

    op = {"watch": False, "name": None, "specs": None, "cands": [],
          "plans": 0, "searches": []}

    real_expand = op_utils.expand_to_full_mesh_op_strategy

    def expand(*a, **kw):
        out = real_expand(*a, **kw)
        if op["watch"]:
            per_dim = a[2] if len(a) > 2 else kw["single_mesh_dim_strategies"]
            op["cands"].append((len(per_dim), len(out.strategies)))
        return out

    op_utils.expand_to_full_mesh_op_strategy = expand
    for name in dir(ops_pkg):     # the rule modules that bound it by name
        mod = getattr(ops_pkg, name)
        if getattr(mod, "expand_to_full_mesh_op_strategy", None) \
                is real_expand:
            mod.expand_to_full_mesh_op_strategy = expand

    real_plan = redist._gen_transform_infos_non_cached

    def plan(*a, **kw):
        op["plans"] += op["watch"]
        return real_plan(*a, **kw)

    redist._gen_transform_infos_non_cached = plan
    planner = redist.DTensorRedistributePlanner
    real_search = planner.generate_graph_based_transform_infos

    def search(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return real_search(self, *a, **kw)
        finally:
            if op["watch"]:
                op["searches"].append(time.perf_counter() - t0)

    planner.generate_graph_based_transform_infos = search
    prop = DTensor._op_dispatcher.sharding_propagator
    real_prop = prop.propagate_op_sharding_non_cached

    def propagate(schema):
        strided = op["name"] is None and any(
            isinstance(s, DTensorSpec) and any(
                isinstance(p, _StridedShard) for p in s.placements)
            for s in schema.args_schema)
        if not strided:
            return real_prop(schema)
        op.update(watch=True, name=str(schema.op), specs=[
            str(s) for s in schema.args_schema if isinstance(s, DTensorSpec)])
        t0 = time.perf_counter()
        try:
            return real_prop(schema)
        finally:
            op["watch"] = False
            op["op_s"] = time.perf_counter() - t0

    prop.propagate_op_sharding_non_cached = propagate

    def stop(*_):
        raise _Stop()

    signal.signal(signal.SIGALRM, stop)
    signal.alarm(int(budget))
    t0 = time.perf_counter()
    try:
        dryrun._trace(probe.fn, dryrun._decode_pos(shape, args))
        ended = f"ended in {time.perf_counter() - t0:.2f} s"
    except _Stop:
        ended = f"not done in {budget:.0f} s"
    signal.alarm(0)
    tag = f"[probe] {arch} {mesh}{' keep-strided' if keep_strided else ''}"
    print(f"{tag}: trace {ended}")
    if op["name"] is None:
        print(f"{tag}: no op took an input with a _StridedShard")
        return
    s = op["searches"]
    print(f"{tag}: first op on a strided input {op['name']} {op['specs']}: "
          f"{'done in %.2f s' % op['op_s'] if 'op_s' in op else 'not done'}"
          f"; candidates (a mesh dim's, expanded) {op['cands']}; "
          f"redistribute plans {op['plans']}, graph-based searches "
          f"{len(s)} in {sum(s):.2f} s (mean {sum(s) / max(len(s), 1):.4f}"
          f" s, max {max(s, default=0.0):.4f} s)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=float, default=240.0)
    ap.add_argument("--case", nargs=3, default=None,
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.case:
        _case(a.case[0], a.case[1], a.case[2] == "keep", a.budget)
        return
    env = dict(os.environ, PYTHONPATH=SRC)
    cases = [("smollm-135m", "pod16x16", "as-is"),
             ("rwkv6-7b", "pod16x16", "as-is"),
             ("smollm-135m", "pod2x16x16", "keep"),
             ("smollm-135m", "pod2x16x16", "as-is")]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--budget", str(a.budget), "--case", *c],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True) for c in cases]
    for p in procs:
        out, _ = p.communicate(timeout=a.budget + 120)
        print(out, end="")


if __name__ == "__main__":
    main()
