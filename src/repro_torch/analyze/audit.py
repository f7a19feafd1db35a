"""Pass 1: a runtime audit of one engine round (counterpart of
``repro.analyze.jaxpr_audit``).

The reference audits the jaxpr of its jitted round without running it. The
port has no trace to read: it runs ONE ``Plan.raw_round`` under a
``TorchDispatchMode`` (``RoundAudit``) that sees every aten and c10d op the
round dispatches (the backward's too: the autograd engine carries the mode
into its threads), on the example arguments the reference's
``_example_round_args`` builds: ``plan.init()``'s engine state, one
``round_batches`` draw of the first round's cohort, and a ones mask on the
plan's device for a masked engine. It checks:

``audit-host-sync``
    no host synchronization in the round: no ``aten._local_scalar_dense``
    (``.item()``, ``float(t)``, a tensor's truth value), no
    ``is_nonzero``/``equal``/``allclose``, no blocking copy between the
    host and the device (either way; a ``torch.tensor(data, device=)``
    copies below the dispatcher's Python modes and shows as the
    ``lift_fresh`` of a device tensor), and no op whose output shape
    depends on the data (``nonzero``, ``masked_select``, ``unique``). The
    counterpart of ``jaxpr-callback``: a host round trip inside the round.
    On the card the round also runs under ``obs.timeline.count_host_syncs``
    (CUDA's sync-debug mode), and the two counts must agree
    (``audit-sync-count``): a sync that dispatches no op (a stream's
    ``synchronize()``) is caught there.
``audit-f64``
    no float64/complex128 tensor made (the counterpart of ``jaxpr-f64``).
``audit-collective-group``
    every collective (a c10d op, or a functional collective) runs on one
    of the plan's ``FleetMesh`` groups: its ``data`` group, and over a
    server sub-mesh (``EngineSpec.server_mesh``) the sub-mesh's ``fsdp``
    and ``tp`` groups, which gather the server state; a plan without a
    group issues none (the counterpart of ``jaxpr-collective-axis``).
``audit-launches``
    each custom ``autograd.Function`` of a kernel seam (``_StraightThroughInt8``,
    ``_FlashAttention``, ``_WKV``) runs as often as the engine's design
    says (``expected_calls``): once a local step for all clients on the
    fleet engines and for all seeds on their Monte-Carlo seed axis, once a
    client step on the scan engines, whose Monte-Carlo seeds share one
    round (``fl/scan``'s seed axis calls no kernel); on the card each call
    launches its kernel once (``expected_launches``, from the wrappers'
    ``launches`` counters).

``audit_plan`` audits a plan's raw round, ``audit_mc`` the round of
``run_monte_carlo(mode="vmap")`` (built by the sweep's own
``sim.monte_carlo.build_vmap_rollout``), ``audit_keys`` the environment
stream registry (``sim/streams._REGISTRY``). Hetero-bucketed plans run one
program a bucket on the host and are refused, as ``run_monte_carlo``
refuses them.

Not ported, by design: ``check_donation`` (a PyTorch step donates no
buffer), ``check_const_budget`` and ``check_trace_stability`` (the port
runs eagerly: no ``torch.compile``, no trace to bake constants into or to
retrace).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import traceback
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .findings import Finding, Report

_aten = torch.ops.aten
# ops that read a tensor's value on the host
_SCALAR_READS = frozenset({
    _aten._local_scalar_dense.default, _aten.is_nonzero.default,
    _aten.equal.default, _aten.allclose.default})
# ops whose output shape depends on the data: the host reads a count
_DATA_SHAPED = frozenset({"nonzero", "masked_select", "_unique", "_unique2",
                          "unique_dim", "unique_consecutive"})
# a tensor of repeats with no output size given: the host reads their sum
_COUNT_READS = frozenset({_aten.repeat_interleave.Tensor,
                          _aten.repeat_interleave.self_Tensor})
_WIDE = (torch.float64, torch.complex128)
_SRC = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.dirname(os.path.abspath(__file__))


def _site() -> str:
    """The innermost ``file:line`` of the port (outside this package) on
    the Python stack: where the round asked for the op."""
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path.startswith(_SRC) and not path.startswith(_HERE):
            return f"{os.path.relpath(path, os.path.dirname(_SRC))}:" \
                   f"{frame.lineno}"
    return "?"


def _group_of(func, args, kwargs) -> Optional[str]:
    """The process group a collective op runs on, by name: a c10d op's
    boxed ``process_group``, a functional collective's ``group_name``;
    None for an op that names no group."""
    import torch.distributed as dist
    for i, arg in enumerate(func._schema.arguments):
        if arg.name not in ("process_group", "group_name"):
            continue
        value = args[i] if i < len(args) else kwargs.get(arg.name)
        if isinstance(value, torch.ScriptObject):
            return dist.ProcessGroup.unbox(value).group_name
        return str(value)
    return None


class RoundAudit(TorchDispatchMode):
    """Records, for every op dispatched under it: the host syncs (op and
    the port's line that asked for it), the float64/complex128 tensors
    made, and each collective with its process group's name."""

    def __init__(self):
        super().__init__()
        self.host_syncs: list[str] = []
        self.f64: list[str] = []
        self.collectives: list[tuple[str, str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("c10d", "_c10d_functional"):
            group = _group_of(func, args, kwargs)
            if group is not None:
                self.collectives.append((str(func), group))
        elif (func in _SCALAR_READS
              or func.overloadpacket.__name__ in _DATA_SHAPED
              or (func in _COUNT_READS and kwargs.get("output_size") is None)
              or (func is _aten.lift_fresh.default
                  and args[0].device.type not in ("cpu", "meta"))
              or self._blocking_copy(func, args, kwargs, out)):
            self.host_syncs.append(f"{func} at {_site()}")
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dtype in _WIDE:
                self.f64.append(f"{t.dtype} made by {func} at {_site()}")
        return out

    @staticmethod
    def _blocking_copy(func, args, kwargs, out) -> bool:
        """A copy between the host and a device that waits for it to end
        (``non_blocking=False``: the host blocks on the copy, the device's
        queue first)."""
        if func is _aten._to_copy.default:
            src, dst = args[0], out
            blocking = not kwargs.get("non_blocking", False)
        elif func is _aten.copy_.default:
            dst, src = args[0], args[1]
            blocking = not (args[2] if len(args) > 2
                            else kwargs.get("non_blocking", False))
        else:
            return False
        if not (isinstance(src, torch.Tensor)
                and isinstance(dst, torch.Tensor)):
            return False
        sides = {src.device.type, dst.device.type}
        return blocking and "cpu" in sides and len(sides - {"cpu",
                                                            "meta"}) == 1


def kernel_functions() -> dict:
    """The custom ``autograd.Function`` of each kernel seam, by name."""
    from ..kernels.attn.flash import _FlashAttention
    from ..kernels.quant.ops import _StraightThroughInt8
    from ..kernels.rwkv.ops import _WKV
    return {f.__name__: f for f in (_StraightThroughInt8, _FlashAttention,
                                     _WKV)}


def kernel_launch_counts() -> dict:
    """The launch counters of the wrappers those Functions reach (a CUDA
    tensor's kernel launch adds one; the plain versions none)."""
    from ..kernels.attn.flash import flash_attention
    from ..kernels.quant.int8 import quant_dequant_int8
    from ..kernels.rwkv.scan import rwkv6_scan, rwkv6_scan_bwd
    return {"quant_dequant_int8": quant_dequant_int8.launches,
            "flash_attention": flash_attention.launches,
            "rwkv6_scan": rwkv6_scan.launches,
            "rwkv6_scan_bwd": rwkv6_scan_bwd.launches}


@contextlib.contextmanager
def counting_calls(functions: dict):
    """Counts each Function's ``forward`` runs in the block (under
    ``torch.func.vmap`` the outermost rule folds the batch and runs one
    forward): ``{name: calls}``, filled as the block runs. The forwards
    are wrapped for the block only."""
    counts = {name: 0 for name in functions}

    def counted(name, real):
        @functools.wraps(real)      # torch.func binds forward's signature
        def forward(*args, **kwargs):
            counts[name] += 1
            return real(*args, **kwargs)
        return staticmethod(forward)

    saved = {}
    for name, fn_cls in functions.items():
        saved[fn_cls] = fn_cls.__dict__["forward"]
        fn_cls.forward = counted(name, saved[fn_cls].__func__)
    try:
        yield counts
    finally:
        for fn_cls, fwd in saved.items():
            fn_cls.forward = fwd


@dataclasses.dataclass
class RoundReport:
    """What one audited call did and what it broke. ``cuda_syncs`` is
    ``count_host_syncs``'s count (None off the card); ``calls`` each kernel
    seam's Function runs, ``launches`` each kernel wrapper's launches in
    the call."""
    where: str
    host_syncs: list
    cuda_syncs: Optional[int]
    f64: list
    collectives: list
    calls: dict
    launches: dict
    findings: list

    def summary(self) -> str:
        groups = sorted({g for _, g in self.collectives})
        return (f"{self.where}: host syncs {len(self.host_syncs)} (dispatch)"
                f"{'' if self.cuda_syncs is None else f', {self.cuda_syncs} (cuda)'}"
                f", f64 tensors {len(self.f64)}, collectives "
                f"{len(self.collectives)} on groups {groups}, calls "
                f"{self.calls}, launches {self.launches}")

    @property
    def report(self) -> Report:
        return Report(findings=list(self.findings), checked=[self.summary()])


def audit_call(fn: Callable[[], Any], *, where: str, group=None,
               expected_calls: Optional[dict] = None,
               expected_launches: Optional[dict] = None,
               device=None) -> tuple[Any, RoundReport]:
    """``fn()`` once under ``RoundAudit`` (and, on a CUDA ``device``,
    ``count_host_syncs``), the kernel seams' Functions counted: ``(out,
    RoundReport)``. ``group`` is the process group, or a tuple of them,
    every collective must run on (None or empty: none may run);
    ``expected_calls`` / ``expected_launches`` (by Function / wrapper
    name) are checked where given."""
    from ..obs.timeline import count_host_syncs
    on_card = device is not None and torch.device(device).type == "cuda"
    audit = RoundAudit()
    before = kernel_launch_counts()

    def audited():
        with audit:
            return fn()

    with counting_calls(kernel_functions()) as calls:
        if on_card:
            out, cuda_syncs = count_host_syncs(audited)
        else:
            out, cuda_syncs = audited(), None
    after = kernel_launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    findings = [Finding("audit-host-sync", where,
                        f"host sync inside the round: {s}")
                for s in audit.host_syncs]
    if cuda_syncs is not None and cuda_syncs != len(audit.host_syncs):
        findings.append(Finding(
            "audit-sync-count", where,
            f"CUDA's sync-debug mode counted {cuda_syncs} synchronizing "
            f"operations, the dispatch audit {len(audit.host_syncs)}"))
    findings += [Finding("audit-f64", where,
                         f"{f}: a silent promotion doubles device bytes")
                 for f in audit.f64]
    groups = (() if group is None else tuple(group)
              if isinstance(group, (tuple, list)) else (group,))
    want = sorted(g.group_name for g in groups)
    for op, name in audit.collectives:
        if name not in want:
            findings.append(Finding(
                "audit-collective-group", where,
                f"{op} runs on process group {name!r}, not one of the "
                f"plan's fleet groups ({want})"))
    for what, got, expected in (("calls", calls, expected_calls),
                                ("launches", launches, expected_launches)):
        for name, n in (expected or {}).items():
            if got[name] != n:
                findings.append(Finding(
                    "audit-launches", where,
                    f"{name}: {got[name]} {what} in the round, the engine's "
                    f"design gives {n}"))
    return out, RoundReport(where, list(audit.host_syncs), cuda_syncs,
                            list(audit.f64), list(audit.collectives),
                            dict(calls), launches, findings)


# ---------------------------------------------------------------------------
# plan-level entry points
# ---------------------------------------------------------------------------

def _refuse_hetero(plan) -> None:
    from ..api.plan import _HeteroSLEngine
    if isinstance(plan._engine, _HeteroSLEngine):
        raise ValueError(
            "hetero-bucketed plans dispatch per bucket on the host and have "
            "no single round to audit (the same restriction as "
            "run_monte_carlo)")


def example_round_args(plan) -> tuple:
    """``(engine_state, batches, mask)`` for ``plan.raw_round``, as the
    reference's ``_example_round_args`` builds them: a fresh ``init()``,
    one ``round_batches`` draw of the first round's cohort, a ones mask on
    the device for a masked engine (else None)."""
    from ..api.plan import _needs_mask
    _refuse_hetero(plan)
    state = plan.init()
    batches = plan.round_batches(state, cohort=plan._round_cohort(state))
    mask = (torch.ones(plan.spec.clients.num_clients, device=plan.device)
            if _needs_mask(plan.spec) else None)
    return state.engine_state, batches, mask


def expected_calls(plan) -> dict:
    """Each kernel seam's Function runs in one round by the engine's
    design: the int8 link on an SL plan with an int8 link, flash on a
    split-LM plan whose attention resolves to the kernel (one a layer),
    once a local step for all clients on the fleet engines, once a client
    step on the scan engines; the WKV on no plan. A Monte-Carlo round
    calls each as often: the fleet engines' seed axis folds the seeds into
    the same call, and the scan engines' seeds share one round (or, on
    ``fl/scan``, call no kernel)."""
    from ..kernels.dispatch import resolve_attn_impl
    spec = plan.spec
    per_step = (1 if spec.engine.client_axis != "scan"
                else spec.clients.num_clients)
    steps = spec.local_steps * per_step
    int8 = (steps if spec.engine.kind == "sl"
            and spec.link_policy.compress == "int8" else 0)
    flash = 0
    if spec.model.family == "transformer" and resolve_attn_impl(
            spec.model.attn_impl, plan.device) == "pallas":
        flash = spec.model.arch.n_layers * steps
    return {"_StraightThroughInt8": int8, "_FlashAttention": flash,
            "_WKV": 0}


def expected_launches(plan, calls: dict) -> Optional[dict]:
    """On the card: each flash call launches once, each int8 call once on
    the fused link kernel (none on the two-op path); off the card None
    (the wrappers take their plain versions)."""
    from ..kernels.dispatch import resolve_link_kernel
    if plan.device.type != "cuda":
        return None
    fused = resolve_link_kernel(plan.spec.engine.link_kernel,
                                plan.device) == "fused"
    return {"quant_dequant_int8": (calls["_StraightThroughInt8"]
                                   if fused else 0),
            "flash_attention": calls["_FlashAttention"],
            "rwkv6_scan": calls["_WKV"]}


def _groups(plan) -> tuple:
    """The process groups the plan's collectives run on: its fleet mesh's
    ``data`` group and, over a server sub-mesh, the sub-mesh's own, one a
    dim (the DTensor gathers of the server state)."""
    mesh = plan.mesh
    if mesh is None:
        return ()
    groups = [mesh.group]
    sub = mesh.server_mesh
    if sub is not None:
        groups += [sub.get_group(d) for d in range(sub.ndim)]
    return tuple(g for g in groups if g is not None)


def _warm(plan, fn, args) -> None:
    """On the card, one call outside the audit: the first call at these
    shapes loads the kernel libraries and makes the library handles."""
    if plan.device.type == "cuda":
        fn(*args)
        torch.cuda.synchronize(plan.device)


def audit_round(plan) -> RoundReport:
    """The audit of one ``plan.raw_round`` on ``example_round_args``."""
    _refuse_hetero(plan)
    _warm(plan, plan.raw_round, example_round_args(plan))
    args = example_round_args(plan)
    calls = expected_calls(plan)
    _, rep = audit_call(lambda: plan.raw_round(*args),
                        where=f"round[{plan.spec.describe()}]",
                        group=_groups(plan), expected_calls=calls,
                        expected_launches=expected_launches(plan, calls),
                        device=plan.device)
    return rep


def audit_plan(plan) -> Report:
    """Every runtime check over ``plan``'s raw round, as a ``Report`` whose
    ``checked`` line gives the counts."""
    return audit_round(plan).report


def audit_mc_round(plan, *, num_seeds: int = 2) -> RoundReport:
    """The audit of the Monte-Carlo round, exactly as
    ``run_monte_carlo(mode="vmap")`` builds and runs it
    (``sim.monte_carlo.build_vmap_rollout``): on the fleet engines one
    launch a local step for all seeds and clients, on the scan engines the
    seeds' shared round (``fl/scan``'s seed axis under a population)."""
    from ..sim.monte_carlo import build_vmap_rollout
    _refuse_hetero(plan)
    fn, args = build_vmap_rollout(plan, num_seeds)
    _warm(plan, fn, args)
    fn, args = build_vmap_rollout(plan, num_seeds)
    calls = expected_calls(plan)
    _, rep = audit_call(lambda: fn(*args),
                        where=f"mc_vmap[{plan.spec.describe()}]",
                        group=_groups(plan), expected_calls=calls,
                        expected_launches=expected_launches(plan, calls),
                        device=plan.device)
    return rep


def audit_mc(plan, *, num_seeds: int = 2) -> Report:
    return audit_mc_round(plan, num_seeds=num_seeds).report


def audit_keys() -> Report:
    """Re-validate the environment stream registry (``sim/streams``): each
    (domain, value) held by one slot, each slot under its own key (the
    registry's ``register`` enforces both; the audit proves the loaded
    state, so a mutation that bypassed it still fails)."""
    from ..sim import streams
    report = Report(checked=["repro_torch.sim.streams registry"])
    seen: dict[tuple[str, int], str] = {}
    for key, slot in streams._REGISTRY.items():
        if key != (slot.domain, slot.name):
            report.findings.append(Finding(
                "audit-fold-slot", "repro_torch/sim/streams.py",
                f"slot {slot} is registered under {key}"))
        k = (slot.domain, slot.value)
        if k in seen:
            report.findings.append(Finding(
                "audit-fold-slot", "repro_torch/sim/streams.py",
                f"stream value {slot.value} in domain {slot.domain!r} is "
                f"registered twice ({seen[k]!r} and {slot.name!r})"))
        seen[k] = slot.name
    return report
