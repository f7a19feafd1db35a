"""The engine-variant matrix the runtime audit sweeps (counterpart of
``repro.analyze.variants``).

The reference's matrix, compiled by the port at the same tiny specs: one
tinycnn spec per ``EngineSpec`` variant (fl/sl x scan/vmap/shard_map), the
masked engines, the population-cohort corners (stateless FL cohorts and
the EPSL shared client tier), the kernel-carrying lowerings (the flash
kernel in a split-LM round, ``attn_impl="pallas"``, the name the port's
spec keeps for it, and the fused int8 link), the Monte-Carlo seed-axis
rollouts, and the metrics-bus twins (``<name>+metrics``: the same specs
compiled with ``ObsConfig(metrics=MetricsConfig())``, so the tap-carrying
rounds clear the audit too): 13 variants, 6 twins, 2 rollouts and 1
rollout twin, 22 entries. ``tools/repro_torch_lint.py --audit`` compiles
each on ``--device`` and runs ``audit_plan`` / ``audit_mc``; a finding on
any entry fails it.

A ``shard_map`` variant takes the default process group when one is up
(``make_fleet_mesh``), else the single-rank mesh, whose collectives are the
identity: the tests audit those variants on two spawned gloo ranks.
"""
from __future__ import annotations

from typing import Iterator, Optional

NUM_CLASSES = 4


def _tiny_spec(kind: str, axis: str, *, pop: Optional[int] = None,
               scenario=None, dropout: float = 0.0, mission: bool = False,
               link_kernel: str = "xla", compress: str = "none"):
    from ..api import (ClientSpec, CutPolicy, DataSpec, EngineSpec,
                       ExperimentSpec, LinkPolicy, MissionSpec, ModelSpec)
    return ExperimentSpec(
        model=ModelSpec(name="tinycnn", num_classes=NUM_CLASSES),
        data=DataSpec(kind="synthetic", image_size=12, classes_per_client=2,
                      n_train=32, n_test=16),
        clients=ClientSpec(num_clients=2, population=pop,
                           dropout_rate=dropout),
        cut_policy=CutPolicy(mode="fraction", fraction=0.4),
        link_policy=LinkPolicy(compress=compress),
        engine=EngineSpec(kind=kind, client_axis=axis,
                          link_kernel=link_kernel),
        mission=MissionSpec(farm_acres=50.0) if mission else None,
        scenario=scenario,
        global_rounds=1, local_steps=1, batch_size=4, seed=0)


def _tiny_lm_spec(axis: str, *, attn_impl: str = "xla"):
    """The least transformer SL spec: the kernel seam
    (``ModelSpec.attn_impl``) in a real split-LM round."""
    from ..api import (ClientSpec, CutPolicy, DataSpec, EngineSpec,
                       ExperimentSpec, ModelSpec)
    from ..configs.base import ArchConfig
    arch = ArchConfig(name="tinylm", family="attn", n_layers=2, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
                      dtype="float32")
    return ExperimentSpec(
        model=ModelSpec(family="transformer", name="tinylm", arch=arch,
                        attn_impl=attn_impl),
        data=DataSpec(kind="tokens", partition="iid", seq_len=16,
                      n_train=32, n_test=16),
        clients=ClientSpec(num_clients=2),
        cut_policy=CutPolicy(mode="fraction", fraction=0.5),
        engine=EngineSpec(kind="sl", client_axis=axis),
        global_rounds=1, local_steps=1, batch_size=4, seed=0)


def variant_specs() -> Iterator[tuple[str, object]]:
    """``(name, ExperimentSpec)`` per audited variant."""
    for kind in ("fl", "sl"):
        for axis in ("scan", "vmap", "shard_map"):
            yield f"{kind}/{axis}", _tiny_spec(kind, axis)
    # masked engines (a round that takes a mask)
    yield "fl/vmap+dropout", _tiny_spec("fl", "vmap", dropout=0.25)
    yield "sl/vmap+dropout", _tiny_spec("sl", "vmap", dropout=0.25)
    # population cohorts: stateless FL rounds and the EPSL shared client tier
    yield "fl/vmap+population", _tiny_spec("fl", "vmap", pop=6)
    yield "sl/vmap+population", _tiny_spec("sl", "vmap", pop=6)
    # the kernels on: the flash kernel in a split-LM round, the fused int8
    # link boundary
    yield "sl/vmap+lm_pallas", _tiny_lm_spec("vmap", attn_impl="pallas")
    yield "sl/scan+lm_pallas", _tiny_lm_spec("scan", attn_impl="pallas")
    yield "sl/vmap+link_fused", _tiny_spec("sl", "vmap", compress="int8",
                                           link_kernel="fused")


# variants whose metrics-bus twin ("<name>+metrics") joins the audit: the
# tap-carrying rounds run other code (the taps' second backward)
METRICS_TWINS = ("fl/vmap", "sl/scan", "sl/vmap", "sl/shard_map",
                 "sl/vmap+population", "sl/vmap+link_fused",
                 "mc/sl/vmap+population")


def _metrics_obs():
    """The metrics-on ObsConfig: the full default tap set, no sink
    (``enabled=False`` keeps the sweep free of run directories)."""
    from ..obs import ObsConfig
    from ..obs.metrics import MetricsConfig
    return ObsConfig(enabled=False, metrics=MetricsConfig())


def mc_specs() -> Iterator[tuple[str, object]]:
    """Variants whose Monte-Carlo seed-axis round is audited."""
    from ..sim import AvailabilityParams, ChannelParams, ScenarioSpec
    scn = ScenarioSpec(
        channel=ChannelParams(kind="a2g"),
        availability=AvailabilityParams(kind="bernoulli", p_drop=0.3),
        seed=1)
    yield "mc/fl/vmap+scenario", _tiny_spec("fl", "vmap", scenario=scn,
                                            mission=True)
    yield "mc/sl/vmap+population", _tiny_spec("sl", "vmap", pop=6)


def compiled_variants(*, mc: bool = True, match: Optional[str] = None,
                      device="cuda", mesh=None
                      ) -> Iterator[tuple[str, object, bool]]:
    """Compile the matrix lazily on ``device``: ``(name, plan,
    audit_mc_too)``. ``match`` filters by substring before compiling (the
    CLI's ``--variant``); ``mesh`` (a ``launch.mesh.FleetMesh``) is the
    ``shard_map`` variants' (default: ``compile_experiment``'s)."""
    from ..api import compile_experiment
    specs = [(n, s, False) for n, s in variant_specs()]
    if mc:
        specs += [(n, s, True) for n, s in mc_specs()]
    for name, spec, with_mc in specs:
        kw = dict(device=device, mesh=(
            mesh if spec.engine.client_axis == "shard_map" else None))
        if match is None or match in name:
            yield name, compile_experiment(spec, **kw), with_mc
        twin = f"{name}+metrics"
        if name in METRICS_TWINS and (match is None or match in twin):
            yield twin, compile_experiment(spec, obs=_metrics_obs(),
                                           **kw), with_mc


def audit_all(*, mc: bool = True, match: Optional[str] = None,
              device="cuda", mesh=None, on_entry=None):
    """The whole runtime audit: the stream registry, then every compiled
    variant's raw round (and its Monte-Carlo round for an ``mc/`` entry).
    ``on_entry(name, report)`` sees each entry's ``Report`` as it is made.
    Returns the combined ``Report``."""
    from .audit import audit_keys, audit_mc, audit_plan
    from .findings import Report
    report = Report()
    report.extend(audit_keys())
    for name, plan, with_mc in compiled_variants(mc=mc, match=match,
                                                 device=device, mesh=mesh):
        r = audit_plan(plan)
        if with_mc:
            r.extend(audit_mc(plan))
        r.checked = [f"{name}: {c}" for c in r.checked]
        if on_entry is not None:
            on_entry(name, r)
        report.extend(r)
    return report
