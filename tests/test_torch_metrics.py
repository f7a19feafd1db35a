"""The port's in-round metrics bus (``repro_torch.obs.metrics``) against
``repro.obs.metrics``.

Counterparts of ``tests/test_metrics.py`` on the CPU at tiny sizes:

  * the config's validation, the tap-name resolution and the nonfinite
    coordinate's layouts, as the reference's;
  * metrics off leaves the rounds alone: a plan compiled with
    ``obs=None``, with ``ObsConfig(enabled=False)`` or with an enabled
    ``ObsConfig()`` without metrics gives bit-equal records and engine
    state, on ``fl|sl`` x ``scan|vmap``;
  * metrics on observes without changing the training: every non-metric
    record field and the engine state bit-equal to the metrics-off run on
    every engine, the EPSL shared cohort tier, a degenerate population,
    ``HeteroFleet`` buckets and the split LM;
  * the port's ``RoundRecord.metrics`` against the reference's on the same
    spec, data and exported ``params0``: the same keys, the health and
    mask entries exactly, the float taps within ``SCAN_RTOL`` (relative)
    on the CNN's sequential engines and ``FLEET_EQUIV_ATOL`` (relative and
    absolute) on the fleet engines and the split LM;
  * ``quant_error`` only with an int8 link, and equal to the RMS of the
    boundary's output minus its input;
  * a NaN planted at the reference's ``_poison`` place (client 2, step 1
    of round 1) localized exactly on every port engine; the raise policy
    carries the coordinate;
  * a Monte-Carlo sweep's seed 0 replays the plan's metrics (rtol 2e-5, in
    both modes), the per-seed stacks and ``summary()["metrics"]``, and a
    sweep without metrics as before;
  * the ``metrics`` event stream and ``tools/obs_report.py
    --health-gate``.

The reference's wall-clock pin (``test_metrics_overhead_under_3pct``) is
not a CPU test here; the overhead is measured on the card by
``chip_smoke.py``.
"""
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_hetero import _data as _hetero_data
from test_torch_hetero import _hetero_spec

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import repro.api as R  # noqa: E402
import repro.obs.metrics as ref_metrics  # noqa: E402
from repro.configs import smollm_135m as ref_smollm  # noqa: E402
from repro.obs import ObsConfig as RefObsConfig  # noqa: E402
import repro_torch.api as T  # noqa: E402
from repro_torch.configs import smollm_135m  # noqa: E402
from repro_torch.convert import from_reference, lm_from_reference  # noqa
from repro_torch.fleet.engine import FLEET_EQUIV_ATOL  # noqa: E402
from repro_torch.obs import NULL_OBS, ObsConfig  # noqa: E402
from repro_torch.obs.metrics import (TAPS, MetricsConfig,  # noqa: E402
                                     NonfiniteError, engine_tap_names,
                                     first_nonfinite_coord,
                                     split_step_tap_names,
                                     summarize_round_metrics)

# the float taps of the CNN's sequential engines agree with the reference's
# to this relative bound; the fleet engines' and the split LM's (whose
# record streams are held to a loss bound of 1e-3) to FLEET_EQUIV_ATOL,
# relative and absolute (the taps range from ~1e-2, the smashed mean, to
# ~30, the LM's gradient norms)
SCAN_RTOL = 1e-4
N_TRAIN, N_TEST = 96, 24

# every RoundRecord field that must stay bitwise identical metrics-on vs
# metrics-off (everything except `metrics` itself)
NON_METRICS_FIELDS = ("round", "loss", "accuracy", "link_bytes",
                      "link_time_s", "link_energy_j", "client_energy_j",
                      "server_energy_j", "uav_energy_j", "client_time_s",
                      "server_time_s", "active_clients", "engine",
                      "cohort_pids")


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, size=(N_TRAIN, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, 12, size=(N_TRAIN,))
    return x, y, x[:N_TEST], y[:N_TEST]


def _cnn(api, kind="sl", axis="vmap", *, n=3, dropout=0.0, pop=None,
         int8=False, rounds=2):
    return api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(kind="arrays", image_size=16),
        clients=api.ClientSpec(num_clients=n, dropout_rate=dropout,
                               population=pop),
        cut_policy=api.CutPolicy(fraction=0.4),
        link_policy=api.LinkPolicy(compress="int8" if int8 else "none"),
        engine=api.EngineSpec(kind=kind, client_axis=axis,
                              link_kernel="fused" if int8 else "xla"),
        global_rounds=rounds, local_steps=2, batch_size=4)


def _lm(api, arch, axis, dropout=0.0):
    return api.ExperimentSpec(
        model=api.ModelSpec(family="transformer", arch=arch,
                            attn_impl="pallas"),
        data=api.DataSpec(kind="tokens", partition="iid", seq_len=16,
                          n_train=32, n_test=4),
        clients=api.ClientSpec(num_clients=3, dropout_rate=dropout),
        cut_policy=api.CutPolicy(fraction=0.4),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(client_axis=axis, link_kernel="fused"),
        global_rounds=2, local_steps=2, batch_size=4)


# case -> (spec builder of an api module, family: its data)
CASES = {
    "fl-scan": (lambda api: _cnn(api, "fl", "scan"), "cnn"),
    "sl-scan": (lambda api: _cnn(api, "sl", "scan", int8=True), "cnn"),
    "fl-vmap": (lambda api: _cnn(api, "fl", "vmap"), "cnn"),
    "sl-vmap": (lambda api: _cnn(api, "sl", "vmap"), "cnn"),
    "fl-vmap-dropout": (lambda api: _cnn(api, "fl", "vmap", dropout=0.34),
                        "cnn"),
    "sl-vmap-int8-dropout": (
        lambda api: _cnn(api, "sl", "vmap", dropout=0.34, int8=True), "cnn"),
    "sl-vmap-shared-cohort": (
        lambda api: _cnn(api, "sl", "vmap", pop=10_000, dropout=0.34,
                         int8=True), "cnn"),
    "sl-vmap-degenerate-population": (
        lambda api: _cnn(api, "sl", "vmap", pop=3), "cnn"),
    "hetero": (lambda api: _hetero_spec(
        api, dropout=0.3, link=api.LinkPolicy(compress="int8"),
        link_kernel="fused"), "hetero"),
    "lm-scan": (lambda api: _lm(api, ref_smollm.reduced() if api is R
                                else smollm_135m.reduced(), "scan"), "lm"),
    "lm-vmap-dropout": (lambda api: _lm(api, ref_smollm.reduced() if api is R
                                        else smollm_135m.reduced(), "vmap",
                                        dropout=0.34), "lm"),
}
ENGINES = ["fl-scan", "fl-vmap", "sl-scan", "sl-vmap"]


def _metrics_obs(**kw):
    return ObsConfig(enabled=False, metrics=MetricsConfig(**kw))


def _case_data(family):
    return {"cnn": _data, "hetero": _hetero_data}.get(family,
                                                       lambda: None)()


def _port(case, obs=None, data=None):
    build, family = CASES[case]
    data = data if data is not None else _case_data(family)
    return T.compile_experiment(build(T), data=data, device="cpu", obs=obs)


def _leaves(tree) -> list:
    """Every tensor of an engine state, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, torch.nn.Module):
        return _leaves(dict(tree.state_dict()))
    if isinstance(tree, torch.optim.Optimizer):
        return [x for p in tree.state for x in _leaves(dict(tree.state[p]))]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return []


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _run(plan, rounds=2):
    return plan.run(rounds)


@pytest.fixture
def deterministic():
    """The bit-equality pins compare runs under deterministic algorithms:
    on the CPU the split LM's embedding gradient (an accumulating index
    put) sums in a thread-dependent order, so two tap-free runs differ in
    the last bits without it (ROADMAP fault H is the card's counterpart,
    cuDNN's default algorithms)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


# ---------------------------------------------------------------------------
# config and the pure helpers
# ---------------------------------------------------------------------------

def test_metrics_config_validation():
    assert MetricsConfig().taps == TAPS == ref_metrics.TAPS
    with pytest.raises(ValueError, match="unknown metrics taps"):
        MetricsConfig(taps=("bogus",))
    with pytest.raises(ValueError, match="on_nonfinite"):
        MetricsConfig(on_nonfinite="ignore")
    assert MetricsConfig(nan_guard=False).on_nonfinite == "record"


@pytest.mark.parametrize("kind", ["fl", "sl"])
@pytest.mark.parametrize("has_link", [False, True])
def test_engine_tap_names_resolution(kind, has_link):
    for cfg, ref in [(None, None), (MetricsConfig(), ref_metrics.
                                    MetricsConfig()),
                     (MetricsConfig(taps=("smashed", "mask"),
                                    nan_guard=False),
                      ref_metrics.MetricsConfig(taps=("smashed", "mask"),
                                                nan_guard=False))]:
        got = engine_tap_names(cfg, kind=kind, has_link=has_link)
        assert got == ref_metrics.engine_tap_names(ref, kind=kind,
                                                   has_link=has_link)
        assert split_step_tap_names(got) == \
            ref_metrics.split_step_tap_names(got)
    names = engine_tap_names(MetricsConfig(), kind=kind, has_link=has_link)
    assert ("quant_error" in names) == (kind == "sl" and has_link)
    assert ("grad_norm_server" in names) == (kind == "sl")


def test_first_nonfinite_coord_layouts():
    sl = np.zeros((3, 4))
    sl[1, 2] = 1.0
    sl[2, 0] = 1.0
    assert first_nonfinite_coord(sl, "sl") == (1, 2, 2)
    fl = np.zeros((4, 3))          # (clients, steps): time-major is .T
    fl[2, 1] = 1.0
    fl[0, 2] = 1.0
    assert first_nonfinite_coord(fl, "fl") == (1, 2, 2)
    assert first_nonfinite_coord(np.zeros((3, 2)), "sl") is None
    for a, kind in ((sl, "sl"), (fl, "fl"), (np.zeros((3, 2)), "sl")):
        assert first_nonfinite_coord(a, kind) == \
            ref_metrics.first_nonfinite_coord(a, kind)


def test_summarize_round_metrics_is_pure_numpy():
    cfg = MetricsConfig()
    taps = {"grad_norm_client": np.array([[1.0, 3.0], [2.0, 4.0]]),
            "update_norm_server": np.array([0.5, 0.25]),
            "nonfinite": np.zeros((2, 2), np.float32)}
    losses = np.array([[1.0, 2.0], [1.5, 2.5]])
    out = summarize_round_metrics(cfg, taps, losses=losses, kind="sl",
                                  n=2, active=2)
    assert out == ref_metrics.summarize_round_metrics(
        ref_metrics.MetricsConfig(), taps, losses=losses, kind="sl", n=2,
        active=2)
    assert out["grad_norm_client/mean"] == pytest.approx(2.5)
    assert out["update_norm_server/max"] == 0.5
    assert out["loss/spread"] == pytest.approx(0.5)
    assert out["mask/active"] == 2 and out["health/first_step"] == -1
    assert out == summarize_round_metrics(cfg, taps, losses=losses,
                                          kind="sl", n=2, active=2)


# ---------------------------------------------------------------------------
# metrics off: the rounds are those of a plan without telemetry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ENGINES)
def test_metrics_off_records_and_state_bit_equal(case, tmp_path,
                                                 deterministic):
    base_state, base = _run(_port(case))
    for obs in (ObsConfig(enabled=False), ObsConfig(run_root=str(tmp_path))):
        plan = _port(case, obs=obs)
        assert plan.graph_taps == () and plan.metrics_config is None
        state, recs = _run(plan)
        assert [r.to_dict() for r in recs] == [r.to_dict() for r in base]
        _assert_states_equal(state.engine_state, base_state.engine_state)
        plan.obs.close()


# ---------------------------------------------------------------------------
# metrics on: observes without changing the training
# ---------------------------------------------------------------------------

PARITY = ["fl-scan", "fl-vmap", "sl-scan", "sl-vmap", "fl-vmap-dropout",
          "sl-vmap-int8-dropout", "sl-vmap-shared-cohort",
          "sl-vmap-degenerate-population", "hetero", "lm-scan",
          "lm-vmap-dropout"]


@pytest.mark.parametrize("case", PARITY)
def test_record_parity_metrics_on_against_off(case, deterministic):
    off_state, off = _run(_port(case))
    plan = _port(case, obs=_metrics_obs())
    assert plan.graph_taps
    on_state, on = _run(plan)
    for a, b in zip(off, on):
        assert a.metrics == {} and b.metrics
        assert b.metrics["health/nonfinite"] == 0
        for f in NON_METRICS_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
    _assert_states_equal(off_state.engine_state, on_state.engine_state)
    m = on[0].metrics
    kind = plan.spec.engine.kind
    assert "grad_norm_client/mean" in m and "update_norm_client/max" in m
    assert ("grad_norm_server/mean" in m) == (kind == "sl")
    assert ("smashed_std/mean" in m) == (kind == "sl")
    assert ("quant_error/mean" in m) == (
        plan.spec.link_policy.compress == "int8")
    if case == "sl-vmap-shared-cohort":
        assert plan._engine.client_tier == "shared"
        assert len(on[0].cohort_pids) == 3


def _reference(case, data):
    build, family = CASES[case]
    ref_obs = RefObsConfig(enabled=False,
                           metrics=ref_metrics.MetricsConfig())
    return R.compile_experiment(build(R), data=data, obs=ref_obs)


@pytest.mark.parametrize("case", PARITY)
def test_metrics_match_reference(case):
    """The port's metrics against the reference's on the same spec, data,
    params0 (and cohorts): keys equal, health and mask entries exactly,
    the float taps within ``SCAN_RTOL`` on the sequential engines and
    ``FLEET_EQUIV_ATOL`` on the fleet engines."""
    _, family = CASES[case]
    data = _case_data(family)
    ref_plan = _reference(case, data)
    _, ref_recs = ref_plan.run()
    if family == "lm":
        data = (ref_plan.x_train, ref_plan.y_train, ref_plan.x_test,
                ref_plan.y_test)
    plan = _port(case, obs=_metrics_obs(), data=data)
    params = jax.tree_util.tree_map(np.asarray, ref_plan.params0)
    plan.params0 = (lm_from_reference(*params, plan.spec.model.arch)
                    if family == "lm" else from_reference(params, "tinycnn"))
    if plan.spec.clients.population is not None:
        plan.cohorts = [r.cohort_pids for r in ref_recs]
    _, recs = plan.run()
    loose = plan.spec.engine.is_fleet or family == "lm"
    for a, b in zip(ref_recs, recs):
        assert set(a.metrics) == set(b.metrics)
        assert b.active_clients == a.active_clients
        for k, want in a.metrics.items():
            if k.startswith(("health/", "mask/")):
                assert b.metrics[k] == want, k
            elif loose:
                np.testing.assert_allclose(b.metrics[k], want,
                                           rtol=FLEET_EQUIV_ATOL,
                                           atol=FLEET_EQUIV_ATOL, err_msg=k)
            else:
                np.testing.assert_allclose(b.metrics[k], want,
                                           rtol=SCAN_RTOL, err_msg=k)


def test_quant_error_tap_requires_int8_link():
    for case, int8 in (("sl-vmap", False), ("sl-vmap-int8-dropout", True)):
        plan = _port(case, obs=_metrics_obs())
        st = plan.init()
        _, rec = plan.run_round(st, with_eval=False)
        assert ("quant_error/mean" in rec.metrics) == int8
    assert rec.metrics["quant_error/mean"] > 0         # int8 is lossy
    d = json.loads(json.dumps(rec.to_dict()))
    assert d["metrics"]["quant_error/mean"] == rec.metrics["quant_error/mean"]


def test_quant_error_is_the_boundarys_rms():
    """One step of the int8 boundary by hand: the tap is the RMS of the
    boundary's output minus the raw smashed tensor."""
    from repro_torch.core.split import SplitStep
    from repro_torch.kernels.quant.ops import make_link_compress
    compress = make_link_compress(kernel="fused")
    step = SplitStep(client_fwd=lambda c, x: x * 3.0,
                     server_loss=lambda s, sm, y: (sm.sum(), {}),
                     link_constraint=compress,
                     taps=("quant_error", "smashed_absmax"))
    x = torch.randn(4, 8, 32, generator=torch.Generator().manual_seed(0))
    _, aux = step.loss_fn(None, None, {"inputs": x, "targets": None})
    raw = x * 3.0
    want = torch.sqrt(torch.mean((compress(raw) - raw) ** 2))
    assert torch.equal(aux["taps"]["quant_error"], want)
    assert torch.equal(aux["taps"]["smashed_absmax"], raw.abs().max())


# ---------------------------------------------------------------------------
# the NaN guard localizes exactly, on every engine
# ---------------------------------------------------------------------------

def _poison(batches, client, step):
    """The round's own batch stack with NaN planted at one (client slot,
    local step), both engine batch formats."""
    if isinstance(batches, dict):                      # SL
        bx = batches["inputs"].clone()
        bx[client, step] = float("nan")
        return {"inputs": bx, "targets": batches["targets"]}
    bx, by = batches                                   # FL
    bx = bx.clone()
    bx[client, step] = float("nan")
    return bx, by


NAN_CASES = ENGINES + ["sl-vmap-shared-cohort", "hetero"]


@pytest.mark.parametrize("case", NAN_CASES)
def test_nan_localized_exactly(case):
    plan = _port(case, obs=_metrics_obs())
    state = plan.init()
    state, rec0 = plan.run_round(state, with_eval=False)
    assert rec0.metrics["health/nonfinite"] == 0
    cohort = plan._round_cohort(state)
    bad = _poison(plan.round_batches(state, cohort=cohort), client=2, step=1)
    state, rec1 = plan.run_round(state, bad, with_eval=False)
    m = rec1.metrics
    assert m["health/nonfinite"] >= 1
    assert m["health/first_step"] == 1
    assert m["health/first_client"] == 2


def test_nan_raise_policy_carries_coordinate():
    plan = _port("sl-vmap", obs=_metrics_obs(on_nonfinite="raise"))
    state = plan.init()
    state, _ = plan.run_round(state, with_eval=False)  # round 0 clean
    bad = _poison(plan.round_batches(state), client=1, step=0)
    with pytest.raises(NonfiniteError) as ei:
        plan.run_round(state, bad, with_eval=False)
    assert ei.value.round_index == 1
    assert ei.value.step == 0 and ei.value.client == 1
    assert ei.value.count >= 1 and "round=1" in str(ei.value)


# ---------------------------------------------------------------------------
# Monte-Carlo sweeps carry the taps per seed
# ---------------------------------------------------------------------------

def _stoch_metrics_plan(rounds=3, kind="sl"):
    from repro_torch.sim import (AvailabilityParams, ChannelParams,
                                 ScenarioSpec)
    scn = ScenarioSpec(
        channel=ChannelParams(kind="a2g"),
        availability=AvailabilityParams(kind="markov", p_drop=0.4,
                                        p_recover=0.6),
        num_uavs=2, serve_mode="relay", seed=1)
    spec = dataclasses.replace(
        _cnn(T, kind, "vmap", n=3, int8=kind == "sl", rounds=rounds),
        mission=T.MissionSpec(farm_acres=100.0), scenario=scn)
    return T.compile_experiment(spec, data=_data(), device="cpu",
                                obs=_metrics_obs())


@pytest.mark.parametrize("mode", ["vmap", "loop"])
@pytest.mark.parametrize("kind", ["sl", "fl"])
def test_monte_carlo_seed_zero_replays_plan_metrics(mode, kind):
    from repro_torch.sim import run_monte_carlo
    plan = _stoch_metrics_plan(kind=kind)
    _, recs = plan.run(with_eval=False)
    mrecs = run_monte_carlo(plan, 2, rounds=3, seed=0,
                            mode=mode).records_for_seed(0)
    for a, b in zip(recs, mrecs):
        assert set(a.metrics) == set(b.metrics) and a.metrics
        for k in a.metrics:
            if k.startswith(("health/", "mask/")):
                assert a.metrics[k] == b.metrics[k], k
            else:
                np.testing.assert_allclose(a.metrics[k], b.metrics[k],
                                           rtol=2e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kind", ["sl", "fl"])
def test_monte_carlo_loop_on_the_scan_engines_carries_taps(kind, tmp_path):
    """The loop mode on a sequential engine with the metrics bus and a run
    directory: seed 0 replays ``plan.run()``'s metrics (the same engine,
    batches and environment), the ``mc/*`` spans are written."""
    from repro_torch.sim import run_monte_carlo
    plan = T.compile_experiment(
        _cnn(T, kind, "scan", int8=kind == "sl"), data=_data(),
        device="cpu", obs=ObsConfig(run_root=str(tmp_path), run_id="scan",
                                    metrics=MetricsConfig()))
    _, recs = plan.run(with_eval=False)
    mc = run_monte_carlo(plan, 2, rounds=2, mode="loop")
    plan.obs.close()
    assert mc.stacks["metrics/grad_norm_client"].shape == (
        (2, 2, 2, 3) if kind == "sl" else (2, 2, 3, 2))
    for a, b in zip(recs, mc.records_for_seed(0)):
        assert a.metrics == b.metrics
    with open(os.path.join(plan.obs.run_dir, "events.jsonl")) as f:
        paths = {json.loads(line).get("path") for line in f}
    assert {"mc/setup", "mc/compile", "mc/execute", "mc/summarize"} <= paths


def test_monte_carlo_metrics_stacks_and_summary():
    from repro_torch.sim import run_monte_carlo
    plan = _stoch_metrics_plan()
    mc = run_monte_carlo(plan, 3, rounds=2)
    tap_keys = sorted(k for k in mc.stacks if k.startswith("metrics/"))
    assert tap_keys == sorted(f"metrics/{t}" for t in plan.graph_taps)
    for k in tap_keys:
        want = (3, 2, 2) if k == "metrics/update_norm_server" \
            else (3, 2, 2, 3)                 # (seeds, rounds, steps[, c])
        assert mc.stacks[k].shape == want, k
    assert mc.stacks["loss_stack"].shape == (3, 2, 2, 3)
    s = mc.summary()["metrics"]
    assert s is not None and "grad_norm_client" in s
    assert s["grad_norm_client"]["min"] <= s["grad_norm_client"]["mean"] \
        <= s["grad_norm_client"]["max"]
    lc = run_monte_carlo(plan, 3, rounds=2, mode="loop")
    for k in tap_keys + ["loss_stack"]:
        np.testing.assert_allclose(lc.stacks[k], mc.stacks[k], rtol=2e-5,
                                   atol=FLEET_EQUIV_ATOL, err_msg=k)
    assert all(r.metrics for r in mc.records_for_seed(2))


def test_monte_carlo_without_metrics_unchanged():
    from repro_torch.sim import run_monte_carlo
    plan = T.compile_experiment(_cnn(T), data=_data(), device="cpu")
    assert plan.obs is NULL_OBS
    mc = run_monte_carlo(plan, 2, rounds=2)
    assert not any(k.startswith("metrics/") for k in mc.stacks)
    assert "loss_stack" not in mc.stacks
    assert mc.records_for_seed(0)[0].metrics == {}
    assert mc.summary()["metrics"] is None


# ---------------------------------------------------------------------------
# the sink's metrics events and the report's health gate
# ---------------------------------------------------------------------------

def test_metrics_events_stream_and_health_gate(tmp_path):
    import obs_report
    plan = T.compile_experiment(
        _cnn(T), data=_data(), device="cpu",
        obs=ObsConfig(run_root=str(tmp_path), run_id="mx",
                      metrics=MetricsConfig()))
    plan.run(with_eval=False)
    plan.obs.close()
    _, events = obs_report.load_run(plan.obs.run_dir)
    mev = obs_report.metrics_rounds(events)
    assert [e["round"] for e in mev] == [0, 1]
    assert all("grad_norm_client/mean" in e for e in mev)
    assert all(e["engine"] == "sl/vmap" for e in mev)
    assert obs_report.health_nonfinite_total(events) == 0
    lines = obs_report.metrics_section(events)
    assert any("metrics taps" in ln for ln in lines)
    assert any("0 nonfinite" in ln for ln in lines)
    rendered = obs_report.render(plan.obs.run_dir, *obs_report.load_run(
        plan.obs.run_dir))
    assert any("grad_norm_client/mean" in ln for ln in rendered)
    # a poisoned round flags the run
    plan2 = T.compile_experiment(
        _cnn(T), data=_data(), device="cpu",
        obs=ObsConfig(run_root=str(tmp_path), run_id="bad",
                      metrics=MetricsConfig()))
    st = plan2.init()
    plan2.run_round(st, _poison(plan2.round_batches(st), 0, 0),
                    with_eval=False)
    plan2.obs.close()
    _, events = obs_report.load_run(plan2.obs.run_dir)
    assert obs_report.health_nonfinite_total(events) >= 1
