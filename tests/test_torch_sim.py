"""The port's scenario layer (``repro_torch.sim``) against the reference's.

The draws and the rules are apart in the port: the reference's own draws
(uniforms of its ``ENV_MASK`` fold, normals and exponentials of its
``ENV_RATES`` fold, ``test_torch_harness.reference_env_draws``) go
through the port's rules and must give the reference's masks and rates:

- the channel: the deterministic rate within 1e-6 of the reference's over
  a distance grid (``a2g`` and ``constant``), ``rates_from_draws`` on the
  reference's draws within 1e-6 of its ``sample_rates_bps``, monotone in
  distance, the deterministic corners drawing nothing;
- availability: the masks of ``availability_step`` on the reference's
  uniforms equal to the reference's, bernoulli, markov and full, the
  one-client guard included;
- ``rollout_mission`` equal to the reference's (hover and relay, 1 to 3
  UAVs), and the stream registry (collisions raise; the cohort stream's
  layout unchanged);
- plans: the degenerate scenario reproduces the port's idealised campaign
  records (rel 1e-12); tinycnn ``sl/vmap`` under the reference tests'
  ``STOCH`` scenario, a population under markov availability, a split LM
  with an ``a2g`` channel and adaptive cuts under relay serving, each with
  the reference's draws fed in (``Plan.env_draws``, and its cohorts
  through ``Plan.cohorts``), match the reference's records
  (``assert_records_match``: masks, active clients, cohort ids and bytes
  exactly, link time and energy within 1e-6, losses within
  ``FLEET_EQUIV_ATOL``); the reference's validation errors, message for
  message; the environment seed is the scenario's, not the spec's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import assert_records_match, reference_env_draws

import repro.api as R
import repro.sim as RS
from repro import keys
from repro.configs import smollm_135m as ref_smollm
from repro.core.energy import HardwareProfile as RefHardwareProfile
from repro.core.energy import JETSON_AGX_ORIN as REF_JETSON
from repro.fleet.campaign import mission_obs_events as ref_mission_obs_events
import repro_torch.api as T
import repro_torch.sim as TS
from repro_torch.configs import smollm_135m
from repro_torch.convert import from_reference, lm_from_reference
from repro_torch.core.energy import HardwareProfile, JETSON_AGX_ORIN
from repro_torch.fleet.campaign import (CampaignConfig, campaign_spec,
                                        mission_obs_events)
from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
from repro_torch.sim import streams
from repro_torch.sim.streams import EnvDraws

NUM_CLASSES = 4
N_TRAIN, N_TEST = 96, 24
MCU_FIELDS = dict(fp32_tflops=0.02, mem_bw_gbs=2.0, tensor_tflops=0.04,
                  cpu_passmark=400.0, power_w=2.0)


def _stoch(S):
    """The reference tests' ``STOCH`` scenario (``tests/test_sim.py``)."""
    return S.ScenarioSpec(
        channel=S.ChannelParams(kind="a2g"),
        availability=S.AvailabilityParams(kind="markov", p_drop=0.4,
                                          p_recover=0.6),
        num_uavs=2, serve_mode="relay", seed=1)


# ---------------------------------------------------------------------------
# the channel
# ---------------------------------------------------------------------------

CHANNELS = {
    "a2g": dict(kind="a2g"),
    "shadowing-only": dict(kind="a2g", fading="none"),
    "fading-only": dict(kind="a2g", shadowing_sigma_db=0.0),
    "5mhz": dict(kind="a2g", bandwidth_hz=5e6, path_loss_exp=2.5),
}
# serve distances of a mission over a farm of up to 250 acres (the slant
# distance to a relay, at least the 30 m altitude). Farther out, at an SNR
# near 0 dB, one unit in the last place of XLA's own float32 log moves the
# rate by up to 6e-6, which no other log reproduces.
DIST = np.asarray([0.5, 1.0, 10.0, 30.0, 60.0, 100.0, 159.4, 300.0, 600.0])


@pytest.mark.parametrize("kind", ["a2g", "constant"])
def test_deterministic_rate_matches_reference(kind):
    for kw in (dict(), dict(ref_loss_db=35.0, path_loss_exp=2.5,
                            bandwidth_hz=5e6)):
        got = TS.deterministic_rate_bps(TS.ChannelParams(kind=kind, **kw),
                                        DIST, 42e6)
        want = np.asarray(RS.deterministic_rate_bps(
            RS.ChannelParams(kind=kind, **kw), jnp.asarray(DIST), 42e6))
        assert got.dtype == np.float32 and got.shape == DIST.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if kind == "constant":
        assert np.array_equal(got, np.full(DIST.shape, 42e6, np.float32))


@pytest.mark.parametrize("case", list(CHANNELS))
def test_rates_from_the_references_draws_match_its_rates(case):
    """The reference's normals and exponentials through the port's rule."""
    t, r = TS.ChannelParams(**CHANNELS[case]), RS.ChannelParams(
        **CHANNELS[case])
    for seed in range(6):
        draws = reference_env_draws(seed, 3, rates_n=len(DIST))
        for rnd, d in enumerate(draws):
            key = keys.fold(keys.round_env_key(jax.random.PRNGKey(seed),
                                               rnd), keys.ENV_RATES)
            want = np.asarray(RS.sample_rates_bps(key, r, jnp.asarray(DIST),
                                                  1e8))
            got = TS.rates_from_draws(t, DIST, 1e8, d.normal, d.exponential)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            assert got.min() >= t.min_rate_bps


def test_channel_monotone_and_deterministic_corners_draw_nothing():
    p = TS.ChannelParams(kind="a2g", shadowing_sigma_db=0.0, fading="none")
    d = np.asarray([10.0, 30.0, 100.0, 300.0, 1000.0])
    rate = TS.deterministic_rate_bps(p, d, 1e8)
    assert np.all(np.diff(rate) < 0) and np.all(rate >= p.min_rate_bps)
    for params in (p, TS.ChannelParams(kind="constant")):
        g = torch.Generator().manual_seed(3)
        before = g.get_state()
        got = TS.sample_rates_bps(g, params, d, 1e8)
        assert torch.equal(g.get_state(), before)
        np.testing.assert_array_equal(
            got, TS.deterministic_rate_bps(params, d, 1e8))
    # a stochastic draw: reproducible from its generator, fresh otherwise
    s = TS.ChannelParams()
    a = TS.sample_rates_bps(torch.Generator().manual_seed(3), s, d, 1e8)
    b = TS.sample_rates_bps(torch.Generator().manual_seed(3), s, d, 1e8)
    c = TS.sample_rates_bps(torch.Generator().manual_seed(4), s, d, 1e8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


# ---------------------------------------------------------------------------
# availability
# ---------------------------------------------------------------------------

AVAILABILITY = {
    "bernoulli": dict(kind="bernoulli", p_drop=0.5),
    "bernoulli-guard": dict(kind="bernoulli", p_drop=0.97),
    "markov": dict(kind="markov", p_drop=0.3, p_recover=0.3),
    "markov-guard": dict(kind="markov", p_drop=0.9, p_recover=0.05),
    "full": dict(kind="full"),
}


@pytest.mark.parametrize("case", list(AVAILABILITY))
def test_availability_on_the_references_uniforms_is_its_mask(case):
    n, rounds = 6, 30
    t = TS.AvailabilityParams(**AVAILABILITY[case])
    r = RS.AvailabilityParams(**AVAILABILITY[case])
    draws = reference_env_draws(2, rounds, mask_n=n)
    up_t, up_r = TS.availability_init(n), RS.availability_init(n)
    guarded = 0
    for rnd, d in enumerate(draws):
        key = keys.fold(keys.round_env_key(jax.random.PRNGKey(2), rnd),
                        keys.ENV_MASK)
        m_r, up_r = RS.availability_step(key, up_r, r)
        m_t, up_t = TS.availability_step(d.mask, up_t, t)
        assert m_t.dtype == np.float32
        np.testing.assert_array_equal(m_t, np.asarray(m_r))
        np.testing.assert_array_equal(up_t, np.asarray(up_r))
        guarded += int(m_t.sum() == 1)
    if case.endswith("guard"):
        assert guarded > 0
    if case == "full":
        assert np.all(m_t == 1.0)


# ---------------------------------------------------------------------------
# the mission rollout and the stream registry
# ---------------------------------------------------------------------------

def _assert_timelines_equal(got, want):
    assert got.rounds == want.rounds and got.num_uavs == want.num_uavs
    for f in ("e_first_j", "e_per_round_j", "e_return_j",
              "round_duration_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12)
    for f in ("battery_j", "round_start_s", "serve_dist_m", "hover_start_s"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=0)
    for a, b in zip(got.routes, want.routes):
        assert a.uav == b.uav and a.client_ids == b.client_ids
        assert a.tour.order == b.tour.order and a.tour.rounds == b.tour.rounds
        assert dataclasses.asdict(a.tour) == pytest.approx(
            dataclasses.asdict(b.tour), rel=1e-12)
        np.testing.assert_allclose(a.hover_xy, b.hover_xy, rtol=1e-12)
        np.testing.assert_allclose(a.serve_dist_m, b.serve_dist_m,
                                   rtol=1e-12)
        assert a.round_duration_s == pytest.approx(b.round_duration_s,
                                                   rel=1e-12)


@pytest.mark.parametrize("mode", ["hover", "relay"])
@pytest.mark.parametrize("uavs", [1, 2, 3])
def test_rollout_mission_equals_the_references(mode, uavs):
    coords = np.random.RandomState(uavs).uniform(0, 500, size=(7, 2))
    kw = dict(hover_s_per_stop=25.0, comm_s_per_stop=12.0, num_uavs=uavs,
              serve_mode=mode)
    got = TS.rollout_mission(coords, np.zeros(2), **kw)
    want = RS.rollout_mission(coords, np.zeros(2), **kw)
    _assert_timelines_equal(got, want)
    assert got.uav_energy_j(0) == want.uav_energy_j(0)
    assert got.uav_energy_j(3) == want.uav_energy_j(3)


def test_stream_registry_refuses_collisions():
    assert [(s.name, s.value) for s in streams.registered_slots()
            if s.domain == "env"] == [
        (s.name, s.value) for s in (keys.ENV_MASK, keys.ENV_RATES,
                                    keys.ENV_COHORT)]
    assert streams.register("env", "mask", 1) is streams.ENV_MASK
    with pytest.raises(ValueError, match="already registered"):
        streams.register("env", "mask", 9)
    with pytest.raises(ValueError, match="already taken"):
        streams.register("env", "weather", 2)
    with pytest.raises(ValueError, match="not a registered"):
        streams.env_generator(0, streams.KeySlot("env", "weather", 4), 0)


def test_cohort_stream_layout_is_unchanged():
    """``cohort_generator(seed, r)`` is the ``ENV_COHORT`` stream, seeded
    from ``SeedSequence([seed, 3, r])`` as before the registry."""
    for seed, r in ((0, 0), (3, 1), (11, 7)):
        old = torch.Generator().manual_seed(int(np.random.SeedSequence(
            [seed, 3, r]).generate_state(1, np.uint64)[0]))
        a = TS.sample_cohort(TS.scenario.cohort_generator(seed, r), 1000, 8)
        b = TS.sample_cohort(old, 1000, 8)
        c = TS.sample_cohort(streams.env_generator(seed, streams.ENV_COHORT,
                                                   r), 1000, 8)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def test_degenerate_scenario_reproduces_campaign_records():
    """Constant channel, full availability, one hovering UAV, through the
    whole scenario path: the idealised campaign's records."""
    cfg = CampaignConfig(model="tinycnn", num_clients=4, global_rounds=2,
                         local_steps=2, batch_size=4,
                         num_classes=NUM_CLASSES, classes_per_client=2,
                         image_size=16)
    plan_ref = T.compile_experiment(campaign_spec(cfg), device="cpu")
    _, recs_ref = plan_ref.run()
    plan_sim = T.compile_experiment(campaign_spec(dataclasses.replace(
        cfg, scenario=TS.degenerate_scenario())), device="cpu")
    _, recs_sim = plan_sim.run()
    assert plan_sim.timeline is not None
    assert plan_sim.tour.order == plan_ref.tour.order
    assert len(recs_sim) == len(recs_ref) > 0
    for a, b in zip(recs_ref, recs_sim):
        da, db = a.to_dict(), b.to_dict()
        for field, va in da.items():
            if isinstance(va, float) and np.isfinite(va):
                assert db[field] == pytest.approx(va, rel=1e-12), field
            else:
                assert db[field] == va, field


def _data(num_classes=NUM_CLASSES):
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, size=(N_TRAIN, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, num_classes, size=(N_TRAIN,))
    return x, y, x[:N_TEST], y[:N_TEST]


def _cnn_spec(api, S, *, scenario, kind="sl", n=4, pop=None, adaptive=False,
              link=None, rounds=2):
    edges = (((JETSON_AGX_ORIN, HardwareProfile("mcu", **MCU_FIELDS))
              if api is T else (REF_JETSON,
                                RefHardwareProfile("mcu", **MCU_FIELDS)))
             if adaptive else None)
    clients = api.ClientSpec(num_clients=n, population=pop,
                             **({"edge_profiles": edges} if edges else {}))
    return api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn", num_classes=NUM_CLASSES),
        data=api.DataSpec(kind="arrays", image_size=16, classes_per_client=2),
        clients=clients,
        cut_policy=(api.CutPolicy(mode="adaptive") if adaptive
                    else api.CutPolicy(fraction=0.4)),
        link_policy=link(api) if link else api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind=kind, client_axis="vmap",
                              link_kernel="fused"),
        mission=api.MissionSpec(), scenario=scenario(S),
        global_rounds=rounds, local_steps=2, batch_size=4)


def _flops_pairs(ref_plan, port_plan):
    if port_plan.spec.engine.kind == "fl":
        return (ref_plan.flops["full"], 0.0), (port_plan.flops["full"], 0.0)
    if len(port_plan.flops) > 1:
        return ([ref_plan.flops[k][:2] for k in ref_plan.cut_of_client],
                [port_plan.flops[k][:2] for k in port_plan.cut_of_client])
    k = port_plan.cut_of_client[0]
    return ref_plan.flops[k][:2], port_plan.flops[k][:2]


def _feed_reference(ref_plan, port_plan, ref_recs):
    """The reference's environment draws (and cohorts) into the port."""
    scn = port_plan.spec.scenario
    port_plan.env_draws = reference_env_draws(
        scn.seed, len(ref_recs),
        mask_n=port_plan.avail_clients if scn.needs_mask else 0,
        rates_n=(port_plan.spec.clients.num_clients
                 if scn.channel is not None and scn.channel.is_stochastic
                 else 0))
    if port_plan.spec.clients.population is not None:
        port_plan.cohorts = [r.cohort_pids for r in ref_recs]


def _assert_plans_match(ref_plan, port_plan, ref_recs, port_recs, n_test,
                        active=None):
    ref_pair, port_pair = _flops_pairs(ref_plan, port_plan)
    hetero = len(port_plan.flops) > 1
    assert_records_match(
        ref_recs, port_recs, ref_flops_pair=ref_pair,
        port_flops_pair=port_pair, server_base_s=0.0, n_test=n_test,
        loss_atol=FLEET_EQUIV_ATOL, link_rel=1e-6,
        ref_consts=((ref_plan._t_client, [e.power_w for e in ref_plan.edges],
                     ref_plan._t_server) if hetero else None),
        active=active)
    assert ([r.active_clients for r in port_recs]
            == [r.active_clients for r in ref_recs])


def _run_cnn_pair(**kw):
    data = _data()
    ref_plan = R.compile_experiment(_cnn_spec(R, RS, **kw), data=data)
    port_plan = T.compile_experiment(_cnn_spec(T, TS, **kw), data=data,
                                     device="cpu")
    port_plan.params0 = from_reference(
        jax.tree_util.tree_map(np.asarray, ref_plan.params0), "tinycnn")
    _, ref_recs = ref_plan.run()
    _feed_reference(ref_plan, port_plan, ref_recs)
    _, port_recs = port_plan.run()
    return ref_plan, port_plan, ref_recs, port_recs


@pytest.mark.parametrize("kind", ["sl", "fl"])
def test_stochastic_plan_matches_reference_on_its_draws(kind):
    """``STOCH`` on tinycnn ``*/vmap``: two relaying UAVs, the ``a2g``
    channel and markov availability, 3 rounds."""
    ref_plan, port_plan, ref_recs, port_recs = _run_cnn_pair(
        scenario=_stoch, kind=kind, rounds=3)
    np.testing.assert_allclose(port_plan.serve_dist_m, ref_plan.serve_dist_m,
                               rtol=1e-12)
    np.testing.assert_allclose(port_plan.rate_nominal, ref_plan.rate_nominal,
                               rtol=1e-6)
    assert port_plan.rounds_budget == ref_plan.rounds_budget
    assert port_plan.tour is None and port_plan.timeline.num_uavs == 2
    _assert_timelines_equal(port_plan.timeline, ref_plan.timeline)
    assert len({r.active_clients for r in ref_recs}) > 1
    _assert_plans_match(ref_plan, port_plan, ref_recs, port_recs, N_TEST)
    if kind == "sl":        # the channel moves the bill, not the bytes
        assert len({r.link_time_s / r.link_bytes for r in port_recs}) > 1
    events = mission_obs_events(port_plan, port_recs)
    assert events == ref_mission_obs_events(ref_plan, ref_recs)
    assert {e["uav"] for e in events} == {0, 1}


def _markov_pop(S):
    return S.ScenarioSpec(availability=S.AvailabilityParams(
        kind="markov", p_drop=0.5, p_recover=0.3), seed=4)


def test_population_under_markov_availability_matches_reference():
    """A cohort of 3 out of 50 on the shared client tier: the trace runs
    over the population, sliced to the reference's cohorts."""
    ref_plan, port_plan, ref_recs, port_recs = _run_cnn_pair(
        scenario=_markov_pop, n=3, pop=50, rounds=3)
    assert port_plan._engine.client_tier == "shared"
    assert [d.mask.shape for d in port_plan.env_draws] == [(50,)] * 3
    assert ([r.cohort_pids for r in port_recs]
            == [r.cohort_pids for r in ref_recs])
    _assert_plans_match(ref_plan, port_plan, ref_recs, port_recs, N_TEST)


def _relay(S):
    return S.ScenarioSpec(channel=S.ChannelParams(kind="a2g",
                                                  bandwidth_hz=2e6),
                          num_uavs=2, serve_mode="relay", seed=3)


def test_adaptive_cuts_under_relay_match_reference():
    """Each client's cut for its own nominal rate at its relay distance
    (a 2 MHz channel, so the rates sit near the dwell deadline)."""
    ref_plan, port_plan, ref_recs, port_recs = _run_cnn_pair(
        scenario=_relay, adaptive=True,
        link=lambda api: api.LinkPolicy(compress="int8", rate_bps=1e6))
    assert port_plan.cut_of_client == ref_plan.cut_of_client
    assert len(set(port_plan.cut_of_client)) > 1
    _assert_plans_match(ref_plan, port_plan, ref_recs, port_recs, N_TEST)


def _lm_spec(api, S, arch):
    return api.ExperimentSpec(
        model=api.ModelSpec(family="transformer", arch=arch,
                            attn_impl="pallas"),
        data=api.DataSpec(kind="tokens", partition="iid", seq_len=16,
                          n_train=32, n_test=4),
        clients=api.ClientSpec(num_clients=3),
        cut_policy=api.CutPolicy(fraction=0.4),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(client_axis="vmap", link_kernel="fused"),
        mission=api.MissionSpec(),
        scenario=S.ScenarioSpec(channel=S.ChannelParams(kind="a2g"),
                                serve_mode="relay", seed=2),
        global_rounds=2, local_steps=2, batch_size=4)


def test_lm_plan_with_a2g_channel_matches_reference():
    ref_plan = R.compile_experiment(_lm_spec(R, RS, ref_smollm.reduced()))
    data = (ref_plan.x_train, ref_plan.y_train, ref_plan.x_test,
            ref_plan.y_test)
    cfg = smollm_135m.reduced()
    port_plan = T.compile_experiment(_lm_spec(T, TS, cfg), data=data,
                                     device="cpu")
    port_plan.params0 = lm_from_reference(
        *jax.tree_util.tree_map(np.asarray, ref_plan.params0), cfg)
    _, ref_recs = ref_plan.run()
    _feed_reference(ref_plan, port_plan, ref_recs)
    _, port_recs = port_plan.run()
    assert np.std(port_plan.rate_nominal) > 0
    _assert_plans_match(ref_plan, port_plan, ref_recs, port_recs, 4 * 16)


# the reference's refusals (tests/test_sim.py::test_scenario_validation_errors)
REFUSALS = {
    "a2g-without-mission": dict(mission=False, scenario=lambda S: (
        S.ScenarioSpec(channel=S.ChannelParams(kind="a2g")))),
    "uavs-without-mission": dict(mission=False, scenario=lambda S: (
        S.ScenarioSpec(num_uavs=2))),
    "relay-without-mission": dict(mission=False, scenario=lambda S: (
        S.ScenarioSpec(serve_mode="relay"))),
    "availability-on-scan": dict(axis="scan", scenario=lambda S: (
        S.ScenarioSpec(availability=S.AvailabilityParams(
            kind="bernoulli", p_drop=0.5)))),
    "two-straggler-processes": dict(dropout=0.5, scenario=lambda S: (
        S.ScenarioSpec(availability=S.AvailabilityParams(
            kind="bernoulli", p_drop=0.5)))),
    "more-uavs-than-clients": dict(scenario=lambda S: (
        S.ScenarioSpec(num_uavs=9))),
    "no-uav": dict(scenario=lambda S: S.ScenarioSpec(num_uavs=0)),
    "serve-mode": dict(scenario=lambda S: S.ScenarioSpec(serve_mode="orbit")),
    "channel-kind": dict(scenario=lambda S: S.ScenarioSpec(
        channel=S.ChannelParams(kind="fso"))),
    "fading": dict(scenario=lambda S: S.ScenarioSpec(
        channel=S.ChannelParams(fading="rician"))),
    "availability-kind": dict(scenario=lambda S: S.ScenarioSpec(
        availability=S.AvailabilityParams(kind="weather"))),
    "probability": dict(scenario=lambda S: S.ScenarioSpec(
        availability=S.AvailabilityParams(kind="markov", p_drop=1.5))),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_scenario_refusals_are_the_references(case):
    kw = REFUSALS[case]
    messages = []
    for api, S, extra in ((R, RS, {}), (T, TS, {"device": "cpu"})):
        spec = api.ExperimentSpec(
            model=api.ModelSpec(name="tinycnn", num_classes=NUM_CLASSES),
            data=api.DataSpec(kind="arrays", image_size=16),
            clients=api.ClientSpec(num_clients=4,
                                   dropout_rate=kw.get("dropout", 0.0)),
            engine=api.EngineSpec(kind="sl",
                                  client_axis=kw.get("axis", "vmap")),
            mission=api.MissionSpec() if kw.get("mission", True) else None,
            scenario=kw["scenario"](S), global_rounds=1, batch_size=4)
        with pytest.raises(ValueError) as err:
            api.compile_experiment(spec, data=_data(), **extra)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_scenario_runs_on_every_engine():
    """``sl/scan`` and ``fl/scan`` take a scenario without availability;
    ``sl/shard_map`` (here on the single-rank mesh) takes it too, with the
    records of ``sl/vmap`` on the same draws."""
    scn = TS.ScenarioSpec(channel=TS.ChannelParams(kind="a2g"), num_uavs=2,
                          seed=5)
    for kind in ("sl", "fl"):
        spec = dataclasses.replace(
            _cnn_spec(T, TS, scenario=lambda S: scn, kind=kind),
            engine=T.EngineSpec(kind=kind, client_axis="scan"))
        plan = T.compile_experiment(spec, data=_data(), device="cpu")
        _, recs = plan.run(with_eval=False)
        assert [r.active_clients for r in recs] == [4, 4]
        assert recs[0].uav_energy_j == plan.timeline.e_first_j
        assert all(np.isfinite(r.loss) for r in recs)
    runs = {}
    for axis in ("shard_map", "vmap"):
        plan = T.compile_experiment(dataclasses.replace(
            _cnn_spec(T, TS, scenario=lambda S: scn),
            engine=T.EngineSpec(kind="sl", client_axis=axis,
                                link_kernel="fused")),
            data=_data(), device="cpu")
        runs[axis] = plan.run(with_eval=False)[1]
    assert plan.mesh is None
    for a, b in zip(runs["shard_map"], runs["vmap"]):
        assert a.engine == "sl/shard_map"
        assert dataclasses.replace(a, engine=b.engine) == dataclasses.replace(
            b, accuracy=a.accuracy)
        assert a.uav_energy_j == b.uav_energy_j and a.active_clients == 4


def test_environment_seed_is_the_scenarios():
    """Cohorts fold from the scenario's seed (0 without one), as in the
    reference: specs that differ only in ``spec.seed`` draw the same
    cohort stream, and a scenario seed moves it."""
    def cohorts(seed, scenario=None):
        spec = dataclasses.replace(
            _cnn_spec(T, TS, scenario=lambda S: scenario, kind="fl", n=3,
                      pop=1000), seed=seed)
        plan = T.compile_experiment(spec, data=_data(), device="cpu")
        state = plan.init()
        out = []
        for r in range(3):
            state.round = r
            out.append(tuple(plan._round_cohort(state)))
        return out

    base = cohorts(0)
    assert cohorts(1) == cohorts(7) == base
    assert cohorts(1, TS.ScenarioSpec(seed=0)) == base
    assert cohorts(0, TS.ScenarioSpec(seed=3)) != base


BAD_DRAWS = {
    "missing-mask": [EnvDraws(normal=np.zeros(4), exponential=np.ones(4))],
    "short-mask": [EnvDraws(mask=np.zeros(3), normal=np.zeros(4),
                            exponential=np.ones(4))],
    "missing-exponential": [EnvDraws(mask=np.zeros(4), normal=np.zeros(4))],
    "past-the-end": [],
}


@pytest.mark.parametrize("case", list(BAD_DRAWS))
def test_bad_env_draws_entry_raises(case):
    plan = T.compile_experiment(_cnn_spec(T, TS, scenario=_stoch, rounds=1),
                                data=_data(), device="cpu")
    plan.env_draws = BAD_DRAWS[case]
    with pytest.raises(ValueError, match="Plan.env_draws"):
        plan.run()
