"""The port's copies of the reference's framework-neutral modules agree with it.

Energy, link and UAV models, partitioners, the deployment and tour planners,
the host half of the runtime (its metrics in class counts against the
reference's per-class loop), the record type, the spec layer, the
scenario layer's mission rollout and spec dataclasses, the paper's
FL/SL configurations (``core.paper_train``), the ten architecture
configs, ``data.pipeline.BatchIterator`` (the same batches for a seed) and
the analysis passes' ``Finding``/``Report`` (the same code):
the same inputs give equal outputs (exactly; these
are the same arithmetic).
"""
import dataclasses

import numpy as np
import pytest

import repro.api as R
import repro.api.records as ref_records
import repro.api.runtime as ref_runtime
import repro.core.deployment as ref_deployment
import repro.core.energy as ref_energy
import repro.core.link as ref_link
import repro.core.paper_train as ref_paper_train
import repro.core.trajectory as ref_trajectory
import repro.core.uav_energy as ref_uav
import repro.data.partition as ref_partition
import repro.sim as ref_sim
import repro.sim.mission as ref_mission
import repro_torch.api as T
import repro_torch.api.records as records
import repro_torch.api.runtime as runtime
import repro_torch.core.deployment as deployment
import repro_torch.core.energy as energy
import repro_torch.core.link as link
import repro_torch.core.paper_train as paper_train
import repro_torch.core.trajectory as trajectory
import repro_torch.core.uav_energy as uav
import repro_torch.data.partition as partition
import repro_torch.sim as sim
import repro_torch.sim.mission as mission

PROFILES = ("RTX_A5000", "JETSON_AGX_ORIN", "TPU_V5E")


def test_energy_profiles_and_scaling():
    for a in PROFILES:
        assert (dataclasses.asdict(getattr(energy, a))
                == dataclasses.asdict(getattr(ref_energy, a)))
        for b in PROFILES:
            args = (0.37, getattr(energy, a), getattr(energy, b))
            ref_args = (0.37, getattr(ref_energy, a), getattr(ref_energy, b))
            assert energy.scale_time(*args) == ref_energy.scale_time(*ref_args)
    assert (energy.roofline_time(3e9, 2e8, energy.RTX_A5000)
            == ref_energy.roofline_time(3e9, 2e8, ref_energy.RTX_A5000))
    assert energy.CO2_G_PER_J == ref_energy.CO2_G_PER_J


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_link_config_bytes_time_energy(compress):
    cfg = link.LinkConfig(rate_bps=50e6, compress=compress, radio_power_w=3.0)
    ref = ref_link.LinkConfig(rate_bps=50e6, compress=compress,
                              radio_power_w=3.0)
    for nbytes, item, block in [(4096.0, 4, 8), (1.6e6, 4, 32),
                                (3e5, 2, 256)]:
        for fn in ("wire_bytes", "roundtrip_bytes", "transfer_time_s",
                   "transfer_energy_j"):
            assert (getattr(cfg, fn)(nbytes, item, scale_block=block)
                    == getattr(ref, fn)(nbytes, item, scale_block=block))
    assert link.smashed_bytes(8, 4, 4, 32) == ref_link.smashed_bytes(8, 4, 4,
                                                                     32)


def test_uav_energy_model():
    p, r = uav.DEFAULT_UAV, ref_uav.DEFAULT_UAV
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    for v in (0.0, 5.0, 10.0, 17.5):
        assert p.xi_m(v) == r.xi_m(v)
    assert p.xi_h == r.xi_h and p.reception_range(60.0) == \
        r.reception_range(60.0)
    assert (uav.tour_energy(1234.5, 6, params=p)
            == ref_uav.tour_energy(1234.5, 6, params=r))


def test_partitions():
    labels = np.random.RandomState(1).randint(0, 12, size=200)
    for got, want in [
            (partition.partition_non_iid(labels, 4, 3, num_classes=12,
                                         seed=2),
             ref_partition.partition_non_iid(labels, 4, 3, num_classes=12,
                                             seed=2)),
            (partition.partition_dirichlet(labels, 5, alpha=0.3, seed=3,
                                           min_size=4),
             ref_partition.partition_dirichlet(labels, 5, alpha=0.3, seed=3,
                                               min_size=4)),
            (partition.partition_iid(200, 6, seed=4),
             ref_partition.partition_iid(200, 6, seed=4))]:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (partition.population_partition_count(10 ** 6, 500)
            == ref_partition.population_partition_count(10 ** 6, 500))


def test_cohort_down_weight():
    import repro.sim.scenario as ref_scenario
    import repro_torch.sim.scenario as scenario
    assert scenario.COHORT_DOWN_WEIGHT == ref_scenario.COHORT_DOWN_WEIGHT


def test_tour_planning_on_six_points():
    pts = np.random.RandomState(5).uniform(0, 600, size=(6, 2))
    base = np.zeros(2)
    for fn in ("plan_tour", "greedy_tour_plan"):
        got = getattr(trajectory, fn)(pts, base, hover_s_per_stop=20.0)
        want = getattr(ref_trajectory, fn)(pts, base, hover_s_per_stop=20.0)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert trajectory.held_karp(pts) == ref_trajectory.held_karp(pts)
    assert (trajectory.budget_rounds(1.9e6, 1e5, 3e4, 2e3)
            == ref_trajectory.budget_rounds(1.9e6, 1e5, 3e4, 2e3))


def test_deployment():
    coords = deployment.random_sensors(10.0, 30, seed=6)
    np.testing.assert_array_equal(coords,
                                  ref_deployment.random_sensors(10.0, 30,
                                                                seed=6))
    got = deployment.deploy_edge_devices(coords, 60.0)
    want = ref_deployment.deploy_edge_devices(coords, 60.0)
    np.testing.assert_array_equal(got.edge_indices, want.edge_indices)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert deployment.field_side_meters(250.0) == \
        ref_deployment.field_side_meters(250.0)


def test_runtime_host_half():
    x = np.arange(40 * 2, dtype=np.float32).reshape(40, 2)
    y = np.arange(40) % 5
    parts = [np.arange(0, 13), np.arange(13, 40)]
    bx, by = runtime.round_batches(x, y, parts, 4, 3,
                                   np.random.RandomState(9))
    rbx, rby = ref_runtime.round_batches(x, y, parts, 4, 3,
                                         np.random.RandomState(9))
    np.testing.assert_array_equal(bx, np.asarray(rbx))
    np.testing.assert_array_equal(by, np.asarray(rby))
    np.testing.assert_array_equal(runtime.client_coords(100.0, 7, seed=1),
                                  ref_runtime.client_coords(100.0, 7, seed=1))
    for f in (1e6, 3.3e9):
        assert runtime.client_step_time_s(f) == \
            ref_runtime.client_step_time_s(f)
        assert (runtime.roofline_s(f, energy.JETSON_AGX_ORIN)
                == ref_runtime.roofline_s(f, ref_energy.JETSON_AGX_ORIN))
    assert (runtime.mission_max_link_s(30.0, 10.0, 3)
            == ref_runtime.mission_max_link_s(30.0, 10.0, 3))
    logits = np.random.RandomState(2).standard_normal((50, 6))
    labels = np.random.RandomState(3).randint(0, 6, size=50)
    assert (runtime.metrics_from_predictions(logits.argmax(-1), labels, 6)
            == ref_runtime.classification_metrics(logits, labels, 6))


def test_round_record():
    fields = [f.name for f in dataclasses.fields(records.RoundRecord)]
    assert fields == [f.name for f in
                      dataclasses.fields(ref_records.RoundRecord)]
    kw = dict(round=1, loss=np.float32(0.5), accuracy=0.25, link_bytes=8.0,
              link_time_s=1e-3, link_energy_j=2e-3, client_energy_j=1.0,
              server_energy_j=2.0, uav_energy_j=3.0, cohort_pids=(1, 2))
    assert (records.RoundRecord(**kw).to_dict()
            == ref_records.RoundRecord(**kw).to_dict())


def _specs(api):
    return [api.ExperimentSpec(),
            api.ExperimentSpec(engine=api.EngineSpec(kind="fl")),
            api.ExperimentSpec(link_policy=api.LinkPolicy(compress="int8"),
                               mission=api.MissionSpec()),
            api.ExperimentSpec(cut_policy=api.CutPolicy(mode="adaptive"),
                               engine=api.EngineSpec(client_axis="vmap"),
                               clients=api.ClientSpec(num_clients=4,
                                                      population=100))]


def _plain(v):
    """A default value with dataclasses (the two packages' distinct
    classes) turned into dicts."""
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


def test_spec_fields_defaults_and_describe():
    for got, want in zip(_specs(T), _specs(R)):
        assert got.describe() == want.describe()
    for cls in ("ModelSpec", "DataSpec", "ClientSpec", "CutPolicy",
                "LinkPolicy", "EngineSpec", "MissionSpec", "ExperimentSpec"):
        got = [(f.name, f.default) for f in
               dataclasses.fields(getattr(T, cls))]
        want = [(f.name, f.default) for f in
                dataclasses.fields(getattr(R, cls))]
        assert [g[0] for g in got] == [w[0] for w in want], cls
        for (name, g), (_, w) in zip(got, want):
            assert _plain(g) == _plain(w), name


@pytest.mark.parametrize("kind", ["fl", "sl"])
def test_paper_spec_field_for_field(kind):
    assert ([(f.name, f.default) for f in
             dataclasses.fields(paper_train.PaperTrainConfig)]
            == [(f.name, f.default) for f in
                dataclasses.fields(ref_paper_train.PaperTrainConfig)])
    for kw in ({}, dict(model="tinycnn", num_clients=3, classes_per_client=2,
                        num_classes=6, client_fraction=0.4, global_rounds=2,
                        local_steps=1, batch_size=4, lr=3e-3, image_size=16,
                        compress_link=True, seed=5)):
        got = paper_train.paper_spec(paper_train.PaperTrainConfig(**kw), kind)
        want = ref_paper_train.paper_spec(
            ref_paper_train.PaperTrainConfig(**kw), kind)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.describe() == want.describe()


def test_arch_configs_field_for_field():
    import repro.configs as ref_configs
    import repro_torch.configs as configs
    import torch
    assert list(configs.ARCHS) == list(ref_configs.ARCHS)
    for name, cfg in configs.ARCHS.items():
        ref = ref_configs.ARCHS[name]
        assert ([f.name for f in dataclasses.fields(cfg)]
                == [f.name for f in dataclasses.fields(ref)])
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
        assert (dataclasses.asdict(cfg.reduced())
                == dataclasses.asdict(ref.reduced())), name
        assert cfg.hd == ref.hd
        assert (cfg.param_dtype == torch.bfloat16) == \
            (ref.param_dtype.__name__ == "bfloat16")
        for i in range(cfg.n_layers):
            assert cfg.is_moe_layer(i) == ref.is_moe_layer(i)
            assert cfg.is_attn_layer(i) == ref.is_attn_layer(i)
        assert configs.get_config(name) is cfg
    assert ({k: dataclasses.asdict(v) for k, v in configs.INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in ref_configs.INPUT_SHAPES.items()})
    assert (dataclasses.asdict(configs.SplitConfig())
            == dataclasses.asdict(ref_configs.SplitConfig()))


@pytest.mark.parametrize("num_classes,n", [(6, 50), (64, 1000), (2048, 3000)])
def test_vectorised_metrics_equal_the_reference_loop(num_classes, n):
    """``metrics_from_predictions`` (class counts by ``bincount``) gives the
    reference's per-class loop's numbers exactly, rare and absent classes
    included."""
    rng = np.random.RandomState(num_classes)
    labels = np.minimum(rng.zipf(1.3, size=n) - 1, num_classes - 1)
    pred = np.where(rng.uniform(size=n) < 0.4, labels,
                    rng.randint(0, num_classes, size=n))
    logits = np.zeros((n, num_classes), np.float32)
    logits[np.arange(n), pred] = 1.0
    want = ref_runtime.classification_metrics(logits, labels, num_classes)
    assert runtime.metrics_from_predictions(pred, labels, num_classes) == want
    assert runtime.metrics_from_predictions(
        logits.argmax(-1), labels, num_classes) == want


def test_mission_rollout_helpers():
    """``sim/mission.py``'s partition, relay tour and leg lengths on the
    reference's inputs."""
    pts = np.random.RandomState(8).uniform(0, 600, size=(9, 2))
    for u in (1, 2, 3, 4):
        got = mission._partition_by_tour(pts, u, 16)
        want = ref_mission._partition_by_tour(pts, u, 16)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    with pytest.raises(ValueError, match="UAVs for"):
        mission._partition_by_tour(pts, 10, 16)
    got = mission._relay_tour(pts.mean(0), np.zeros(2), 9, uav.DEFAULT_UAV,
                              30.0, 10.0)
    want = ref_mission._relay_tour(pts.mean(0), np.zeros(2), 9,
                                   ref_uav.DEFAULT_UAV, 30.0, 10.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    np.testing.assert_array_equal(mission._leg_lengths(pts, [3, 1, 0, 2]),
                                  ref_mission._leg_lengths(pts, [3, 1, 0, 2]))
    got = mission.rollout_mission(pts, np.zeros(2), num_uavs=2,
                                  serve_mode="relay")
    want = ref_mission.rollout_mission(pts, np.zeros(2), num_uavs=2,
                                       serve_mode="relay")
    np.testing.assert_array_equal(got.serve_dist_m, want.serve_dist_m)
    np.testing.assert_array_equal(got.battery_j, want.battery_j)
    assert got.rounds == want.rounds
    with pytest.raises(ValueError, match="serve_mode"):
        mission.rollout_mission(pts, np.zeros(2), serve_mode="orbit")


def test_scenario_dataclasses_field_for_field():
    for cls in ("ChannelParams", "AvailabilityParams", "ScenarioSpec"):
        got = [(f.name, f.default) for f in
               dataclasses.fields(getattr(sim, cls))]
        want = [(f.name, f.default) for f in
                dataclasses.fields(getattr(ref_sim, cls))]
        assert got == want, cls
    assert (dataclasses.asdict(sim.degenerate_scenario())
            == dataclasses.asdict(ref_sim.degenerate_scenario()))
    for av in ("full", "bernoulli", "markov"):
        assert (sim.ScenarioSpec(availability=sim.AvailabilityParams(av))
                .needs_mask == ref_sim.ScenarioSpec(
                    availability=ref_sim.AvailabilityParams(av)).needs_mask)
    for kw in (dict(), dict(fading="none", shadowing_sigma_db=0.0),
               dict(kind="constant")):
        assert (sim.ChannelParams(**kw).is_stochastic
                == ref_sim.ChannelParams(**kw).is_stochastic)
    assert sim.COHORT_DOWN_WEIGHT == ref_sim.COHORT_DOWN_WEIGHT


# the telemetry layer's framework-neutral pieces: the port keeps copies of
# the reference's code (``repro_torch.obs.sink``, the numpy half and the
# configuration of ``repro_torch.obs.metrics``, ``host_rss_bytes``)

SINK_NAMES = ("json_default", "new_run_id", "NullSink", "JsonlSink")
METRICS_NAMES = ("MetricsConfig", "NonfiniteError", "engine_tap_names",
                 "split_step_tap_names", "_time_major",
                 "first_nonfinite_coord", "summarize_round_metrics")


@pytest.mark.parametrize("module,names", [
    ("sink", SINK_NAMES), ("metrics", METRICS_NAMES),
    ("gauges", ("host_rss_bytes",))])
def test_obs_copies_are_the_references_code(module, names):
    import importlib
    import inspect
    port = importlib.import_module(f"repro_torch.obs.{module}")
    ref = importlib.import_module(f"repro.obs.{module}")
    for name in names:
        assert (inspect.getsource(getattr(port, name))
                == inspect.getsource(getattr(ref, name))), name
    if module == "metrics":
        assert port.TAPS == ref.TAPS


def test_obs_metrics_summaries_equal_the_references():
    import repro.obs.metrics as ref_m
    import repro_torch.obs.metrics as m
    rng = np.random.RandomState(4)
    taps = {"grad_norm_client": rng.uniform(size=(3, 4)),
            "update_norm_server": rng.uniform(size=3),
            "nonfinite": (rng.uniform(size=(3, 4)) > 0.8).astype(np.float32)}
    losses = rng.uniform(size=(3, 4))
    for kind in ("sl", "fl"):
        for taps_sel in (m.TAPS, ("mask",), ("loss_spread", "grad_norms")):
            got = m.summarize_round_metrics(
                m.MetricsConfig(taps=taps_sel), taps, losses=losses,
                kind=kind, n=4, active=3)
            want = ref_m.summarize_round_metrics(
                ref_m.MetricsConfig(taps=taps_sel), taps, losses=losses,
                kind=kind, n=4, active=3)
            assert got == want


def test_batch_iterator_is_the_references():
    from repro.data.pipeline import BatchIterator as RefBatchIterator
    from repro_torch.data.pipeline import BatchIterator
    rng = np.random.RandomState(0)
    arrays = (rng.standard_normal((23, 3)).astype(np.float32),
              np.arange(23))
    for drop_last in (True, False):
        ref = RefBatchIterator(arrays, 5, seed=4, drop_last=drop_last)
        port = BatchIterator(arrays, 5, seed=4, drop_last=drop_last)
        assert port.steps_per_epoch() == ref.steps_per_epoch()
        for _ in range(2):                           # two epochs
            want, got = list(ref), list(port)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)


def test_analyze_findings_are_the_references_code():
    import inspect
    import repro.analyze.findings as ref_findings
    import repro_torch.analyze.findings as findings
    for name in ("Finding", "Report"):
        assert (inspect.getsource(getattr(findings, name))
                == inspect.getsource(getattr(ref_findings, name))), name
    f = findings.Finding("raw-timer", "a.py:3", "m")
    ref = ref_findings.Finding("raw-timer", "a.py:3", "m")
    assert (f.to_dict(), str(f)) == (ref.to_dict(), str(ref))
    report = findings.Report(findings=[f], checked=["a.py"])
    assert report.to_dict() == ref_findings.Report(
        findings=[ref], checked=["a.py"]).to_dict()
    assert not report.ok
