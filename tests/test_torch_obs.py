"""``repro_torch.obs``, the port's run telemetry, held against ``repro.obs``.

Counterparts of ``tests/test_obs.py`` on the CPU at tiny sizes: span
paths, depths, fences and notes (the same events as the reference's
timeline for the same nesting, timings aside); the fenced timers and the
shared null span; the sink's buffering, manifest appends and
``json_default`` (torch tensors too); ``tensor_bytes`` against the
reference's ``pytree_bytes`` and host RSS; the kernel-build counter, with a
stand-in for ``nvcc``; ``NULL_OBS``, ``Obs.ensure`` and the manifest's
facts; the profiler's window and its Chrome trace; a mission plan's run
directory, its phase coverage through ``tools/obs_report.py`` and its
mission span decomposition; the Monte-Carlo sweep's telemetry; and the
``obs_report`` command line on a port run directory. The reference's
wall-clock overhead pin (``test_obs_overhead_under_2pct``) is not a CPU
test here: the overhead is measured on the card by ``chip_smoke.py``.
"""
import json
import os
import stat
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))

import repro.obs as ref_obs  # noqa: E402
import repro.obs.sink as ref_sink  # noqa: E402
import repro.obs.timeline as ref_timeline  # noqa: E402
import repro_torch.api as T  # noqa: E402
from repro_torch.api.records import RoundRecord  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.obs import (NULL_OBS, Obs, ObsConfig, fenced,  # noqa: E402
                             host_rss_bytes, tensor_bytes, time_fenced)
from repro_torch.obs.gauges import RecompileCounter, global_counter  # noqa
from repro_torch.obs.profiler import ProfilerCapture  # noqa: E402
from repro_torch.obs.sink import JsonlSink, NullSink, json_default  # noqa
from repro_torch.obs.timeline import NULL_SPAN, Timeline, _block  # noqa
from repro_torch.optim.optimizers import FunctionalAdamW  # noqa: E402

NUM_CLASSES = 4

BASE = T.ExperimentSpec(
    model=T.ModelSpec(name="tinycnn", num_classes=NUM_CLASSES),
    data=T.DataSpec(kind="synthetic", image_size=16, classes_per_client=2),
    clients=T.ClientSpec(num_clients=4),
    cut_policy=T.CutPolicy(mode="fraction", fraction=0.4),
    engine=T.EngineSpec(kind="sl", client_axis="vmap"),
    global_rounds=2, local_steps=2, batch_size=4)


def _compile(spec=BASE, **kw):
    return T.compile_experiment(spec, device="cpu", **kw)


class ListSink:
    run_dir = None

    def __init__(self):
        self.events = []
        self.manifest = {}

    def emit(self, event):
        self.events.append(event)

    def write_manifest(self, fields):
        self.manifest.update(fields)

    def flush(self):
        pass

    def close(self):
        pass


def _load_events(run_dir):
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in ("t", "dur_s", "sync_s")}
            for e in events]


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def test_round_record_to_dict_json_round_trip():
    rec = RoundRecord(
        round=np.int64(3), loss=np.float32(0.5),
        accuracy=np.float64("nan"), link_bytes=np.float32(1e6),
        link_time_s=0.1, link_energy_j=np.float64(2.0),
        client_energy_j=np.float32(3.0), server_energy_j=4.0,
        uav_energy_j=5.0, active_clients=np.int32(4), engine="sl/vmap",
        cohort_pids=tuple(np.asarray([7, 9], np.int64)),
        metrics={"grad_norm_client/mean": 1.5, "health/nonfinite": 0})
    back = json.loads(json.dumps(rec.to_dict()))
    assert back["round"] == 3 and isinstance(back["round"], int)
    assert back["cohort_pids"] == [7, 9]
    assert abs(back["loss"] - 0.5) < 1e-6
    assert back["accuracy"] != back["accuracy"]
    assert back["metrics"] == {"grad_norm_client/mean": 1.5,
                               "health/nonfinite": 0}


# ---------------------------------------------------------------------------
# timeline
# ---------------------------------------------------------------------------

def _nest(tl):
    with tl.span("run", rounds=2):
        with tl.span("round", round=0):
            with tl.span("round/execute"):
                pass
        with tl.span("round", round=1):
            with tl.span("round"):
                pass
    with tl.span("mc/setup", seeds=2):
        pass


def test_span_nesting_paths_and_depth():
    sink, ref = ListSink(), ListSink()
    _nest(Timeline(sink))
    _nest(ref_timeline.Timeline(ref))
    evs = sink.events
    assert _untimed(evs) == _untimed(ref.events)
    assert [e["path"] for e in evs] == [
        "run/round/execute", "run/round", "run/round/round", "run/round",
        "run", "mc/setup"]
    assert [e["depth"] for e in evs] == [2, 1, 2, 1, 0, 0]
    assert evs[0]["name"] == "round/execute" and evs[4]["rounds"] == 2
    # children are contained in the parent's wall clock
    assert evs[1]["dur_s"] >= evs[0]["dur_s"]
    assert evs[4]["dur_s"] >= evs[1]["dur_s"] + evs[3]["dur_s"] - 1e-6


def test_span_fence_books_sync_and_note():
    sink = ListSink()
    tl = Timeline(sink)
    with tl.span("execute") as sp:
        y = torch.ones(64, 64) @ torch.ones(64, 64)
        out = sp.fence({"y": y, "state": (y, [y])})
        sp.note(flavor="matmul")
    ev = sink.events[0]
    assert out["y"] is y
    assert 0.0 <= ev["sync_s"] <= ev["dur_s"]
    assert ev["flavor"] == "matmul"
    with tl.span("host") as sp:
        assert sp.fence({"a": 1}) == {"a": 1}


def test_block_syncs_each_cuda_device_once(monkeypatch):
    """The fence walks tensors, dicts, tuples, lists and dataclasses and
    synchronizes each CUDA device it finds once; CPU tensors and host
    values need none."""
    import types

    import repro_torch.obs.timeline as timeline

    class FakeCuda:
        is_cuda = True

        def __init__(self, index):
            self.device = torch.device("cuda", index)

    calls = []
    monkeypatch.setattr(timeline, "torch", types.SimpleNamespace(
        Tensor=(torch.Tensor, FakeCuda),
        cuda=types.SimpleNamespace(synchronize=calls.append)))
    st = FunctionalAdamW().init({"w": torch.zeros(3)})
    st.mu["w"] = FakeCuda(1)
    value = {"a": [FakeCuda(0), (FakeCuda(0), 3.0)], "opt": st,
             "host": np.zeros(2), "cpu": torch.zeros(2)}
    assert _block(value) is value
    assert sorted(str(d) for d in calls) == ["cuda:0", "cuda:1"]
    calls.clear()
    _block({"cpu": torch.zeros(2), "n": np.ones(3)})
    assert calls == []


def test_fenced_helpers():
    out, wall = fenced(lambda: torch.arange(8).sum())
    assert int(out) == 28 and wall > 0
    calls = []
    wall = time_fenced(lambda: calls.append(1) or torch.ones(4), repeats=5)
    assert len(calls) == 5 and wall > 0


def test_disabled_timeline_hands_out_shared_null_span():
    tl = Timeline(ListSink(), enabled=False)
    sp = tl.span("anything", round=3)
    assert sp is NULL_SPAN and tl.span("other") is NULL_SPAN
    with sp as s:
        assert s.fence(5) == 5
        s.note(ignored=True)


# ---------------------------------------------------------------------------
# sink
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", ["port", "reference"])
def test_jsonl_sink_buffers_and_manifest_appends(tmp_path, mod):
    cls = JsonlSink if mod == "port" else ref_sink.JsonlSink
    run_dir = str(tmp_path / "run")
    sink = cls(run_dir, buffer=3)
    ev_path = os.path.join(run_dir, "events.jsonl")
    sink.emit({"ev": "note", "i": 0})
    sink.emit({"ev": "note", "i": 1})
    assert not os.path.exists(ev_path)          # buffered, not yet on disk
    sink.emit({"ev": "note", "i": 2})           # buffer full -> flushed
    assert len(open(ev_path).readlines()) == 3
    sink.emit({"ev": "note", "i": 3, "x": np.float32(1.5),
               "t": torch.tensor(2.5), "v": torch.arange(3)})
    sink.close()
    lines = [json.loads(line) for line in open(ev_path)]
    assert [e["i"] for e in lines] == [0, 1, 2, 3]
    assert lines[-1]["x"] == 1.5 and lines[-1]["t"] == 2.5
    assert lines[-1]["v"] == [0, 1, 2]
    sink.write_manifest({"a": 1, "plan": {"model": "m1"}})
    sink.write_manifest({"b": 2, "plan": {"model": "m2"},
                         "sweep": {"num_seeds": 4}})
    man = json.load(open(os.path.join(run_dir, "manifest.json")))
    assert man["a"] == 1 and man["b"] == 2
    assert [p["model"] for p in man["plans"]] == ["m1", "m2"]
    assert man["sweeps"] == [{"num_seeds": 4}]
    assert NullSink().run_dir is None


def test_json_default_coercions():
    for v in (np.float32(2.5), np.arange(3), torch.tensor(2.5),
              torch.tensor([1.0, 2.0]), torch.tensor(7, dtype=torch.int64)):
        assert json_default(v) == ref_sink.json_default(
            v.numpy() if torch.is_tensor(v) else v)
    assert json_default(object()).startswith("<object")


# ---------------------------------------------------------------------------
# gauges
# ---------------------------------------------------------------------------

def test_tensor_bytes_and_rss():
    tree = {"a": torch.zeros((4, 4), dtype=torch.float32),
            "b": (np.zeros(10, np.int64), "not-an-array", 3.0),
            "h": [torch.zeros(3, dtype=torch.bfloat16)]}
    want = ref_obs.pytree_bytes({"a": jnp.zeros((4, 4), jnp.float32),
                                 "b": (np.zeros(10, np.int64),
                                       "not-an-array", 3.0),
                                 "h": [jnp.zeros(3, jnp.bfloat16)]})
    assert tensor_bytes(tree) == want == 4 * 4 * 4 + 10 * 8 + 3 * 2
    assert tensor_bytes(None) == 0
    opt = FunctionalAdamW()
    params = {"w": torch.zeros(5, 2)}
    st = opt.init_stacked(params, 3)
    assert tensor_bytes((params, st)) == 40 + 3 * 4 + 2 * 3 * 40
    assert host_rss_bytes() > 0


def test_tensor_bytes_of_the_sequential_engines_state():
    """Modules count their parameters and buffers, optimizers their
    state: the sl/scan engine state's bytes after a round."""
    plan = _compile(T.ExperimentSpec(
        model=T.ModelSpec(name="tinycnn", num_classes=NUM_CLASSES),
        data=T.DataSpec(image_size=8, n_train=16, n_test=8),
        clients=T.ClientSpec(num_clients=2), global_rounds=1,
        local_steps=1, batch_size=2))
    st, _ = plan.run(with_eval=False)
    es = st.engine_state
    params = sum(p.numel() * 4 for m in es.clients + [es.server]
                 for p in m.parameters())
    # AdamW keeps two f32 moments a parameter
    assert tensor_bytes(es) >= 3 * params
    assert tensor_bytes(es.clients[0]) == sum(
        t.numel() * t.element_size()
        for t in es.clients[0].state_dict().values())


def _fake_nvcc(tmp_path):
    """A stand-in compiler: writes the ``-o`` file and exits 0."""
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then shift; : > \"$1\"; fi\n"
                    "  shift\ndone\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_counter_counts_each_library_build(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: _fake_nvcc(tmp_path))
    counter = global_counter()
    assert counter.available
    c0, s0 = counter.snapshot()
    logs = build.build_all(("quant_int8", "flash_attn"))
    c1, s1 = counter.snapshot()
    assert sorted(logs) == ["flash_attn", "quant_int8"]
    assert c1 - c0 == 2 and s1 >= s0
    build.build_all(("quant_int8",))         # built already: no nvcc run
    assert counter.snapshot()[0] == c1


def test_build_counter_install_uninstall(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: _fake_nvcc(tmp_path))
    c = RecompileCounter()
    c.install()
    assert c.available and c.install() is c
    build.build_all(("rwkv6_scan",))
    assert c.snapshot()[0] == 1 and c.duration_s > 0
    c.uninstall()
    assert not c.available
    (tmp_path / "_build").joinpath(
        build.library_path("rwkv6_scan").name).unlink()
    build.build_all(("rwkv6_scan",))
    assert c.snapshot()[0] == 1


# ---------------------------------------------------------------------------
# Obs facade
# ---------------------------------------------------------------------------

def test_null_obs_is_shared_and_writes_nothing(tmp_path):
    assert Obs.ensure(None) is NULL_OBS
    assert not NULL_OBS and NULL_OBS.run_dir is None
    assert isinstance(NULL_OBS.sink, NullSink)
    assert NULL_OBS.span("x") is NULL_SPAN
    NULL_OBS.event("note", x=1)
    NULL_OBS.gauge(0, engine_state={"w": torch.zeros(4)})
    NULL_OBS.record(RoundRecord(0, 0., 0., 0., 0., 0., 0., 0., 0.))
    NULL_OBS.manifest(a=1)
    NULL_OBS.set_device(torch.device("cpu"))
    NULL_OBS.round_started(0)
    NULL_OBS.round_finished(0)
    NULL_OBS.flush()
    assert NULL_OBS.compiles_total() == 0
    assert list(tmp_path.iterdir()) == []
    off = Obs.ensure(ObsConfig(enabled=False))
    assert not off and off.span("x") is NULL_SPAN and off.run_dir is None
    assert Obs.disabled().run_dir is None


def test_obs_ensure_normalization(tmp_path):
    cfg = ObsConfig(run_root=str(tmp_path), run_id="r1", gauge_every=2)
    obs = Obs.ensure(cfg)
    assert obs and obs.run_dir == str(tmp_path / "r1")
    assert Obs.ensure(obs) is obs
    obs.gauge(0, tally=1)
    obs.gauge(1, tally=1)      # throttled: gauge_every=2 skips odd rounds
    obs.gauge(2, tally=1, engine_state={"w": torch.zeros(8)})
    obs.close()
    gauges = [e for e in _load_events(obs.run_dir) if e["ev"] == "gauge"]
    assert [g["round"] for g in gauges] == [0, 2]
    assert all(g["rss_bytes"] > 0 and g["compiles"] == 0 for g in gauges)
    assert gauges[1]["state_bytes"] == 32
    man = json.load(open(os.path.join(obs.run_dir, "manifest.json")))
    assert man["run_id"] == "r1" and man["torch_version"] == torch.__version__
    assert man["cuda_version"] == torch.version.cuda
    assert man["device_count"] == torch.cuda.device_count()
    assert man["recompile_counter"] == "available"
    assert "jax_version" not in man


def test_obs_config_fields_are_the_references():
    import dataclasses
    got = [(f.name, f.default) for f in dataclasses.fields(ObsConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(
        ref_obs.ObsConfig)]
    assert got == want


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------

def test_profiler_capture_window(tmp_path):
    cap = ProfilerCapture((1, 2), str(tmp_path / "prof"))
    assert cap.status == "armed"
    cap.round_started(0)
    assert cap.status == "armed"               # before the window: idle
    cap.round_started(1)                       # window opens
    assert cap.active and cap.status == "tracing rounds 1..2"
    torch.ones(8, 8) @ torch.ones(8, 8)
    cap.round_finished(1)
    assert cap.active
    cap.round_started(2)
    cap.round_finished(2)                      # window closes
    cap.close()
    assert cap.status == f"captured -> {tmp_path / 'prof'}"
    trace = json.load(open(cap.trace_path))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_profiler_failure_is_a_status(tmp_path):
    path = tmp_path / "file"
    path.write_text("")
    cap = ProfilerCapture((0, 0), str(path / "prof"))   # under a file
    cap.round_started(0)
    assert cap.status.startswith("unavailable: ") and not cap.active


def test_profiler_validates_window():
    with pytest.raises(ValueError, match="start <= stop"):
        ProfilerCapture((3, 1), "x")
    off = ProfilerCapture(None, "x")
    off.round_started(0)
    off.close()
    assert off.status == "off"


# ---------------------------------------------------------------------------
# plan integration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mission_run(tmp_path_factory):
    """One obs-enabled mission campaign, shared across assertions."""
    root = str(tmp_path_factory.mktemp("runs"))
    spec = T.ExperimentSpec(
        model=BASE.model, data=BASE.data, clients=BASE.clients,
        cut_policy=BASE.cut_policy, engine=BASE.engine,
        mission=T.MissionSpec(farm_acres=100.0),
        global_rounds=3, local_steps=2, batch_size=4)
    plan = _compile(spec, obs=ObsConfig(run_root=root, run_id="trun"))
    state, records = plan.run()
    plan.obs.close()
    return plan, records, plan.obs.run_dir


def test_plan_run_writes_run_dir(mission_run):
    plan, records, run_dir = mission_run
    assert sorted(os.listdir(run_dir)) == ["events.jsonl", "manifest.json"]
    man = json.load(open(os.path.join(run_dir, "manifest.json")))
    assert man["backend"] == "cpu" and "device_name" not in man
    assert len(man["plans"]) == 1
    p = man["plans"][0]
    assert p["engine"] == "sl/vmap" and p["num_clients"] == 4
    assert p["device"] == "cpu" and p["rounds"] == 3
    evs = _load_events(run_dir)
    assert {"span", "gauge", "record", "mission_span"} <= {e["ev"]
                                                           for e in evs}
    recs = [e for e in evs if e["ev"] == "record"]
    assert [r["round"] for r in recs] == [0, 1, 2]
    assert abs(recs[-1]["loss"] - records[-1].loss) < 1e-9
    gauges = [e for e in evs if e["ev"] == "gauge"]
    assert len(gauges) == 3
    assert all(g["state_bytes"] == tensor_bytes(plan.init().engine_state)
               and g["rss_bytes"] > 0 and g["compiles"] == 0
               for g in gauges)
    assert all(g["cohort"] == 0 and g["dropped"] == 0 for g in gauges)
    names = {e["path"] for e in evs if e["ev"] == "span"}
    assert {"compile", "compile/data", "compile/mission", "compile/params",
            "compile/cuts", "compile/flops", "compile/lower", "run",
            "run/init", "run/round", "run/round/sample",
            "run/round/execute", "run/round/account",
            "run/round/eval"} <= names
    # no metrics bus: no metrics events, records carry an empty dict
    assert not any(e["ev"] == "metrics" for e in evs)
    assert all(r.metrics == {} for r in records)


def test_phase_breakdown_covers_95pct(mission_run):
    import obs_report
    _, _, run_dir = mission_run
    manifest, events = obs_report.load_run(run_dir)
    spans = [e for e in events if e["ev"] == "span"]
    for root in (e for e in spans if e["depth"] == 0):
        prefix = root["path"] + "/"
        child_s = sum(e["dur_s"] for e in spans
                      if e["depth"] == 1 and e["path"].startswith(prefix))
        assert child_s >= 0.95 * root["dur_s"], root["path"]
    cov, root = obs_report.root_coverage(events)
    assert root is not None and cov >= 0.95
    text = "\n".join(obs_report.render(run_dir, manifest, events))
    assert "coverage" in text and "round/execute" in text
    assert "mission dwell" in text


def test_mission_span_decomposition(mission_run):
    plan, records, run_dir = mission_run
    evs = [e for e in _load_events(run_dir) if e["ev"] == "mission_span"]
    assert {e["name"] for e in evs} == \
        {"mission/travel", "mission/hover", "mission/comm"}
    assert all(e["clock"] == "mission" for e in evs)
    per_round = {e["name"]: e for e in evs if e["round"] == 0}
    travel, hover, comm = (per_round[f"mission/{k}"]
                           for k in ("travel", "hover", "comm"))
    n = plan.spec.clients.num_clients
    mission = plan.spec.mission
    assert travel["dur_s"] == pytest.approx(
        plan.tour.tour_length / mission.uav.V, abs=1e-2)
    assert hover["dur_s"] == pytest.approx(n * mission.hover_s_per_stop)
    assert comm["dur_s"] == pytest.approx(n * mission.comm_s_per_stop)
    assert hover["t_mission_s"] == pytest.approx(
        travel["t_mission_s"] + travel["dur_s"], abs=1e-2)
    assert len(evs) == 3 * len(records)


def test_profile_rounds_capture_via_plan(tmp_path):
    plan = _compile(obs=ObsConfig(run_root=str(tmp_path), run_id="prof",
                                  profile_rounds=(0, 0)))
    plan.run(rounds=2, with_eval=False)
    plan.obs.close()
    run_dir = plan.obs.run_dir
    man = json.load(open(os.path.join(run_dir, "manifest.json")))
    assert man["profiler"] == f"captured -> {os.path.join(run_dir, 'profile')}"
    trace = json.load(open(os.path.join(run_dir, "profile", "trace.json")))
    assert trace["traceEvents"]
    assert not plan.obs.profiler.cuda
    # the profiler's start and stop (the trace's export) are phases of the
    # run, so its direct children still account for its wall time
    import obs_report
    _, events = obs_report.load_run(run_dir)
    spans = {e["path"]: e for e in events if e["ev"] == "span"}
    assert {"run/profiler/start", "run/profiler/stop"} <= set(spans)
    assert spans["run/profiler/stop"]["depth"] == 1
    run = spans["run"]
    child_s = sum(e["dur_s"] for e in events if e["ev"] == "span"
                  and e["depth"] == 1 and e["path"].startswith("run/"))
    assert child_s >= 0.95 * run["dur_s"]


def test_obs_off_and_disabled_share_the_null_path(tmp_path):
    """``obs=None`` and ``ObsConfig(enabled=False)`` write nothing and give
    the same records as each other and as an enabled run."""
    p_none = _compile()
    p_off = _compile(obs=ObsConfig(enabled=False))
    p_on = _compile(obs=ObsConfig(run_root=str(tmp_path / "on")))
    assert p_none.obs is NULL_OBS and not p_off.obs and p_on.obs
    recs = [p.run()[1] for p in (p_none, p_off, p_on)]
    assert [r.to_dict() for r in recs[0]] == [r.to_dict() for r in recs[1]] \
        == [r.to_dict() for r in recs[2]]
    assert sorted(os.listdir(tmp_path)) == ["on"]


# ---------------------------------------------------------------------------
# monte-carlo sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["vmap", "loop"])
def test_monte_carlo_emits_sweep_telemetry(tmp_path, mode):
    from repro_torch.sim import run_monte_carlo
    plan = _compile(obs=ObsConfig(run_root=str(tmp_path), run_id="mc"))
    mc = run_monte_carlo(plan, 2, rounds=2, mode=mode)   # inherits plan.obs
    plan.obs.close()
    evs = _load_events(plan.obs.run_dir)
    paths = {e["path"] for e in evs if e["ev"] == "span"}
    assert {"mc/setup", "mc/compile", "mc/execute",
            "mc/summarize"} <= paths
    note = [e for e in evs if e["ev"] == "note"
            and e.get("kind") == "monte_carlo"][0]
    assert note["num_seeds"] == 2 and note["mode"] == mode
    assert note["wall_s"] == pytest.approx(mc.wall_s, abs=1e-5)
    execute = [e for e in evs if e.get("path") == "mc/execute"][0]
    assert execute["dur_s"] >= mc.wall_s - 1e-5
    man = json.load(open(os.path.join(plan.obs.run_dir, "manifest.json")))
    sweep = man["sweeps"][0]
    assert sweep["seeds"] == [0, 1] and sweep["rounds"] == 2
    assert sweep["mode"] == mode and sweep["engine"] == "sl/vmap"


def test_monte_carlo_obs_argument_overrides_the_plans(tmp_path):
    from repro_torch.sim import run_monte_carlo
    plan = _compile()
    run_monte_carlo(plan, 2, rounds=1,
                    obs=ObsConfig(run_root=str(tmp_path), run_id="own"))
    assert os.listdir(tmp_path) == ["own"]
    assert plan.obs is NULL_OBS


def test_monte_carlo_without_obs_writes_nothing(tmp_path):
    from repro_torch.sim import run_monte_carlo
    plan = _compile()
    mc = run_monte_carlo(plan, 2, rounds=2)
    assert mc.rounds == 2 and plan.obs is NULL_OBS
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# the report tool on a port run
# ---------------------------------------------------------------------------

def test_obs_report_cli_on_a_port_run(tmp_path):
    from repro_torch.obs import MetricsConfig
    plan = _compile(obs=ObsConfig(run_root=str(tmp_path), run_id="cli",
                                  metrics=MetricsConfig()))
    plan.run(with_eval=False)
    plan.obs.close()
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "obs_report.py"),
         plan.obs.run_dir, "--coverage-min", "0.95", "--health-gate"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "coverage ok" in out.stdout and "health ok" in out.stdout
    assert "round/execute" in out.stdout
    # the runs root resolves to its latest run
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "obs_report.py"),
         str(tmp_path)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "run cli" in out.stdout
