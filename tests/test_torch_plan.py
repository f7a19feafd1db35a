"""Record-stream parity: one spec through both packages' ``compile_experiment``.

tinycnn at 16x16, 3 clients, 2 rounds x 2 local steps, batch 4 (the shape
of ``test_engine.py::test_paper_spec_energy_ratio_and_records``), the same
arrays (``DataSpec(kind="arrays")``) and the same initial params (the
reference plan's ``params0`` through ``convert.from_reference``). The
records agree as ``assert_records_match`` states: loss within 1e-3 (at the
int8 cut an element of a rare row may round to the neighbouring code, the
two frameworks' smashed tensors differing by ~1e-6), link bytes exactly,
and the energy/time fields by the billing arithmetic, because the port
bills from its own FLOP count (see ``test_torch_flops.py``).
"""
import jax
import numpy as np
import pytest

from test_torch_harness import assert_records_match, plan_flops_pair

import repro.api as R
import repro_torch.api as T
from repro_torch import configs
from repro_torch.api.plan import FL_SERVER_AGG_S
from repro_torch.convert import from_reference
from repro_torch.sim import AvailabilityParams, ScenarioSpec

N_TRAIN, N_TEST = 96, 24


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, size=(N_TRAIN, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, 12, size=(N_TRAIN,))
    return x, y, x[:N_TEST], y[:N_TEST]


def _spec(api, kind, compress="none", link_kernel="xla", mission=False):
    return api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(kind="arrays", image_size=16),
        clients=api.ClientSpec(num_clients=3),
        cut_policy=api.CutPolicy(fraction=0.4),
        link_policy=api.LinkPolicy(compress=compress),
        engine=api.EngineSpec(kind=kind, link_kernel=link_kernel),
        mission=api.MissionSpec() if mission else None,
        global_rounds=2, local_steps=2, batch_size=4)


def _run_both(kind, **kw):
    data = _data()
    ref_plan = R.compile_experiment(_spec(R, kind, **kw), data=data)
    port_plan = T.compile_experiment(_spec(T, kind, **kw), data=data,
                                     device="cpu")
    port_plan.params0 = from_reference(
        jax.tree_util.tree_map(np.asarray, ref_plan.params0), "tinycnn")
    _, ref_recs = ref_plan.run()
    _, port_recs = port_plan.run()
    return ref_plan, port_plan, ref_recs, port_recs


CASES = {
    "sl-fp32": dict(kind="sl"),
    "sl-int8-fused": dict(kind="sl", compress="int8", link_kernel="fused"),
    "sl-int8-xla-mission": dict(kind="sl", compress="int8", mission=True),
    "fl": dict(kind="fl"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_record_streams_match_reference(case):
    kw = CASES[case]
    ref_plan, port_plan, ref_recs, port_recs = _run_both(**kw)
    assert port_plan.num_rounds == ref_plan.num_rounds == 2
    assert port_plan.rounds_budget == ref_plan.rounds_budget
    assert port_plan.cut_of_client == ref_plan.cut_of_client
    assert_records_match(
        ref_recs, port_recs, ref_flops_pair=plan_flops_pair(ref_plan),
        port_flops_pair=plan_flops_pair(port_plan),
        server_base_s=FL_SERVER_AGG_S if kw["kind"] == "fl" else 0.0,
        n_test=N_TEST)
    if kw.get("mission"):
        assert port_recs[0].uav_energy_j == ref_plan.tour.e_first
        assert port_recs[1].uav_energy_j == ref_plan.tour.e_per_round
    if kw.get("compress") == "int8":
        assert port_recs[0].link_bytes > 0


def test_headline_direction_sl_client_energy_below_fl():
    data = _data()
    sl = T.compile_experiment(_spec(T, "sl", "int8", "fused"), data=data,
                              device="cpu")
    fl = T.compile_experiment(_spec(T, "fl"), data=data, device="cpu")
    _, rec_sl = sl.run()
    _, rec_fl = fl.run()
    k = sl.cut_of_client[0]
    assert sl.flops[k][0] < fl.flops["full"]
    assert (sum(r.client_energy_j for r in rec_sl)
            < sum(r.client_energy_j for r in rec_fl))
    assert sum(r.link_bytes for r in rec_fl) == 0
    assert all(np.isfinite(r.loss) for r in rec_sl + rec_fl)


def test_synthetic_data_plan_runs_and_evaluates():
    spec = T.ExperimentSpec(model=T.ModelSpec(name="tinycnn"),
                            data=T.DataSpec(image_size=16, n_train=48,
                                            n_test=12),
                            global_rounds=1, batch_size=2)
    plan = T.compile_experiment(spec, device="cpu")
    assert plan.x_train.shape == (48, 16, 16, 3)
    state, recs = plan.run()
    assert len(recs) == 1 and np.isfinite(recs[0].loss)
    assert set(plan.evaluate(state)) == {"accuracy", "precision", "recall",
                                         "f1", "mcc"}


def test_default_device_is_cuda_and_refuses_without_it():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.compile_experiment(_spec(T, "sl"), data=_data())


def _lm(arch, **kw):
    """Spec fields of a split LM on ``arch`` (a port ArchConfig)."""
    return dict(model=T.ModelSpec(family="transformer", arch=arch),
                data=T.DataSpec(kind="tokens", partition="iid", seq_len=8),
                **kw)


_RUNS = dict(data=T.DataSpec(kind="arrays", image_size=16),
             clients=T.ClientSpec(num_clients=4), global_rounds=1,
             local_steps=1, batch_size=4)
OUT_OF_SLICE = {
    # the vmap fleet engines run adaptive cuts with a server_mesh (the
    # reference's buckets over a server sub-mesh): it runs (None)
    "vmap": (dict(engine=T.EngineSpec(client_axis="vmap", server_mesh=(1, 1)),
                  cut_policy=T.CutPolicy(mode="adaptive"), **_RUNS), None),
    # adaptive cuts on the shard_map engines (HeteroFleet on shard_map):
    # it runs, on the single-rank mesh here (None)
    "shard_map": (dict(engine=T.EngineSpec(client_axis="shard_map"),
                       cut_policy=T.CutPolicy(mode="adaptive"), **_RUNS),
                  None),
    # server_mesh on sl/scan: the reference's own refusal
    "server_mesh": (dict(engine=T.EngineSpec(server_mesh=(1, 1))),
                    (ValueError, "server_mesh shards the SL server suffix; "
                                 "it needs a fleet SL engine")),
    # dropout runs on the fleet engines; on sl/scan it is the reference's
    # own refusal
    "dropout": (dict(clients=T.ClientSpec(dropout_rate=0.5)),
                (ValueError, "client dropout is a fleet policy")),
    # a sampled population runs on the fleet and FL engines; on sl/scan it
    # is the reference's own refusal
    "population": (dict(clients=T.ClientSpec(num_clients=4, population=8)),
                   (ValueError, "population sampling with sl/scan")),
    # adaptive cuts run on sl/vmap; on sl/scan it is the reference's own
    # refusal
    "adaptive": (dict(cut_policy=T.CutPolicy(mode="adaptive")),
                 (ValueError, "need the bucketed fleet engine")),
    # a scenario runs on every engine; its availability trace on sl/scan is
    # the reference's own refusal
    "scenario": (dict(scenario=ScenarioSpec(availability=AvailabilityParams(
        kind="bernoulli", p_drop=0.5))),
        (ValueError, "availability traces mask clients per round")),
    # the transformer family runs now, but only on a stack it is given
    "transformer": (dict(model=T.ModelSpec(family="transformer")),
                    (ValueError, "needs arch=")),
    # the split LM runs on sl/scan, sl/vmap and sl/shard_map; a
    # server_mesh on it is the reference's own refusal
    "lm-vmap": (_lm(configs.smollm_135m.reduced(),
                    engine=T.EngineSpec(client_axis="vmap",
                                        server_mesh=(1, 1))),
                (ValueError, "server_mesh tier specs are wired for the CNN "
                             "stage path only")),
    # population cohorts run on sl/vmap; with adaptive cuts they are the
    # reference's own refusal
    "vmap-population": (dict(engine=T.EngineSpec(client_axis="vmap"),
                             clients=T.ClientSpec(num_clients=4,
                                                  population=8),
                             cut_policy=T.CutPolicy(mode="adaptive")),
                        (ValueError, "population sampling supports "
                                     "fraction cuts only")),
    # ... and takes the port's ScenarioSpec, nothing else
    "vmap-scenario": (dict(engine=T.EngineSpec(client_axis="vmap"),
                           scenario=object()),
                      (TypeError, "takes a repro_torch.sim.ScenarioSpec")),
    # MoE stacks: the reference's own refusal
    "lm-moe": (_lm(configs.deepseek_moe_16b.reduced()),
               (ValueError, "MoE stacks")),
    # a recurrent stack: the reference's plan fails on it (zero heads)
    "lm-rwkv": (_lm(configs.rwkv6_7b.reduced()),
                (ValueError, "not a plan the reference runs")),
}


@pytest.mark.parametrize("field", list(OUT_OF_SLICE))
def test_fields_outside_the_slice_are_refused(field):
    """Each field is refused with its message, or (an expectation of None:
    a field the port has since taken in) compiles and runs a round."""
    fields, want = OUT_OF_SLICE[field]
    spec = T.ExperimentSpec(**{"data": T.DataSpec(kind="arrays"), **fields})
    if want is None:
        plan = T.compile_experiment(spec, data=_data(), device="cpu")
        _, rec = plan.run_round(plan.init())
        assert np.isfinite(rec.loss)
        return
    exc, match = want
    with pytest.raises(exc, match=match):
        T.compile_experiment(spec, data=_data(), device="cpu")
