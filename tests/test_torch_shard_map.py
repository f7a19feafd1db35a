"""The explicit-collective fleet engines (``client_axis="shard_map"``,
``fleet/engine.py``) over ``torch.distributed`` gloo ranks on the CPU.

The reference's contract (``repro/fleet/engine.py:50-54``) is shard_map ==
vmap within ``FLEET_EQUIV_ATOL``. Its own shard_map engines do not build on
jax 0.9 (``tests/test_fleet.py``), so the port's shard_map engines are
held against the port's ``vmap`` engine and the reference's ``vmap``
engine, on the same numpy inputs and the reference's parameters:

- engines (tinycnn at 16 px, 2 local steps, batch 4, int8 on the fused
  path): ``sl`` on the stacked and shared client tiers, ``fl``, with no
  mask, a mask, a rank with no active client and an all-masked fleet,
  over 2 ranks (4 clients) and 4 ranks (8 clients): losses, both tiers'
  params and optimizer states within ``FLEET_EQUIV_ATOL`` (step counters
  exactly), and one int8 launch a local step a rank, for that rank's
  clients;
- plans through ``compile_experiment`` (its own mesh over the default
  group): ``sl`` and ``fl`` with dropout, the shared cohort tier
  (population > clients, the reference's cohorts), a Bernoulli
  availability scenario (the reference's draws), the default taps on
  ``fl``, the cohort tier and the scenario, a reduced SmolLM split LM,
  and a Monte-Carlo sweep on the seed axis: wire bytes, bills, masks,
  cohort ids and the taps' health and mask entries exactly, losses,
  accuracy, float taps and state within the tolerance;
- the single-rank mesh in this process (no process group): bit for bit
  the ``vmap`` engine;
- the refusals, with the reference's messages.

The ranks are spawned by ``launch.mesh.run_ranks`` from a ``FileStore``
in a temporary directory (no TCP port); the cases run in three spawns (2,
4 and 2 ranks; ``torch_rank_cases``) plus one of a failing rank. This
process initialises no process group.
"""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

import torch_rank_cases as RC
from test_torch_fedavg_pmean import check_pmean_case, pmean_inputs
from test_torch_fleet import _tier
from test_torch_harness import (assert_records_match, reference_env_draws,
                                reference_params)

import repro.api as R
import repro.sim as RS
from repro.configs import smollm_135m as ref_smollm
from repro.core.link import LinkConfig as RefLinkConfig
from repro.core.split import SplitStep as RefSplitStep
from repro.core.split import apply_stages as ref_apply_stages
from repro.fleet.engine import make_fleet_fl_round as ref_fleet_fl_round
from repro.fleet.engine import make_fleet_sl_round as ref_fleet_sl_round
from repro.fleet.link import FleetLink as RefFleetLink
from repro.models.cnn import cross_entropy_loss as ref_cross_entropy
from repro.optim import adamw as ref_adamw
from repro.optim import init_stacked as ref_init_stacked
from repro.api.runtime import stack_replicas as ref_stack_replicas
import repro_torch.api as T
from repro_torch.api.plan import FL_SERVER_AGG_S
from repro_torch.configs import smollm_135m
from repro_torch.convert import from_reference, lm_from_reference
from repro_torch.data.pipeline import shard_batch
from repro_torch.fleet.engine import (FLEET_EQUIV_ATOL, make_fleet_sl_round,
                                      validate_fleet_mesh)
from repro_torch.launch.mesh import (FleetMesh, all_gather_rows,
                                     fleet_data_size, make_fleet_mesh,
                                     run_ranks, single_device_fleet_mesh)
from repro_torch.optim import FunctionalAdamW

S, B, K = 2, 4, RC.K        # local steps, batch, the tinycnn cut
LR = RC.LR
N_TRAIN, N_TEST = 96, 24
CPU = torch.device("cpu")


def _masks(n: int) -> dict:
    """No mask, a mask, the first half masked (rank 0 holds no active
    client), every client masked."""
    return {"none": None,
            "mask": (np.arange(n) % 3 != 1).astype(np.float32),
            "idle-rank": (np.arange(n) >= n // 2).astype(np.float32),
            "all-masked": np.zeros(n, np.float32)}


def _engine_cases(n: int, full: bool) -> dict:
    masks = _masks(n)
    names = list(masks) if full else ["mask"]
    cases = {}
    for tier in ("stacked", "shared"):
        for m in names:
            cases[f"sl-{tier}-{m}"] = dict(kind="sl", tier=tier,
                                           reduce="mean", kernel="fused",
                                           mask=masks[m])
    for m in names:
        cases[f"fl-{m}"] = dict(kind="fl", mask=masks[m])
    if full:
        cases["sl-stacked-sum-mask"] = dict(kind="sl", tier="stacked",
                                            reduce="sum", kernel="fused",
                                            mask=masks["mask"])
        cases["sl-stacked-xla-none"] = dict(kind="sl", tier="stacked",
                                            reduce="mean", kernel="xla",
                                            mask=None)
    return cases


@functools.lru_cache(maxsize=None)
def _engine_inputs(n: int) -> dict:
    stages, params = reference_params("tinycnn")
    rng = np.random.RandomState(n)
    bx = rng.uniform(0, 1, (n, S, B, 16, 16, 3)).astype(np.float32)
    by = rng.randint(0, 12, (n, S, B))
    return {"ref_stages": stages, "ref_params": params, "bx": bx, "by": by,
            "params": {k: v.numpy() for k, v in _tier(params, False).items()},
            "params_c": {k: v.numpy()
                         for k, v in _tier(params[:K], False).items()},
            "params_s": {k: v.numpy() for k, v in
                         _tier(params[K:], False).items()}}


def _rank_engine_inputs(n: int) -> dict:
    inp = _engine_inputs(n)
    return {k: inp[k] for k in ("bx", "by", "params", "params_c",
                                "params_s")}


# ---------------------------------------------------------------------------
# plan cases
# ---------------------------------------------------------------------------

PLAN_CASES = {
    "sl-dropout": dict(kind="sl", n=4, dropout=0.5),
    "fl-dropout": dict(kind="fl", n=4, dropout=0.5, taps=True),
    "sl-cohort": dict(kind="sl", n=4, population=100, taps=True),
    "sl-scenario-taps": dict(kind="sl", n=4, p_drop=0.5, env_seed=3,
                             taps=True, mc=2),
    "lm": dict(kind="sl", n=4, lm=True, dropout=0.5, mission=False),
}
PLAN_CASES_4 = {"sl-dropout-8": dict(kind="sl", n=8, dropout=0.5)}


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, size=(N_TRAIN, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, 4, size=(N_TRAIN,))
    return x, y, x[:N_TEST], y[:N_TEST]


def _ref_spec(case: dict):
    """The reference's ``sl|fl/vmap`` spec of a plan case (the fields of
    ``torch_rank_cases.plan_spec``)."""
    scenario = None
    if case.get("p_drop"):
        scenario = RS.ScenarioSpec(availability=RS.AvailabilityParams(
            kind="bernoulli", p_drop=case["p_drop"]),
            seed=case.get("env_seed", 0))
    common = dict(
        clients=R.ClientSpec(num_clients=case["n"],
                             dropout_rate=case.get("dropout", 0.0),
                             population=case.get("population")),
        link_policy=R.LinkPolicy(compress="int8"),
        engine=R.EngineSpec(kind=case["kind"], client_axis="vmap",
                            link_kernel="fused"),
        global_rounds=case.get("rounds", 2), local_steps=S, batch_size=B,
        scenario=scenario)
    if case.get("lm"):
        return R.ExperimentSpec(
            model=R.ModelSpec(family="transformer",
                              arch=ref_smollm.reduced(), attn_impl="pallas"),
            data=R.DataSpec(kind="tokens", partition="iid", seq_len=16,
                            n_train=32, n_test=4),
            cut_policy=R.CutPolicy(fraction=0.4), **common)
    return R.ExperimentSpec(
        model=R.ModelSpec(name="tinycnn", num_classes=4),
        data=R.DataSpec(kind="arrays", image_size=16, classes_per_client=2),
        cut_policy=R.CutPolicy(fraction=0.4),
        mission=R.MissionSpec() if case.get("mission", True) else None,
        **common)


@functools.lru_cache(maxsize=None)
def _reference_plan(name: str):
    """The reference's vmap plan of a case, run, and what the port's plans
    take from it: data, params0, cohorts, environment draws."""
    case = {**PLAN_CASES, **PLAN_CASES_4}[name]
    ref_plan = R.compile_experiment(
        _ref_spec(case), data=None if case.get("lm") else _data())
    _, recs = ref_plan.run()
    params = jax.tree_util.tree_map(np.asarray, ref_plan.params0)
    if case.get("lm"):
        params0 = lm_from_reference(*params, smollm_135m.reduced())
    else:
        params0 = from_reference(params, "tinycnn")
    env_draws = None
    if case.get("p_drop"):
        env_draws = reference_env_draws(case.get("env_seed", 0), len(recs),
                                        mask_n=case["n"])
    inputs = {"data": (ref_plan.x_train, ref_plan.y_train, ref_plan.x_test,
                       ref_plan.y_test),
              "params0": params0,
              "cohorts": ([r.cohort_pids for r in recs]
                          if case.get("population") else None),
              "env_draws": env_draws}
    return ref_plan, recs, inputs


# ---------------------------------------------------------------------------
# the spawns: all cases of a world size in one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    plans = {k: _reference_plan(k)[2] for k in PLAN_CASES}
    return run_ranks(RC.world_two, 2, str(tmp_path_factory.mktemp("two")),
                     args=((_engine_cases(4, True), _rank_engine_inputs(4)),
                           (PLAN_CASES, plans)))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    plans = {k: _reference_plan(k)[2] for k in PLAN_CASES_4}
    return run_ranks(RC.world_four, 4, str(tmp_path_factory.mktemp("four")),
                     args=(pmean_inputs(8, seed=4),
                           (_engine_cases(8, False), _rank_engine_inputs(8)),
                           (PLAN_CASES_4, plans), _data()))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_sl_round(n, tier, reduce, kernel, masked):
    stages = _engine_inputs(n)["ref_stages"]
    cs, ss = stages[:K], stages[K:]
    link = RefFleetLink(config=RefLinkConfig(compress="int8"),
                        use_pallas=kernel == "fused", interpret=True)
    step = RefSplitStep(
        client_fwd=lambda pc, x: ref_apply_stages(cs, pc, x),
        server_loss=lambda ps, sm, y: (
            ref_cross_entropy(ref_apply_stages(ss, ps, sm), y), {}),
        link_constraint=link.boundary())
    opt_c, opt_s = ref_adamw(LR), ref_adamw(LR)
    return opt_c, opt_s, jax.jit(ref_fleet_sl_round(
        step, opt_c, opt_s, local_rounds=S, server_reduce=reduce,
        client_dropout=masked, client_tier=tier))


def _reference_engine(n: int, case: dict):
    """The reference's vmap engine on the case: SL ``(params_c, params_s,
    oc, os_, losses)``, FL ``(params, losses)``, in the port's layout."""
    import jax.numpy as jnp
    inp = _engine_inputs(n)
    params, m = inp["ref_params"], case["mask"]
    extra = () if m is None else (jnp.asarray(m),)
    if case["kind"] == "fl":
        stages = inp["ref_stages"]

        def grad_fn(p, batch):
            xx, yy = batch
            return jax.value_and_grad(lambda q: ref_cross_entropy(
                ref_apply_stages(stages, q, xx), yy))(p)

        fn = jax.jit(ref_fleet_fl_round(grad_fn, ref_adamw(LR),
                                        client_dropout=m is not None))
        p, losses = fn(params, (jnp.asarray(inp["bx"]),
                                jnp.asarray(inp["by"])), *extra)
        return _tier(p, False), np.asarray(losses)
    shared = case["tier"] == "shared"
    opt_c, opt_s, fn = _ref_sl_round(n, case["tier"], case["reduce"],
                                     case["kernel"], m is not None)
    cp0, sp0 = params[:K], params[K:]
    state = ((cp0 if shared else ref_stack_replicas(cp0, n)), sp0,
             (opt_c.init(cp0) if shared else ref_init_stacked(opt_c, cp0, n)),
             opt_s.init(sp0))
    out = fn(*state, {"inputs": jnp.asarray(inp["bx"]),
                      "targets": jnp.asarray(inp["by"])}, *extra)
    st = not shared

    def opt(o, stacked):
        return {"step": np.asarray(o.step), "mu": _tier(o.mu, stacked),
                "nu": _tier(o.nu, stacked)}
    return (_tier(out[0], st), _tier(out[1], False), opt(out[2], st),
            opt(out[3], False), np.asarray(out[4]))


def _port_vmap_engine(n: int, case: dict):
    inp = _engine_inputs(n)
    if case["kind"] == "fl":
        return RC.fl_round_outputs(case, inp["params"], inp["bx"], inp["by"])
    return RC.sl_round_outputs(case, inp["params_c"], inp["params_s"],
                               inp["bx"], inp["by"])


def _close(got, want, what, atol=FLEET_EQUIV_ATOL):
    """Numpy trees (tuples and dicts of arrays) within ``atol``; optimizer
    step counters (key ``step``) equal."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]", atol)
    elif isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            if k == "step":
                np.testing.assert_array_equal(got[k], want[k], err_msg=what)
            else:
                _close(got[k], want[k], f"{what}.{k}", atol)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), atol=atol,
                                   rtol=0, err_msg=what)


def _check_engine(n: int, name: str, case: dict, got: dict, ranks: int):
    out = got["out"]
    for label, want in (("port vmap", _port_vmap_engine(n, case)),
                        ("reference vmap", _reference_engine(n, case))):
        _close(out, want, f"{name} vs {label}")
    if case["kind"] == "sl":
        assert out[4].shape == (S, n)
        # one int8 launch a local step a rank, for that rank's clients
        assert [len(c) for c in got["calls"]] == [S] * ranks
        assert all(c[0] == n // ranks for calls in got["calls"]
                   for c in calls)
        if case["mask"] is not None and not case["mask"].any():
            assert int(out[3]["step"]) == 0        # a no-op on all state
    else:
        assert out[1].shape == (n, S)


ENGINE_2 = list(_engine_cases(4, True))
ENGINE_4 = list(_engine_cases(8, False))


@pytest.mark.parametrize("name", ENGINE_2)
def test_engine_on_two_ranks_matches_vmap(two_ranks, name):
    _check_engine(4, name, _engine_cases(4, True)[name],
                  two_ranks["engine"][name], 2)


@pytest.mark.parametrize("name", ENGINE_4)
def test_engine_on_four_ranks_matches_vmap(four_ranks, name):
    _check_engine(8, name, _engine_cases(8, False)[name],
                  four_ranks["engine"][name], 4)


@pytest.mark.parametrize("case", ["plain", "mask", "idle-rank",
                                  "all-masked"])
def test_pmean_family_matches_reference_on_four_ranks(four_ranks, case):
    check_pmean_case(four_ranks["pmean"][case], pmean_inputs(8, seed=4)[case],
                     4)


def test_default_mesh_takes_the_largest_divisor_that_fits(four_ranks):
    """6 clients on 4 ranks: ``make_fleet_mesh`` gives ``data=3`` over
    ranks 0-2 (a new group), and rank 3, holding no client, is refused
    (the reference's rule: the largest divisor of the fleet that fits)."""
    six = four_ranks["six"]
    assert [r.get("mesh") for r in six[:3]] == [
        {"data": 3, "fsdp": 1, "tp": 1}] * 3
    assert [r.get("rank") for r in six[:3]] == [0, 1, 2]
    assert "rank 3 holds none of the 6 clients" in six[3]["error"]


def test_ranks_import_no_jax_and_refuse_a_mismatched_backend(two_ranks,
                                                             four_ranks):
    for world in (two_ranks, four_ranks):
        for part in ("engine", "plans"):
            assert not any(world[part]["jax"])
        assert "cannot carry a fleet on cuda" in world["backend"]
    assert len(two_ranks["engine"]["jax"]) == 2
    assert len(four_ranks["engine"]["jax"]) == 4


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

RECORD_EXACT = ("round", "link_bytes", "link_time_s", "link_energy_j",
                "client_time_s", "client_energy_j", "server_time_s",
                "server_energy_j", "uav_energy_j", "active_clients",
                "cohort_pids")


def _check_plan(name: str, case: dict, got: dict, ranks: int):
    ref_plan, ref_recs, inputs = _reference_plan(name)
    recs = got["records"]
    kind = case["kind"]
    assert all(r.engine == f"{kind}/shard_map" for r in recs)
    assert got["meshes"] == [{"data": ranks, "fsdp": 1, "tp": 1}] * ranks
    # against the port's vmap plan on the same inputs: the host's fields
    # exactly, the device's within the tolerance
    want = RC.run_plan_case(case, inputs, "vmap")
    for a, b in zip(recs, want["records"]):
        for f in RECORD_EXACT:
            assert getattr(a, f) == getattr(b, f), (name, f)
        assert abs(a.loss - b.loss) <= FLEET_EQUIV_ATOL
        assert abs(a.accuracy - b.accuracy) <= 1.0 / N_TEST + 1e-12
        assert set(a.metrics) == set(b.metrics)
        for k in b.metrics:
            if k.startswith(("health/", "mask/")):
                assert a.metrics[k] == b.metrics[k], k
            else:
                assert abs(a.metrics[k] - b.metrics[k]) <= (
                    FLEET_EQUIV_ATOL * (1 + abs(b.metrics[k]))), k
    _close(got["state"], want["state"], f"{name} state")
    # against the reference's vmap plan (its shard_map == vmap contract)
    port_flops = want["flops"]
    if kind == "fl":
        pair = (ref_plan.flops["full"], 0.0), (port_flops["full"], 0.0)
    else:
        k = ref_plan.cut_of_client[0]
        pair = ref_plan.flops[k][:2], port_flops[k]
    assert_records_match(
        [dataclasses.replace(r, engine=f"{kind}/shard_map")
         for r in ref_recs], recs, ref_flops_pair=pair[0],
        port_flops_pair=pair[1],
        server_base_s=FL_SERVER_AGG_S if kind == "fl" else 0.0,
        n_test=4 * 16 if case.get("lm") else N_TEST)
    # one int8 launch a local step a rank, for that rank's clients
    if kind == "sl":
        rounds = len(recs)
        assert [len(c) for c in got["calls"]] == [rounds * S] * ranks
        assert all(c[0] == case["n"] // ranks for calls in got["calls"]
                   for c in calls)
    return want


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_on_two_ranks_matches_vmap_and_reference(two_ranks, name):
    case = PLAN_CASES[name]
    got = two_ranks["plans"][name]
    want = _check_plan(name, case, got, 2)
    recs = got["records"]
    if case.get("dropout") or case.get("p_drop"):
        assert len({r.active_clients for r in recs}) > 1 or any(
            r.active_clients < case["n"] for r in recs)
    if case.get("population"):
        assert all(len(r.cohort_pids) == case["n"] for r in recs)
    if case.get("taps"):
        assert recs[0].metrics and "mask/active" in recs[0].metrics
    if case.get("mc"):
        # the seed axis on shard_map against it on vmap: the host's
        # stacks exactly, the losses and taps within the tolerance
        assert set(got["mc"]) == set(want["mc"])
        for key, v in want["mc"].items():
            g = got["mc"][key]
            if key in RECORD_EXACT + ("mask", "cohort"):
                np.testing.assert_array_equal(g, v, err_msg=key)
            elif key == "final_accuracy":
                np.testing.assert_allclose(g, v, atol=1.0 / N_TEST + 1e-12,
                                           rtol=0)
            elif key.startswith("metrics/health") or key.startswith(
                    "metrics/mask"):
                np.testing.assert_array_equal(g, v, err_msg=key)
            else:
                np.testing.assert_allclose(
                    g, v, atol=FLEET_EQUIV_ATOL,
                    rtol=FLEET_EQUIV_ATOL, err_msg=key)


@pytest.mark.parametrize("name", list(PLAN_CASES_4))
def test_plan_on_four_ranks_matches_vmap_and_reference(four_ranks, name):
    _check_plan(name, PLAN_CASES_4[name], four_ranks["plans"][name], 4)


# ---------------------------------------------------------------------------
# the single-rank mesh, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sl-dropout", "fl-dropout", "sl-cohort",
                                  "sl-scenario-taps"])
def test_single_rank_mesh_is_the_vmap_engine_bit_for_bit(name):
    """``compile_experiment(mesh=None)`` with no process group: the
    single-rank mesh, every collective the identity. Records, taps and
    state equal the ``vmap`` plan's bit for bit."""
    case = PLAN_CASES[name]
    inputs = _reference_plan(name)[2]
    got = RC.run_plan_case(case, inputs, "shard_map")
    want = RC.run_plan_case(case, inputs, "vmap")
    assert got["mesh"] == {"data": 1, "fsdp": 1, "tp": 1}
    for a, b in zip(got["records"], want["records"]):
        assert dataclasses.replace(a, engine=b.engine) == b
    for a, b in zip(jax.tree_util.tree_leaves(got["state"]),
                    jax.tree_util.tree_leaves(want["state"])):
        np.testing.assert_array_equal(a, b)
    assert got["calls"] == want["calls"]


# ---------------------------------------------------------------------------
# the mesh and the batch shard, in this process
# ---------------------------------------------------------------------------

def test_mesh_rules_without_a_process_group():
    assert not torch.distributed.is_initialized()
    assert make_fleet_mesh(4) is None
    one = single_device_fleet_mesh()
    assert (one.group, one.rank, one.size) == (None, 0, 1)
    assert one.shape == {"data": 1, "fsdp": 1, "tp": 1}
    # the reference's rule: the largest divisor of the fleet that fits
    assert [fleet_data_size(n, 4) for n in (1, 2, 3, 4, 6, 8, 9)] == \
        [1, 2, 3, 4, 3, 4, 3]
    assert fleet_data_size(8, 4, max_data=2) == 2
    x = torch.arange(24).reshape(2, 4, 3)
    assert all_gather_rows(one, [(x, 1)])[0] is x
    assert not torch.distributed.is_initialized()


def test_shard_batch_takes_the_ranks_block():
    x = {"a": torch.arange(8 * 3).reshape(8, 3),
         "b": (torch.arange(16).reshape(2, 8),)}
    for rank in range(4):
        mesh = FleetMesh(group=None, rank=rank, size=4, device=CPU)
        got = shard_batch(x["a"], mesh)
        assert torch.equal(got, x["a"][2 * rank:2 * rank + 2])
        got_b = shard_batch(x["b"], mesh, dim=1)[0]
        assert torch.equal(got_b, x["b"][0][:, 2 * rank:2 * rank + 2])
    assert shard_batch(x, None)["a"] is not None
    with pytest.raises(ValueError, match="do not divide over data=3"):
        shard_batch(x["a"], FleetMesh(None, 0, 3, CPU))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _cnn(**kw):
    return T.ExperimentSpec(**{
        "model": T.ModelSpec(name="tinycnn", num_classes=4),
        "data": T.DataSpec(kind="arrays", image_size=16,
                           classes_per_client=2),
        "clients": T.ClientSpec(num_clients=4),
        "engine": T.EngineSpec(kind="sl", client_axis="shard_map"),
        "global_rounds": 1, "local_steps": S, "batch_size": B, **kw})


REFUSALS = {
    # the reference's own messages
    "indivisible": (dict(), dict(mesh=FleetMesh(None, 0, 3, CPU)),
                    ValueError, "4 clients do not divide over data=3"),
    "server-mesh-on-scan": (dict(engine=T.EngineSpec(server_mesh=(1, 1))),
                            {}, ValueError,
                            "server_mesh shards the SL server suffix"),
    "server-mesh-on-fl": (dict(engine=T.EngineSpec(
        kind="fl", client_axis="shard_map", server_mesh=(1, 1))), {},
        ValueError, "needs a fleet SL engine"),
    "server-mesh-sizes": (dict(engine=T.EngineSpec(
        client_axis="shard_map", server_mesh=(0, 1))), {}, ValueError,
        "server_mesh sizes must be >= 1"),
    # the port's own: the mesh serves the plan's device
    "device": (dict(), dict(mesh=FleetMesh(None, 0, 1,
                                           torch.device("cuda"))),
               ValueError, "collectives of a cpu fleet stay on its device"),
    # adaptive cuts on shard_map (HeteroFleet on shard_map) run, on the
    # single-rank mesh with no process group (None)
    "adaptive": (dict(cut_policy=T.CutPolicy(mode="adaptive")), {},
                 None, None),
    # the reference's: a server sub-mesh of 2 ranks with one rank up
    "fsdp": (dict(engine=T.EngineSpec(client_axis="shard_map",
                                      server_mesh=(2, 1))), {},
             ValueError, r"server_mesh=\(2, 1\) needs at least 2 devices "
                         r"\(1 available\)"),
    # a vmap plan over a mesh of more than one rank runs (4 gloo ranks:
    # test_torch_server_mesh.py); a mesh of 2 data ranks with no process
    # group behind it cannot carry one
    "vmap-over-ranks": (dict(engine=T.EngineSpec(client_axis="vmap")),
                        dict(mesh=FleetMesh(None, 0, 2, CPU)),
                        ValueError, "needs their process group"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(name):
    """Each case is refused with its message, or (an exception of None: a
    case the port has since taken in) runs a round."""
    fields, kw, exc, match = REFUSALS[name]
    if exc is None:
        plan = T.compile_experiment(_cnn(**fields), data=_data(),
                                    device="cpu", **kw)
        _, rec = plan.run_round(plan.init())
        assert np.isfinite(rec.loss) and rec.engine == "sl/shard_map"
        return
    with pytest.raises(exc, match=match):
        T.compile_experiment(_cnn(**fields), data=_data(), device="cpu",
                             **kw)


def test_reference_messages_are_the_references():
    """The divisibility and server_mesh messages are the reference's
    words (its ``validate_fleet_mesh`` and ``_validate``)."""
    from repro.fleet.engine import validate_fleet_mesh as ref_validate
    from repro.launch.mesh import single_device_fleet_mesh as ref_single
    msgs = []
    with pytest.raises(ValueError) as err:
        validate_fleet_mesh(FleetMesh(None, 0, 3, CPU), 4)
    msgs.append(str(err.value))

    class Three:
        axis_names = ("data",)
        devices = np.zeros((3,))
    with pytest.raises(ValueError) as err:
        ref_validate(Three(), 4)
    msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert ref_single() is not None
    for fields in (dict(engine=T.EngineSpec(server_mesh=(1, 1))),):
        got = want = None
        with pytest.raises(ValueError) as err:
            T.compile_experiment(_cnn(**fields), data=_data(), device="cpu")
        got = str(err.value)
        with pytest.raises(ValueError) as err:
            R.compile_experiment(R.ExperimentSpec(
                model=R.ModelSpec(name="tinycnn", num_classes=4),
                data=R.DataSpec(kind="arrays", image_size=16),
                engine=R.EngineSpec(server_mesh=(1, 1))), data=_data())
        want = str(err.value)
        assert got == want


def test_engine_refuses_an_unknown_client_axis():
    opt = FunctionalAdamW(LR)
    with pytest.raises(ValueError, match="fleet client_axis must be one of"):
        make_fleet_sl_round(lambda *a: None, opt, opt, local_rounds=1,
                            client_axis="scan")


def test_a_failing_rank_raises_its_error(tmp_path):
    with pytest.raises(KeyError, match="rank 1 refuses"):
        run_ranks(RC.failing_rank, 2, str(tmp_path), args=(1,),
                  timeout_s=30.0)
    assert not torch.distributed.is_initialized()
    assert "MASTER_ADDR" not in os.environ and "MASTER_PORT" not in os.environ
