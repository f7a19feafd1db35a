"""Population cohorts (``ClientSpec.population``) in the port against the reference.

tinycnn at 16x16 and a reduced SmolLM, a cohort of 3 out of 10,000, the
same arrays, the reference's parameters (``convert.from_reference`` /
``lm_from_reference``) and the reference's cohorts fed to the port
(``Plan.cohorts`` from the reference's ``RoundRecord.cohort_pids``):

- the reference's three population refusals, message for message;
- the port's sampler (``sim.scenario.sample_cohort``): deterministic per
  seed and round, sorted, distinct, in range, the identity when the cohort
  is the population, and down-weighted ids drawn less often;
- record parity on ``fl/scan``, ``fl/vmap`` and ``sl/vmap`` (the EPSL
  shared client tier; mean and sum, with and without dropout 0.34) and of
  a reduced SmolLM on ``sl/vmap``: ``cohort_pids`` and ``active_clients``
  exactly, the rest as ``assert_records_match`` states;
- the degenerate corner, population == num_clients, on all four engines:
  the port's own records without a population exactly, pids 0..K-1, and
  the reference's;
- engine-state bytes equal at populations of 10,000 and 1,000,000, the
  partitions capped at ``POPULATION_PARTITION_CAP``, only the cohort's
  images gathered;
- a bad ``Plan.cohorts`` entry raises.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_harness import assert_records_match

import repro.api as R
from repro.configs import smollm_135m as ref_smollm
import repro_torch.api as T
from repro_torch.api.plan import FL_SERVER_AGG_S
from repro_torch.configs import smollm_135m
from repro_torch.convert import from_reference, lm_from_reference
from repro_torch.data.partition import POPULATION_PARTITION_CAP
from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
from repro_torch.sim.scenario import (COHORT_DOWN_WEIGHT, cohort_generator,
                                      sample_cohort)

K, POP = 3, 10_000
N_TRAIN, N_TEST = 96, 24


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, size=(N_TRAIN, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, 12, size=(N_TRAIN,))
    return x, y, x[:N_TEST], y[:N_TEST]


def _cnn_spec(api, kind, axis, *, pop=POP, n=K, reduce="mean", dropout=0.0,
              rounds=3):
    return api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(kind="arrays", image_size=16),
        clients=api.ClientSpec(num_clients=n, dropout_rate=dropout,
                               population=pop),
        cut_policy=api.CutPolicy(fraction=0.4),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind=kind, client_axis=axis,
                              link_kernel="fused", server_reduce=reduce),
        mission=api.MissionSpec(), global_rounds=rounds, local_steps=2,
        batch_size=4)


def _flops_pair(plan):
    if plan.spec.engine.kind == "fl":
        return plan.flops["full"], 0.0
    return tuple(plan.flops[plan.cut_of_client[0]][:2])


def _assert_cohort_records(ref_plan, port_plan, ref_recs, port_recs, n_test):
    assert_records_match(
        ref_recs, port_recs, ref_flops_pair=_flops_pair(ref_plan),
        port_flops_pair=_flops_pair(port_plan),
        server_base_s=(FL_SERVER_AGG_S if port_plan.spec.engine.kind == "fl"
                       else 0.0),
        n_test=n_test, loss_atol=FLEET_EQUIV_ATOL)
    assert ([r.active_clients for r in port_recs]
            == [r.active_clients for r in ref_recs])


def _run_cnn_pair(kind, axis, **kw):
    """The reference's plan, then the port's on its params and cohorts."""
    data = _data()
    ref_plan = R.compile_experiment(_cnn_spec(R, kind, axis, **kw),
                                    data=data)
    port_plan = T.compile_experiment(_cnn_spec(T, kind, axis, **kw),
                                     data=data, device="cpu")
    port_plan.params0 = from_reference(
        jax.tree_util.tree_map(np.asarray, ref_plan.params0), "tinycnn")
    _, ref_recs = ref_plan.run()
    port_plan.cohorts = [r.cohort_pids for r in ref_recs]
    _, port_recs = port_plan.run()
    return ref_plan, port_plan, ref_recs, port_recs


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

REFUSALS = {
    "smaller-than-cohort": dict(kind="sl", axis="vmap", pop=2),
    "sl-scan": dict(kind="sl", axis="scan", pop=100),
    "adaptive": dict(kind="sl", axis="vmap", pop=100, adaptive=True),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_population_refusals_are_the_references(case):
    kw = dict(REFUSALS[case])
    adaptive = kw.pop("adaptive", False)
    messages = []
    for api, extra in ((R, {}), (T, {"device": "cpu"})):
        spec = _cnn_spec(api, kw["kind"], kw["axis"], pop=kw["pop"])
        if adaptive:
            spec = dataclasses.replace(
                spec, cut_policy=api.CutPolicy(mode="adaptive"))
        with pytest.raises(ValueError) as err:
            api.compile_experiment(spec, data=_data(), **extra)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def test_sample_cohort_deterministic_sorted_in_range():
    a = sample_cohort(cohort_generator(3, 0), 1000, 8)
    b = sample_cohort(cohort_generator(3, 0), 1000, 8)
    c = sample_cohort(cohort_generator(3, 1), 1000, 8)
    d = sample_cohort(cohort_generator(4, 0), 1000, 8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, d)
    assert np.all(np.diff(a) > 0)             # sorted, no replacement
    assert a.min() >= 0 and a.max() < 1000
    with pytest.raises(ValueError, match="cohort size"):
        sample_cohort(cohort_generator(3, 0), 4, 8)


def test_sample_cohort_identity_when_cohort_equals_population():
    w = np.asarray([1.0, 0.05, 1.0, 0.05, 1.0, 0.05])
    for seed in range(4):
        np.testing.assert_array_equal(
            sample_cohort(cohort_generator(seed, 0), 6, 6), np.arange(6))
        np.testing.assert_array_equal(
            sample_cohort(cohort_generator(seed, 0), 6, 6, weights=w),
            np.arange(6))


def test_sample_cohort_weights_downweight_bad_clients():
    """Half the population at ``COHORT_DOWN_WEIGHT`` is drawn far less
    often than the other half (unweighted: about half the draws)."""
    pop, k, trials = 100, 10, 200
    w = np.concatenate([np.ones(50), np.full(50, COHORT_DOWN_WEIGHT)])
    down = sum(int((sample_cohort(cohort_generator(s, 0), pop, k,
                                  weights=w) >= 50).sum())
               for s in range(trials))
    assert down / (trials * k) < 0.2


# ---------------------------------------------------------------------------
# record parity on the reference's cohorts
# ---------------------------------------------------------------------------

CNN_CASES = {
    "fl-scan": dict(kind="fl", axis="scan"),
    "fl-vmap": dict(kind="fl", axis="vmap"),
    "sl-vmap-mean": dict(kind="sl", axis="vmap"),
    "sl-vmap-sum": dict(kind="sl", axis="vmap", reduce="sum"),
    "sl-vmap-mean-dropout": dict(kind="sl", axis="vmap", dropout=0.34),
    "sl-vmap-sum-dropout": dict(kind="sl", axis="vmap", reduce="sum",
                                dropout=0.34),
}


@pytest.mark.parametrize("case", list(CNN_CASES))
def test_cohort_records_match_reference(case):
    ref_plan, port_plan, ref_recs, port_recs = _run_cnn_pair(
        **CNN_CASES[case])
    assert len(port_plan.parts) == len(ref_plan.parts) == N_TRAIN
    pids = [r.cohort_pids for r in port_recs]
    assert pids == [r.cohort_pids for r in ref_recs]
    assert all(len(p) == K and max(p) < POP for p in pids)
    assert len(set(pids)) == len(pids)        # a new cohort every round
    if CNN_CASES[case]["kind"] == "sl":
        assert port_plan._engine.client_tier == "shared"
    _assert_cohort_records(ref_plan, port_plan, ref_recs, port_recs, N_TEST)


def _lm_spec(api, arch, pop):
    return api.ExperimentSpec(
        model=api.ModelSpec(family="transformer", arch=arch,
                            attn_impl="pallas"),
        data=api.DataSpec(kind="tokens", partition="iid", seq_len=16,
                          n_train=32, n_test=4),
        clients=api.ClientSpec(num_clients=K, population=pop),
        cut_policy=api.CutPolicy(fraction=0.4),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(client_axis="vmap", link_kernel="fused"),
        global_rounds=2, local_steps=2, batch_size=4)


def test_lm_cohort_records_match_reference():
    """A reduced SmolLM on ``sl/vmap`` with the shared client tier, flash
    attention on its plain version here (the reference's Pallas kernel in
    interpret mode)."""
    ref_plan = R.compile_experiment(_lm_spec(R, ref_smollm.reduced(), POP))
    data = (ref_plan.x_train, ref_plan.y_train, ref_plan.x_test,
            ref_plan.y_test)
    cfg = smollm_135m.reduced()
    port_plan = T.compile_experiment(_lm_spec(T, cfg, POP), data=data,
                                     device="cpu")
    port_plan.params0 = lm_from_reference(
        *jax.tree_util.tree_map(np.asarray, ref_plan.params0), cfg)
    _, ref_recs = ref_plan.run()
    port_plan.cohorts = [r.cohort_pids for r in ref_recs]
    _, port_recs = port_plan.run()
    assert port_plan._engine.client_tier == "shared"
    assert all(len(r.cohort_pids) == K for r in port_recs)
    _assert_cohort_records(ref_plan, port_plan, ref_recs, port_recs, 4 * 16)


# ---------------------------------------------------------------------------
# the degenerate corner: population == num_clients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,axis", [("fl", "scan"), ("fl", "vmap"),
                                       ("sl", "scan"), ("sl", "vmap")])
def test_degenerate_population_reproduces_records(kind, axis):
    """The whole cohort path (draw, pool gather, profile gather) with the
    cohort the population: the records of the plan without a population,
    field for field, pids 0..K-1; and the reference's corner."""
    data = _data()
    port = {}
    for pop in (None, K):
        plan = T.compile_experiment(_cnn_spec(T, kind, axis, pop=pop,
                                              rounds=2),
                                    data=data, device="cpu")
        _, port[pop] = plan.run()
    for a, b in zip(port[None], port[K]):
        da, db = a.to_dict(), b.to_dict()
        assert da.pop("cohort_pids") == ()
        assert db.pop("cohort_pids") == tuple(range(K))
        assert da == db
    ref_plan = R.compile_experiment(_cnn_spec(R, kind, axis, pop=K,
                                              rounds=2), data=data)
    plan.params0 = from_reference(
        jax.tree_util.tree_map(np.asarray, ref_plan.params0), "tinycnn")
    _, ref_recs = ref_plan.run()
    _, port_recs = plan.run()
    assert [r.cohort_pids for r in ref_recs] == [tuple(range(K))] * 2
    _assert_cohort_records(ref_plan, plan, ref_recs, port_recs, N_TEST)


# ---------------------------------------------------------------------------
# O(cohort) state and data
# ---------------------------------------------------------------------------

def _state_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_state_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_state_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(_state_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


@pytest.mark.parametrize("kind", ["fl", "sl"])
def test_engine_state_independent_of_population(kind):
    """FL cohorts are stateless and SL's shares one client model: the
    engine state takes the same bytes at M = 10,000 and 1,000,000, and a
    round gathers and moves the cohort's images alone."""
    sizes = {}
    for pop in (10_000, 1_000_000):
        spec = dataclasses.replace(
            _cnn_spec(T, kind, "vmap", pop=pop, n=8, rounds=1),
            data=T.DataSpec(image_size=16, n_train=2048, n_test=24,
                            partition="iid"))
        plan = T.compile_experiment(spec, device="cpu")
        state = plan.init()
        sizes[pop] = _state_bytes(state.engine_state)
        assert len(plan.parts) == POPULATION_PARTITION_CAP
        cohort = plan._round_cohort(state)
        batches = plan.round_batches(state, cohort=cohort)
        bx = batches[0] if kind == "fl" else batches["inputs"]
        assert bx.shape == (8, 2, 4, 16, 16, 3)
        state, rec = plan.run_round(state, with_eval=False)
        assert rec.cohort_pids == tuple(int(p) for p in cohort)
        assert max(rec.cohort_pids) < pop and np.isfinite(rec.loss)
    assert sizes[10_000] == sizes[1_000_000] > 0


# ---------------------------------------------------------------------------
# Plan.cohorts is checked
# ---------------------------------------------------------------------------

BAD_COHORTS = {
    "unsorted": [(5, 2, 9)],
    "repeated": [(2, 2, 9)],
    "out-of-range": [(2, 5, POP)],
    "negative": [(-1, 5, 9)],
    "too-few": [(2, 5)],
    "not-integers": [(2.0, 5.0, 9.0)],
    "past-the-end": [],
}


@pytest.mark.parametrize("case", list(BAD_COHORTS))
def test_bad_cohorts_entry_raises(case):
    plan = T.compile_experiment(_cnn_spec(T, "fl", "vmap", rounds=1),
                                data=_data(), device="cpu")
    plan.cohorts = BAD_COHORTS[case]
    with pytest.raises(ValueError, match="Plan.cohorts"):
        plan.run()


def test_cohorts_need_a_population():
    plan = T.compile_experiment(_cnn_spec(T, "fl", "vmap", pop=None,
                                          rounds=1),
                                data=_data(), device="cpu")
    plan.cohorts = [(0, 1, 2)]
    with pytest.raises(ValueError, match="without ClientSpec.population"):
        plan.run()
