"""Monte-Carlo sweeps (``repro_torch.sim.run_monte_carlo``) against the reference.

The port's versions of the reference's contracts (``tests/test_sim.py``),
on tinycnn at 16x16 under the reference tests' ``STOCH`` scenario:

- bitwise reproducible under a fixed sweep seed, and another seed differs;
- ``mode="vmap"`` equals ``mode="loop"`` seed by seed: masks, active
  clients, cohorts and bills exactly, losses (and taps) within
  ``FLEET_EQUIV_ATOL``. On the fleet engines' seed axis: ``sl/vmap``
  (stacked and shared client tiers), ``fl/vmap`` with a plain dropout
  rate, and a reduced split LM, the int8 boundary one call a local step
  for all seeds and clients. On the scan engines under a channel-only
  scenario: the shared round of ``sl/scan`` (the int8 boundary one call a
  client step for all seeds) and of ``fl/scan``, whose seeds train one
  trajectory, and the seed axis of ``fl/scan`` under a population, whose
  seeds draw their own cohorts and train apart (taps too);
- seed 0 replays ``plan.run(with_eval=False)``, and a shifted scenario
  seed shifts which realisation seed 0 is;
- ``records_for_seed`` and ``summary``;
- hetero-bucketed plans raise, a plan whose seeds train apart on an
  engine without a seed axis raises, ``mode="loop"`` runs the scan
  engines;
- a sweep on the reference's per-seed draws (``env_draws``) matches the
  reference's own ``run_monte_carlo`` on ``sl/vmap``, ``sl/scan`` and
  ``fl/scan``.
"""
import copy
import dataclasses
import functools

import jax
import numpy as np
import pytest

from test_torch_harness import assert_records_match, reference_env_draws

import repro.api as R
import repro.sim as RS
import repro_torch.api as T
import repro_torch.sim as TS
import repro_torch.kernels.quant.ops as quant_ops
from repro_torch.configs import smollm_135m
from repro_torch.convert import from_reference
from repro_torch.core.energy import HardwareProfile, JETSON_AGX_ORIN
from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
from repro_torch.obs import ObsConfig
from repro_torch.obs.metrics import MetricsConfig
from repro_torch.sim.monte_carlo import build_vmap_rollout

NUM_CLASSES = 4
N_TRAIN, N_TEST = 96, 24
SEEDS, ROUNDS = 3, 2


def _stoch(S, seed=1):
    return S.ScenarioSpec(
        channel=S.ChannelParams(kind="a2g"),
        availability=S.AvailabilityParams(kind="markov", p_drop=0.4,
                                          p_recover=0.6),
        num_uavs=2, serve_mode="relay", seed=seed)


def _channel(S):
    """The scan engines' scenario: the ``a2g`` channel alone (they refuse
    availability traces)."""
    return S.ScenarioSpec(channel=S.ChannelParams(kind="a2g"), num_uavs=2,
                          serve_mode="relay", seed=1)


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, size=(N_TRAIN, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, NUM_CLASSES, size=(N_TRAIN,))
    return x, y, x[:N_TEST], y[:N_TEST]


def _spec(api, S, *, kind="sl", axis="vmap", scenario=_stoch, dropout=0.0,
          pop=None, rounds=ROUNDS, clients=None, adaptive=False):
    return api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn", num_classes=NUM_CLASSES),
        data=api.DataSpec(kind="arrays", image_size=16, classes_per_client=2),
        clients=clients or api.ClientSpec(num_clients=4, dropout_rate=dropout,
                                          population=pop),
        cut_policy=(api.CutPolicy(mode="adaptive") if adaptive
                    else api.CutPolicy(fraction=0.4)),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind=kind, client_axis=axis,
                              link_kernel="fused"),
        mission=api.MissionSpec(),
        scenario=None if scenario is None else scenario(S),
        global_rounds=rounds, local_steps=2, batch_size=4)


@functools.lru_cache(maxsize=None)
def _plan(metrics=False, **kw):
    return T.compile_experiment(
        _spec(T, TS, **kw), data=_data(), device="cpu",
        obs=ObsConfig(enabled=False, metrics=MetricsConfig()) if metrics
        else None)


def _assert_stacks_agree(a, b, *, loss_atol=0.0):
    """Masks, cohorts and bills exactly; losses within ``loss_atol``, the
    per-step loss and tap stacks within it and a relative 2e-5."""
    assert set(a.stacks) == set(b.stacks)
    for k in a.stacks:
        if k in ("loss", "final_accuracy"):
            np.testing.assert_allclose(a.stacks[k], b.stacks[k],
                                       atol=loss_atol if k == "loss" else
                                       1.0 / N_TEST + 1e-12, rtol=0,
                                       err_msg=k)
        elif k == "loss_stack" or k.startswith("metrics/"):
            np.testing.assert_allclose(a.stacks[k], b.stacks[k],
                                       atol=loss_atol, rtol=2e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(a.stacks[k], b.stacks[k],
                                          err_msg=k)


def test_monte_carlo_bitwise_reproducible():
    plan = _plan()
    a = TS.run_monte_carlo(plan, SEEDS, rounds=ROUNDS, seed=11)
    b = TS.run_monte_carlo(plan, SEEDS, rounds=ROUNDS, seed=11)
    for k in a.stacks:
        np.testing.assert_array_equal(a.stacks[k], b.stacks[k], err_msg=k)
    c = TS.run_monte_carlo(plan, SEEDS, rounds=ROUNDS, seed=12)
    assert any(not np.array_equal(a.stacks[k], c.stacks[k])
               for k in a.stacks)
    assert a.stacks["loss"].shape == (SEEDS, ROUNDS)
    assert a.stacks["mask"].shape == (SEEDS, ROUNDS, 4)


def _lm_plan():
    spec = T.ExperimentSpec(
        model=T.ModelSpec(family="transformer", arch=smollm_135m.reduced(),
                          attn_impl="pallas"),
        data=T.DataSpec(kind="tokens", partition="iid", seq_len=16,
                        n_train=32, n_test=4),
        clients=T.ClientSpec(num_clients=3),
        cut_policy=T.CutPolicy(fraction=0.4),
        link_policy=T.LinkPolicy(compress="int8"),
        engine=T.EngineSpec(client_axis="vmap", link_kernel="fused"),
        mission=T.MissionSpec(),
        scenario=_stoch(TS),
        global_rounds=ROUNDS, local_steps=2, batch_size=4)
    return T.compile_experiment(spec, device="cpu")


VMAP_CASES = {
    "sl-stacked": dict(),
    "sl-shared-cohort": dict(pop=40, scenario=lambda S: S.ScenarioSpec(
        availability=S.AvailabilityParams(kind="markov", p_drop=0.5,
                                          p_recover=0.3), seed=2)),
    "fl-dropout": dict(kind="fl", dropout=0.4, scenario=None),
    "lm": None,
    "sl-scan": dict(axis="scan", scenario=_channel),
    "fl-scan": dict(kind="fl", axis="scan", scenario=_channel),
    "fl-scan-cohort": dict(kind="fl", axis="scan", pop=40,
                           scenario=_channel),
    "fl-scan-cohort+metrics": dict(kind="fl", axis="scan", pop=40,
                                   scenario=_channel, metrics=True),
}


@pytest.mark.parametrize("case", list(VMAP_CASES))
def test_monte_carlo_vmap_matches_loop(case, monkeypatch):
    """The vmap mode against the loop seed by seed. The int8 boundary is
    one call a local step for all seeds and clients on the fleet engines'
    seed axis and one a client step for all seeds on ``sl/scan``'s shared
    round, against one a local step (a client step on ``sl/scan``) a seed
    in ``loop`` mode. The shared round gives every seed one trajectory;
    seeds that draw their own cohorts (``fl/scan`` under a population)
    train apart."""
    plan = _lm_plan() if case == "lm" else _plan(**VMAP_CASES[case])
    calls = []
    real = quant_ops.quant_dequant

    def counting(x, kernel="xla"):
        calls.append(tuple(x.shape))
        return real(x, kernel=kernel)

    monkeypatch.setattr(quant_ops, "quant_dequant", counting)
    v = TS.run_monte_carlo(plan, SEEDS, rounds=ROUNDS, mode="vmap")
    v_calls, calls[:] = list(calls), []
    l = TS.run_monte_carlo(plan, SEEDS, rounds=ROUNDS, mode="loop")
    l_calls = list(calls)
    _assert_stacks_agree(v, l, loss_atol=FLEET_EQUIV_ATOL)
    steps, n = plan.spec.local_steps, plan.spec.clients.num_clients
    scan = plan.spec.engine.client_axis == "scan"
    if plan.spec.engine.kind == "fl":
        assert v_calls == l_calls == []
    elif scan:
        # the warm-up round, then the sweep: one call a client step
        assert len(v_calls) == (1 + ROUNDS) * steps * n
        assert len(l_calls) == (1 + SEEDS * ROUNDS) * steps * n
        assert v_calls[-1][0] == plan.spec.batch_size
    else:
        assert len(v_calls) == steps + ROUNDS * steps
        assert len(l_calls) == steps + SEEDS * ROUNDS * steps
        assert v_calls[-1][:2] == (SEEDS, n)
    if scan:
        # the sweep's path: the plan's own round, or the seed axis for
        # seeds that draw their own cohorts
        fn, _ = build_vmap_rollout(plan, SEEDS)
        assert fn == (plan._engine.run_seeds if "cohort" in v.stacks
                      else plan._engine.run)
    if scan and "cohort" not in v.stacks:
        # one trajectory: every seed's losses are seed 0's; the link's
        # bills (SL's) are each seed's channel's
        for k in ("loss", "final_accuracy"):
            assert (v.stacks[k] == v.stacks[k][:1]).all(), k
        if plan.spec.engine.kind == "sl":
            assert np.std(v.stacks["link_time_s"][:, -1]) > 0
    else:
        assert np.std(v.stacks["loss"][:, -1]) > 0      # the seeds differ
    if "cohort" in v.stacks:
        assert v.stacks["cohort"].shape == (SEEDS, ROUNDS, 4)
    if case != "lm" and not scan:
        assert len(np.unique(v.stacks["active_clients"])) > 1
    if plan.metrics_config is not None:
        assert v.stacks["metrics/grad_norm_client"].shape == (
            SEEDS, ROUNDS, n, steps)


def test_monte_carlo_seed_zero_replays_the_plan():
    """Sweep seed i is realisation scn.seed + seed + i: seed 0 of a seed-0
    sweep draws the streams ``plan.run()`` draws."""
    plan = _plan(rounds=3)
    _, recs = plan.run(with_eval=False)
    mc = TS.run_monte_carlo(plan, 2, rounds=3, seed=0)
    for r, rec in enumerate(recs):
        assert int(mc.stacks["active_clients"][0, r]) == rec.active_clients
        assert mc.stacks["loss"][0, r] == pytest.approx(rec.loss,
                                                        abs=FLEET_EQUIV_ATOL)
        for f in ("link_bytes", "link_time_s", "link_energy_j",
                  "client_time_s", "client_energy_j", "server_time_s",
                  "uav_energy_j"):
            assert mc.stacks[f][0, r] == getattr(rec, f), f
    loop = TS.run_monte_carlo(plan, 1, rounds=3, mode="loop")
    assert list(loop.stacks["loss"][0]) == [r.loss for r in recs]
    shifted = T.compile_experiment(
        _spec(T, TS, rounds=3, scenario=lambda S: _stoch(S, seed=2)),
        data=_data(), device="cpu")
    mc2 = TS.run_monte_carlo(shifted, 1, rounds=3, seed=0)
    np.testing.assert_array_equal(mc.stacks["link_time_s"][1],
                                  mc2.stacks["link_time_s"][0])
    np.testing.assert_array_equal(mc.stacks["mask"][1], mc2.stacks["mask"][0])


def test_monte_carlo_records_and_summary():
    plan = _plan()
    mc = TS.run_monte_carlo(plan, SEEDS, rounds=ROUNDS)
    recs = mc.records_for_seed(1)
    assert len(recs) == ROUNDS
    assert recs[0].engine == plan.engine_label == mc.engine
    assert recs[0].uav_energy_j == pytest.approx(plan.timeline.e_first_j)
    assert recs[1].uav_energy_j == pytest.approx(plan.timeline.e_per_round_j)
    assert np.isnan(recs[0].accuracy)
    assert recs[-1].accuracy == mc.stacks["final_accuracy"][1]
    assert [r.active_clients for r in recs] == list(
        mc.stacks["active_clients"][1])
    s = mc.summary()
    assert s["num_seeds"] == SEEDS and s["rounds"] == ROUNDS
    assert s["final_loss"]["min"] <= s["final_loss"]["mean"] \
        <= s["final_loss"]["max"]
    assert s["total_energy_j"]["mean"] > 0 and s["metrics"] is None
    assert mc.wall_s > 0


def test_monte_carlo_refuses_what_it_cannot_sweep():
    mcu = HardwareProfile("mcu", fp32_tflops=0.02, mem_bw_gbs=2.0,
                          tensor_tflops=0.04, cpu_passmark=400.0,
                          power_w=2.0)
    hetero = T.compile_experiment(dataclasses.replace(
        _spec(T, TS, adaptive=True, scenario=None,
              clients=T.ClientSpec(num_clients=4,
                                   edge_profiles=(JETSON_AGX_ORIN, mcu))),
        link_policy=T.LinkPolicy(),
        engine=T.EngineSpec(kind="sl", client_axis="vmap")),
        data=_data(), device="cpu")
    assert len(set(hetero.cut_of_client)) > 1
    for mode in ("vmap", "loop"):
        with pytest.raises(ValueError, match="hetero"):
            TS.run_monte_carlo(hetero, 2, rounds=1, mode=mode)
    scan = _plan(axis="scan", scenario=lambda S: S.ScenarioSpec(
        channel=S.ChannelParams(kind="a2g"), num_uavs=2, seed=1))
    assert TS.run_monte_carlo(scan, 2, rounds=1).stacks["loss"].shape == (
        2, 1)
    # seeds that would train apart on an engine without a seed axis
    apart = copy.copy(scan)
    apart.spec = dataclasses.replace(scan.spec, clients=T.ClientSpec(
        num_clients=4, population=40))
    with pytest.raises(ValueError, match="no seed axis"):
        TS.run_monte_carlo(apart, 2, rounds=1)
    with pytest.raises(ValueError, match="mode"):
        TS.run_monte_carlo(_plan(), 2, mode="scan")
    with pytest.raises(ValueError, match="env_draws"):
        TS.run_monte_carlo(_plan(), 2, rounds=1, env_draws=[[]])


@pytest.mark.parametrize("kind", ["sl", "fl"])
def test_monte_carlo_loop_runs_the_scan_engines(kind):
    plan = _plan(kind=kind, axis="scan", scenario=lambda S: S.ScenarioSpec(
        channel=S.ChannelParams(kind="a2g"), num_uavs=2, seed=1))
    mc = TS.run_monte_carlo(plan, 2, rounds=ROUNDS, mode="loop")
    _, recs = plan.run(with_eval=False)
    assert list(mc.stacks["loss"][0]) == [r.loss for r in recs]
    assert list(mc.stacks["link_time_s"][0]) == [r.link_time_s for r in recs]
    assert (mc.stacks["active_clients"] == 4).all()


REFERENCE_SWEEPS = {
    "sl-vmap": dict(),
    "sl-scan": dict(axis="scan", scenario=_channel),
    "fl-scan": dict(kind="fl", axis="scan", scenario=_channel),
}


@pytest.mark.parametrize("case", list(REFERENCE_SWEEPS))
def test_monte_carlo_matches_the_references_sweep(case):
    """The reference's vmapped sweep and the port's, both modes, on the
    reference's per-seed draws and parameters: the fleet engine's seed
    axis under the stochastic scenario, and the scan engines' shared round
    under the channel alone (the reference's ``EnvDraws`` carry no cohort,
    so these run without a population)."""
    kw = REFERENCE_SWEEPS[case]
    data = _data()
    ref_plan = R.compile_experiment(_spec(R, RS, **kw), data=data)
    port_plan = T.compile_experiment(_spec(T, TS, **kw), data=data,
                                     device="cpu")
    port_plan.params0 = from_reference(
        jax.tree_util.tree_map(np.asarray, ref_plan.params0), "tinycnn")
    ref_mc = RS.run_monte_carlo(ref_plan, SEEDS, rounds=ROUNDS, seed=5)
    scn = port_plan.spec.scenario
    draws = [reference_env_draws(scn.seed + 5 + i, ROUNDS,
                                 mask_n=4 if scn.needs_mask else 0,
                                 rates_n=4) for i in range(SEEDS)]
    if port_plan.spec.engine.kind == "fl":
        # FL's server time is its aggregation constant, which the
        # reference's sweep bills in float32: a server ratio of 1 holds
        # both server fields to a relative 1e-6
        pairs = (ref_plan.flops["full"], 1.0), (port_plan.flops["full"], 1.0)
    else:
        k = port_plan.cut_of_client[0]
        pairs = ref_plan.flops[k][:2], port_plan.flops[k][:2]
    for mode in ("vmap", "loop"):
        mc = TS.run_monte_carlo(port_plan, SEEDS, rounds=ROUNDS, mode=mode,
                                seed=5, env_draws=draws)
        np.testing.assert_array_equal(mc.stacks["active_clients"],
                                      ref_mc.stacks["active_clients"])
        for i in range(SEEDS):
            assert_records_match(
                ref_mc.records_for_seed(i), mc.records_for_seed(i),
                ref_flops_pair=pairs[0], port_flops_pair=pairs[1],
                server_base_s=0.0, n_test=N_TEST,
                loss_atol=FLEET_EQUIV_ATOL, link_rel=1e-6)
    if scn.needs_mask:
        assert len(np.unique(ref_mc.stacks["active_clients"])) > 1
    elif port_plan.spec.engine.kind == "sl":
        # the seeds' channels differ (FL has no link to bill)
        assert np.std(ref_mc.stacks["link_time_s"][:, -1]) > 0


def test_nested_vmap_rules_fold_seeds_and_clients():
    """The seed axis's two custom rules on the CPU: the int8 boundary under
    ``vmap(vmap(...))`` is one call, bit-equal to the plain version seed by
    seed and client by client; the chunked LM loss with a head a seed
    gives each seed's own losses and gradients."""
    import torch
    from torch.func import vmap
    from repro_torch.fleet.hetero import chunked_lm_loss
    from repro_torch.kernels.quant.int8 import quant_dequant_int8_plain
    from repro_torch.kernels.quant.ops import make_link_compress
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 2, 4, 5, 5, 8, generator=g) * 3
    x[1, 0, 2, 3, 1] = float("nan")
    calls = []
    real = quant_ops.quant_dequant

    def counting(t, kernel="xla"):
        calls.append(tuple(t.shape))
        return real(t, kernel=kernel)

    quant_ops.quant_dequant = counting
    try:
        got = vmap(vmap(make_link_compress(kernel="fused")))(x)
    finally:
        quant_ops.quant_dequant = real
    assert calls == [(3, 2, 4, 5, 5, 8)]
    want = torch.stack([torch.stack([
        quant_dequant_int8_plain(x[s, c].reshape(-1, 8)).reshape(x.shape[2:])
        for c in range(2)]) for s in range(3)])
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))

    h = torch.randn(3, 2, 6, 4, generator=g, requires_grad=True)
    head = torch.randn(3, 4, 11, generator=g, requires_grad=True)
    t = torch.randint(0, 11, (3, 2, 6), generator=g)
    w = torch.rand(3, 2, generator=g)
    per_seed = vmap(vmap(lambda a, b, c: chunked_lm_loss(a, b, c, chunk=4),
                         in_dims=(0, None, 0)))
    losses = per_seed(h, head, t)
    grads = torch.autograd.grad((losses * w).sum(), [h, head])
    for s in range(3):
        hs = h[s].detach().requires_grad_()
        hd = head[s].detach().requires_grad_()
        ls = torch.stack([chunked_lm_loss(hs[c], hd, t[s, c], chunk=4)
                          for c in range(2)])
        gs = torch.autograd.grad((ls * w[s]).sum(), [hs, hd])
        torch.testing.assert_close(losses[s], ls, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(grads[0][s], gs[0], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(grads[1][s], gs[1], atol=1e-6, rtol=1e-6)
