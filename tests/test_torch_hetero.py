"""Per-client cuts on ``sl/vmap`` (``fleet/hetero.py``'s CNN half, the
plan's bucketed engine) and the campaign specs (``fleet/campaign.py``)
against the reference.

- ``HeteroFleet`` on tinycnn at 16x16, cuts [1, 2, 1, 2], 2 local steps,
  batch 4, from the reference's params, batches and masks, 2 rounds, the
  second of which drops the whole cut-1 bucket: losses and every bucket's
  state (both tiers' parameters, optimizer moments, step counters exactly)
  within ``FLEET_EQUIV_ATOL`` of the reference's ``HeteroFleet``, on the
  int8 link's two-op and fused paths; the dropped bucket's state is
  unchanged; the fleet's own surface (live state, ``reset``, the
  refusals).
- Plans: the reference's ``sl_hetero_cut`` variant (``tests/test_api.py:
  61-65``) and an int8 variant at 1 Mb/s with dropout and a mission, which
  drops a whole bucket in its second round: ``cut_of_client`` equal, the
  records equal as ``assert_records_match`` states with each client billed
  at its own cut. The mission's deadline gives the cuts an explicit one
  does (``tests/test_api.py:259-284``); plan states are independent; the
  refusals carry the reference's messages.
- The transformer half (ROADMAP item 17.6): ``stack_split_program`` and
  ``arch_split_program`` on the reference's parameters (carried across by
  ``convert.module_from_reference``), at the reference's own cases
  (``tests/test_fleet.py:368``, ``tests/test_api.py:297``): the smashed
  tensor, the served tensor against one pass over the whole stack, the
  loss and every gradient within 1e-4 in f32, and one fleet round's losses
  within ``FLEET_EQUIV_ATOL``; the MoE refusal; ``assign_cuts_transformer``
  equal to the reference's exactly for a Jetson and an MCU profile.
- The campaign: ``campaign_spec`` equals the reference's field by field,
  ``campaign_totals`` and ``mission_obs_events`` equal the reference's on
  the same records, and the reference's adaptive campaign
  (``tests/test_fleet.py:523-535``) runs with the reference's cuts.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fleet import _assert_state, _assert_tier
from test_torch_harness import assert_records_match, reference_params

import repro.api as R
from repro import configs as ref_configs
from repro.core.energy import HardwareProfile as RefHardwareProfile
from repro.core.energy import JETSON_AGX_ORIN as REF_JETSON
from repro.core.link import LinkConfig as RefLinkConfig
from repro.fleet import CampaignConfig as RefCampaignConfig
from repro.fleet import campaign_spec as ref_campaign_spec
from repro.fleet import campaign_totals as ref_campaign_totals
from repro.fleet.campaign import mission_obs_events as ref_mission_obs_events
from repro.fleet.hetero import HeteroFleet as RefHeteroFleet
from repro.fleet.hetero import cnn_split_program as ref_cnn_split_program
from repro.fleet.link import FleetLink as RefFleetLink
from repro.models.cnn import cross_entropy_loss as ref_cross_entropy
from repro.optim import adamw as ref_adamw
import repro_torch.api as T
from repro_torch import configs
from repro_torch.convert import from_reference
from repro_torch.core.energy import HardwareProfile, JETSON_AGX_ORIN
from repro_torch.core.link import LinkConfig
from repro_torch.fleet.campaign import (CampaignConfig, campaign_spec,
                                        campaign_totals, mission_obs_events)
from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
from repro_torch.fleet.hetero import HeteroFleet, cnn_split_program
from repro_torch.fleet.link import FleetLink
from repro_torch.models.cnn import CNN_BUILDERS, cross_entropy_loss
from repro_torch.optim import FunctionalAdamW

C, S, B = 4, 2, 4          # clients, local steps, batch
CUTS = [1, 2, 1, 2]
LR = 1e-2
# round 1 drops client 1; round 2 drops clients 0 and 2: the cut-1 bucket
MASKS = (np.array([1, 0, 1, 1], np.float32),
         np.array([0, 1, 0, 1], np.float32))
MCU_FIELDS = dict(fp32_tflops=0.02, mem_bw_gbs=2.0, tensor_tflops=0.04,
                  cpu_passmark=400.0, power_w=2.0)
MCU = HardwareProfile("mcu-class", **MCU_FIELDS)
REF_MCU = RefHardwareProfile("mcu-class", **MCU_FIELDS)


# ---------------------------------------------------------------------------
# HeteroFleet against the reference's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup():
    stages, params = reference_params("tinycnn")
    rng = np.random.RandomState(2)
    bx = rng.uniform(0, 1, (len(MASKS), C, S, B, 16, 16, 3)).astype(
        np.float32)
    by = rng.randint(0, 12, (len(MASKS), C, S, B))
    return stages, params, bx, by


@functools.lru_cache(maxsize=None)
def _reference_rounds():
    """The reference fleet's (losses, per-bucket states) after each round,
    copied out as numpy (its engines donate their state)."""
    stages, params, bx, by = _setup()
    link = RefFleetLink(config=RefLinkConfig(compress="int8"))
    fleet = RefHeteroFleet(
        lambda k: ref_cnn_split_program(stages, params, k,
                                        loss_fn=ref_cross_entropy,
                                        link_boundary=link.boundary()),
        CUTS, ref_adamw(LR), ref_adamw(LR), local_rounds=S,
        client_dropout=True)
    states = fleet.init_states()
    out = []
    for r, mask in enumerate(MASKS):
        states, losses = fleet.run_round_on(
            states, {"inputs": jnp.asarray(bx[r]),
                     "targets": jnp.asarray(by[r])}, mask)
        out.append((np.array(losses),
                    jax.tree_util.tree_map(np.array, states)))
    return [b.cut_index for b in fleet.buckets], out


def _port_fleet(kernel: str, **kw) -> HeteroFleet:
    _, params, _, _ = _setup()
    stages = CNN_BUILDERS["tinycnn"](12)
    for st in stages:
        st.to(memory_format=torch.channels_last)
    params0 = from_reference(params, "tinycnn")
    link = FleetLink(config=LinkConfig(compress="int8"), kernel=kernel)
    return HeteroFleet(
        lambda k: cnn_split_program(stages, params0, k,
                                    loss_fn=cross_entropy_loss,
                                    link_boundary=link.boundary("nchw")),
        CUTS, FunctionalAdamW(LR), FunctionalAdamW(LR), local_rounds=S,
        **kw)


def _leaves(tree):
    """Every tensor of a port engine state (dicts, tuples, lists,
    ``OptState``)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return [t for sub in tree for t in _leaves(sub)]


def _batches(r):
    _, _, bx, by = _setup()
    return {"inputs": torch.from_numpy(bx[r]),
            "targets": torch.from_numpy(by[r]).long()}


@pytest.mark.parametrize("kernel", ["xla", "fused"])
def test_hetero_rounds_match_reference(kernel):
    ref_cuts, ref_rounds = _reference_rounds()
    fleet = _port_fleet(kernel, client_dropout=True)
    assert [b.cut_index for b in fleet.buckets] == ref_cuts == [1, 2]
    assert [b.client_ids for b in fleet.buckets] == [(0, 2), (1, 3)]
    assert fleet.cut_of_client == CUTS
    states = fleet.init_states()
    for r, mask in enumerate(MASKS):
        before = states
        states, losses = fleet.run_round_on(states, _batches(r),
                                            torch.from_numpy(mask))
        want_losses, want_states = ref_rounds[r]
        assert losses.shape == (S, C)
        np.testing.assert_allclose(losses.numpy(), want_losses,
                                   atol=FLEET_EQUIV_ATOL, rtol=0)
        for got, want in zip(states, want_states):
            _assert_tier(got[0], want[0], stacked=True)
            _assert_tier(got[1], want[1], stacked=False)
            _assert_state(got[2], want[2], stacked=True)
            _assert_state(got[3], want[3], stacked=False)
    # round 2 dropped the whole cut-1 bucket: its state passed through
    for a, b in zip(_leaves(before[0]), _leaves(states[0])):
        assert torch.equal(a, b)
    assert int(states[0][3].step) == S        # its server: round 1's steps


def test_fleet_live_state_and_fresh_states():
    """``run_round`` on the fleet's own state equals ``run_round_on`` from
    ``init_states()``; ``init_states`` makes new tensors on every call;
    ``reset`` starts over; a mask needs ``client_dropout``."""
    fleet = _port_fleet("xla")
    a, b = fleet.init_states(), fleet.init_states()
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    losses = fleet.run_round(_batches(0))
    _, want = fleet.run_round_on(a, _batches(0))
    torch.testing.assert_close(losses, want, atol=0, rtol=0)
    assert int(fleet.bucket_state(1)[3].step) == S
    fleet.reset()
    assert int(fleet.bucket_state(1)[3].step) == 0
    with pytest.raises(ValueError, match="client_dropout=True"):
        fleet.run_round(_batches(0), MASKS[0])


@pytest.mark.parametrize("kw,exc,match", [
    # HeteroFleet on shard_map runs (on the single-rank mesh here: every
    # collective the identity, so it is the vmap fleet bit for bit)
    (dict(client_axis="shard_map"), None, None),
    (dict(server_reduce="median"), ValueError, "median"),
    (dict(client_axis="scan"), ValueError, "must be 'vmap'"),
])
def test_fleet_refusals(kw, exc, match):
    if exc is None:
        fleet, twin = _port_fleet("xla", **kw), _port_fleet("xla")
        for r in range(len(MASKS)):
            got, want = fleet.run_round(_batches(r)), twin.run_round(
                _batches(r))
            torch.testing.assert_close(got, want, atol=0, rtol=0)
        for x, y in zip(_leaves(fleet.bucket_state(0)),
                        _leaves(twin.bucket_state(0))):
            assert torch.equal(x, y)
        return
    with pytest.raises(exc, match=match):
        _port_fleet("xla", **kw)


def test_build_program_must_keep_the_cut():
    stages = CNN_BUILDERS["tinycnn"](12)
    params0 = from_reference(_setup()[1], "tinycnn")
    with pytest.raises(ValueError, match="different cut"):
        HeteroFleet(lambda k: cnn_split_program(stages, params0, 1,
                                                loss_fn=cross_entropy_loss),
                    [2, 2], FunctionalAdamW(LR), FunctionalAdamW(LR),
                    local_rounds=1)
    with pytest.raises(ValueError, match="outside"):
        cnn_split_program(stages, params0, 3, loss_fn=cross_entropy_loss)


# ---------------------------------------------------------------------------
# plans with per-client cuts
# ---------------------------------------------------------------------------

NUM_CLASSES = 4
N_TRAIN, N_TEST = 96, 24


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, size=(N_TRAIN, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, NUM_CLASSES, size=(N_TRAIN,))
    return x, y, x[:N_TEST], y[:N_TEST]


def _hetero_spec(api, *, rounds=2, dropout=0.0, link=None, mission=None,
                 cut_policy=None, link_kernel="xla", kind="sl",
                 client_axis="vmap"):
    """The reference's ``sl_hetero_cut`` variant (``BASE`` of
    ``tests/test_api.py`` on ``sl/vmap``, adaptive cuts, edges (Jetson,
    MCU)) on arrays, with the fields a case changes."""
    edges = ((JETSON_AGX_ORIN, MCU) if api is T else (REF_JETSON, REF_MCU))
    return api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn", num_classes=NUM_CLASSES),
        data=api.DataSpec(kind="arrays", image_size=16, classes_per_client=2),
        clients=api.ClientSpec(num_clients=C, edge_profiles=edges,
                               dropout_rate=dropout),
        cut_policy=cut_policy or api.CutPolicy(mode="adaptive"),
        link_policy=link or api.LinkPolicy(),
        engine=api.EngineSpec(kind=kind, client_axis=client_axis,
                              link_kernel=link_kernel),
        mission=mission, global_rounds=rounds, local_steps=S, batch_size=B)


def _active_sets(rate, rounds, seed=0):
    """Each round's active clients under the reference's dropout draw
    (``repro/api/plan.py:242-244``)."""
    rng = np.random.RandomState(seed + 1)
    out = []
    for _ in range(rounds):
        mask = rng.uniform(size=C) >= rate
        if not mask.any():
            mask[rng.randint(C)] = True
        out.append(np.flatnonzero(mask))
    return out


CASES = {
    "sl_hetero_cut": dict(),
    "int8-1mbps-dropout-mission": dict(
        rounds=3, dropout=0.3, link_kernel="fused",
        link=dict(compress="int8", rate_bps=1e6), mission=True),
}


def _case_spec(api, case):
    kw = dict(CASES[case])
    if "link" in kw:
        kw["link"] = api.LinkPolicy(**kw["link"])
    if kw.get("mission"):
        kw["mission"] = api.MissionSpec()
    return _hetero_spec(api, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_hetero_plan_records_match_reference(case):
    data = _data()
    ref_plan = R.compile_experiment(_case_spec(R, case), data=data)
    port_plan = T.compile_experiment(_case_spec(T, case), data=data,
                                     device="cpu")
    assert port_plan.cut_of_client == ref_plan.cut_of_client == [2, 1, 2, 1]
    assert sorted(port_plan.flops) == [1, 2]
    port_plan.params0 = from_reference(
        jax.tree_util.tree_map(np.asarray, ref_plan.params0), "tinycnn")
    _, ref_recs = ref_plan.run()
    _, port_recs = port_plan.run()
    rate = port_plan.spec.clients.dropout_rate
    active = _active_sets(rate, len(ref_recs)) if rate else None
    if rate:    # the second round keeps client 1 alone: the cut-2 bucket
        #         is all dropped
        assert [len(a) for a in active] == [3, 1, 4]
    assert_records_match(
        ref_recs, port_recs,
        ref_flops_pair=[ref_plan.flops[k][:2] for k in ref_plan.cut_of_client],
        port_flops_pair=[port_plan.flops[k][:2]
                         for k in port_plan.cut_of_client],
        server_base_s=0.0, n_test=N_TEST,
        ref_consts=(ref_plan._t_client,
                    [e.power_w for e in ref_plan.edges],
                    ref_plan._t_server), active=active)
    assert ([r.active_clients for r in port_recs]
            == [r.active_clients for r in ref_recs])
    assert all(r.engine == "sl/vmap" for r in port_recs)


def test_mission_derives_the_link_deadline():
    """With adaptive cuts and a mission, the UAV's dwell bounds each step's
    link time as an explicit ``max_link_s`` does, and the cuts are the
    reference's."""
    mission = dict(hover_s_per_stop=0.002, comm_s_per_stop=0.002)
    derived = 0.004 / S
    starved = dict(rate_bps=1e6)
    cuts = {}
    for api in (R, T):
        with_mission = _hetero_spec(api, link=api.LinkPolicy(**starved),
                                    mission=api.MissionSpec(**mission))
        explicit = _hetero_spec(api, link=api.LinkPolicy(**starved),
                                cut_policy=api.CutPolicy(
                                    mode="adaptive", max_link_s=derived))
        kw = {} if api is R else dict(device="cpu")
        got = [api.compile_experiment(s, data=_data(), **kw).cut_of_client
               for s in (with_mission, explicit)]
        assert got[0] == got[1]
        cuts[api.__name__] = got[0]
    assert cuts["repro_torch.api"] == cuts["repro.api"]


def test_hetero_plan_states_are_independent():
    """``plan.init()`` gives fresh state on every call: a second init
    neither wipes nor aliases the first run's trained state."""
    plan = T.compile_experiment(_hetero_spec(T), data=_data(), device="cpu")
    s1, _ = plan.run_round(plan.init())
    m1 = plan.evaluate(s1)
    s2 = plan.init()
    assert plan.evaluate(s1) == m1
    assert s2.engine_state is not s1.engine_state
    ptrs = {t.data_ptr() for t in _leaves(s1.engine_state)}
    assert not ptrs & {t.data_ptr() for t in _leaves(s2.engine_state)}
    assert plan.evaluate(s2) == plan.evaluate(plan.init())


def _lm(api, arch):
    return dict(model=api.ModelSpec(family="transformer", arch=arch),
                data=api.DataSpec(kind="tokens", partition="iid", seq_len=8))


REFUSALS = {
    # (spec fields a package; the reference's refusal is the port's)
    "fl-scan": dict(kind="fl", client_axis="scan"),
    "fl-vmap": dict(kind="fl", client_axis="vmap"),
    "sl-scan": dict(kind="sl", client_axis="scan"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_adaptive_cuts_off_the_sl_fleet_are_the_references_refusal(case):
    with pytest.raises(ValueError) as want:
        R.compile_experiment(_hetero_spec(R, **REFUSALS[case]), data=_data())
    with pytest.raises(ValueError) as got:
        T.compile_experiment(_hetero_spec(T, **REFUSALS[case]), data=_data(),
                             device="cpu")
    assert str(got.value) == str(want.value)
    assert "bucketed fleet engine" in str(got.value)


@pytest.mark.parametrize("case", ["population", "transformer"])
def test_adaptive_refusals_carry_the_references_messages(case):
    def spec(api):
        base = _hetero_spec(api)
        if case == "population":
            return dataclasses.replace(base, clients=api.ClientSpec(
                num_clients=C, population=2 * C))
        arch = (configs if api is T else ref_configs).smollm_135m.reduced()
        return dataclasses.replace(base, **_lm(api, arch))
    with pytest.raises(ValueError) as want:
        R.compile_experiment(spec(R), data=None if case == "transformer"
                             else _data())
    with pytest.raises(ValueError) as got:
        T.compile_experiment(spec(T), data=None if case == "transformer"
                             else _data(), device="cpu")
    assert str(got.value) == str(want.value)


def test_shard_map_with_adaptive_cuts_stays_refused():
    """Adaptive cuts on ``sl/shard_map`` are no longer refused: with no
    process group the plan runs its buckets on the single-rank mesh, every
    collective the identity, and its records equal the ``sl/vmap`` plan's
    bit for bit but the engine label (4 gloo ranks:
    ``test_torch_server_mesh.py``)."""
    recs = {}
    for axis in ("shard_map", "vmap"):
        plan = T.compile_experiment(_hetero_spec(T, client_axis=axis),
                                    data=_data(), device="cpu")
        assert plan.cut_of_client == [2, 1, 2, 1]
        recs[axis] = plan.run()[1]
    assert all(r.engine == "sl/shard_map" for r in recs["shard_map"])
    for a, b in zip(recs["shard_map"], recs["vmap"]):
        assert dataclasses.replace(a, engine=b.engine) == b


# ---------------------------------------------------------------------------
# the campaign specs
# ---------------------------------------------------------------------------

def _campaign_cfgs(mod, link_cls, jetson, mcu):
    return {
        "default": mod(),
        "adaptive": mod(model="tinycnn", num_clients=8, global_rounds=1,
                        local_steps=2, batch_size=4, image_size=16,
                        num_classes=NUM_CLASSES, classes_per_client=2,
                        adaptive_cuts=True, edge_profiles=(jetson, mcu)),
        "int8-dropout-cohort": mod(link=link_cls(compress="int8",
                                                 rate_bps=5e6),
                                   dropout_rate=0.25, population=100,
                                   farm_acres=40.0, seed=3),
    }


@pytest.mark.parametrize("case", ["default", "adaptive",
                                  "int8-dropout-cohort"])
def test_campaign_spec_equals_the_references(case):
    got = campaign_spec(_campaign_cfgs(CampaignConfig, LinkConfig,
                                       JETSON_AGX_ORIN, MCU)[case])
    want = ref_campaign_spec(_campaign_cfgs(RefCampaignConfig, RefLinkConfig,
                                            REF_JETSON, REF_MCU)[case])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.describe() == want.describe()


def test_campaign_totals_and_mission_events_equal_the_references():
    """On the reference's records of a 2-round int8 campaign: the totals
    (the return-to-base leg added) and the mission-clock legs."""
    kw = dict(model="tinycnn", num_clients=4, global_rounds=2, local_steps=2,
              batch_size=4, image_size=16, num_classes=NUM_CLASSES,
              classes_per_client=2)
    ref_plan = R.compile_experiment(ref_campaign_spec(RefCampaignConfig(
        link=RefLinkConfig(compress="int8"), **kw)))
    port_plan = T.compile_experiment(campaign_spec(CampaignConfig(
        link=LinkConfig(compress="int8"), **kw)), device="cpu")
    assert port_plan.tour.e_return == ref_plan.tour.e_return
    _, records = ref_plan.run()
    assert campaign_totals(records, port_plan.tour) == \
        ref_campaign_totals(records, ref_plan.tour)
    assert mission_obs_events(port_plan, records) == \
        ref_mission_obs_events(ref_plan, records)
    assert campaign_totals([], None)["uav_energy_j"] == 0.0
    assert mission_obs_events(port_plan, []) == []


def test_adaptive_campaign_runs():
    """The reference's adaptive campaign (``tests/test_fleet.py:523-535``)
    in the port: the reference's cuts, a finite record."""
    cfgs = (_campaign_cfgs(CampaignConfig, LinkConfig, JETSON_AGX_ORIN,
                           MCU)["adaptive"],
            _campaign_cfgs(RefCampaignConfig, RefLinkConfig, REF_JETSON,
                           REF_MCU)["adaptive"])
    plan = T.compile_experiment(campaign_spec(cfgs[0]), device="cpu")
    ref_plan = R.compile_experiment(ref_campaign_spec(cfgs[1]))
    assert plan.cut_of_client == ref_plan.cut_of_client
    assert len(plan.cut_of_client) == 8
    assert all(k >= 1 for k in plan.cut_of_client)
    _, records = plan.run()
    assert len(records) == 1 and np.isfinite(records[0].loss)
    totals = campaign_totals(records, plan.tour)
    assert totals["uav_energy_j"] == pytest.approx(
        records[0].uav_energy_j + plan.tour.e_return)


# ---------------------------------------------------------------------------
# the transformer half: stack and arch split programs, transformer cuts
# ---------------------------------------------------------------------------

TOL = 1e-4


class _Dense(torch.nn.Module):
    """The reference test's stacked block ``tanh(h @ w + b)``, one layer."""

    def __init__(self, w: np.ndarray, b: np.ndarray):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(np.array(w)))
        self.b = torch.nn.Parameter(torch.from_numpy(np.array(b)))


def _mse(h, targets):
    return ((h.mean(-1) - targets) ** 2).mean()


def _ref_mse(h, targets):
    return jnp.mean((h.mean(-1) - targets) ** 2)


def _grads_close(module, want_rows, rows_of):
    """Every parameter gradient of a port block stack against the
    reference's stacked gradient tree (row ``i`` for block ``i``)."""
    for i, block in enumerate(module):
        want = rows_of(jax.tree_util.tree_map(lambda v: np.asarray(v[i]),
                                              want_rows))
        got = dict(block.named_parameters())
        assert set(got) == set(want)
        for name, p in got.items():
            np.testing.assert_allclose(p.grad.numpy(), want[name],
                                       atol=TOL, rtol=TOL, err_msg=name)


def _port_step_grads(prog, batch):
    for p in list(prog.client.parameters()) + list(prog.server.parameters()):
        p.grad = None
    loss, _ = prog.step.loss_fn(prog.client, prog.server, batch)
    loss.backward()
    return loss


def _ref_step_grads(prog, batch):
    def total(pc, ps):
        return prog.step.server_loss(ps, prog.step.client_fwd(
            pc, batch["inputs"]), batch["targets"])[0]
    return jax.jit(jax.value_and_grad(total, argnums=(0, 1)))(
        prog.params_c0, prog.params_s0)


def _fleet_round_losses(prog, ref_prog, bx, by, lr):
    """One fleet round of the port's and the reference's program from
    their own initial parameters (equal by construction)."""
    from repro.fleet.engine import make_fleet_sl_round as ref_round
    from repro.optim import init_stacked
    from repro_torch.core.split import make_split_loss
    from repro_torch.fleet.engine import fleet_state, make_fleet_sl_round
    n, steps = bx.shape[:2]
    opt_c, opt_s = FunctionalAdamW(lr), FunctionalAdamW(lr)
    run = make_fleet_sl_round(
        make_split_loss(prog.step, prog.client, prog.server), opt_c, opt_s,
        local_rounds=steps)
    *_, losses = run(*fleet_state(prog.params_c0, prog.params_s0, opt_c,
                                  opt_s, n),
                     {"inputs": torch.from_numpy(bx),
                      "targets": torch.from_numpy(by)})
    ropt_c, ropt_s = ref_adamw(lr), ref_adamw(lr)
    engine = jax.jit(ref_round(ref_prog.step, ropt_c, ropt_s,
                               local_rounds=steps))
    stack = jax.tree_util.tree_map(
        lambda v: jnp.broadcast_to(v[None], (n,) + v.shape),
        ref_prog.params_c0)
    *_, want = engine(stack, ref_prog.params_s0,
                      init_stacked(ropt_c, ref_prog.params_c0, n),
                      ropt_s.init(ref_prog.params_s0),
                      {"inputs": jnp.asarray(bx), "targets": jnp.asarray(by)})
    np.testing.assert_allclose(losses.numpy(), np.asarray(want),
                               atol=FLEET_EQUIV_ATOL, rtol=0)
    assert losses.shape == (steps, n)


def test_stack_split_program_matches_reference():
    """The reference's case (``tests/test_fleet.py:368``): L 6 blocks of
    ``tanh(h @ w + b)`` cut at 2, from the reference's parameters."""
    from repro.fleet.hetero import stack_split_program as ref_program
    from repro_torch.fleet.hetero import stack_split_program
    L, D, Bz = 6, 8, 4
    key = jax.random.PRNGKey(0)
    stacked = {"w": 0.3 * jax.random.normal(key, (L, D, D)),
               "b": 0.1 * jax.random.normal(jax.random.fold_in(key, 4),
                                            (L, D))}
    ref = ref_program(stacked, 2, block_apply=lambda blk, h: jnp.tanh(
        h @ blk["w"] + blk["b"]), loss_fn=_ref_mse)
    blocks = torch.nn.ModuleList(
        _Dense(np.asarray(stacked["w"][i]), np.asarray(stacked["b"][i]))
        for i in range(L))
    prog = stack_split_program(blocks, 2, block_apply=lambda blk, h: torch.tanh(
        h @ blk.w + blk.b), loss_fn=_mse)
    assert prog.cut_index == 2 and len(prog.client) == 2
    assert set(prog.params_c0) == {"0.w", "0.b", "1.w", "1.b"}
    x = np.array(jax.random.normal(jax.random.fold_in(key, 1), (Bz, D)))
    y = np.array(jax.random.normal(jax.random.fold_in(key, 2), (Bz,)))
    smashed = prog.step.client_fwd(prog.client, torch.from_numpy(x))
    want_sm = ref.step.client_fwd(ref.params_c0, jnp.asarray(x))
    np.testing.assert_allclose(smashed.detach().numpy(), want_sm, atol=TOL,
                               rtol=TOL)
    # the same function serves either tier: the server's blocks on the
    # smashed tensor are the whole stack's pass
    full = torch.from_numpy(x)
    for block in blocks:
        full = torch.tanh(full @ block.w + block.b)
    served = prog.step.client_fwd(prog.server, smashed)
    torch.testing.assert_close(served, full, atol=1e-6, rtol=1e-5)
    batch = {"inputs": torch.from_numpy(x), "targets": torch.from_numpy(y)}
    loss = _port_step_grads(prog, batch)
    want_loss, (g_c, g_s) = _ref_step_grads(
        ref, {"inputs": jnp.asarray(x), "targets": jnp.asarray(y)})
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=TOL, rtol=TOL)
    _grads_close(prog.client, g_c, dict)
    _grads_close(prog.server, g_s, dict)
    rng = np.random.RandomState(3)
    _fleet_round_losses(prog, ref, rng.randn(C, S, Bz, D).astype(np.float32),
                        rng.randn(C, S, Bz).astype(np.float32), 1e-2)


def _tiny_arch(mod):
    return mod.base.ArchConfig(name="tiny-attn", family="dense", n_layers=4,
                               d_model=16, n_heads=2, n_kv_heads=2, d_ff=32,
                               vocab=64, dtype="float32")


def _attn_rows(cfg):
    """A reference attention layer's tree (no layer axis) -> the port's
    ``AttnLayer`` state dict, through ``convert.module_from_reference``."""
    from repro_torch.convert import module_from_reference
    from repro_torch.models.transformer import AttnLayer

    def rows_of(tree):
        with torch.device("meta"):
            layer = AttnLayer(cfg)
        return {k: v.numpy() for k, v in
                module_from_reference(tree, layer).state_dict().items()}
    return rows_of


@functools.lru_cache(maxsize=None)
def _ref_arch_case():
    """The reference's case (``tests/test_api.py:297``) as numpy: its
    4-layer dense attention stack cut at 2 (``arch_split_program``), an
    input and targets, the smashed tensor, one ``group_apply`` pass over
    the whole stack, the loss and both tiers' gradients."""
    from repro.fleet.hetero import arch_split_program as ref_program
    from repro.models.transformer import GroupSpec as RefGroupSpec
    from repro.models.transformer import group_apply as ref_group_apply
    cfg = _tiny_arch(ref_configs)
    key = jax.random.PRNGKey(0)
    ref = ref_program(cfg, key, 2, loss_fn=_ref_mse)
    Bz, Sq = 2, 8
    x = 0.5 * jax.random.normal(jax.random.fold_in(key, 1),
                                (Bz, Sq, cfg.d_model))
    y = jax.random.normal(jax.random.fold_in(key, 3), (Bz, Sq))
    whole = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]),
                                   ref.params_c0, ref.params_s0)
    full, _ = ref_group_apply(
        cfg, RefGroupSpec("attn", cfg.n_layers, 0), whole, x,
        jnp.zeros((), jnp.float32),
        positions=jnp.broadcast_to(jnp.arange(Sq, dtype=jnp.int32),
                                   (Bz, Sq)), window=cfg.swa_window)
    loss, grads = _ref_step_grads(ref, {"inputs": x, "targets": y})
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (to_np((ref.params_c0, ref.params_s0)), np.asarray(x),
            np.asarray(y), np.asarray(ref.step.client_fwd(ref.params_c0, x)),
            np.asarray(full), float(loss), to_np(grads))


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_arch_split_program_matches_reference(attn_impl):
    """``arch_split_program``'s blocks loaded with the reference's
    parameters (``_ref_arch_case``); the port's attention on its chunked
    plain path and on the flash kernel's plain version against the
    reference's ``xla`` path: smashed, served, loss and gradients."""
    from repro_torch.fleet.hetero import arch_split_program
    cfg = _tiny_arch(configs)
    params, x, y, want_sm, want_full, want_loss, (g_c, g_s) = \
        _ref_arch_case()
    prog = arch_split_program(cfg, torch.Generator().manual_seed(0), 2,
                              loss_fn=_mse, attn_impl=attn_impl)
    rows_of = _attn_rows(cfg)
    for tier, tree in zip((prog.client, prog.server), params):
        for i, block in enumerate(tier):
            block.load_state_dict({k: torch.from_numpy(v) for k, v in rows_of(
                jax.tree_util.tree_map(lambda a: a[i], tree)).items()})
    smashed = prog.step.client_fwd(prog.client, torch.from_numpy(x))
    assert smashed.shape == x.shape
    np.testing.assert_allclose(smashed.detach().numpy(), want_sm, atol=TOL,
                               rtol=TOL)
    served = prog.step.client_fwd(prog.server, smashed)
    np.testing.assert_allclose(served.detach().numpy(), want_full,
                               atol=TOL, rtol=TOL)
    loss = _port_step_grads(prog, {"inputs": torch.from_numpy(x),
                                   "targets": torch.from_numpy(y)})
    np.testing.assert_allclose(float(loss.detach()), want_loss, atol=TOL,
                               rtol=TOL)
    _grads_close(prog.client, g_c, rows_of)
    _grads_close(prog.server, g_s, rows_of)


def test_arch_split_program_refuses_moe_and_outside_cuts():
    from repro.fleet.hetero import arch_split_program as ref_program
    from repro_torch.fleet.hetero import arch_split_program
    moe = dataclasses.replace(_tiny_arch(configs), n_experts=4, top_k=2)
    ref_moe = dataclasses.replace(_tiny_arch(ref_configs), n_experts=4,
                                  top_k=2)
    with pytest.raises(ValueError) as want:
        ref_program(ref_moe, jax.random.PRNGKey(0), 2, loss_fn=_ref_mse)
    with pytest.raises(ValueError) as got:
        arch_split_program(moe, torch.Generator(), 2, loss_fn=_mse)
    assert str(got.value) == str(want.value)
    for k in (0, 4):
        with pytest.raises(ValueError, match="outside"):
            arch_split_program(_tiny_arch(configs), torch.Generator(), k,
                               loss_fn=_mse)


@pytest.mark.parametrize("name,batch,seq", [("smollm-135m", 8, 1024),
                                            ("rwkv6-7b", 4, 1024),
                                            ("deepseek-moe-16b", 2, 64)])
def test_assign_cuts_transformer_equals_the_references(name, batch, seq):
    """Per-client cuts for a Jetson and the MCU profile of
    ``tests/test_analyze.py:321``, on the default link, a starved int8 one
    and under a link deadline: equal lists."""
    from repro.fleet.hetero import assign_cuts_transformer as ref_assign
    from repro_torch.fleet.hetero import assign_cuts_transformer
    edges, ref_edges = [JETSON_AGX_ORIN, MCU] * 2, [REF_JETSON, REF_MCU] * 2
    for link in (None, dict(rate_bps=1e6, compress="int8")):
        for max_link_s in (None, 0.5):
            kw = dict(batch=batch, seq=seq, max_link_s=max_link_s)
            got = assign_cuts_transformer(
                configs.ARCHS[name], edges=edges,
                links=None if link is None else [LinkConfig(**link)] * 4, **kw)
            want = ref_assign(
                ref_configs.ARCHS[name], edges=ref_edges,
                links=None if link is None else [RefLinkConfig(**link)] * 4,
                **kw)
            assert got == list(want)
            assert len(got) == 4 and got[0] == got[2] and got[1] == got[3]
