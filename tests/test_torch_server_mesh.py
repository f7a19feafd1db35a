"""The server sub-mesh (``EngineSpec.server_mesh``), a ``vmap`` plan over
more than one rank, and ``HeteroFleet`` on ``shard_map``, on 4 gloo ranks
of the CPU against the reference on 4 forced host devices.

The reference's fleet mesh is ``('data', 'fsdp', 'tp')``; with
``server_mesh=(fsdp, tp)`` its server suffix's params and AdamW moments
are sharded over the ``(fsdp, tp)`` sub-mesh by
``launch.steps.fleet_server_pspecs`` and the clients over ``data``. The
port holds that state as DTensors on the same sub-mesh of a
``DeviceMesh`` (``launch.mesh.make_fleet_mesh``) and computes each step
on plain tensors (``fleet.engine``). Its contract (``repro/api/README.md``)
is shard_map == vmap within ``FLEET_EQUIV_ATOL``.

- The reference runs once, in one subprocess with
  ``--xla_force_host_platform_device_count=4``: tinycnn ``sl/vmap`` plans
  (8 clients, an int8 link, 2 rounds of 2 local steps) with
  ``server_mesh`` None, (2, 1), (1, 2) and (2, 2), and adaptive cuts with
  (2, 1) on two edge mixes (buckets of 4 and 4, which shard over
  ``data``, and of 3 and 5, which take the reference's
  ``_server_only_mesh``).
- The port runs once, in one spawn of 4 gloo ranks
  (``torch_rank_cases.server_mesh_cases``): the same specs on ``sl/vmap``,
  ``sl/shard_map`` with (2, 1), a ``vmap`` plan over the 4-rank mesh and
  ``HeteroFleet`` on ``shard_map`` with (2, 1). The two run side by side.
- Gates: each record within ``FLEET_EQUIV_ATOL`` of the reference's (wire
  bytes exactly), the gathered final state too; the shard_map and hetero
  cases against the reference's ``vmap`` (its shard_map engines do not
  run under jax 0.9). The server params and both moments are
  DTensors whose placements, mapped back through ``convert``'s layout,
  are the reference's ``fleet_server_pspecs`` leaf by leaf; each rank's
  shard of a moment is the slice of the whole moment, and of the
  unsharded run's.
- The Monte-Carlo seed axis over the sharded server: the reference's
  second subprocess also sweeps the (2, 1) plan under a stochastic
  scenario with ``run_monte_carlo(mode="loop")`` (its vmap sweep of a
  sharded plan fails under jax 0.9) and the unsharded plan with
  ``mode="vmap"``, 2 seeds x 2 rounds; the port's spawn sweeps (2, 1),
  (2, 2), ``shard_map`` at (2, 1) and the unsharded plan in ``vmap``
  mode on the reference's per-seed draws. Each seed's records within
  ``FLEET_EQUIV_ATOL`` of both reference sweeps; the server state after
  the sweep seed-stacked DTensors, the reference's placements shifted by
  the seed axis, each rank's shard the slice of the whole, each seed's
  gathered state the unsharded sweep's; ``HeteroFleet`` plans refuse.

The reference refuses ``sl/shard_map`` with fsdp * tp > 1 on its CPU
backend only, for an abort of its XLA:CPU partitioner (``repro/api/
plan.py:659-669``); the port has no such abort, so its ``shard_map``
cases run here and are held against the reference's ``vmap``.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import torch_rank_cases as RC
from test_torch_fleet import _flat, _tier
from test_torch_harness import (assert_records_match, reference_env_draws,
                                reference_params)

from repro.core.split import init_stages as ref_init_stages
from repro.launch.mesh import abstract_mesh as ref_abstract_mesh
from repro.launch.steps import fleet_server_pspecs as ref_server_pspecs
from repro.models.cnn import CNN_BUILDERS as REF_BUILDERS
from repro_torch.convert import from_reference
from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.steps import (fleet_server_pspecs, reference_dims,
                                      server_placements)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N_TRAIN, N_TEST = 96, 24
ODD = "jmjmjmjj"           # cuts [2, 1, 2, 1, 2, 1, 2, 2]: buckets of 3, 5

# the reference's plans (all sl/vmap), by name
REF_CASES = {
    "none": dict(),
    "21": dict(server_mesh=(2, 1)),
    "12": dict(server_mesh=(1, 2)),
    "22": dict(server_mesh=(2, 2)),
    "ad21": dict(server_mesh=(2, 1), edges="jm"),
    "odd21": dict(server_mesh=(2, 1), edges=ODD),
}
# the port's plans, and the reference plan each is held against
PORT_CASES = {
    "none": dict(axis="vmap"),
    "21": dict(axis="vmap", server_mesh=(2, 1)),
    "12": dict(axis="vmap", server_mesh=(1, 2)),
    "22": dict(axis="vmap", server_mesh=(2, 2)),
    "ad21": dict(axis="vmap", server_mesh=(2, 1), edges="jm"),
    "odd21": dict(axis="vmap", server_mesh=(2, 1), edges=ODD),
    "sm21": dict(axis="shard_map", server_mesh=(2, 1)),
    "vmap-ranks": dict(axis="vmap", vmap_over_ranks=True),
    "explicit-ranks": dict(axis="vmap", vmap_over_ranks=True,
                           explicit=True),
    "hetero-sm21": dict(axis="shard_map", server_mesh=(2, 1), edges="jm"),
    "hetero-odd-sm21": dict(axis="shard_map", server_mesh=(2, 1),
                            edges=ODD),
}
AGAINST = {"sm21": "21", "vmap-ranks": "none", "explicit-ranks": "none",
           "hetero-sm21": "ad21", "hetero-odd-sm21": "odd21"}
MESHES = {"none": None, "21": (2, 2, 1), "12": (2, 1, 2), "22": (1, 2, 2),
          "vmap-ranks": (4, 1, 1), "explicit-ranks": (4, 1, 1)}
# the Monte-Carlo sweeps under the stochastic scenario, MC_SEEDS seeds x 2
# rounds: the reference's loop sweep of the (2, 1) plan (its vmap sweep
# of a sharded plan fails under jax 0.9) and its vmap sweep of the
# unsharded plan; the port's vmap sweep on the reference's per-seed draws
MC_SEEDS = 2
REF_CASES.update({"mc21": dict(server_mesh=(2, 1), stoch=True, mc="loop"),
                  "mcnone": dict(stoch=True, mc="vmap")})
MC_CASES = {
    "mc21": dict(axis="vmap", server_mesh=(2, 1), stoch=True),
    "mc22": dict(axis="vmap", server_mesh=(2, 2), stoch=True),
    "mcsm21": dict(axis="shard_map", server_mesh=(2, 1), stoch=True),
    "mcnone": dict(axis="vmap", stoch=True),
}
MC_MESHES = {"mc21": (2, 2, 1), "mc22": (1, 2, 2), "mcsm21": (2, 2, 1),
             "mcnone": None}

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import pickle, sys
    import jax
    import numpy as np
    import repro.api as R
    import repro.sim as RS
    from repro.core.energy import JETSON_AGX_ORIN, HardwareProfile

    data_path, out_path, cases, mcu_fields = pickle.load(
        open(sys.argv[1], "rb"))
    d = np.load(data_path)
    data = (d["x"], d["y"], d["x"][:{n_test}], d["y"][:{n_test}])
    mcu = HardwareProfile("mcu-class", **mcu_fields)
    out = {{}}
    for name, case in cases.items():
        edges = case.get("edges", "j")
        adaptive = len(set(edges)) > 1
        spec = R.ExperimentSpec(
            model=R.ModelSpec(name="tinycnn", num_classes=4),
            data=R.DataSpec(kind="arrays", image_size=16,
                            classes_per_client=2),
            clients=R.ClientSpec(num_clients=8, edge_profiles=tuple(
                JETSON_AGX_ORIN if e == "j" else mcu for e in edges)),
            cut_policy=(R.CutPolicy(mode="adaptive") if adaptive
                        else R.CutPolicy(fraction=0.4)),
            link_policy=R.LinkPolicy(
                compress="int8", **({{"rate_bps": 1e6}} if adaptive else {{}})),
            engine=R.EngineSpec(kind="sl", client_axis="vmap",
                                link_kernel="fused",
                                server_mesh=case.get("server_mesh")),
            mission=R.MissionSpec() if case.get("stoch") else None,
            scenario=RS.ScenarioSpec(
                channel=RS.ChannelParams(kind="a2g"),
                availability=RS.AvailabilityParams(
                    kind="markov", p_drop=0.4, p_recover=0.6),
                num_uavs=2, serve_mode="relay", seed=1)
            if case.get("stoch") else None,
            global_rounds=2, local_steps=2, batch_size=4)
        plan = R.compile_experiment(spec, data=data)
        if case.get("mc"):
            mc = RS.run_monte_carlo(plan, {mc_seeds}, rounds=2,
                                    mode=case["mc"])
            out[name] = {{
                "records": [mc.records_for_seed(i)
                            for i in range({mc_seeds})],
                "stacks": {{k: np.asarray(v) for k, v in mc.stacks.items()}},
                "cuts": list(plan.cut_of_client),
                "flops": {{k: tuple(float(f) for f in v[:2])
                          for k, v in plan.flops.items()}},
                "mesh": (None if plan.mesh is None else
                         tuple(int(s) for s in plan.mesh.devices.shape))}}
            continue
        state, recs = plan.run()
        out[name] = {{
            "records": recs, "cuts": list(plan.cut_of_client),
            "state": jax.tree_util.tree_map(np.asarray, state.engine_state),
            "flops": {{k: tuple(float(f) for f in v[:2])
                      for k, v in plan.flops.items()}},
            "consts": (np.asarray(plan._t_client),
                       [e.power_w for e in plan.edges],
                       np.asarray(plan._t_server)),
            "mesh": (None if plan.mesh is None else
                     tuple(int(s) for s in plan.mesh.devices.shape)),
            "params0": jax.tree_util.tree_map(np.asarray, plan.params0)}}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
""").format(n_test=N_TEST, mc_seeds=MC_SEEDS)


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, size=(N_TRAIN, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, 4, size=(N_TRAIN,))
    return x, y, x[:N_TEST], y[:N_TEST]


def _ref_params0():
    """The reference plan's ``params0`` (``init_stages`` at the spec's seed
    0), as numpy."""
    return jax.tree_util.tree_map(np.asarray, ref_init_stages(
        jax.random.PRNGKey(0), REF_BUILDERS["tinycnn"](4)))


def _mc_draws() -> list:
    """The reference's environment draws of each sweep seed (scenario seed
    1 + i), as the port's ``EnvDraws``."""
    return [reference_env_draws(1 + i, 2, mask_n=8, rates_n=8)
            for i in range(MC_SEEDS)]


# the reference's plans run in two subprocesses side by side (each about
# half of its compile time)
REF_GROUPS = (("none", "21", "12", "22"),
              ("ad21", "odd21", "mc21", "mcnone"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocesses and the port's 4-rank spawn, side by
    side: ``(reference, port)``, each a dict by case name."""
    tmp = tmp_path_factory.mktemp("server-mesh")
    x, y, _, _ = _data()
    data_path = str(tmp / "data.npz")
    np.savez(data_path, x=x, y=y)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = []
    for i, names in enumerate(REF_GROUPS):
        args_path, out_path = str(tmp / f"args{i}.pkl"), str(tmp / f"ref{i}.pkl")
        with open(args_path, "wb") as f:
            pickle.dump((data_path, out_path,
                         {k: REF_CASES[k] for k in names}, RC.MCU_FIELDS), f)
        procs.append((subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, args_path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            out_path))
    try:
        params0 = [{k: v.numpy() for k, v in stage.items()}
                   for stage in from_reference(_ref_params0(), "tinycnn")]
        port = run_ranks(RC.server_mesh_cases, 4, str(tmp),
                         args=(dict(PORT_CASES, **MC_CASES),
                               {"data": _data(), "params0": params0,
                                "mc_draws": _mc_draws()}),
                         timeout_s=240.0)
        reference = {}
        for proc, out_path in procs:
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            with open(out_path, "rb") as f:
                reference.update(pickle.load(f))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return reference, port


def _ref_state_in_port_layout(state, cuts: list) -> list:
    """The reference's final state (a bucket tuple, or a list of them) as
    the port's numpy trees, bucket by bucket."""
    buckets = state if isinstance(state, list) else [state]

    def opt(o, stacked):
        return {"step": np.asarray(o.step),
                "mu": {k: v.numpy() for k, v in _tier(o.mu, stacked).items()},
                "nu": {k: v.numpy() for k, v in _tier(o.nu, stacked).items()}}
    return [({k: v.numpy() for k, v in _tier(pc, True).items()},
             {k: v.numpy() for k, v in _tier(ps, False).items()},
             opt(oc, True), opt(os_, False)) for pc, ps, oc, os_ in buckets]


def _close(got, want, what):
    """Numpy trees within ``FLEET_EQUIV_ATOL``; step counters equal."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
    elif isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            if k == "step":
                np.testing.assert_array_equal(got[k], want[k], err_msg=what)
            else:
                _close(got[k], want[k], f"{what}.{k}")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   atol=FLEET_EQUIV_ATOL, rtol=0,
                                   err_msg=what)


# ---------------------------------------------------------------------------
# records and state against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PORT_CASES))
def test_plan_matches_the_reference(runs, name):
    """Every port case against the reference's ``vmap`` plan of its spec
    (its own ``server_mesh``): records within ``FLEET_EQUIV_ATOL``, wire
    bytes and the host's fields exactly, the gathered final state within
    the tolerance, the meshes the reference's, one int8 launch a local
    step a bucket on every rank."""
    reference, port = runs
    case = PORT_CASES[name]
    ref = reference[AGAINST.get(name, name)]
    got = port[name]
    np.testing.assert_equal(
        ref["params0"], _ref_params0(), err_msg="the reference's params0")
    assert got["cuts"] == ref["cuts"]
    want_mesh = MESHES.get(name, (2, 2, 1))
    if name in reference:
        assert ref["mesh"] == want_mesh
    assert [r["mesh"] for r in got["ranks"]] == [
        None if want_mesh is None
        else dict(zip(("data", "fsdp", "tp"), want_mesh))] * 4
    label = f"sl/{case['axis']}"
    assert all(r.engine == label for r in got["records"])
    if len(set(ref["cuts"])) > 1:
        kw = dict(ref_flops_pair=[ref["flops"][k] for k in ref["cuts"]],
                  port_flops_pair=[got["flops"][k] for k in got["cuts"]],
                  ref_consts=ref["consts"])
    else:
        k = ref["cuts"][0]
        kw = dict(ref_flops_pair=ref["flops"][k],
                  port_flops_pair=got["flops"][k])
    assert_records_match(
        [dataclasses.replace(r, engine=label) for r in ref["records"]],
        got["records"], server_base_s=0.0, n_test=N_TEST, **kw)
    _close(got["state"], _ref_state_in_port_layout(ref["state"],
                                                   ref["cuts"]),
           f"{name} state")
    buckets = len(set(ref["cuts"]))
    assert [len(r["calls"]) for r in got["ranks"]] == [2 * 2 * buckets] * 4


# ---------------------------------------------------------------------------
# placements and shards
# ---------------------------------------------------------------------------

def _ref_axes(placements, ndim: int) -> tuple:
    """A port leaf's placements over (fsdp, tp) as the reference's spec
    entries, dim by dim of the reference's layout."""
    port = [None] * ndim
    for axis, p in zip(("fsdp", "tp"), placements):
        if p[0] == "S":
            port[p[1]] = axis
    return tuple(port[d] for d in reference_dims(ndim))


def _padded(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


SHARDED = [n for n, c in PORT_CASES.items() if c.get("server_mesh")]


@pytest.mark.parametrize("name", SHARDED)
def test_server_state_is_dtensors_placed_as_the_reference(runs, name):
    """On every rank the server params and both moments are DTensors on
    the ``(fsdp, tp)`` sub-mesh whose placements, mapped back through the
    HWIO -> OIHW layout, are the reference's ``fleet_server_pspecs`` of
    the same leaf; the step counter is replicated."""
    _, port = runs
    got = port[name]
    f, t = PORT_CASES[name]["server_mesh"]
    ref_mesh = ref_abstract_mesh((1, f, t), ("data", "fsdp", "tp"))
    params0 = _ref_params0()
    cuts = sorted(set(got["cuts"]))
    for rank in got["ranks"]:
        for k, local in zip(cuts, rank["locals"]):
            assert local is not None, (name, k)
            specs = ref_server_pspecs(params0[k:], ref_mesh)
            want = {key: tuple(s) for key, s in _flat_specs(specs)}
            assert local["step"] == [("R",), ("R",)]
            for side in ("params", "mu", "nu"):
                assert set(local[side]) == set(want)
                for key, leaf in local[side].items():
                    ndim = leaf["local"].ndim
                    assert leaf["sizes"] == (f, t)
                    assert _ref_axes(leaf["placements"], ndim) == \
                        _padded(want[key], ndim), (name, side, key)


def _flat_specs(specs):
    """The reference's spec tree (a list of stage dicts) keyed as the
    port's tier dict."""
    is_p = (lambda s: isinstance(s, jax.sharding.PartitionSpec))
    for i, tree in enumerate(specs):
        flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_p)[0]
        for path, s in flat:
            key = ".".join(str(getattr(p, "key", p)) for p in path)
            yield f"{i}.body.{key}", s


def _slice(full: np.ndarray, leaf: dict) -> np.ndarray:
    for (kind, *dim), c, n in zip(leaf["placements"], leaf["coord"],
                                  leaf["sizes"]):
        if kind == "S":
            w = full.shape[dim[0]] // n
            full = np.take(full, range(c * w, (c + 1) * w), axis=dim[0])
    return full


@pytest.mark.parametrize("name", SHARDED)
def test_each_rank_holds_the_slice_of_the_moments(runs, name):
    """Each rank's shard of the params and of both moments is exactly its
    slice of the whole (gathered) tensors, and within the tolerance the
    slice of the unsharded run's (the port's ``server_mesh=None`` plan; the
    reference's for the adaptive cuts)."""
    reference, port = runs
    got = port[name]
    if got["cuts"] == port["none"]["cuts"]:
        unsharded = port["none"]["state"]
    else:
        ref = reference[AGAINST.get(name, name)]
        unsharded = _ref_state_in_port_layout(ref["state"], ref["cuts"])
    for rank in got["ranks"]:
        for b, local in enumerate(rank["locals"]):
            _, ps, _, os_ = got["state"][b]
            _, ps_u, _, os_u = unsharded[b]
            for side, whole, base in (("params", ps, ps_u),
                                      ("mu", os_["mu"], os_u["mu"]),
                                      ("nu", os_["nu"], os_u["nu"])):
                for key, leaf in local[side].items():
                    np.testing.assert_array_equal(
                        leaf["local"], _slice(whole[key], leaf),
                        err_msg=f"{name} {side} {key}")
                    want = _slice(base[key], leaf)
                    scale = float(np.abs(want).max()) or 1.0
                    np.testing.assert_allclose(
                        leaf["local"], want, rtol=FLEET_EQUIV_ATOL,
                        atol=FLEET_EQUIV_ATOL * scale,
                        err_msg=f"{name} {side} {key} vs unsharded")


def test_unsharded_and_data_only_cases_keep_plain_server_state(runs):
    """No server sub-mesh, no DTensor: ``server_mesh=None`` and a ``vmap``
    plan over a data-only mesh keep plain tensors, as the reference
    replicates its server suffix there."""
    _, port = runs
    for name in ("none", "vmap-ranks"):
        assert all(loc is None for rank in port[name]["ranks"]
                   for loc in rank["locals"])


def test_server_pspecs_place_the_server_on_a_one_rank_sub_mesh(runs):
    """``compile_experiment(server_pspecs=)`` places the server state by
    the function given, even on a sub-mesh of one rank, where the
    reference's rule places nothing: every rank holds DTensors sharded
    on the size-1 ``fsdp`` axis, whole (the plan's records and state are
    held to the reference's unsharded plan above). A plan with no fleet
    mesh has no server to place and refuses the argument."""
    import repro_torch.api as T
    _, port = runs
    for rank in port["explicit-ranks"]["ranks"]:
        for local in rank["locals"]:
            assert local is not None
            assert local["step"] == [("R",), ("R",)]
            for side in ("params", "mu", "nu"):
                for key, leaf in local[side].items():
                    assert leaf["sizes"] == (1, 1)
                    assert leaf["placements"] == (
                        [("S", 0), ("R",)] if leaf["local"].ndim
                        else [("R",), ("R",)]), (side, key)
    with pytest.raises(ValueError, match="server_pspecs"):
        T.compile_experiment(RC.server_mesh_spec(dict(axis="vmap")),
                             device="cpu", server_pspecs=RC.dim0_over_fsdp)


def test_ranks_import_no_jax(runs):
    _, port = runs
    assert port["jax"] == [False] * 4


# ---------------------------------------------------------------------------
# the Monte-Carlo seed axis over the sharded server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MC_CASES))
def test_sweep_matches_the_references_sweeps(runs, name):
    """The port's ``run_monte_carlo(mode="vmap")`` on the reference's
    per-seed draws, seed by seed, against the reference's loop sweep of
    the (2, 1) plan and its vmap sweep of the unsharded plan: losses
    within ``FLEET_EQUIV_ATOL``, wire bytes, active clients and cohort
    ids exactly, the bills by the billing arithmetic; the masks equal the
    unsharded sweep's; the meshes; ONE int8 call a local step for all
    seeds and clients on every rank, the warm-up round's included."""
    reference, port = runs
    got = port[name]
    label = f"sl/{MC_CASES[name]['axis']}"
    k = got["cuts"][0]
    for against in ("mc21", "mcnone"):
        ref = reference[against]
        assert got["cuts"] == ref["cuts"]
        np.testing.assert_array_equal(got["stacks"]["active_clients"],
                                      ref["stacks"]["active_clients"])
        for i in range(MC_SEEDS):
            assert all(r.engine == label for r in got["records"][i])
            assert_records_match(
                [dataclasses.replace(r, engine=label)
                 for r in ref["records"][i]], got["records"][i],
                ref_flops_pair=ref["flops"][k],
                port_flops_pair=got["flops"][k], server_base_s=0.0,
                n_test=N_TEST, loss_atol=FLEET_EQUIV_ATOL, link_rel=1e-6)
    assert reference["mc21"]["mesh"] == (2, 2, 1)
    assert reference["mcnone"]["mesh"] is None
    assert len(np.unique(got["stacks"]["active_clients"])) > 1
    np.testing.assert_array_equal(got["stacks"]["mask"],
                                  port["mcnone"]["stacks"]["mask"])
    want_mesh = MC_MESHES[name]
    assert [r["mesh"] for r in got["ranks"]] == [
        None if want_mesh is None
        else dict(zip(("data", "fsdp", "tp"), want_mesh))] * 4
    assert [len(r["calls"]) for r in got["ranks"]] == [(1 + 2) * 2] * 4


SHARDED_MC = [n for n, c in MC_CASES.items() if c.get("server_mesh")]


@pytest.mark.parametrize("name", SHARDED_MC)
def test_sweep_server_state_is_seed_stacked_shards(runs, name):
    """After the sweep the server params and both moments are DTensors
    whose placements are the reference's ``fleet_server_pspecs`` shifted
    by the seed axis (dim 0 never sharded), the step counter a replicated
    (seeds,) tensor; each rank's shard of every seed's tensors is exactly
    its slice of the whole, and each seed's gathered final state is the
    unsharded sweep's within ``FLEET_EQUIV_ATOL``."""
    _, port = runs
    got = port[name]
    f, t = MC_CASES[name]["server_mesh"]
    ref_mesh = ref_abstract_mesh((1, f, t), ("data", "fsdp", "tp"))
    k = got["cuts"][0]
    want = {key: tuple(s) for key, s in _flat_specs(
        ref_server_pspecs(_ref_params0()[k:], ref_mesh))}
    for i in range(MC_SEEDS):
        _close(got["state"][i], port["mcnone"]["state"][i],
               f"{name} seed {i}")
    def seeds(tree_of):
        return {key: np.stack([tree_of(got["state"][i])[key]
                               for i in range(MC_SEEDS)]) for key in want}
    whole = {"params": seeds(lambda st: st[1]),
             "mu": seeds(lambda st: st[3]["mu"]),
             "nu": seeds(lambda st: st[3]["nu"])}
    for rank in got["ranks"]:
        (local,) = rank["locals"]
        assert local["step"] == [("R",), ("R",)]
        for side in ("params", "mu", "nu"):
            assert set(local[side]) == set(want)
            for key, leaf in local[side].items():
                assert leaf["local"].shape[0] == MC_SEEDS
                assert ("S", 0) not in leaf["placements"]
                shifted = [(p[0], p[1] - 1) if p[0] == "S" else p
                           for p in leaf["placements"]]
                ndim = leaf["local"].ndim - 1
                assert _ref_axes(shifted, ndim) == _padded(want[key], ndim), \
                    (name, side, key)
                np.testing.assert_array_equal(
                    leaf["local"], _slice(whole[side][key], leaf),
                    err_msg=f"{name} {side} {key}")


def test_hetero_plans_refuse_the_sweep(runs):
    """Plans of more than one cut bucket dispatch a program a bucket and
    refuse ``run_monte_carlo``, as the reference does, on ``vmap`` and on
    ``shard_map`` over the sub-mesh."""
    _, port = runs
    for name in ("ad21", "odd21", "hetero-sm21", "hetero-odd-sm21"):
        assert "hetero-bucketed" in port[name]["mc_refusal"], name


# ---------------------------------------------------------------------------
# the placement rule, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(2, 1), (1, 2), (2, 2), (4, 1)])
@pytest.mark.parametrize("model", ["tinycnn", "mobilenetv2"])
def test_placements_map_to_the_references_pspecs(model, sizes):
    """``server_placements(fleet_server_pspecs(...))`` of the port's server
    suffix (every stage after the first), mapped back through the HWIO ->
    OIHW layout, equals the reference's ``fleet_server_pspecs`` of the
    same leaves, leaf by leaf."""
    f, t = sizes
    _, params = reference_params(model)
    port = from_reference(params, model)
    server = {f"{i}.body.{k}": v for i, st in enumerate(port[1:])
              for k, v in st.items()}
    mesh = {"data": 1, "fsdp": f, "tp": t}
    placements = server_placements(fleet_server_pspecs(server, mesh))
    want = dict(_flat_specs(ref_server_pspecs(
        params[1:], ref_abstract_mesh((1, f, t), ("data", "fsdp", "tp")))))
    assert set(placements) == set(want)
    sharded = 0
    for key, pl in placements.items():
        ndim = server[key].dim()
        pl = [("S", p.dim) if p.is_shard() else ("R",) for p in pl]
        assert _ref_axes(pl, ndim) == _padded(want[key], ndim), key
        sharded += any(p[0] == "S" for p in pl)
    assert sharded > 0
