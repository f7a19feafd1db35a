"""What each rank of a spawned gloo group runs for ``test_torch_shard_map.py``,
``test_torch_fedavg_pmean.py`` and ``test_torch_analyze.py`` (through
``repro_torch.launch.mesh.run_ranks``).

Not a test module: the ranks unpickle their function from here, so it
imports the port, numpy and torch and nothing of jax or of the reference
(each case reports ``"jax" in sys.modules`` so the tests can check). Every
entry point runs on every rank, gathers what the ranks computed to every
rank (``all_gather_object``) and returns it; ``run_ranks`` hands rank 0's
to the test. Inputs arrive as numpy, results leave as numpy.
"""
import contextlib
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

K = 1          # tinycnn cut: the stem on the client
LR = 1e-2


def _np(tree):
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if hasattr(tree, "step") and hasattr(tree, "mu"):
        return {"step": _np(tree.step), "mu": _np(tree.mu),
                "nu": _np(tree.nu)}
    return tree


def _t(tree):
    if isinstance(tree, np.ndarray):
        t = torch.from_numpy(np.array(tree))
        return t.long() if not t.is_floating_point() else t
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_t(v) for v in tree)
    return tree


def _all_ranks(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


@contextlib.contextmanager
def _counting_int8():
    """Count the link boundary's calls in this rank (one a vmapped local
    step: the clients fold into the kernel's rows)."""
    from repro_torch.kernels.quant import ops as quant_ops
    calls = []
    real = quant_ops.quant_dequant

    def counting(x, *, kernel="xla"):
        calls.append(tuple(x.shape))
        return real(x, kernel=kernel)

    quant_ops.quant_dequant = counting
    try:
        yield calls
    finally:
        quant_ops.quant_dequant = real


# ---------------------------------------------------------------------------
# the pmean family
# ---------------------------------------------------------------------------

def pmean_cases(cases: dict) -> dict:
    """Each case ``{"x": stacked (n, ...) dict, "mask": (n,) or None,
    "fallback": dict}``: this rank's rows through the four functions; the
    stacked results gathered back to (n, ...) rows."""
    from repro_torch.core.fedavg import (fedavg_pmean, fedavg_pmean_masked,
                                         fedavg_pmean_stack,
                                         fedavg_pmean_stack_masked)
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import data_mesh
    mesh = data_mesh()
    group = mesh.group
    out = {}
    for name, case in cases.items():
        x = shard_batch(_t(case["x"]), mesh)
        mask = case["mask"]
        got = {"pmean": fedavg_pmean(x, group),
               "pmean_stack": fedavg_pmean_stack(x, group)}
        if mask is not None:
            m = shard_batch(torch.from_numpy(mask), mesh)
            got["pmean_masked"] = fedavg_pmean_masked(
                x, m, _t(case["fallback"]), group)
            got["pmean_stack_masked"] = fedavg_pmean_stack_masked(x, m, group)
        rows = _all_ranks(_np(got))
        merged = {}
        for fn in got:
            if fn.startswith("pmean_stack"):
                merged[fn] = {k: np.concatenate([r[fn][k] for r in rows])
                              for k in rows[0][fn]}
            else:
                merged[fn] = [r[fn] for r in rows]
        out[name] = merged
    return out


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _sl_round(tier, reduce, masked, kernel, client_axis, mesh=None):
    from repro_torch.core.link import LinkConfig
    from repro_torch.core.split import (SplitStep, make_split_loss,
                                        to_port_layout)
    from repro_torch.fleet.engine import make_fleet_sl_round
    from repro_torch.fleet.link import FleetLink
    from repro_torch.models.cnn import CNN_BUILDERS, cross_entropy_loss
    from repro_torch.optim import FunctionalAdamW
    port = CNN_BUILDERS["tinycnn"](12)
    for st in port:
        st.to(memory_format=torch.channels_last)
    client = torch.nn.Sequential(*port[:K])
    server = torch.nn.Sequential(*port[K:])
    step = SplitStep(
        client_fwd=lambda c, x: c(to_port_layout(x)),
        server_loss=lambda s_, sm, y: (cross_entropy_loss(s_(sm), y), {}),
        link_constraint=FleetLink(config=LinkConfig(compress="int8"),
                                  kernel=kernel).boundary("nchw"))
    opt_c, opt_s = FunctionalAdamW(LR), FunctionalAdamW(LR)
    return opt_c, opt_s, make_fleet_sl_round(
        make_split_loss(step, client, server), opt_c, opt_s,
        local_rounds=2, server_reduce=reduce, client_dropout=masked,
        client_tier=tier, client_axis=client_axis, mesh=mesh)


def sl_round_outputs(case: dict, params_c, params_s, bx, by,
                     client_axis="vmap", mesh=None):
    """One ``make_fleet_sl_round`` of ``case`` (tier, reduce, mask, kernel)
    from the given port-layout tiers and (clients, 2, batch, ...) batches:
    ``(params_c, params_s, oc, os_, losses)`` as numpy."""
    from repro_torch.fleet.engine import fleet_state
    mask = case["mask"]
    opt_c, opt_s, round_fn = _sl_round(case["tier"], case["reduce"],
                                       mask is not None, case["kernel"],
                                       client_axis, mesh)
    state = fleet_state(_t(params_c), _t(params_s), opt_c, opt_s,
                        bx.shape[0], client_tier=case["tier"])
    args = state + ({"inputs": _t(bx), "targets": _t(by)},)
    if mask is not None:
        args += (torch.from_numpy(mask),)
    return _np(round_fn(*args))


def fl_round_outputs(case: dict, params, bx, by, client_axis="vmap",
                     mesh=None):
    """One ``make_fleet_fl_round`` of tinycnn (``case["mask"]``):
    ``(global_params, losses)`` as numpy."""
    from repro_torch.core.split import to_port_layout
    from repro_torch.fleet.engine import make_fleet_fl_round
    from repro_torch.models.cnn import CNN_BUILDERS, cross_entropy_loss
    from repro_torch.optim import FunctionalAdamW
    model = torch.nn.Sequential(*CNN_BUILDERS["tinycnn"](12))

    def loss_fn(p, batch):
        xx, yy = batch
        return cross_entropy_loss(torch.func.functional_call(
            model, p, (to_port_layout(xx),)), yy)

    mask = case["mask"]
    round_fn = make_fleet_fl_round(loss_fn, FunctionalAdamW(LR),
                                   client_dropout=mask is not None,
                                   client_axis=client_axis, mesh=mesh)
    args = (_t(params), (_t(bx), _t(by)))
    if mask is not None:
        args += (torch.from_numpy(mask),)
    return _np(round_fn(*args))


def engine_cases(cases: dict, inputs: dict) -> dict:
    """Each case on ``client_axis="shard_map"`` over the world's data
    group: its outputs, the int8 boundary's calls in each rank, and
    whether jax was imported."""
    from repro_torch.launch.mesh import data_mesh
    mesh = data_mesh()
    out = {}
    for name, case in cases.items():
        with _counting_int8() as calls:
            if case["kind"] == "fl":
                got = fl_round_outputs(case, inputs["params"], inputs["bx"],
                                       inputs["by"], "shard_map", mesh)
            else:
                got = sl_round_outputs(case, inputs["params_c"],
                                       inputs["params_s"], inputs["bx"],
                                       inputs["by"], "shard_map", mesh)
        out[name] = {"out": got, "calls": _all_ranks(list(calls))}
    out["jax"] = _all_ranks("jax" in sys.modules)
    return out


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def plan_spec(case: dict, client_axis: str):
    """The port's ``ExperimentSpec`` of a plan case: tinycnn at 16 px (or
    the reduced SmolLM), int8 on the fused path, 2 local steps, batch 4."""
    import repro_torch.api as T
    from repro_torch import sim
    scenario = None
    if case.get("p_drop"):
        scenario = sim.ScenarioSpec(availability=sim.AvailabilityParams(
            kind="bernoulli", p_drop=case["p_drop"]), seed=case.get(
                "env_seed", 0))
    clients = T.ClientSpec(num_clients=case["n"],
                           dropout_rate=case.get("dropout", 0.0),
                           population=case.get("population"))
    engine = T.EngineSpec(kind=case["kind"], client_axis=client_axis,
                          link_kernel="fused")
    common = dict(clients=clients, link_policy=T.LinkPolicy(compress="int8"),
                  engine=engine, global_rounds=case.get("rounds", 2),
                  local_steps=2, batch_size=4, scenario=scenario)
    if case.get("lm"):
        from repro_torch.configs import smollm_135m
        return T.ExperimentSpec(
            model=T.ModelSpec(family="transformer",
                              arch=smollm_135m.reduced(),
                              attn_impl="pallas"),
            data=T.DataSpec(kind="tokens", partition="iid", seq_len=16,
                            n_train=32, n_test=4),
            cut_policy=T.CutPolicy(fraction=0.4), **common)
    return T.ExperimentSpec(
        model=T.ModelSpec(name="tinycnn", num_classes=4),
        data=T.DataSpec(kind="arrays", image_size=16, classes_per_client=2),
        cut_policy=T.CutPolicy(fraction=0.4),
        mission=T.MissionSpec() if case.get("mission", True) else None,
        **common)


def run_plan_case(case: dict, inputs: dict, client_axis: str, mesh=None):
    """Compile and run a plan case on the CPU (the default mesh under
    ``shard_map``): its records, final engine state and the int8 calls."""
    import repro_torch.api as T
    from repro_torch.obs import MetricsConfig, ObsConfig
    obs = (ObsConfig(enabled=False, metrics=MetricsConfig())
           if case.get("taps") else None)
    plan = T.compile_experiment(plan_spec(case, client_axis),
                                data=inputs["data"], device="cpu", obs=obs,
                                mesh=mesh)
    if inputs.get("params0") is not None:
        plan.params0 = _t(inputs["params0"])
    plan.cohorts = inputs.get("cohorts")
    plan.env_draws = inputs.get("env_draws")
    with _counting_int8() as calls:
        state, recs = plan.run()
    out = {"records": recs, "state": _np(state.engine_state),
           "calls": list(calls),
           "mesh": None if plan.mesh is None else plan.mesh.shape,
           "flops": {k: (float(v) if k == "full"
                         else tuple(float(f) for f in v[:2]))
                     for k, v in plan.flops.items()}}
    if case.get("mc"):
        from repro_torch.sim import run_monte_carlo
        plan.env_draws = None
        res = run_monte_carlo(plan, case["mc"], rounds=2, mode="vmap")
        out["mc"] = {k: np.asarray(v) for k, v in res.stacks.items()}
    return out


def plan_cases(cases: dict, inputs: dict) -> dict:
    """Each plan case on ``sl|fl/shard_map`` over the default data group
    (``compile_experiment``'s own mesh): rank 0's records and state, the
    int8 calls of every rank, the mesh each rank got."""
    out = {}
    for name, case in cases.items():
        got = run_plan_case(case, inputs[name], "shard_map")
        ranks = _all_ranks({"calls": got.pop("calls"),
                            "mesh": got["mesh"]})
        got["calls"] = [r["calls"] for r in ranks]
        got["meshes"] = [r["mesh"] for r in ranks]
        out[name] = got
    out["jax"] = _all_ranks("jax" in sys.modules)
    return out


def backend_refusal() -> str:
    """A gloo group asked to carry a CUDA fleet: the message."""
    from repro_torch.launch.mesh import data_mesh
    try:
        data_mesh(device="cuda")
    except ValueError as err:
        return str(err)
    return ""


def mesh_rule(n: int, data) -> dict:
    """``compile_experiment``'s own mesh for ``n`` clients on this world:
    its shape and this rank in it, or the refusal on a rank that holds no
    client."""
    import repro_torch.api as T
    try:
        plan = T.compile_experiment(plan_spec(dict(kind="sl", n=n),
                                              "shard_map"),
                                    data=data, device="cpu")
    except ValueError as err:
        return {"error": str(err)}
    return {"mesh": plan.mesh.shape, "rank": plan.mesh.rank}


def world_four(pmean: dict, engine: tuple, plans: tuple, data) -> dict:
    """The one 4-rank spawn: the pmean cases, engine cases over 8 clients
    and plan cases, the refusal of a mismatched backend, and the mesh of 6
    clients (3 ranks hold them, the fourth none)."""
    return {"pmean": pmean_cases(pmean), "engine": engine_cases(*engine),
            "plans": plan_cases(*plans), "backend": backend_refusal(),
            "six": _all_ranks(mesh_rule(6, data))}


def world_two(engine: tuple, plans: tuple) -> dict:
    """The 2-rank spawn of the engine and plan cases."""
    return {"engine": engine_cases(*engine), "plans": plan_cases(*plans),
            "backend": backend_refusal()}


def failing_rank(bad_rank: int):
    """Rank ``bad_rank`` raises before any collective."""
    if dist.get_rank() == bad_rank:
        raise KeyError(f"rank {bad_rank} refuses")
    return dist.get_rank()


def analyze_shard_map() -> dict:
    """The runtime audit of the variant matrix's ``shard_map`` entries on
    this group (each rank audits its own raw round), and of one
    ``all_reduce`` on a second group over the same ranks (a collective off
    the plan's group: a finding) beside its clean twin on the plan's."""
    from repro_torch.analyze import audit_all, audit_call
    from repro_torch.launch.mesh import make_fleet_mesh
    report = audit_all(match="shard_map", mc=False, device="cpu")
    mesh = make_fleet_mesh(2, device="cpu")
    other = dist.new_group(ranks=list(range(dist.get_world_size())))
    t = torch.ones(3)
    _, foreign = audit_call(lambda: dist.all_reduce(t, group=other),
                            where="foreign", group=mesh.group)
    _, own = audit_call(lambda: dist.all_reduce(t, group=mesh.group),
                        where="own", group=mesh.group)
    return {"ranks": _all_ranks({
        "report": report.to_dict(),
        "foreign": [(f.rule, f.message) for f in foreign.findings],
        "own": [(f.rule, f.message) for f in own.findings],
        "own_collectives": own.collectives,
        "server_mesh": analyze_server_mesh()}),
        "jax": "jax" in sys.modules}


def analyze_server_mesh() -> dict:
    """The runtime audit of an ``sl/vmap`` plan whose server suffix is
    sharded over ``EngineSpec.server_mesh=(2, 1)`` on this 2-rank world
    (tinycnn at 12 px, 4 clients, an int8 fused link, dropout 0.25), its
    raw round and its Monte-Carlo seed-axis round: each report, the
    collectives' groups and the mesh."""
    import repro_torch.api as T
    from repro_torch.analyze import audit_mc, audit_plan
    from repro_torch.analyze.audit import audit_mc_round, audit_round
    spec = T.ExperimentSpec(
        model=T.ModelSpec(name="tinycnn", num_classes=4),
        data=T.DataSpec(image_size=12, n_train=32, n_test=8),
        clients=T.ClientSpec(num_clients=4, dropout_rate=0.25),
        link_policy=T.LinkPolicy(compress="int8"),
        engine=T.EngineSpec(kind="sl", client_axis="vmap",
                            link_kernel="fused", server_mesh=(2, 1)),
        global_rounds=1, local_steps=2, batch_size=4)
    plan = T.compile_experiment(spec, device="cpu")
    rounds = {"plan": audit_round(plan), "mc": audit_mc_round(plan)}
    return {"mesh": plan.mesh.shape,
            "reports": {"plan": audit_plan(plan).to_dict(),
                        "mc": audit_mc(plan).to_dict()},
            "groups": {k: sorted({g for _, g in r.collectives})
                       for k, r in rounds.items()},
            "calls": {k: r.calls for k, r in rounds.items()},
            "data_group": (None if plan.mesh.group is None
                           else plan.mesh.group.group_name)}


# ---------------------------------------------------------------------------
# the server sub-mesh (EngineSpec.server_mesh), vmap over ranks, HeteroFleet
# on shard_map
# ---------------------------------------------------------------------------

MCU_FIELDS = dict(fp32_tflops=0.02, mem_bw_gbs=2.0, tensor_tflops=0.04,
                  cpu_passmark=400.0, power_w=2.0)


def server_mesh_spec(case: dict):
    """The port's spec of a server-mesh case: tinycnn at 16 px, 8 clients,
    an int8 link on the fused path, 2 rounds of 2 local steps at batch 4;
    ``edges`` a string of ``j`` (Jetson AGX Orin) and ``m`` (an MCU-class
    profile) cycled over the clients, adaptive cuts at 1 Mb/s."""
    import repro_torch.api as T
    from repro_torch.core.energy import JETSON_AGX_ORIN, HardwareProfile
    mcu = HardwareProfile("mcu-class", **MCU_FIELDS)
    edges = tuple(JETSON_AGX_ORIN if e == "j" else mcu
                  for e in case.get("edges", "j"))
    adaptive = len(set(case.get("edges", "j"))) > 1
    scenario = mission = None
    if case.get("stoch"):
        from repro_torch import sim
        mission, scenario = T.MissionSpec(), stoch_scenario(sim)
    return T.ExperimentSpec(
        model=T.ModelSpec(name="tinycnn", num_classes=4),
        data=T.DataSpec(kind="arrays", image_size=16, classes_per_client=2),
        clients=T.ClientSpec(num_clients=8, edge_profiles=edges),
        cut_policy=(T.CutPolicy(mode="adaptive") if adaptive
                    else T.CutPolicy(fraction=0.4)),
        link_policy=T.LinkPolicy(compress="int8",
                                 **({"rate_bps": 1e6} if adaptive else {})),
        engine=T.EngineSpec(kind="sl", client_axis=case["axis"],
                            link_kernel="fused",
                            server_mesh=case.get("server_mesh")),
        mission=mission, scenario=scenario,
        global_rounds=2, local_steps=2, batch_size=4)


def stoch_scenario(S):
    """The reference tests' stochastic scenario (``tests/test_sim.py``'s
    ``STOCH``): the ``a2g`` channel, markov availability, two UAVs
    relaying, seed 1; ``S`` the port's or the reference's ``sim``."""
    return S.ScenarioSpec(
        channel=S.ChannelParams(kind="a2g"),
        availability=S.AvailabilityParams(kind="markov", p_drop=0.4,
                                          p_recover=0.6),
        num_uavs=2, serve_mode="relay", seed=1)


def _placement(p) -> tuple:
    return ("S", p.dim) if p.is_shard() else ("R",)


def _server_locals(params_s: dict, os_) -> Optional[dict]:
    """Each server leaf's placements, this rank's sub-mesh coordinate and
    its local slice, of the params and both moments (None when the server
    state is not a DTensor); the step counter's placements."""
    leaf = next(iter(params_s.values()))
    if not hasattr(leaf, "placements"):
        return None

    def side(tree):
        return {k: {"placements": [_placement(p) for p in v.placements],
                    "coord": tuple(v.device_mesh.get_coordinate()),
                    "sizes": tuple(v.device_mesh.shape),
                    "local": _np(v.to_local())} for k, v in tree.items()}
    return {"params": side(params_s), "mu": side(os_.mu),
            "nu": side(os_.nu),
            "step": [_placement(p) for p in os_.step.placements]}


def dim0_over_fsdp(params_s: dict, mesh) -> dict:
    """``compile_experiment(server_pspecs=)``: every server leaf's dim 0
    over ``fsdp``, whatever its size."""
    from repro_torch.parallel.sharding import P
    return {k: P("fsdp") if v.dim() else P() for k, v in params_s.items()}


def server_mesh_plan(case: dict, inputs: dict) -> dict:
    """A server-mesh case's plan on this rank (``vmap_over_ranks``: a
    ``vmap`` plan given ``make_fleet_mesh`` over every rank; ``explicit``:
    its server placed by ``dim0_over_fsdp``): its records, its final state
    with the server state gathered, each bucket's server leaves as this
    rank holds them, the mesh, and the int8 calls."""
    import repro_torch.api as T
    from repro_torch.fleet.engine import gather_server_state
    from repro_torch.launch.mesh import make_fleet_mesh
    mesh = (make_fleet_mesh(8, device="cpu")
            if case.get("vmap_over_ranks") else None)
    plan = T.compile_experiment(
        server_mesh_spec(case), data=inputs["data"], device="cpu", mesh=mesh,
        server_pspecs=dim0_over_fsdp if case.get("explicit") else None)
    plan.params0 = _t(inputs["params0"])
    if case.get("stoch"):
        return server_mesh_sweep(plan, inputs["mc_draws"])
    with _counting_int8() as calls:
        state, recs = plan.run()
    es = state.engine_state
    buckets = es if isinstance(es, list) else [es]
    out = {"records": recs, "cuts": list(plan.cut_of_client),
           "flops": {k: tuple(float(f) for f in v[:2])
                     for k, v in plan.flops.items()},
           "state": [_np((pc, gather_server_state(ps), oc,
                          gather_server_state(os_)))
                     for pc, ps, oc, os_ in buckets],
           "locals": [_server_locals(ps, os_)
                      for _, ps, _, os_ in buckets],
           "mesh": None if plan.mesh is None else plan.mesh.shape,
           "calls": list(calls)}
    if len(buckets) > 1:
        from repro_torch.sim import run_monte_carlo
        try:
            run_monte_carlo(plan, 2, rounds=1)
        except ValueError as err:
            out["mc_refusal"] = str(err)
    return out


def server_mesh_sweep(plan, draws: list) -> dict:
    """``run_monte_carlo(plan, len(draws), mode="vmap")`` on the
    reference's per-seed draws: each seed's records and the sweep's
    stacks, the int8 calls, and the engine state the sweep ends on
    (``final_state``), its server state gathered seed by seed and as this
    rank holds it."""
    from repro_torch.fleet.engine import gather_server_state, seed_row
    from repro_torch.sim import run_monte_carlo
    n = len(draws)
    with _counting_int8() as calls:
        res = run_monte_carlo(plan, n, rounds=2, mode="vmap",
                              env_draws=draws)
    pc, ps, oc, os_ = res.final_state
    return {"records": [res.records_for_seed(i) for i in range(n)],
            "stacks": {k: np.asarray(v) for k, v in res.stacks.items()},
            "cuts": list(plan.cut_of_client),
            "flops": {k: tuple(float(f) for f in v[:2])
                      for k, v in plan.flops.items()},
            "state": [_np(seed_row((pc, gather_server_state(ps), oc,
                                    gather_server_state(os_)), i))
                      for i in range(n)],
            "locals": [_server_locals(ps, os_)],
            "mesh": None if plan.mesh is None else plan.mesh.shape,
            "calls": list(calls)}


def server_mesh_cases(cases: dict, inputs: dict) -> dict:
    """Every server-mesh case on this world: rank 0's records and state;
    every rank's mesh, server leaves and int8 calls."""
    out = {}
    for name, case in cases.items():
        got = server_mesh_plan(case, inputs)
        ranks = _all_ranks({k: got.pop(k) for k in ("locals", "mesh",
                                                     "calls")})
        got["ranks"] = ranks
        out[name] = got
    out["jax"] = _all_ranks("jax" in sys.modules)
    return out
