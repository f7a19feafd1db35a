"""Monte-Carlo campaign sweeps over scenario seeds.

Counterpart of ``repro.sim.monte_carlo``. A compiled ``Plan`` runs ONE
realisation of its scenario; ``run_monte_carlo(plan, num_seeds)`` runs
``num_seeds`` of them and stacks each ``RoundRecord`` field as a (seeds,
rounds) array, with ONE held-out accuracy a seed at the end (intermediate
rounds hold NaN in ``records_for_seed``).

Sweep seed ``i`` is the realisation of environment seed ``scn.seed + seed
+ i`` (a bare ``ScenarioSpec()`` without a scenario): its availability
uniforms, channel draws and cohorts come from the same streams
(``sim.streams``) as a plan compiled with that scenario seed, so seed 0 of
a ``seed=0`` sweep replays ``plan.run()``. The seeds share one stack of
the plan's own batch draws (the environment varies, the data does not);
under a population each seed gathers its own cohort's partitions. A plain
``ClientSpec.dropout_rate`` is swept as a bernoulli availability trace on
the mask stream, as the reference sweeps it.

Modes:

  * ``"vmap"`` (the default), on every single-engine plan, by one of two
    paths. ``_Sweep.shared`` chooses, from the sweep's own fields:
      - the shared round, on a sequential engine (``sl/scan``, ``fl/scan``)
        that takes no mask while the sweep draws no cohort (no population,
        or one the size of the fleet). Nothing drawn per seed then reaches
        the engine: the scan engines refuse masks, and the seeds share the
        plan's batch stream. So every seed trains the same trajectory, and
        only the channel's bills differ. The plan's own engine round runs
        once a round on one state and the round's one batch, every seed
        takes its losses, taps and final state, and the state is evaluated
        once. The result is the reference's ``vmap`` over seeds, at 1/N of
        the device work: on ``sl/scan`` the int8 boundary runs once a
        client step for all seeds.
      - the seed axis, on the fleet engines (``fl/vmap``, ``sl/vmap`` and
        their ``shard_map`` forms, CNNs and the split LM) and on ``fl/scan``
        under a population, whose seeds draw their own cohorts: all seeds
        in one program a local step. On the fleet engines that is one more
        ``vmap`` level over seeds (``fleet.engine``: each seed its own
        server, the int8 and flash kernels one launch for all seeds and
        clients; under shard_map each rank its own clients of every seed,
        the collectives carrying all seeds at once, as the reference's
        ``vmap`` over its shard_map round does; over a server sub-mesh,
        ``EngineSpec.server_mesh``, each rank holds its slices of every
        seed's server, the placements shifted by the seed axis, gathered
        once a local step for all seeds). On ``fl/scan`` it is
        ``core.split.make_fl_seeds_round``: the clients one after another,
        each local step one ``vmap`` over seeds.
    A plan that fits neither path raises ``ValueError``; nothing falls back
    to the loop.
  * ``"loop"``: seed after seed, round after round through the plan's own
    engine, on every single-engine plan the port compiles.

Hetero-bucketed plans (per-client cuts in more than one bucket) run one
program a bucket on the host and raise ``ValueError``. Host draws (masks,
rates, cohorts) are the same in both modes, so masks, active clients and
bills agree exactly and losses within ``FLEET_EQUIV_ATOL``. ``env_draws``
(one sequence of per-round ``EnvDraws`` a seed) takes the place of the
sweep's own draws, as ``Plan.env_draws`` does for one run. ``wall_s`` is
the sweep's host time after one warm-up round, fenced on the card
(``obs.timeline.fenced``).

Telemetry: the sweep inherits ``plan.obs`` (``obs=`` overrides); enabled,
it emits the ``mc/setup``, ``mc/compile`` (the warm-up round),
``mc/execute`` (the fenced sweep) and ``mc/summarize`` spans, a ``note``
event and the manifest's ``sweep`` entry. A plan compiled with a
``MetricsConfig`` adds each round's ``metrics/<tap>`` stacks and its
``loss_stack`` (seeds, rounds, ...) from either mode; ``records_for_seed``
summarizes them as the plan does (``summarize_round_metrics``), and
``summary()["metrics"]`` gives each tap's spread over the seeds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..obs import Obs
from ..obs.metrics import summarize_round_metrics
from ..obs.timeline import fenced
from .scenario import (AvailabilityParams, ScenarioSpec, availability_init,
                       availability_step, cohort_mask)

_STATS = ("mean", "std", "min", "max", "p10", "p90")

def _stats(v: np.ndarray) -> dict:
    return {"mean": float(v.mean()), "std": float(v.std()),
            "min": float(v.min()), "max": float(v.max()),
            "p10": float(np.percentile(v, 10)),
            "p90": float(np.percentile(v, 90))}


@dataclasses.dataclass
class MonteCarloResult:
    """Per-seed (seeds, rounds) stacks of the RoundRecord numeric fields,
    ``mask`` (seeds, rounds, clients), ``cohort`` (seeds, rounds, clients)
    under a population and ``final_accuracy`` (seeds,)."""
    stacks: dict
    num_seeds: int
    rounds: int
    engine: str
    mode: str                   # "vmap" | "loop"
    wall_s: float               # the sweep's fenced host time
    # the swept plan's MetricsConfig (None without one): records_for_seed
    # runs the plan's own numpy reduction on the per-seed stacks
    metrics_config: object = None
    kind: str = "sl"
    num_clients: int = 0
    # the engine state the sweep ends on: in vmap mode the seed-stacked
    # state (on the shared path the one state), in loop mode the last
    # seed's
    final_state: object = None

    def _round_metrics(self, i: int, r: int) -> dict:
        if self.metrics_config is None:
            return {}
        s = self.stacks
        taps = {k.split("/", 1)[1]: s[k][i, r]
                for k in s if k.startswith("metrics/")}
        return summarize_round_metrics(
            self.metrics_config, taps, losses=s["loss_stack"][i, r],
            kind=self.kind, n=self.num_clients,
            active=int(s["active_clients"][i, r]))

    def records_for_seed(self, i: int) -> list:
        from ..api.records import RoundRecord
        s = self.stacks
        return [RoundRecord(
            round=r, loss=float(s["loss"][i, r]),
            # one held-out evaluation a seed: the last round carries it
            accuracy=(float(s["final_accuracy"][i])
                      if r == self.rounds - 1 else float("nan")),
            link_bytes=float(s["link_bytes"][i, r]),
            link_time_s=float(s["link_time_s"][i, r]),
            link_energy_j=float(s["link_energy_j"][i, r]),
            client_time_s=float(s["client_time_s"][i, r]),
            client_energy_j=float(s["client_energy_j"][i, r]),
            server_time_s=float(s["server_time_s"][i, r]),
            server_energy_j=float(s["server_energy_j"][i, r]),
            uav_energy_j=float(s["uav_energy_j"][i, r]),
            active_clients=int(s["active_clients"][i, r]),
            engine=self.engine,
            cohort_pids=(tuple(int(p) for p in s["cohort"][i, r])
                         if "cohort" in s else ()),
            metrics=self._round_metrics(i, r)) for r in range(self.rounds)]

    def summary(self) -> dict:
        """Across-seed statistics of the campaign totals and the last
        round's loss."""
        s = self.stacks
        total_energy = (s["client_energy_j"] + s["server_energy_j"]
                        + s["link_energy_j"] + s["uav_energy_j"]).sum(axis=1)
        return {
            "num_seeds": self.num_seeds, "rounds": self.rounds,
            "mode": self.mode, "engine": self.engine,
            "final_loss": _stats(s["loss"][:, -1]),
            "final_accuracy": _stats(s["final_accuracy"]),
            "mean_active_clients": _stats(s["active_clients"].mean(axis=1)),
            "total_link_bytes": _stats(s["link_bytes"].sum(axis=1)),
            "total_link_time_s": _stats(s["link_time_s"].sum(axis=1)),
            "total_link_energy_j": _stats(s["link_energy_j"].sum(axis=1)),
            "total_client_energy_j": _stats(s["client_energy_j"].sum(axis=1)),
            "total_energy_j": _stats(total_energy),
            # each tap channel's spread over the seeds: a seed's mean over
            # its (rounds, steps, clients) stack, then _stats
            "metrics": {k.split("/", 1)[1]:
                        _stats(s[k].reshape(s[k].shape[0], -1).mean(axis=1))
                        for k in sorted(s) if k.startswith("metrics/")}
            or None,
        }


class _Seed:
    """One seed's host side: its environment seed, its draws and its
    availability state."""

    def __init__(self, env_seed: int, up: np.ndarray, draws):
        self.env_seed, self.up, self.draws = env_seed, up, draws


def _sweep_context(plan):
    """The scenario, the availability process the sweep runs (a plain
    dropout rate as a bernoulli trace) and whether the engine takes a
    mask; raises for a plan without one engine round."""
    from ..api.plan import _HeteroSLEngine, _needs_mask
    if isinstance(plan._engine, _HeteroSLEngine):
        raise ValueError("Monte-Carlo rollouts need a single compiled engine "
                         "round; hetero-bucketed plans dispatch per bucket "
                         "on the host (run those seeds with plan.run())")
    spec = plan.spec
    scn = spec.scenario or ScenarioSpec()
    avail = (scn.availability if scn.needs_mask
             else AvailabilityParams(kind="bernoulli",
                                     p_drop=spec.clients.dropout_rate)
             if spec.clients.dropout_rate > 0
             else AvailabilityParams(kind="full"))
    return scn, avail, _needs_mask(spec)


class _Sweep:
    """The host half of a sweep: per (seed, round) the cohort, the mask and
    the rate ratio from the seed's draws, and the round's bill."""

    def __init__(self, plan, num_seeds, rounds, seed, env_draws):
        scn, self.avail, self.masked = _sweep_context(plan)
        self.plan = plan
        self.pop = plan.spec.clients.population
        self.weighted = self.pop is not None and scn.needs_mask
        # the vmap mode's path (the module docstring): a sequential engine
        # without a mask, and no cohort drawn, gives every seed one
        # trajectory
        self.shared = (not plan.spec.engine.is_fleet and not self.masked
                       and self.pop in (None, plan.spec.clients.num_clients))
        self.mask_n = plan.avail_clients if self.avail.is_stochastic else 0
        if env_draws is not None and len(env_draws) != num_seeds:
            raise ValueError(f"env_draws holds {len(env_draws)} seeds, "
                             f"want {num_seeds}")
        self.seeds = [_Seed(scn.seed + seed + i,
                            availability_init(plan.avail_clients),
                            None if env_draws is None else env_draws[i])
                      for i in range(num_seeds)]
        # the plan's own batch stream, shared by the seeds: each round's
        # sample indices of every partition
        st = plan.init()
        self.indices = [plan.round_indices(st) for _ in range(rounds)]

    def host_round(self, i: int, r: int):
        """Seed ``i``'s round ``r``: (cohort, mask, rate ratio, sample
        indices), stepping its availability state."""
        sd, plan = self.seeds[i], self.plan
        env = plan.env_round(r, self.mask_n, sd.env_seed, sd.draws,
                             f"env_draws[{i}]")
        cohort = (None if self.pop is None else plan.draw_cohort(
            r, sd.up if self.weighted else None, sd.env_seed))
        mask, sd.up = availability_step(env.mask, sd.up, self.avail)
        sel = self.indices[r]
        if cohort is not None:
            mask = cohort_mask(mask, cohort)
            sel = sel[cohort % len(plan.parts)]
        return cohort, mask, plan._round_rate_ratio(env), sel

    def mask_tensor(self, masks):
        if not self.masked:
            return None
        return torch.from_numpy(np.stack(masks)).to(self.plan.device)

    def outputs(self, r, loss_c, cohort, mask, ratio, taps=None) -> dict:
        out = self.plan._round_bill(r, mask, cohort, ratio)
        out["loss"] = self.plan._round_loss(loss_c, mask)
        out["mask"] = mask
        if cohort is not None:
            out["cohort"] = cohort
        if self.plan.metrics_config is not None:
            out["loss_stack"] = loss_c
            for name, v in (taps or {}).items():
                out[f"metrics/{name}"] = v
        return out


def _loop(sweep: _Sweep, rounds: int):
    """Seed after seed, round after round through the plan's engine.
    Returns the per-seed rows, the accuracies and the last engine state."""
    from ..api.plan import pull_round
    plan = sweep.plan
    engine = plan._engine
    shared = ([plan.gather_batches(sel) for sel in sweep.indices]
              if sweep.pop is None else None)
    rows, accs = [], []
    state = None
    for i in range(len(sweep.seeds)):
        state = engine.init_state(plan.params0)
        per_round = []
        for r in range(rounds):
            cohort, mask, ratio, sel = sweep.host_round(i, r)
            batch = shared[r] if shared is not None \
                else plan.gather_batches(sel)
            m = sweep.mask_tensor([mask])
            state, losses, *taps = engine.run(state, batch,
                                              None if m is None else m[0])
            loss_c, taps = pull_round(losses, taps[0] if taps else None)
            per_round.append(sweep.outputs(r, loss_c, cohort, mask, ratio,
                                           taps))
        rows.append(per_round)
        accs.append(plan.evaluate_engine_state(state)["accuracy"])
    return rows, accs, state


def _vmap_round_inputs(sweep: _Sweep, r: int):
    """Round ``r`` of a vmap-mode sweep: each seed's host draws, and the
    round's batch and mask (None for an unmasked engine) on the plan's
    device: on the shared round the one (clients, ...) batch, on the seed
    axis the (seeds, clients, ...) batch and (seeds, clients) mask."""
    plan = sweep.plan
    num_seeds = len(sweep.seeds)
    host = [sweep.host_round(i, r) for i in range(num_seeds)]
    if sweep.shared:
        # no cohort is drawn: every seed's sample indices are seed 0's
        batch = plan.gather_batches(host[0][3])
    elif sweep.pop is None:
        batch = _tree_map(
            lambda v: v.expand((num_seeds,) + tuple(v.shape)),
            plan.gather_batches(sweep.indices[r]))
    else:
        batch = plan.gather_batches(np.stack([h[3] for h in host]))
    return host, batch, sweep.mask_tensor([h[1] for h in host])


def _vmap_round(sweep: _Sweep):
    """The vmap mode's round and its initial state: the plan's own engine
    round on one state when the seeds share it, else the engine's seed
    axis on a seed-stacked state; ``ValueError`` for a plan with neither."""
    plan = sweep.plan
    engine = plan._engine
    if sweep.shared:
        return engine.run, engine.init_state(plan.params0)
    if not hasattr(engine, "run_seeds"):
        raise ValueError(
            f"run_monte_carlo(mode='vmap') on {plan.engine_label}: its seeds "
            f"train apart (a mask or a cohort a seed reaches the engine) "
            f"and the engine has no seed axis; use mode='loop'")
    return engine.run_seeds, engine.init_seeds(plan.params0,
                                               len(sweep.seeds))


def build_vmap_rollout(plan, num_seeds: int, *, seed: int = 0):
    """The round ``run_monte_carlo(plan, num_seeds, mode="vmap")`` runs,
    with its first round's arguments: ``(fn, (state, batch, mask))``, ``fn``
    the plan's engine round on the shared path (``state`` its initial
    state, ``batch`` round 0's) or the engine's seed-axis round
    (``run_seeds``; ``state`` seed-stacked, ``batch`` and ``mask`` round
    0's from the sweep's own draws). The sweep runs this same builder."""
    sweep = _Sweep(plan, num_seeds, 1, seed, None)
    fn, state = _vmap_round(sweep)
    _, batch, mask = _vmap_round_inputs(sweep, 0)
    return fn, (state, batch, mask)


def _vmap(sweep: _Sweep, rounds: int):
    """All seeds at once: the round they share (its losses, taps and final
    state every seed's, the state evaluated once) or the engine's seed
    axis. Returns the per-seed rows, the accuracies and the engine
    state."""
    from ..api.plan import pull_round
    from ..fleet.engine import seed_row
    plan = sweep.plan
    num_seeds = len(sweep.seeds)
    fn, state = _vmap_round(sweep)
    outs = [[] for _ in range(num_seeds)]
    for r in range(rounds):
        host, batch, mask = _vmap_round_inputs(sweep, r)
        state, losses, *taps = fn(state, batch, mask)
        losses, taps = pull_round(losses, taps[0] if taps else None)
        for i, (cohort, mask, ratio, _) in enumerate(host):
            if sweep.shared:
                loss_i, taps_i = losses, taps
            else:
                loss_i = losses[i]
                taps_i = (None if taps is None
                          else {k: v[i] for k, v in taps.items()})
            outs[i].append(sweep.outputs(r, loss_i, cohort, mask, ratio,
                                         taps_i))
    if sweep.shared:
        accs = [plan.evaluate_engine_state(state)["accuracy"]] * num_seeds
    else:
        accs = [plan.evaluate_engine_state(seed_row(state, i))["accuracy"]
                for i in range(num_seeds)]
    return outs, accs, state


def _tree_map(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return type(batch)(fn(v) for v in batch)


def run_monte_carlo(plan, num_seeds: int, *, rounds: Optional[int] = None,
                    mode: str = "vmap", seed: int = 0,
                    env_draws=None, obs=None) -> MonteCarloResult:
    """Sweep ``num_seeds`` scenario realisations of ``plan`` for ``rounds``
    rounds (default the plan's ``num_rounds``), seed ``i`` at environment
    seed ``scn.seed + seed + i``, in ``mode`` ``"vmap"`` or ``"loop"``
    (the module docstring). ``obs`` (an ``ObsConfig`` or ``Obs``) takes
    the place of ``plan.obs`` for the sweep's telemetry."""
    if mode not in ("vmap", "loop"):
        raise ValueError(f"mode must be 'vmap' or 'loop', got {mode!r}")
    if num_seeds < 1:
        raise ValueError(f"need at least one seed, got {num_seeds}")
    rounds = plan.num_rounds if rounds is None else rounds
    if rounds < 1:
        raise ValueError("need at least one round")
    _sweep_context(plan)
    run = _vmap if mode == "vmap" else _loop
    obs = plan.obs if obs is None else Obs.ensure(obs)
    scn = plan.spec.scenario or ScenarioSpec()

    with obs.span("mc/setup", seeds=num_seeds, rounds=rounds, mode=mode):
        warm = num_seeds if mode == "vmap" else 1
        warm_sweep = _Sweep(plan, warm, 1, seed,
                            None if env_draws is None else env_draws[:warm])
        sweep = _Sweep(plan, num_seeds, rounds, seed, env_draws)
    # one warm-up round outside the timed sweep (first calls at these
    # shapes), on a sweep of its own, fenced on its final state
    with obs.span("mc/compile", mode=mode):
        fenced(lambda: run(warm_sweep, 1))
    with obs.span("mc/execute", mode=mode):
        (rows, accs, final_state), wall = fenced(
            lambda: run(sweep, rounds))
    with obs.span("mc/summarize"):
        stacks = {k: np.asarray([[out[k] for out in per_round]
                                 for per_round in rows])
                  for k in rows[0][0]}
        stacks["final_accuracy"] = np.asarray(accs, np.float64)
    if obs:
        obs.event("note", kind="monte_carlo", num_seeds=num_seeds,
                  rounds=rounds, mode=mode, engine=plan.engine_label,
                  wall_s=round(wall, 6))
        obs.manifest(sweep={"kind": "monte_carlo", "mode": mode,
                            "num_seeds": num_seeds, "rounds": rounds,
                            "engine": plan.engine_label,
                            "seed_base": scn.seed + seed,
                            "seeds": [scn.seed + seed + i
                                      for i in range(num_seeds)],
                            "wall_s": round(wall, 6)})
        obs.flush()
    return MonteCarloResult(stacks=stacks, num_seeds=num_seeds,
                            rounds=rounds, engine=plan.engine_label,
                            mode=mode, wall_s=wall,
                            metrics_config=plan.metrics_config,
                            kind=plan.spec.engine.kind,
                            num_clients=plan.spec.clients.num_clients,
                            final_state=final_state)
