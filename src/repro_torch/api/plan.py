"""``compile_experiment``: lower one ``ExperimentSpec`` to a runnable ``Plan``.

Counterpart of ``repro.api.plan`` for the slices ported so far:

- the CNN family on the sequential engines (``fl/scan``, the FL baseline,
  and ``sl/scan``, Algorithm 3) and on the fleet engines (``fl/vmap`` and
  ``sl/vmap``, parallel SL with one server update a step on the reduced
  client gradient; ``fleet.engine``), and their explicit-collective form
  ``fl/shard_map`` and ``sl/shard_map``, the clients spread over the data
  group of a ``launch.mesh.FleetMesh`` (``compile_experiment(mesh=)``);
- the transformer family (the split LM, ``fleet.hetero.lm_split_program``)
  on ``sl/scan``, ``sl/vmap`` and ``sl/shard_map``, its attention on the
  kernel path
  ``ModelSpec.attn_impl`` resolves to (the hand-written flash kernel for
  ``"pallas"``);

each with a fraction cut, an fp32 or int8 link (the int8 boundary on the
fused CUDA kernel or the two-op plain path), the UAV mission budget and, on
the fleet engines, client dropout (``ClientSpec.dropout_rate``: a numpy
mask a round from ``RandomState(seed + 1)``, as the reference draws it) and
population cohorts (``ClientSpec.population``: a round's ``num_clients``
participants drawn out of the population, their batches gathered from the
partitions by population id, their edge profiles billed by population id;
parallel SL trains one client model shared by the cohort, the EPSL shared
client tier, so engine state stays O(cohort)). A CNN on ``sl/vmap`` also
takes per-client adaptive cuts (``CutPolicy(mode="adaptive")``: each
client's minimum-energy cut for its own edge profile and link under the
link deadline, ``fleet.hetero.assign_cuts_cnn``); with more than one
distinct cut the clients train in cut buckets, one fleet round and one
server suffix a bucket (``fleet.hetero.HeteroFleet``, on ``vmap`` or
``shard_map``), each client billed at its own cut. The SL fleet engines
take the reference's server sub-mesh (``EngineSpec.server_mesh=(fsdp,
tp)``): the ``('data', 'fsdp', 'tp')`` fleet mesh of
``launch.mesh.make_fleet_mesh``, the server suffix's params and AdamW
moments DTensors on its ``(fsdp, tp)`` sub-mesh
(``launch.steps.fleet_server_pspecs``), the clients over ``data``; a
``vmap`` plan over a mesh of more than one rank runs the rank-local
program of ``shard_map``. A ``ScenarioSpec`` (``ExperimentSpec.scenario``,
``repro_torch.sim``) runs on every engine: the mission rolls out in time
(``sim.mission.rollout_mission``: several UAVs, hover or relay serving),
each client's link constants are hoisted at its nominal channel rate, the
channel's draws re-bill link time and energy each round, and on the fleet
engines an availability trace masks the clients (and, under a population,
weights the cohort draw). The run surface is the reference's:

    plan = compile_experiment(spec, device="cuda")
    state = plan.init()
    state, rec = plan.run_round(state)          # one RoundRecord per round
    metrics = plan.evaluate(state)

Every energy/FLOP/link constant is hoisted at compile time (the paper's
Eq. 8/9 accounting); ``run_round`` multiplies the per-client constants by
the steps that ran. Spec fields outside the slices raise
``NotImplementedError`` naming their ROADMAP item; nothing falls back.

Telemetry (``compile_experiment(..., obs=ObsConfig(...))``,
``repro_torch.obs``): the lowering's ``compile/*`` spans, the plan's row
in the run manifest, and a round's ``round/sample``, ``round/execute``
(fenced on the card), ``round/account`` and ``round/eval`` spans, gauge,
record and metrics events. A ``MetricsConfig`` (``ObsConfig.metrics``)
adds the in-round taps of ``repro_torch.obs.metrics`` to every engine and
fills ``RoundRecord.metrics``; without one the rounds run the same tensor
operations as a plan without telemetry.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from ..core.energy import RTX_A5000
from ..core.split import (SplitStep, cut_index_for_fraction,
                          init_stages, make_fl_round, make_fl_seeds_round,
                          make_multi_client_round, make_split_loss,
                          stack_cut_index, tier_call, tier_params,
                          to_port_layout)
from ..core.link import LinkConfig
from ..core.trajectory import TourPlan, plan_tour
from ..data.partition import (partition_dirichlet, partition_iid,
                              partition_non_iid, population_partition_count)
from ..data.synthetic import SyntheticPestImages, synthetic_tokens
from ..fleet.engine import (fleet_state, gather_server_state,
                            make_fleet_fl_round, make_fleet_sl_round,
                            stack_seeds, validate_fleet_mesh)
from ..fleet.hetero import (HeteroFleet, assign_cuts_cnn, cnn_split_program,
                            lm_split_program, lm_split_step)
from ..fleet.link import FleetLink
from ..kernels.dispatch import (ATTN_IMPLS, LINK_KERNELS, resolve_attn_impl,
                                resolve_link_kernel)
from ..launch.mesh import (fleet_layout, make_fleet_mesh,
                           server_mesh_sizes, single_device_fleet_mesh)
from ..launch.steps import fleet_server_pspecs, server_placements
from ..models.cnn import CNN_BUILDERS, cross_entropy_loss
from ..obs import NULL_OBS, Obs, ObsConfig
from ..obs.metrics import (NonfiniteError, engine_tap_names,
                           split_step_tap_names, summarize_round_metrics)
from ..optim.optimizers import FunctionalAdamW, adamw
from ..sim.channel import deterministic_rate_bps, rates_from_draws
from ..sim.mission import MissionTimeline, rollout_mission
from ..sim.scenario import (COHORT_DOWN_WEIGHT, ScenarioSpec,
                            availability_init, availability_step,
                            cohort_generator, cohort_mask, sample_cohort)
from ..sim.streams import EnvDraws, checked_draws, draw_env
from .records import RoundRecord
from .runtime import (client_coords, client_step_time_s, count_fl_step_flops,
                      count_sl_step_flops, count_split_step_flops,
                      metrics_from_predictions, mission_max_link_s,
                      roofline_s, round_batch_indices)
from .spec import ExperimentSpec

# time billed to the FL server per round: aggregation only (the
# reference's constant, repro/api/plan.py FL_SERVER_AGG_S)
FL_SERVER_AGG_S = 1e-3

# held-out evaluation runs in chunks of this many images (CNNs) or
# sequences (the split LM: one chunk of 8 x 1024 positions of SmolLM-135M's
# 49,152-way logits is 1.6 GB in f32; all 16 test sequences at once, 3.2 GB)
EVAL_CHUNK = 64
LM_EVAL_CHUNK = 8


@dataclasses.dataclass
class PlanState:
    """Mutable run state threaded through ``run_round``."""
    round: int
    engine_state: Any
    rng: np.random.RandomState      # minibatch sampling stream
    dropout_rng: np.random.RandomState   # client dropout stream
    last_metrics: Optional[dict] = None
    # a scenario's availability state (population-sized when one is
    # declared), carried from round to round
    avail_up: Optional[np.ndarray] = None


class Plan:
    """A compiled experiment. Built by ``compile_experiment``.

    ``params0`` is what ``init()`` loads: for a CNN the list of per-stage
    parameter dicts (keys are the reference's pytree paths, e.g.
    ``"conv.w"``), for the split LM the (client, server) state dicts. Assign
    ``convert.from_reference(...)`` / ``convert.lm_from_reference(...)`` to
    it before ``init()`` to start from the reference's parameters.

    ``cohorts`` (population plans only) takes the place of the plan's own
    cohort draw: a sequence with one entry a round, each ``num_clients``
    distinct sorted population ids. Assign it before running, e.g. the
    reference's ``RoundRecord.cohort_pids``, to replay its cohorts; an
    entry that breaks those rules, or a round past its end, raises.

    ``env_draws`` (scenario plans) takes the place of the plan's own
    environment draws in the same way: a sequence with one
    ``sim.streams.EnvDraws`` a round, its ``mask`` the availability
    process's (clients,) uniforms (population-sized under a population) and
    its ``normal``/``exponential`` the channel's (clients,) draws, each
    given when the scenario uses it, e.g. the reference's draws from its
    folded keys. A field of the wrong length, a missing one, or a round past
    its end raises.

    With a scenario the plan also reads ``timeline`` (the rolled-out
    mission), ``serve_dist_m`` (each client's slant distance to its UAV)
    and ``rate_nominal`` (each client's deterministic channel rate, at
    which its link constants are hoisted)."""

    def __init__(self, spec: ExperimentSpec, *, device, arrays, parts,
                 stages, params0, tour: Optional[TourPlan], cut_of_client,
                 flops: dict, edges, consts, engine, num_classes: int,
                 eval_chunk: int, prof_consts=None,
                 timeline: Optional[MissionTimeline] = None,
                 serve_dist_m=None, rate_nominal=None,
                 obs: Optional[Obs] = None, metrics=None,
                 graph_taps: tuple = (), mesh=None):
        self.spec = spec
        self.device = device
        # the fleet mesh of a shard_map plan (None on the other engines)
        self.mesh = mesh
        # the metrics bus: the MetricsConfig the plan was compiled with
        # (None = off) and the tap channels its engine rounds return — with
        # any, the engines return (state, losses, taps)
        self.metrics_config = metrics
        self.graph_taps = tuple(graph_taps)
        # telemetry: the shared disabled instance unless compile_experiment
        # was handed an ObsConfig (every hot-path touch a branch + no-op)
        self.obs = obs if obs is not None else NULL_OBS
        self.engine_label = f"{spec.engine.kind}/{spec.engine.client_axis}"
        self.x_train, self.y_train, self.x_test, self.y_test = arrays
        self.parts = parts
        self.stages = stages
        self.params0 = params0
        self.tour = tour
        self.timeline = timeline
        budget = (timeline.rounds if timeline is not None
                  else tour.rounds if tour is not None else None)
        self.rounds_budget = budget
        self.num_rounds = (min(spec.global_rounds, budget)
                           if budget is not None else spec.global_rounds)
        n = spec.clients.num_clients
        self.serve_dist_m = (np.zeros(n) if serve_dist_m is None
                             else np.asarray(serve_dist_m))
        self.rate_nominal = (np.full(n, spec.link_policy.rate_bps)
                             if rate_nominal is None
                             else np.asarray(rate_nominal))
        scn = spec.scenario
        self._channel = scn.channel if scn is not None else None
        # masks, rates and cohorts fold from the scenario's seed, or from
        # seed 0 without a scenario (as run_monte_carlo's default does)
        self.env_seed = scn.seed if scn is not None else 0
        self.env_draws = None
        self.cut_of_client = list(cut_of_client)
        self.flops = flops            # {"full": f} | {cut: (client, server, sd)}
        self.edges = edges
        (self._t_client, self._t_server, self._link_bytes, self._link_time,
         self._link_energy, self._server_base_s) = consts
        # per-PROFILE per-step client constants for cohort billing (edge
        # profiles cycle over population ids), or None without a population
        self._t_client_prof, self._p_edge_prof = (
            prof_consts if prof_consts is not None else (None, None))
        self._population = spec.clients.population
        self.cohorts = None
        self._engine = engine
        self._num_classes = num_classes
        self._eval_chunk = eval_chunk
        self._x_test = _to_device(self.x_test, device)

    # ---- lifecycle --------------------------------------------------------

    @property
    def avail_clients(self) -> int:
        """The clients the availability trace runs over: the population
        when one is declared, else the fleet."""
        return (self._population if self._population is not None
                else self.spec.clients.num_clients)

    def init(self) -> PlanState:
        """Fresh run state from ``params0``; the batch stream is one
        ``RandomState(spec.seed)`` and the dropout stream one
        ``RandomState(spec.seed + 1)``, as in the reference; a scenario's
        availability trace starts with every client up."""
        scn = self.spec.scenario
        return PlanState(round=0,
                         engine_state=self._engine.init_state(self.params0),
                         rng=np.random.RandomState(self.spec.seed),
                         dropout_rng=np.random.RandomState(self.spec.seed + 1),
                         avail_up=(availability_init(self.avail_clients)
                                   if scn is not None and scn.needs_mask
                                   else None))

    def round_indices(self, state: PlanState) -> np.ndarray:
        """One round's (partitions, local_steps, batch) sample indices of
        every partition (one ``choice`` a partition, the reference's call
        sequence), from the batch stream."""
        return round_batch_indices(self.parts, self.spec.batch_size,
                                   self.spec.local_steps, state.rng,
                                   shrink=self.spec.data.shrink_batches)

    def gather_batches(self, sel: np.ndarray):
        """The images (tokens) and labels at sample indices ``sel``
        (clients, local_steps, batch), on the plan's device, in the
        engine's format (FL: ``(bx, by)``; SL: dict)."""
        bx = _to_device(self.x_train[sel], self.device)
        by = torch.from_numpy(self.y_train[sel].astype(np.int64)).to(
            self.device)
        if self.spec.engine.kind == "fl":
            return bx, by
        return {"inputs": bx, "targets": by}

    def round_batches(self, state: PlanState, cohort=None):
        """One round's (clients, local_steps, ...) batch stacks on the
        plan's device, in the engine's format (FL: ``(bx, by)``; SL: dict).

        The sample indices of every partition are drawn; with ``cohort``
        (population ids) only the cohort's partitions (``cohort % P``) are
        gathered and moved to the device, without it every partition."""
        sel = self.round_indices(state)
        if cohort is not None:
            sel = sel[np.asarray(cohort) % len(self.parts)]
        return self.gather_batches(sel)

    def round_env(self, round_index: int) -> EnvDraws:
        """One round's environment draws (what the scenario uses, else
        empty): the entry of ``env_draws`` when it is set (checked), else
        drawn from the plan's environment seed."""
        scn = self.spec.scenario
        mask_n = (self.avail_clients
                  if scn is not None and scn.needs_mask else 0)
        return self.env_round(round_index, mask_n, self.env_seed,
                              self.env_draws, "Plan.env_draws")

    def env_round(self, round_index: int, mask_n: int, env_seed: int,
                  given, where: str) -> EnvDraws:
        """Round ``round_index``'s draws: ``mask_n`` availability uniforms
        and, under a stochastic channel, a normal and an exponential a
        client; from ``given`` (a sequence with one ``EnvDraws`` a round,
        named ``where`` in its errors) when it is not None, else from
        environment seed ``env_seed``."""
        rates_n = (self.spec.clients.num_clients
                   if self._channel is not None
                   and self._channel.is_stochastic else 0)
        if given is None:
            return draw_env(env_seed, round_index, mask_n=mask_n,
                            rates_n=rates_n)
        if round_index >= len(given):
            raise ValueError(f"{where} holds {len(given)} rounds; round "
                             f"{round_index} is past its end")
        return checked_draws(given[round_index], mask_n=mask_n,
                             rates_n=rates_n,
                             where=f"{where}[{round_index}]")

    def _round_cohort(self, state: PlanState) -> Optional[np.ndarray]:
        """The round's sorted cohort population ids, or None without a
        population: the entry of ``cohorts`` when it is set (checked), else
        the plan's own draw (``draw_cohort``)."""
        if self._population is None:
            if self.cohorts is not None:
                raise ValueError("Plan.cohorts is set on a plan without "
                                 "ClientSpec.population")
            return None
        k = self.spec.clients.num_clients
        if self.cohorts is None:
            return self.draw_cohort(state.round, state.avail_up,
                                    self.env_seed)
        if state.round >= len(self.cohorts):
            raise ValueError(f"Plan.cohorts holds {len(self.cohorts)} "
                             f"rounds; round {state.round} is past its end")
        ids = np.asarray(self.cohorts[state.round])
        if (ids.shape != (k,) or not np.issubdtype(ids.dtype, np.integer)
                or np.any(np.diff(ids) <= 0) or ids[0] < 0
                or ids[-1] >= self._population):
            raise ValueError(f"Plan.cohorts[{state.round}] = {ids.tolist()} "
                             f"is not {k} distinct sorted ids below the "
                             f"population {self._population}")
        return ids.astype(np.int64)

    def draw_cohort(self, round_index: int, avail_up, env_seed: int
                    ) -> np.ndarray:
        """A Gumbel top-k draw of the round's cohort from the
        ``ENV_COHORT`` generator of environment seed ``env_seed``: weighted
        by an availability state ``avail_up`` entering the round (a down
        client at ``COHORT_DOWN_WEIGHT``), uniform when it is None."""
        weights = None
        if avail_up is not None:
            weights = avail_up + (1.0 - avail_up) * np.float32(
                COHORT_DOWN_WEIGHT)
        return sample_cohort(cohort_generator(env_seed, round_index),
                             self._population, self.spec.clients.num_clients,
                             weights=weights)

    def _round_mask(self, state: PlanState, env: EnvDraws,
                    cohort=None) -> Optional[np.ndarray]:
        """The round's (clients,) 0/1 client mask, or None when the engine
        takes none. Under a scenario's availability trace: one step of the
        trace on the round's uniforms (``env.mask``), sliced to the cohort
        under a population (an all-down cohort keeps slot 0; the trace's
        own guard holds for the population). Under client dropout:
        ``uniform >= rate`` per client from the dropout stream, never an
        all-dropped fleet (one client drawn back in)."""
        scn = self.spec.scenario
        if scn is not None and scn.needs_mask:
            mask, state.avail_up = availability_step(
                env.mask, state.avail_up, scn.availability)
            return mask if cohort is None else cohort_mask(mask, cohort)
        rate = self.spec.clients.dropout_rate
        if rate <= 0.0:
            return None
        n = self.spec.clients.num_clients
        mask = (state.dropout_rng.uniform(size=n) >= rate).astype(np.float32)
        if mask.sum() == 0:          # never drop the whole fleet
            mask[state.dropout_rng.randint(n)] = 1.0
        return mask

    def _round_rate_ratio(self, env: EnvDraws) -> Optional[np.ndarray]:
        """nominal / sampled channel rate a client for one round, from the
        round's draws, or None without a channel (the hoisted constants
        stand as they are)."""
        if self._channel is None:
            return None
        rates = rates_from_draws(self._channel, self.serve_dist_m,
                                 self.spec.link_policy.rate_bps, env.normal,
                                 env.exponential)
        return self.rate_nominal / rates

    def run_round(self, state: PlanState, batches=None, *,
                  with_eval: bool = True) -> tuple[PlanState, RoundRecord]:
        """Execute one global round; returns (state, RoundRecord).

        With telemetry the round decomposes into spans: ``round/sample``
        (the environment draws, cohort, mask and batch gather),
        ``round/execute`` (the engine, fenced on the losses and taps
        together so the device's work lands in ``sync_s``),
        ``round/account`` (the record and the metrics summary) and
        ``round/eval``; then one gauge stamp, the record and, with
        metrics, the round's ``metrics`` event."""
        obs = self.obs
        r = state.round
        obs.round_started(r)
        with obs.span("round", round=r):
            with obs.span("round/sample", round=r):
                env = self.round_env(r)
                cohort = self._round_cohort(state)
                if batches is None:
                    batches = self.round_batches(state, cohort=cohort)
                mask = self._round_mask(state, env, cohort)
            with obs.span("round/execute", round=r) as sp:
                out = self.raw_round(state.engine_state, batches, mask)
                state.engine_state, losses = out[0], out[1]
                taps = out[2] if self.graph_taps else None
                # the losses and taps leave the device together, once
                sp.fence((losses, taps))
            rec = self._assemble_record(state, losses, mask, cohort, env,
                                        taps=taps, with_eval=with_eval)
            if obs:
                n = self.spec.clients.num_clients
                obs.gauge(r, engine_state=state.engine_state,
                          active_clients=rec.active_clients,
                          dropped=n - rec.active_clients,
                          cohort=len(rec.cohort_pids),
                          link_bytes=rec.link_bytes)
                obs.record(rec)
                if rec.metrics:
                    obs.event("metrics", round=r, engine=self.engine_label,
                              **rec.metrics)
        obs.round_finished(r)
        state.round += 1
        return state, rec

    def raw_round(self, engine_state, batches, mask=None):
        """One engine round with no record and no host synchronization:
        ``(engine_state, losses)`` on the device, plus the tap dict third
        when the plan carries metrics taps (``graph_taps``). ``mask`` is a
        (clients,) 0/1 array (or tensor) for an engine that takes one.
        Benches queue rounds back to back through it and fence once
        (``obs.time_fenced``)."""
        if mask is not None and not torch.is_tensor(mask):
            mask = torch.from_numpy(np.asarray(mask, np.float32))
        return self._engine.run(
            engine_state, batches,
            None if mask is None else mask.to(self.device))

    def _round_loss(self, loss_c: np.ndarray, mask) -> float:
        """The round's loss: the mean over the active clients' steps
        (losses FL (clients, steps), SL (steps, clients))."""
        n = self.spec.clients.num_clients
        active = np.arange(n) if mask is None else np.flatnonzero(mask > 0)
        return float((loss_c[active, :] if self.spec.engine.kind == "fl"
                      else loss_c[:, active]).mean())

    def _round_bill(self, round_index: int, mask, cohort, ratio) -> dict:
        """The analytic energy/link bill of one round over the active
        clients only; under a population the client time and energy at the
        cohort's own edge profiles (``cohort % profiles``); under a channel
        link time and energy at ``ratio`` (nominal / sampled rate) times
        the hoisted constants, the bytes as they are."""
        n = self.spec.clients.num_clients
        steps = self.spec.local_steps
        active = np.arange(n) if mask is None else np.flatnonzero(mask > 0)
        uav = 0.0
        if self.timeline is not None:
            uav = self.timeline.uav_energy_j(round_index)
        elif self.tour is not None:
            uav = float(self.tour.e_first if round_index == 0
                        else self.tour.e_per_round)
        if cohort is not None and self._t_client_prof is not None:
            prof = cohort % len(self._t_client_prof)
            t_client, p_edge = (self._t_client_prof[prof],
                                self._p_edge_prof[prof])
        else:
            t_client = self._t_client
            p_edge = np.asarray([e.power_w for e in self.edges])
        t_cli = float(t_client[active].sum() * steps)
        e_cli = float(sum(t_client[c] * steps * p_edge[c] for c in active))
        t_srv = float(self._t_server[active].sum() * steps
                      + self._server_base_s)
        l_time, l_energy = self._link_time, self._link_energy
        if ratio is not None:
            l_time, l_energy = l_time * ratio, l_energy * ratio
        return dict(
            link_bytes=float(self._link_bytes[active].sum() * steps),
            link_time_s=float(l_time[active].sum() * steps),
            link_energy_j=float(l_energy[active].sum() * steps),
            client_time_s=t_cli, client_energy_j=e_cli,
            server_time_s=t_srv,
            server_energy_j=t_srv * RTX_A5000.power_w,
            uav_energy_j=uav, active_clients=len(active))

    def _assemble_record(self, state: PlanState, losses, mask, cohort, env,
                         *, with_eval: bool, taps=None) -> RoundRecord:
        """One executed round's record: the loss, the held-out accuracy
        (NaN without ``with_eval``), the bill (``_round_bill``, at the
        round's channel draws ``env``) and, when the plan carries a
        MetricsConfig, the metrics summary (raising ``NonfiniteError``
        under ``on_nonfinite="raise"``)."""
        obs = self.obs
        with obs.span("round/account", round=state.round):
            loss_c, taps = pull_round(losses, taps)
            loss = self._round_loss(loss_c, mask)
            bill = self._round_bill(state.round, mask, cohort,
                                    self._round_rate_ratio(env))
            metrics = {}
            if self.metrics_config is not None:
                metrics = summarize_round_metrics(
                    self.metrics_config, taps, losses=loss_c,
                    kind=self.spec.engine.kind,
                    n=self.spec.clients.num_clients,
                    active=bill["active_clients"])
                if (self.metrics_config.on_nonfinite == "raise"
                        and metrics.get("health/nonfinite", 0)):
                    raise NonfiniteError(
                        round_index=state.round,
                        step=metrics["health/first_step"],
                        client=metrics["health/first_client"],
                        count=metrics["health/nonfinite"])
        if with_eval:
            with obs.span("round/eval", round=state.round):
                state.last_metrics = self.evaluate(state)
            accuracy = state.last_metrics["accuracy"]
        else:
            accuracy = float("nan")
        return RoundRecord(
            round=state.round, loss=loss, accuracy=accuracy,
            engine=self.engine_label,
            cohort_pids=(() if cohort is None
                         else tuple(int(p) for p in cohort)),
            metrics=metrics, **bill)

    def evaluate(self, state: PlanState) -> dict:
        """Held-out classification metrics of the current global model (for
        the split LM: next-token prediction at every position)."""
        return self.evaluate_engine_state(state.engine_state)

    @torch.no_grad()
    def evaluate_engine_state(self, engine_state) -> dict:
        """``evaluate`` of an engine state (a Monte-Carlo seed's). Logits
        stay on the device chunk by chunk; only the argmax goes to the
        host."""
        chunk = self._eval_chunk
        pred = torch.cat([
            self._engine.predict(engine_state,
                                 self._x_test[i:i + chunk]).reshape(-1)
            for i in range(0, len(self._x_test), chunk)])
        return metrics_from_predictions(pred.cpu().numpy(), self.y_test,
                                        self._num_classes)

    def run(self, rounds: Optional[int] = None, *, with_eval: bool = True
            ) -> tuple[PlanState, list[RoundRecord]]:
        """Init + run ``rounds`` (default: the mission-budgeted count). With
        telemetry the run is one ``run`` span over ``init`` and the rounds'
        spans; a mission plan also emits its tour legs on the mission clock
        (``fleet.campaign.mission_obs_events``), and the sink is flushed."""
        obs = self.obs
        num = self.num_rounds if rounds is None else rounds
        records = []
        with obs.span("run", rounds=num):
            with obs.span("init"):
                state = self.init()
            for _ in range(num):
                state, rec = self.run_round(state, with_eval=with_eval)
                records.append(rec)
        if obs:
            if self.tour is not None or self.timeline is not None:
                # deferred: fleet.campaign imports the api package
                from ..fleet.campaign import mission_obs_events
                for ev in mission_obs_events(self, records):
                    obs.event(**ev)
            obs.flush()
        return state, records


def pull_round(losses: torch.Tensor, taps: Optional[dict]):
    """A round's losses and tap stacks as numpy, in ONE copy from the
    device (the taps cast to float32, as the reference's are); without taps
    ``(losses, None)``."""
    if not taps:
        return losses.cpu().numpy(), None
    parts = [losses] + [taps[k] for k in taps]
    flat = torch.cat([t.reshape(-1).float() for t in parts]).cpu().numpy()
    out, at = [], 0
    for t in parts:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out[0], dict(zip(taps, out[1:]))


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A numpy batch on ``device``; integer arrays (token ids) as int64,
    the index type of the embedding lookup."""
    t = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    if not t.is_floating_point():
        t = t.long()
    return t.to(device)


# ---------------------------------------------------------------------------
# engines: init_state(params0) / run(state, batches, mask) -> (state, losses
#          tensor[, taps]) / predict(state, inputs) -> predicted classes (on
#          the device). With metrics taps every engine returns the tap dict
#          third. The sequential engines update their modules in place and
#          take no mask (dropout is a fleet policy, refused at validation).
#          An engine with a Monte-Carlo seed axis also has
#          init_seeds(params0, num_seeds) / run_seeds(state, batches, mask),
#          every tensor on a leading seed axis.
# ---------------------------------------------------------------------------

def _load(stages, params):
    """A deep copy of ``stages`` as one module, loaded with ``params``."""
    model = copy.deepcopy(nn.Sequential(*stages))
    with torch.no_grad():
        for stage, p in zip(model, params):
            stage.body.load_state_dict(p)
    return model


def _load_module(module: nn.Module, state_dict: dict,
                 device) -> nn.Module:
    """A deep copy of ``module`` on ``device`` loaded with ``state_dict``."""
    out = copy.deepcopy(module).to(device)
    out.load_state_dict(state_dict)
    return out


class _FLEngine:
    """``fl/scan``: the global model; each client trains a copy from it
    with a fresh AdamW, FedAvg at the end of the round. Its Monte-Carlo
    seed axis (for seeds that draw their own cohorts) is the same round in
    functional form over seed-stacked params (``make_fl_seeds_round``);
    ``predict`` takes a seed's row of those params too."""

    def __init__(self, spec, stages, device, taps=()):
        self.stages = stages
        self.device = device
        self.taps = taps
        self.model = nn.Sequential(*stages)
        self.round_fn = make_fl_round(
            lambda model, bx, by: cross_entropy_loss(
                model(to_port_layout(bx)), by),
            adamw(spec.lr), taps=taps)
        self.seeds_round_fn = make_fl_seeds_round(
            lambda params, bx, by: cross_entropy_loss(
                self.forward(params, bx), by),
            FunctionalAdamW(spec.lr), taps=taps)

    def forward(self, params, x):
        return functional_call(self.model, params, (to_port_layout(x),))

    def init_state(self, params0):
        return _load(self.stages, params0)

    def run(self, model, batches, mask):
        assert mask is None, "dropout needs a fleet engine (validated)"
        out = self.round_fn(model, batches)
        return (model, *out) if self.taps else (model, out)

    def init_seeds(self, params0, num_seeds: int):
        return stack_seeds(tier_params(params0, self.device), num_seeds)

    def run_seeds(self, params, batches, mask):
        assert mask is None, "dropout needs a fleet engine (validated)"
        return self.seeds_round_fn(params, batches)

    def predict(self, state, x):
        if isinstance(state, dict):
            return self.forward(state, x).argmax(dim=-1)
        return state(to_port_layout(x)).argmax(dim=-1)


@dataclasses.dataclass
class SLState:
    clients: list            # per-client prefix modules
    server: nn.Module        # the one shared server suffix
    client_opts: list
    server_opt: Any


class _SLScanEngine:
    """``sl/scan``: sequential Algorithm 3 with one shared server model
    updated per client visit, homogeneous cut. ``load_client(params0)`` /
    ``load_server(params0)`` build one tier's module from the plan's
    ``params0``; ``logits(client, server, inputs)`` is the evaluation
    forward (no link: the reference evaluates the model itself)."""

    def __init__(self, spec, step: SplitStep, *, load_client, load_server,
                 logits, taps=()):
        self.spec = spec
        self.load_client, self.load_server = load_client, load_server
        self.logits = logits
        self.taps = taps
        self.round_fn = make_multi_client_round(
            step, local_rounds=spec.local_steps, taps=taps)

    def init_state(self, params0):
        n = self.spec.clients.num_clients
        clients = [self.load_client(params0) for _ in range(n)]
        server = self.load_server(params0)
        make_opt = adamw(self.spec.lr)
        return SLState(clients=clients, server=server,
                       client_opts=[make_opt(c.parameters()) for c in clients],
                       server_opt=make_opt(server.parameters()))

    def run(self, st: SLState, batches, mask):
        assert mask is None, "dropout needs a fleet engine (validated)"
        out = self.round_fn(st.clients, st.server, st.client_opts,
                            st.server_opt, batches)
        return (st, *out) if self.taps else (st, out)

    def predict(self, st: SLState, x):
        # every client holds the FedAvg'd prefix after a round
        return self.logits(st.clients[0], st.server, x).argmax(dim=-1)


class _FLFleetEngine:
    """``fl/vmap`` and ``fl/shard_map``: the global params dict; the clients
    train from it in one vmapped program (``fleet.engine.
    make_fleet_fl_round``; under shard_map each rank of ``mesh`` its own
    clients), FedAvg (over the active clients under dropout) at the end of
    the round."""

    def __init__(self, spec, stages, device, taps=(), mesh=None):
        self.device = device
        self.model = nn.Sequential(*stages)
        self.masked = _needs_mask(spec)

        def loss_fn(params, batch):
            bx, by = batch
            return cross_entropy_loss(self.forward(params, bx), by)

        self.round_fn, self.seeds_round_fn = (make_fleet_fl_round(
            loss_fn, FunctionalAdamW(spec.lr), client_dropout=self.masked,
            seed_axis=seed_axis, taps=taps,
            client_axis=spec.engine.client_axis, mesh=mesh)
            for seed_axis in (False, True))

    def forward(self, params, x):
        return functional_call(self.model, params, (to_port_layout(x),))

    def init_state(self, params0):
        return tier_params(params0, self.device)

    def run(self, params, batches, mask):
        return self.round_fn(params, batches, *_mask_arg(mask))

    def init_seeds(self, params0, num_seeds: int):
        return stack_seeds(self.init_state(params0), num_seeds)

    def run_seeds(self, params, batches, mask):
        """``run`` with a leading seed axis on every tensor (a
        Monte-Carlo sweep's seeds in one program a local step)."""
        return self.seeds_round_fn(params, batches, *_mask_arg(mask))

    def predict(self, params, x):
        return self.forward(params, x).argmax(dim=-1)


class _SLFleetEngine:
    """``sl/vmap`` and ``sl/shard_map``: parallel SL (``fleet.engine.
    make_fleet_sl_round``; under shard_map each rank of ``mesh`` its own
    clients) over the client-stacked prefixes, one shared server suffix
    updated once a local step on the ``server_reduce`` of the clients'
    gradients, the (masked) FedAvg of the prefixes at the end of the
    round. State:
    ``(params_c, params_s, oc, os_)``. ``params0_tiers(params0)`` gives the
    (client, server) parameter dicts of the plan's ``params0``;
    ``logits(client, server, inputs)`` is the evaluation forward, on the
    prefix of row 0 (or, under dropout, the row mean).

    A sampled cohort (population > num_clients) cannot keep a prefix a
    slot, since a slot holds another population client every round: the
    fleet trains ONE client model shared by the cohort (the EPSL shared
    client tier, ``client_tier="shared"``), updated on the cohort-mean
    gradient, and evaluates with it as it is.

    ``server_pspecs_fn`` (``launch.steps.fleet_server_pspecs``, given for
    a mesh whose ``(fsdp, tp)`` sub-mesh has more than one rank): the
    server params and optimizer state are DTensors on that sub-mesh
    (``server_placements``), gathered for evaluation; under a
    Monte-Carlo seed axis each rank holds its slices of every seed's
    server, the placements shifted by the seed axis."""

    def __init__(self, spec, step: SplitStep, client: nn.Module,
                 server: nn.Module, *, params0_tiers, logits, taps=(),
                 mesh=None, server_pspecs_fn=None):
        self.spec = spec
        self.mesh = mesh
        self.masked = _needs_mask(spec)
        pop = spec.clients.population
        self.client_tier = ("shared" if pop is not None
                            and pop > spec.clients.num_clients
                            else "stacked")
        self.params0_tiers = params0_tiers
        self.opt_c, self.opt_s = (FunctionalAdamW(spec.lr),
                                  FunctionalAdamW(spec.lr))
        self.logits = tier_call(logits, client, server)
        self.loss = make_split_loss(step, client, server)
        # the server sub-mesh's placements, from the server tier's shapes
        self.server_placements = None
        if server_pspecs_fn is not None:
            self.server_placements = server_placements(
                server_pspecs_fn(server.state_dict(), mesh))

        def build(seed_axis):
            return make_fleet_sl_round(
                self.loss, self.opt_c, self.opt_s,
                local_rounds=spec.local_steps,
                server_reduce=spec.engine.server_reduce,
                client_dropout=self.masked, client_tier=self.client_tier,
                seed_axis=seed_axis, taps=taps,
                client_axis=spec.engine.client_axis, mesh=mesh,
                server_placements=self.server_placements)

        self.round_fn, self.seeds_round_fn = build(False), build(True)

    def init_state(self, params0):
        params_c, params_s = self.params0_tiers(params0)
        return fleet_state(params_c, params_s, self.opt_c, self.opt_s,
                           self.spec.clients.num_clients,
                           client_tier=self.client_tier, mesh=self.mesh,
                           server_placements=self.server_placements)

    def run(self, st, batches, mask):
        out = self.round_fn(*st, batches, *_mask_arg(mask))
        return (out[:4], *out[4:])

    def init_seeds(self, params0, num_seeds: int):
        """``init_state`` on a new leading seed axis; a placed server
        state stays DTensors, each rank stacking its own slices."""
        return stack_seeds(self.init_state(params0), num_seeds)

    def run_seeds(self, st, batches, mask):
        """``run`` with a leading seed axis on every tensor (a
        Monte-Carlo sweep's seeds in one program a local step)."""
        out = self.seeds_round_fn(*st, batches, *_mask_arg(mask))
        return (out[:4], *out[4:])

    def predict(self, st, x):
        params_c, params_s = st[0], gather_server_state(st[1])
        prefix = (params_c if self.client_tier == "shared"
                  else _eval_prefix(params_c, self.masked))
        return self.logits(prefix, params_s, x).argmax(dim=-1)


class _HeteroSLEngine:
    """``sl/vmap`` or ``sl/shard_map`` with per-client cuts
    (``fleet.hetero.HeteroFleet`` over ``mesh``): one
    ``make_fleet_sl_round`` and one server suffix a cut bucket, the buckets
    run one after another. State: a list of per-bucket ``(params_c,
    params_s, oc, os_)``, fresh on every ``init_state``. Evaluation is the
    reference's vote: every bucket's model gives its f32 logits (on its
    ``_eval_prefix``), weighted by its client count, summed and divided by
    the fleet size; the argmax of that sum is the prediction."""

    def __init__(self, spec, stages, params0, cut_of_client, link, device,
                 taps=(), mesh=None, server_pspecs_fn=None):
        self.device = device
        self.masked = _needs_mask(spec)
        self.num_clients = spec.clients.num_clients
        self.fleet = HeteroFleet(
            lambda k: cnn_split_program(stages, params0, k,
                                        loss_fn=cross_entropy_loss,
                                        link_boundary=link.boundary("nchw"),
                                        taps=split_step_tap_names(taps)),
            cut_of_client, FunctionalAdamW(spec.lr), FunctionalAdamW(spec.lr),
            local_rounds=spec.local_steps, client_dropout=self.masked,
            server_reduce=spec.engine.server_reduce,
            client_axis=spec.engine.client_axis, mesh=mesh,
            server_pspecs_fn=server_pspecs_fn, taps=taps)
        self.logits = [
            tier_call(_cnn_logits, prog.client, prog.server)
            for prog in (self.fleet.programs[b.cut_index]
                         for b in self.fleet.buckets)]

    def init_state(self, params0):
        return self.fleet.init_states(
            lambda k: (tier_params(params0[:k], self.device),
                       tier_params(params0[k:], self.device)))

    def run(self, st, batches, mask):
        return self.fleet.run_round_on(st, batches, mask)

    def predict(self, st, x):
        votes = None
        for bucket, (params_c, params_s, _, _), logits in zip(
                self.fleet.buckets, st, self.logits):
            out = (logits(_eval_prefix(params_c, self.masked),
                          gather_server_state(params_s), x).float()
                   * len(bucket.client_ids))
            votes = out if votes is None else votes + out
        return (votes / self.num_clients).argmax(dim=-1)


def _cnn_logits(client, server, x):
    """A split CNN's evaluation forward on NHWC images (no link: the
    reference evaluates the model itself)."""
    return server(client(to_port_layout(x)))


def _mask_arg(mask) -> tuple:
    """The fleet rounds take a trailing mask only when built with client
    dropout or an availability trace, and the plan draws one exactly
    then."""
    return () if mask is None else (mask,)


def _needs_mask(spec: ExperimentSpec) -> bool:
    """Whether the engine takes a client mask a round: client dropout, or
    a scenario's stochastic availability trace."""
    if spec.clients.dropout_rate > 0:
        return True
    scn = spec.scenario
    return scn is not None and scn.needs_mask


def _eval_prefix(client_stack: dict, dropout: bool) -> dict:
    """The global client prefix to evaluate with: row 0 (every row holds
    the FedAvg'd prefix), or under dropout, where dropped rows hold stale
    prefixes, the f32 row mean (the reference's ``_eval_prefix``)."""
    if dropout:
        return {k: v.float().mean(dim=0).to(v.dtype)
                for k, v in client_stack.items()}
    return {k: v[0] for k, v in client_stack.items()}


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

def _resolve_data(spec: ExperimentSpec, data):
    if data is not None or spec.data.kind == "arrays":
        if data is None:
            raise ValueError("DataSpec(kind='arrays') needs data=(x_train, "
                             "y_train, x_test, y_test) at compile time")
        return tuple(np.asarray(a) for a in data)
    if spec.data.kind == "tokens":
        # the LM stream: inputs are tokens[:, :-1], targets the next token
        vocab = spec.model.arch.vocab
        n_train = spec.data.n_train or max(24 * spec.clients.num_clients, 96)
        n_test = spec.data.n_test or max(n_train // 4, 32)
        seq = spec.data.seq_len
        toks_tr = synthetic_tokens(np.random.default_rng([spec.seed, 0]),
                                   n_train, seq + 1, vocab)
        toks_te = synthetic_tokens(np.random.default_rng([spec.seed, 1]),
                                   n_test, seq + 1, vocab)
        return toks_tr[:, :-1], toks_tr[:, 1:], toks_te[:, :-1], toks_te[:, 1:]
    gen = SyntheticPestImages(num_classes=spec.model.num_classes,
                              image_size=spec.data.image_size, seed=spec.seed)
    n_train = spec.data.n_train or max(24 * spec.clients.num_clients,
                                       12 * spec.model.num_classes)
    n_test = spec.data.n_test or max(n_train // 4, 48)
    x_train, y_train = gen.sample(np.random.default_rng([spec.seed, 0]),
                                  n_train)
    x_test, y_test = gen.sample(np.random.default_rng([spec.seed, 1]), n_test)
    return x_train, y_train, x_test, y_test


def _resolve_parts(spec: ExperimentSpec, y_train: np.ndarray) -> list:
    """Client data partitions per ``DataSpec.partition``; under a
    population ``population_partition_count`` of them, cycled over the
    population ids (``pid % count``). The materialised corner (population
    == num_clients) builds the per-client partitions of a plan without
    one."""
    n = spec.clients.num_clients
    if spec.clients.population is not None:
        n = population_partition_count(spec.clients.population,
                                       len(y_train))
    if spec.data.partition == "dirichlet":
        return partition_dirichlet(y_train, n, alpha=spec.data.dirichlet_alpha,
                                   seed=spec.seed, min_size=1)
    if spec.data.partition == "iid":
        return partition_iid(len(y_train), n, seed=spec.seed)
    return partition_non_iid(y_train, n, spec.data.classes_per_client,
                             num_classes=spec.model.num_classes,
                             seed=spec.seed)


def _cnn_cuts(spec: ExperimentSpec, stages, sample_x, edges,
              links: list) -> list[int]:
    """Each client's cut of a CNN: the fraction's, or under
    ``CutPolicy(mode="adaptive")`` its minimum-energy cut for its edge
    profile and its own link (``links``, at its nominal channel rate;
    ``fleet.hetero.assign_cuts_cnn``) within the per-step link deadline:
    ``CutPolicy.max_link_s``, or with a mission the UAV's dwell at a stop
    over the local steps."""
    n = spec.clients.num_clients
    if spec.cut_policy.mode != "adaptive":
        return [cut_index_for_fraction(stages, spec.cut_policy.fraction)] * n
    max_link_s = spec.cut_policy.max_link_s
    if max_link_s is None and spec.mission is not None:
        max_link_s = mission_max_link_s(spec.mission.hover_s_per_stop,
                                        spec.mission.comm_s_per_stop,
                                        spec.local_steps)
    return assign_cuts_cnn(stages, sample_x, edges=edges,
                           links=[lk.config for lk in links],
                           min_client_layers=spec.cut_policy.min_client_layers,
                           max_link_s=max_link_s)


def _profile_consts(spec: ExperimentSpec, client_flops):
    """Per-PROFILE ``(t_client_s, power_w)`` arrays for cohort billing, from
    the homogeneous per-step client FLOPs (FL's full step, or the single
    cut's client step), or None without a population. Profiles cycle over
    population ids as they cycle over slots, so in the materialised corner
    the gather ``cohort % profiles`` gives the per-slot constants."""
    if spec.clients.population is None:
        return None
    profs = spec.clients.edge_profiles
    return (np.asarray([client_step_time_s(client_flops, p) for p in profs]),
            np.asarray([p.power_w for p in profs]))


def _validate_transformer(spec: ExperimentSpec):
    """The reference's checks of a transformer spec (``repro/api/plan.py:
    545-571``), then the port's refusals for what it has not ported."""
    eng, arch = spec.engine, spec.model.arch
    if arch is None:
        raise ValueError("ModelSpec(family='transformer') needs arch="
                         "ArchConfig (the stacked attention blocks to split)")
    if arch.n_experts:
        raise ValueError("MoE stacks can't split through the stacked-block "
                         "interface (see transformer_block_apply)")
    if eng.kind != "sl":
        raise ValueError("the transformer family trains split (sl); the "
                         "full-model FL baseline is a CNN-family path")
    if spec.cut_policy.mode != "fraction":
        raise ValueError("transformer cuts are fraction-placed "
                         "(stack_cut_index); adaptive per-client cuts are a "
                         "CNN-stage path for now")
    if spec.data.kind != "tokens":
        raise ValueError("transformer specs train on DataSpec(kind='tokens')")
    if spec.data.partition != "iid":
        raise ValueError("token streams carry no label classes to skew; use "
                         "DataSpec(partition='iid')")
    if eng.server_mesh is not None:
        raise ValueError("server_mesh tier specs are wired for the CNN stage "
                         "path only; the transformer family would silently "
                         "replicate the server suffix (plumb "
                         "fleet_server_pspecs through _compile_sl_stack to "
                         "lift this)")
    if arch.ssm_kind or arch.attn_period:
        # the reference's lm_split_program builds "attn" groups whatever
        # the arch (repro/fleet/hetero.py:225): for a recurrent stack, with
        # no attention heads, its attention divides by zero heads
        # (repro/models/attention.py:80, ZeroDivisionError) and its plan
        # cannot run, so there is nothing to port; a hybrid stack is an MoE
        # one, refused above. Such a stack trains through launch.train.
        raise ValueError(
            f"a split-LM plan of the {arch.name} stack ({arch.family}, "
            f"{arch.n_heads} attention heads) is not a plan the reference "
            f"runs: it builds attention groups of any arch and fails on "
            f"this one (ZeroDivisionError, zero heads); train it with "
            f"launch.train")


def _validate(spec: ExperimentSpec):
    """The reference's checks for the fields the port runs, and a refusal
    for every field it does not."""
    eng, cli = spec.engine, spec.clients
    if cli.num_clients < 1:
        raise ValueError(f"ClientSpec.num_clients must be >= 1, got "
                         f"{cli.num_clients}")
    if not 0.0 <= cli.dropout_rate < 1.0:
        raise ValueError(f"ClientSpec.dropout_rate must be in [0, 1), got "
                         f"{cli.dropout_rate}")
    if cli.population is not None:
        # the reference's refusals, with its messages
        if cli.population < cli.num_clients:
            raise ValueError(
                f"ClientSpec.population={cli.population} is smaller than the "
                f"cohort num_clients={cli.num_clients}; a round samples "
                f"num_clients participants FROM the population (use "
                f"population=None for a fully-materialized fleet)")
        if cli.population > cli.num_clients:
            if eng.kind == "sl" and not eng.is_fleet:
                raise ValueError(
                    "population sampling with sl/scan is unsupported: the "
                    "sequential Algorithm 3 engine keeps per-slot client "
                    "params + Adam moments across rounds, which would leak "
                    "state between the different population clients a slot "
                    "maps to; use sl/vmap or sl/shard_map (the EPSL shared "
                    "client tier) or fl/* (stateless rounds)")
            if spec.cut_policy.mode == "adaptive":
                raise ValueError(
                    "adaptive per-client cuts re-bucket (and so recompile) "
                    "per sampled cohort; population sampling supports "
                    "fraction cuts only")
    if eng.kind not in ("fl", "sl"):
        raise ValueError(f"engine.kind must be 'fl' or 'sl', got {eng.kind!r}")
    if eng.client_axis not in ("scan", "vmap", "shard_map"):
        raise ValueError(f"engine.client_axis must be 'scan', 'vmap' or "
                         f"'shard_map', got {eng.client_axis!r}")
    if spec.model.family not in ("cnn", "transformer"):
        raise ValueError(f"unknown model family {spec.model.family!r}")
    if spec.model.family == "transformer":
        _validate_transformer(spec)
    elif spec.model.name not in CNN_BUILDERS:
        raise ValueError(f"unknown CNN {spec.model.name!r}")
    if spec.model.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"ModelSpec.attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {spec.model.attn_impl!r}")
    if spec.model.attn_impl != "xla" and spec.model.family != "transformer":
        raise ValueError("ModelSpec.attn_impl selects the transformer "
                         "attention kernel; CNN stage lists have no "
                         "attention to dispatch")
    if eng.link_kernel not in LINK_KERNELS:
        raise ValueError(f"EngineSpec.link_kernel must be one of "
                         f"{LINK_KERNELS}, got {eng.link_kernel!r}")
    if eng.link_kernel != "xla" and spec.link_policy.compress != "int8":
        raise ValueError("EngineSpec.link_kernel fuses the int8 boundary; "
                         "it needs LinkPolicy(compress='int8')")
    if spec.data.kind not in ("synthetic", "arrays", "tokens"):
        raise ValueError(f"DataSpec.kind must be 'synthetic', 'arrays' or "
                         f"'tokens', got {spec.data.kind!r}")
    if spec.data.kind == "tokens" and spec.model.family != "transformer":
        raise ValueError("DataSpec(kind='tokens') is the transformer "
                         "family's pipeline; CNN specs train on 'synthetic' "
                         "or 'arrays'")
    if spec.data.partition not in ("classes", "dirichlet", "iid"):
        raise ValueError(f"DataSpec.partition must be 'classes', 'dirichlet' "
                         f"or 'iid', got {spec.data.partition!r}")
    if spec.cut_policy.mode not in ("fraction", "adaptive"):
        raise ValueError(spec.cut_policy.mode)
    if spec.cut_policy.mode == "adaptive" and not (
            eng.kind == "sl" and eng.is_fleet):
        raise ValueError("adaptive cuts produce per-client programs; they "
                         "need the bucketed fleet engine (sl/vmap or "
                         "sl/shard_map)")
    if cli.dropout_rate > 0 and not eng.is_fleet:
        raise ValueError("client dropout is a fleet policy; use a vmap or "
                         "shard_map client axis")
    scn = spec.scenario
    if scn is not None:
        if not isinstance(scn, ScenarioSpec):
            raise TypeError(f"ExperimentSpec.scenario takes a "
                            f"repro_torch.sim.ScenarioSpec, got "
                            f"{type(scn).__name__}")
        scn.validate(has_mission=spec.mission is not None)
        if scn.needs_mask and not eng.is_fleet:
            raise ValueError("availability traces mask clients per round; "
                             "they need a fleet engine (vmap or shard_map "
                             "client axis)")
        if scn.needs_mask and cli.dropout_rate > 0:
            raise ValueError("pick ONE straggler process: ClientSpec."
                             "dropout_rate (i.i.d.) or the scenario's "
                             "availability trace")
        if scn.num_uavs > cli.num_clients:
            raise ValueError(f"{scn.num_uavs} UAVs for "
                             f"{cli.num_clients} clients")
    if eng.server_mesh is not None:
        if eng.kind != "sl" or not eng.is_fleet:
            raise ValueError("server_mesh shards the SL server suffix; it "
                             "needs a fleet SL engine (sl/vmap or "
                             "sl/shard_map)")
        f, t = eng.server_mesh
        if f < 1 or t < 1:
            raise ValueError(f"server_mesh sizes must be >= 1, got "
                             f"{eng.server_mesh}")


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("compile_experiment runs on a CUDA device by "
                           "default and none is available; pass "
                           "device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be CUDA or the CPU, got {device}")
    return device


def _refuse_idle_rank(n: int, fsdp: int, tp: int) -> None:
    """On a rank past the fleet mesh ``make_fleet_mesh`` built over the
    default process group (it holds no clients): the refusal."""
    if not dist.is_initialized():
        return
    world = dist.get_world_size()
    layout = fleet_layout(n, world, fsdp=fsdp, tp=tp)
    if layout is not None:
        data = layout[0]
        raise ValueError(
            f"rank {dist.get_rank()} holds none of the {n} clients "
            f"(data={data}, fsdp={fsdp}, tp={tp}: {data * fsdp * tp} of "
            f"{world} ranks)")


def _resolve_mesh(spec: ExperimentSpec, mesh, device: torch.device):
    """The fleet mesh of a fleet-axis engine (the reference's
    ``_resolve_mesh``): a ``server_mesh`` grows the ``('data', 'fsdp',
    'tp')`` layout (``make_fleet_mesh`` over the default process group),
    refused when it needs more ranks than exist; an explicit mesh must
    have the spec's ``(fsdp, tp)``; ``shard_map`` always gets a concrete
    mesh (else the single-rank mesh); a mesh must divide the fleet and
    serve the plan's device.

    The reference refuses ``shard_map`` with fsdp * tp > 1 on its CPU
    backend, for an abort of its XLA:CPU partitioner; the port has no such
    abort and runs that layout on the CPU and the card alike."""
    eng = spec.engine
    if not eng.is_fleet:
        return mesh
    n = spec.clients.num_clients
    # every rank takes part in make_fleet_mesh (the DeviceMesh makes groups)
    if mesh is None and eng.server_mesh is not None:
        f, t = eng.server_mesh
        mesh = make_fleet_mesh(n, fsdp=f, tp=t, device=device)
        if mesh is None:
            _refuse_idle_rank(n, f, t)
            if f * t > 1:
                world = dist.get_world_size() if dist.is_initialized() else 1
                raise ValueError(
                    f"server_mesh={eng.server_mesh} needs at least {f * t} "
                    f"devices ({world} available)")
    elif mesh is not None and eng.server_mesh is not None:
        # an explicit mesh must deliver the server sub-mesh the spec asked
        # for, never silently fall back to a replicated server suffix
        if server_mesh_sizes(mesh) != tuple(eng.server_mesh):
            raise ValueError(
                f"server_mesh={eng.server_mesh} but the supplied mesh has "
                f"(fsdp, tp)={server_mesh_sizes(mesh)}; build it with "
                f"launch.mesh.make_fleet_mesh(num_clients, fsdp=, tp=) or "
                f"drop one of the two")
    if mesh is None and eng.client_axis == "shard_map":
        mesh = make_fleet_mesh(n, device=device)
        if mesh is None:
            _refuse_idle_rank(n, 1, 1)
            mesh = single_device_fleet_mesh(device)
    if mesh is None:
        return None
    validate_fleet_mesh(mesh, n)
    if mesh.size > 1 and mesh.group is None:
        raise ValueError(f"a fleet mesh of data={mesh.size} ranks needs "
                         f"their process group (launch.mesh."
                         f"make_fleet_mesh or data_mesh)")
    if mesh.device.type != device.type:
        raise ValueError(f"the fleet mesh's ranks work on {mesh.device}, "
                         f"the plan on {device}: the collectives of a "
                         f"{device.type} fleet stay on its device")
    return mesh


def _rank_obs(obs: Obs, mesh) -> Obs:
    """Rank 0 of a data group writes the run's telemetry; any other rank
    computes the same metrics with no sink."""
    if obs and mesh is not None and not mesh.writes:
        return Obs(ObsConfig(enabled=False, metrics=obs.config.metrics))
    return obs


def compile_experiment(spec: ExperimentSpec, *, mesh=None, data=None,
                       device="cuda", obs=None, server_pspecs=None) -> Plan:
    """Lower ``spec`` to a ``Plan`` on ``device`` (CUDA unless the caller
    asks for the CPU). ``data`` is an optional ``(x_train, y_train, x_test,
    y_test)`` tuple of numpy arrays: NHWC images and labels, or (for the
    split LM) token and next-token arrays (required for
    ``DataSpec(kind='arrays')``).

    ``mesh`` (a ``launch.mesh.FleetMesh``) spreads a fleet plan's clients
    over its data group: every rank compiles and runs the same plan (the
    same seed draws the same batches and masks), trains its own clients,
    and holds the whole client state; rank 0 writes the telemetry. By
    default a ``shard_map`` plan takes ``make_fleet_mesh`` over the
    initialised default process group, or the single-rank mesh, whose
    collectives are the identity; a ``server_mesh=(fsdp, tp)`` spec takes
    ``make_fleet_mesh(num_clients, fsdp=, tp=)``. With fsdp * tp > 1 the
    SL server suffix's params and AdamW moments are DTensors on the
    mesh's ``(fsdp, tp)`` sub-mesh (``launch.steps.fleet_server_pspecs``),
    the clients sharded over ``data``. ``server_pspecs`` (a function of
    the server params and the mesh, as ``fleet_server_pspecs`` is) takes
    that rule's place for a split CNN on the fleet engines, and places
    the server suffix even on a sub-mesh of one rank (where the rule
    places nothing): a one-card run of the placed path.

    ``obs`` opts into telemetry: a ``repro_torch.obs.ObsConfig`` (or a live
    ``Obs`` to share one run dir across plans). The lowering emits
    ``compile/*`` spans, the plan stamps its row into the run manifest, and
    every ``run_round`` streams spans, gauges and records to
    ``<run_root>/<run_id>/``. ``ObsConfig.metrics`` adds the metrics bus,
    with or without a sink. ``None`` (default) attaches the shared disabled
    instance."""
    _validate(spec)
    device = _resolve_device(device)
    mesh = _resolve_mesh(spec, mesh, device)
    obs = _rank_obs(Obs.ensure(obs), mesh)
    with obs.span("compile", spec=spec.describe()):
        plan = _compile_plan(spec, data=data, device=device, obs=obs,
                             mesh=mesh, server_pspecs=server_pspecs)
    if obs:
        obs.manifest(plan={
            "spec": spec.describe(), "engine": plan.engine_label,
            "model": (spec.model.name if spec.model.family == "cnn"
                      else spec.model.family),
            "num_clients": spec.clients.num_clients,
            "population": spec.clients.population,
            "rounds": plan.num_rounds, "local_steps": spec.local_steps,
            "batch_size": spec.batch_size,
            "mesh": None if mesh is None else mesh.shape,
            "device": str(plan.device)})
        obs.flush()
    return plan


def _compile_plan(spec: ExperimentSpec, *, data, device, obs: Obs,
                  mesh=None, server_pspecs=None) -> Plan:
    """The lowering; every phase of it runs inside a ``compile/*`` span, so
    the spans account for the ``compile`` span's wall time."""
    n = spec.clients.num_clients
    if server_pspecs is not None and not (
            mesh is not None and spec.engine.is_fleet
            and spec.engine.kind == "sl" and spec.model.family == "cnn"):
        raise ValueError(
            "server_pspecs places the server suffix of a split CNN on the "
            "fleet engines over a fleet mesh (mesh=, or a server_mesh "
            "spec); this plan has none to place")
    # the metrics bus: the tap channels, resolved here. No MetricsConfig ->
    # no taps -> every engine runs its tap-free operations;
    # ObsConfig(enabled=False, metrics=...) computes the taps with no sink
    metrics = obs.config.metrics
    graph_taps = engine_tap_names(
        metrics, kind=spec.engine.kind,
        has_link=spec.link_policy.compress == "int8")
    step_taps = split_step_tap_names(graph_taps)
    with obs.span("compile/data"):
        obs.set_device(device)
        arrays = _resolve_data(spec, data)
        x_train, y_train, _, _ = arrays
        parts = _resolve_parts(spec, y_train)
        edges = [spec.clients.edge_profiles[
            i % len(spec.clients.edge_profiles)] for i in range(n)]
        link = FleetLink(config=spec.link_policy.config(),
                         kernel=resolve_link_kernel(spec.engine.link_kernel,
                                                    device))

    scn = spec.scenario
    tour = timeline = None
    with obs.span("compile/mission"):
        if spec.mission is not None:
            coords = client_coords(spec.mission.farm_acres, n,
                                   seed=spec.seed)
            if scn is not None:
                # a scenario's mission rolls out in time (several UAVs, the
                # serve geometry); one hovering UAV is plan_tour's plan
                timeline = rollout_mission(
                    coords, np.zeros(2), params=spec.mission.uav,
                    hover_s_per_stop=spec.mission.hover_s_per_stop,
                    comm_s_per_stop=spec.mission.comm_s_per_stop,
                    num_uavs=scn.num_uavs, serve_mode=scn.serve_mode)
                if scn.num_uavs == 1:
                    tour = timeline.routes[0].tour
            else:
                tour = plan_tour(
                    coords, np.zeros(2), params=spec.mission.uav,
                    hover_s_per_stop=spec.mission.hover_s_per_stop,
                    comm_s_per_stop=spec.mission.comm_s_per_stop)

        # each client's nominal rate: the channel's deterministic rate at
        # its serve distance (the link policy's without a channel); its
        # link constants are hoisted at it, and a round's draw scales them
        # by nominal / sampled
        serve_dist = (timeline.serve_dist_m if timeline is not None
                      else np.zeros(n))
        rate_nominal = np.full(n, spec.link_policy.rate_bps)
        if scn is not None and scn.channel is not None:
            rate_nominal = deterministic_rate_bps(
                scn.channel, serve_dist,
                spec.link_policy.rate_bps).astype(np.float64)
        lp = spec.link_policy
        client_links = [FleetLink(config=LinkConfig(
            rate_bps=float(rate_nominal[c]), compress=lp.compress,
            radio_power_w=lp.radio_power_w), kernel=link.kernel)
            for c in range(n)]

    # ---- per-client constants -------------------------------------------
    t_client = np.zeros(n)
    t_server = np.zeros(n)
    link_bytes = np.zeros(n)
    link_time = np.zeros(n)
    link_energy = np.zeros(n)
    server_base_s = 0.0
    flops: dict = {}
    stages = None
    num_classes, eval_chunk = spec.model.num_classes, EVAL_CHUNK

    if spec.model.family == "transformer":
        cfg = spec.model.arch
        k = stack_cut_index(cfg.n_layers, spec.cut_policy.fraction)
        impl = resolve_attn_impl(spec.model.attn_impl, device)
        with obs.span("compile/params"):
            sample_x, sample_y = _sample_batch(spec, x_train, y_train,
                                               device)
            prog = lm_split_program(
                cfg, torch.Generator().manual_seed(spec.seed), k,
                link_boundary=link.boundary("bsd"), attn_impl=impl,
                taps=step_taps)
            params0 = tuple({key: v.detach().clone()
                             for key, v in m.state_dict().items()}
                            for m in (prog.client, prog.server))
            client, server = prog.client.to(device), prog.server.to(device)
        with obs.span("compile/flops"):
            # the dispatch-level FLOP counter cannot see inside a kernel
            # launch: a "pallas" plan is billed through the plain attention
            # of the "ref" seam, the same O(S^2) work, so its bill does not
            # depend on the kernel. Likewise the bill counts the plain loss
            # of the whole logits, the reference's form: the chunked loss
            # the engines train on forms the same three head products, and
            # its backward's scaling of the saved gradients is work the
            # plain loss does not do. The counted step has no taps, so the
            # bill is the same with the metrics bus on
            count_step, _ = lm_split_step(
                cfg, attn_impl="ref" if impl == "pallas" else impl)
            cut_of_client = [k] * n
            flops[k] = count_split_step_flops(count_step, client, server,
                                              sample_x, sample_y)

        def lm_logits(c, s_, x):
            return prog.server_logits(s_, prog.step.client_fwd(c, x))

        with obs.span("compile/lower"):
            if spec.engine.is_fleet:
                engine = _SLFleetEngine(
                    spec, prog.step, client, server, logits=lm_logits,
                    params0_tiers=lambda p: tuple(
                        {key: v.to(device) for key, v in tier.items()}
                        for tier in p), taps=graph_taps, mesh=mesh)
            else:
                # each init() copies the two tiers from these templates; they
                # wait on the host, not on the card beside their copies
                client.cpu()
                server.cpu()
                engine = _SLScanEngine(
                    spec, prog.step,
                    load_client=lambda p: _load_module(client, p[0], device),
                    load_server=lambda p: _load_module(server, p[1], device),
                    logits=lm_logits, taps=graph_taps)
        num_classes, eval_chunk = cfg.vocab, LM_EVAL_CHUNK
    else:
        with obs.span("compile/params"):
            sample_x, sample_y = _sample_batch(spec, x_train, y_train,
                                               device)
            # the port's own initializer; see init_stages
            stages = CNN_BUILDERS[spec.model.name](spec.model.num_classes)
            init_stages(torch.Generator().manual_seed(spec.seed), stages)
            params0 = [{key: v.detach().clone()
                        for key, v in st.body.state_dict().items()}
                       for st in stages]
            for st in stages:
                st.to(device=device, memory_format=torch.channels_last)
        if spec.engine.kind == "sl":
            with obs.span("compile/cuts"):
                cut_of_client = _cnn_cuts(spec, stages, sample_x, edges,
                                          client_links)
            with obs.span("compile/flops"):
                for k in sorted(set(cut_of_client)):
                    flops[k] = count_sl_step_flops(stages[:k], stages[k:],
                                                   sample_x, sample_y)
            # the server sub-mesh's specs: the reference shards the server
            # suffix only over a sub-mesh of more than one rank
            fsdp, tp = server_mesh_sizes(mesh)
            pspecs_fn = (server_pspecs if server_pspecs is not None
                         else fleet_server_pspecs if fsdp * tp > 1
                         else None)
            with obs.span("compile/lower"):
                if len(flops) > 1:
                    engine = _HeteroSLEngine(spec, stages, params0,
                                             cut_of_client, link, device,
                                             taps=graph_taps, mesh=mesh,
                                             server_pspecs_fn=pspecs_fn)
                else:
                    engine = _sl_cnn_engine(spec, stages, params0,
                                            cut_of_client[0], link, device,
                                            graph_taps, mesh, pspecs_fn)

    if spec.engine.kind == "fl":
        cut_of_client: list[int] = []
        with obs.span("compile/flops"):
            step_flops = count_fl_step_flops(stages, sample_x, sample_y)
            flops["full"] = step_flops
            for c in range(n):
                t_client[c] = client_step_time_s(step_flops, edges[c])
        server_base_s = FL_SERVER_AGG_S
        with obs.span("compile/lower"):
            engine = (_FLFleetEngine(spec, stages, device, taps=graph_taps,
                                     mesh=mesh)
                      if spec.engine.is_fleet
                      else _FLEngine(spec, stages, device, taps=graph_taps))
    else:
        # each client at its own cut's counts and smashed tensor
        with obs.span("compile/flops"):
            for cid, k in enumerate(cut_of_client):
                fl_client, fl_server, smashed = flops[k]
                t_client[cid] = client_step_time_s(fl_client, edges[cid])
                t_server[cid] = roofline_s(fl_server, RTX_A5000)
                link_bytes[cid] = client_links[cid].step_wire_bytes(smashed)
                link_time[cid] = client_links[cid].step_time_s(smashed)
                link_energy[cid] = client_links[cid].step_energy_j(smashed)
    consts = (t_client, t_server, link_bytes, link_time, link_energy,
              server_base_s)
    # one per-step client cost exists for FL and for a single cut; with
    # cuts that differ there is none (reachable only without a population,
    # where the per-slot constants bill exactly)
    client_flops = (flops["full"] if spec.engine.kind == "fl"
                    else flops[cut_of_client[0]][0] if len(flops) == 1
                    else None)
    with obs.span("compile/lower"):
        return Plan(spec, device=device, arrays=arrays, parts=parts,
                    stages=stages, params0=params0, tour=tour,
                    cut_of_client=cut_of_client, flops=flops, edges=edges,
                    consts=consts, engine=engine, num_classes=num_classes,
                    eval_chunk=eval_chunk,
                    prof_consts=_profile_consts(spec, client_flops),
                    timeline=timeline, serve_dist_m=serve_dist,
                    rate_nominal=rate_nominal, obs=obs, metrics=metrics,
                    graph_taps=graph_taps, mesh=mesh)


def _sample_batch(spec: ExperimentSpec, x_train, y_train, device):
    """The first ``batch_size`` training examples on ``device``: the batch
    the FLOP counters and the cut profile trace."""
    return (_to_device(x_train[:spec.batch_size], device),
            torch.from_numpy(
                y_train[:spec.batch_size].astype(np.int64)).to(device))


def _sl_cnn_engine(spec, stages, params0, k: int, link, device, taps,
                   mesh=None, server_pspecs_fn=None):
    """The single-cut split CNN's engine: ``sl/vmap``, ``sl/shard_map`` or
    ``sl/scan``."""
    prog = cnn_split_program(stages, params0, k, loss_fn=cross_entropy_loss,
                             link_boundary=link.boundary("nchw"),
                             taps=split_step_tap_names(taps))
    if spec.engine.is_fleet:
        return _SLFleetEngine(
            spec, prog.step, prog.client, prog.server, logits=_cnn_logits,
            params0_tiers=lambda p: (tier_params(p[:k], device),
                                     tier_params(p[k:], device)),
            taps=taps, mesh=mesh, server_pspecs_fn=server_pspecs_fn)
    return _SLScanEngine(
        spec, prog.step,
        load_client=lambda p: _load(stages[:k], p[:k]),
        load_server=lambda p: _load(stages[k:], p[k:]),
        logits=_cnn_logits, taps=taps)
