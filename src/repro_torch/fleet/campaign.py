"""Fleet campaign configs: the paper's UAV mission, at fleet scale, as specs.

Counterpart of ``repro.fleet.campaign``. ``CampaignConfig`` is the
historical config surface and ``campaign_spec`` turns one into the
``ExperimentSpec`` (with a ``MissionSpec``) it stands for, on the parallel
fleet SL engine (``sl/vmap``)::

    plan = repro_torch.api.compile_experiment(campaign_spec(cfg))
    state, records = plan.run()        # one RoundRecord per executed round

One campaign composes the layers end to end: client placement on the farm
(``api.runtime.client_coords``), the exact-TSP UAV tour and Algorithm 2's
round budget (``plan.tour``, ``plan.rounds_budget``), the fleet SL engine
with one cut or per-client cuts in buckets (``adaptive_cuts``, under the
UAV's dwell as the link deadline) and optional client dropout, the fp32 or
int8 link, and the per-step energy constants. The rounds that run are
``min(cfg.global_rounds, tour.rounds)``: the UAV's energy budget caps the
campaign. ``campaign_totals`` adds the return-to-base leg that no record
bills; ``mission_obs_events`` decomposes each round's UAV time into its
legs on the mission clock, a UAV at a time under a scenario's rolled-out
mission (``plan.timeline``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..api.spec import (ClientSpec, CutPolicy, DataSpec, EngineSpec,
                        ExperimentSpec, LinkPolicy, MissionSpec, ModelSpec)
from ..core.energy import HardwareProfile, JETSON_AGX_ORIN
from ..core.link import LinkConfig
from ..core.uav_energy import DEFAULT_UAV, UAVParams
from ..sim.scenario import ScenarioSpec


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    model: str = "tinycnn"
    num_classes: int = 12
    num_clients: int = 8
    client_fraction: float = 0.4       # the one cut (adaptive_cuts off)
    adaptive_cuts: bool = False        # per-client cuts in buckets
    global_rounds: int = 4             # cap; the UAV budget may cut it short
    local_steps: int = 2
    batch_size: int = 8
    image_size: int = 16
    classes_per_client: int = 3
    lr: float = 1e-3
    link: LinkConfig = LinkConfig()
    farm_acres: float = 100.0
    uav: UAVParams = DEFAULT_UAV
    hover_s_per_stop: float = 30.0
    comm_s_per_stop: float = 10.0
    # heterogeneity for adaptive cuts: profiles cycled over the clients
    edge_profiles: tuple[HardwareProfile, ...] = (JETSON_AGX_ORIN,)
    # P3SL-style straggler masking: per-round client dropout probability
    dropout_rate: float = 0.0
    # the registered fleet a round's cohort of num_clients is drawn from
    # (None: the fleet is the cohort); see ClientSpec.population
    population: int | None = None
    # the stochastic environment (ExperimentSpec.scenario, a
    # sim.ScenarioSpec); None keeps the constant-rate, always-available
    # campaign
    scenario: Optional[ScenarioSpec] = None
    seed: int = 0


def campaign_totals(records, tour) -> dict:
    """Mission totals over a campaign's ``RoundRecord`` stream. A record
    bills the tour legs flown in its round; the return-to-base leg
    (``tour.e_return``) is flown once at the mission's end and is in no
    record, though Algorithm 2's budget reserves it, so it is added here
    (pass ``plan.tour``)."""
    return {
        "rounds_run": len(records),
        "link_bytes": sum(r.link_bytes for r in records),
        "link_energy_j": sum(r.link_energy_j for r in records),
        "client_energy_j": sum(r.client_energy_j for r in records),
        "server_energy_j": sum(r.server_energy_j for r in records),
        "uav_energy_j": sum(r.uav_energy_j for r in records)
        + (tour.e_return if tour is not None else 0.0),
        "final_accuracy": records[-1].accuracy if records else 0.0,
    }


def _event(name, rnd, uav, t, dur) -> dict:
    return {"ev": "mission_span", "name": f"mission/{name}", "round": rnd,
            "uav": uav, "clock": "mission", "t_mission_s": round(t, 3),
            "dur_s": round(float(dur), 3)}


def mission_obs_events(plan, records) -> list[dict]:
    """The tour's legs as telemetry events on the simulated mission clock,
    one event a (round, UAV, leg): ``travel`` (the tour length at cruise
    speed), ``hover`` (the clients' compute window, ``hover_s_per_stop`` a
    stop) and ``comm`` (the link's window, ``comm_s_per_stop`` a stop).
    Each event carries ``clock: "mission"`` and ``t_mission_s``, the
    seconds into the mission, in place of a wall-clock time. Without a
    timeline rounds follow one another at the sum of the three legs; with
    one (``plan.timeline``) each UAV's legs start at the round's
    fleet-synchronised start time, over the clients of its route."""
    mission = plan.spec.mission
    if mission is None or not records:
        return []
    v = max(mission.uav.V, 1e-9)
    events = []
    if plan.timeline is not None:
        tl = plan.timeline
        starts = tl.round_start_s
        for rec in records:
            r = rec.round
            t0 = float(starts[r]) if r < len(starts) else float(
                starts[-1] + (r - len(starts) + 1) * tl.round_duration_s)
            for route in tl.routes:
                legs = (("travel", route.tour.tour_length / v),
                        ("hover", len(route.client_ids)
                         * mission.hover_s_per_stop),
                        ("comm", len(route.client_ids)
                         * mission.comm_s_per_stop))
                t = t0
                for name, dur in legs:
                    events.append(_event(name, r, route.uav, t, dur))
                    t += dur
        return events
    n = plan.spec.clients.num_clients
    legs = (("travel", plan.tour.tour_length / v),
            ("hover", n * mission.hover_s_per_stop),
            ("comm", n * mission.comm_s_per_stop))
    round_s = sum(d for _, d in legs)
    for rec in records:
        t = rec.round * round_s
        for name, dur in legs:
            events.append(_event(name, rec.round, 0, t, dur))
            t += dur
    return events


def campaign_spec(cfg: CampaignConfig) -> ExperimentSpec:
    """The ``ExperimentSpec`` a ``CampaignConfig`` stands for: the parallel
    fleet SL engine (``sl/vmap``) under a UAV mission."""
    return ExperimentSpec(
        model=ModelSpec(name=cfg.model, num_classes=cfg.num_classes),
        data=DataSpec(kind="synthetic", image_size=cfg.image_size,
                      classes_per_client=cfg.classes_per_client),
        clients=ClientSpec(num_clients=cfg.num_clients,
                           edge_profiles=cfg.edge_profiles,
                           dropout_rate=cfg.dropout_rate,
                           population=cfg.population),
        cut_policy=CutPolicy(
            mode="adaptive" if cfg.adaptive_cuts else "fraction",
            fraction=cfg.client_fraction),
        link_policy=LinkPolicy(rate_bps=cfg.link.rate_bps,
                               compress=cfg.link.compress,
                               radio_power_w=cfg.link.radio_power_w),
        engine=EngineSpec(kind="sl", client_axis="vmap"),
        mission=MissionSpec(farm_acres=cfg.farm_acres, uav=cfg.uav,
                            hover_s_per_stop=cfg.hover_s_per_stop,
                            comm_s_per_stop=cfg.comm_s_per_stop),
        scenario=cfg.scenario,
        global_rounds=cfg.global_rounds, local_steps=cfg.local_steps,
        batch_size=cfg.batch_size, lr=cfg.lr, seed=cfg.seed)
