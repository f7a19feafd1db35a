"""Time-stepped mission rollout over the Held-Karp tour.

A copy of ``repro.sim.mission`` (numpy only) on the port's
``core.trajectory`` and ``core.uav_energy``, pinned equal to it by
``tests/test_torch_copies.py``.

Turns Algorithm 2's closed-form round budget into an explicit timeline:
per-round start times, per-client hover (serve) windows, per-UAV battery
state, and the return-to-base reservation — plus two generalizations the
paper's single-UAV mission idealizes away:

  * **multi-UAV dispatch** — the fleet is partitioned into ``num_uavs``
    contiguous arcs of the global exact tour; each UAV plans its own
    (exact) tour + budget over its arc, and a *fleet* round completes when
    the slowest UAV finishes (rounds = min over UAVs of their budgets).
  * **serve modes** — ``"hover"``: the UAV parks directly above each
    client (slant distance = altitude, the paper's geometry); ``"relay"``:
    the UAV parks at its partition's centroid and serves all its clients
    from there (per-client slant distances vary — the knob that makes the
    ``sim.channel`` path-loss term bite).

With ``num_uavs=1`` and ``serve_mode="hover"`` the single route is the
verbatim ``core.trajectory.plan_tour`` plan — same Held-Karp order, same
``e_first`` / ``e_per_round`` / ``rounds`` — so the degenerate scenario
bills exactly what the idealized campaign billed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.trajectory import TourPlan, budget_rounds, plan_tour, solve_tsp
from ..core.uav_energy import DEFAULT_UAV, UAVParams


@dataclasses.dataclass(frozen=True)
class UavRoute:
    """One UAV's assignment: the clients it serves and its planned tour."""
    uav: int
    client_ids: tuple[int, ...]   # global client indices, visit order
    tour: TourPlan                # over this partition (order indexes the
    #                               partition's coords, not global ids)
    hover_xy: np.ndarray          # (stops, 2) serve waypoints, visit order
    serve_dist_m: np.ndarray      # (len(client_ids),) slant distance per
    #                               client, aligned with client_ids
    round_duration_s: float       # steady-state seconds per round


@dataclasses.dataclass(frozen=True)
class MissionTimeline:
    """The rolled-out mission: fleet-synchronized rounds + battery traces."""
    routes: tuple[UavRoute, ...]
    rounds: int                   # fleet rounds (min over UAVs; Alg. 2 budget)
    e_first_j: float              # summed over UAVs: base->first + round 0
    e_per_round_j: float          # summed over UAVs
    e_return_j: float             # summed return legs (reserved, billed once)
    battery_j: np.ndarray         # (num_uavs, rounds+1) energy remaining
    round_start_s: np.ndarray     # (rounds,) fleet-synchronized start times
    round_duration_s: float       # max over UAVs (the fleet waits)
    serve_dist_m: np.ndarray      # (num_clients,) slant distances, global ids
    hover_start_s: np.ndarray     # (num_clients,) serve-window offset within
    #                               a steady-state round

    @property
    def num_uavs(self) -> int:
        return len(self.routes)

    def uav_energy_j(self, round_index: int) -> float:
        """The fleet's tour energy billed to one round (round 0 carries the
        base->first legs) — the same split the idealized campaign bills."""
        return self.e_first_j if round_index == 0 else self.e_per_round_j


def _partition_by_tour(coords: np.ndarray, num_uavs: int,
                       exact_limit: int) -> list[np.ndarray]:
    """Contiguous arcs of the global tour, one per UAV (near-equal sizes).
    Single-UAV keeps the identity order so the route's own exact solve is
    byte-identical to ``plan_tour`` over the full fleet."""
    n = len(coords)
    if num_uavs == 1:
        return [np.arange(n)]
    if num_uavs > n:
        raise ValueError(f"{num_uavs} UAVs for {n} clients")
    order, _ = solve_tsp(coords, exact_limit=exact_limit)
    return [np.asarray(chunk)
            for chunk in np.array_split(np.asarray(order), num_uavs)]


def _relay_tour(centroid: np.ndarray, base: np.ndarray, num_stops: int,
                params: UAVParams, hover_s: float, comm_s: float) -> TourPlan:
    """A degenerate one-waypoint tour: park at the centroid, dwell one
    hover+comm window per served client, return at mission end."""
    leg = float(np.linalg.norm(centroid - base))
    e_pi = num_stops * (hover_s * params.xi_h + comm_s * params.xi_c)
    e_first = (leg / params.V) * params.xi_m() + e_pi
    e_return = (leg / params.V) * params.xi_m()
    rounds, total = budget_rounds(params.beta, e_first, e_pi, e_return)
    return TourPlan(order=[0], tour_length=0.0, rounds=rounds,
                    e_per_round=e_pi, e_first=e_first, e_return=e_return,
                    total_energy=total)


def _leg_lengths(waypoints: np.ndarray, order: list[int]) -> np.ndarray:
    """Cycle leg lengths in visit order: leg[i] = dist(order[i-1], order[i])
    (leg[0] closes the cycle from the last stop)."""
    pts = waypoints[np.asarray(order)]
    return np.linalg.norm(pts - np.roll(pts, 1, axis=0), axis=-1)


def rollout_mission(coords: np.ndarray, base: np.ndarray, *,
                    params: UAVParams = DEFAULT_UAV,
                    hover_s_per_stop: float = 30.0,
                    comm_s_per_stop: float = 10.0,
                    num_uavs: int = 1, serve_mode: str = "hover",
                    exact_limit: int = 16) -> MissionTimeline:
    """Roll one mission out in time. ``coords`` are the (n, 2) client ground
    positions, ``base`` the charging station. Returns the fleet timeline."""
    if serve_mode not in ("hover", "relay"):
        raise ValueError(f"serve_mode must be 'hover' or 'relay', "
                         f"got {serve_mode!r}")
    n = len(coords)
    parts = _partition_by_tour(coords, num_uavs, exact_limit)
    alt = params.altitude
    routes: list[UavRoute] = []
    serve_dist = np.zeros(n)
    hover_start = np.zeros(n)
    for u, ids in enumerate(parts):
        sub = coords[ids]
        m = len(ids)
        if serve_mode == "hover":
            tour = plan_tour(sub, base, params=params,
                             hover_s_per_stop=hover_s_per_stop,
                             comm_s_per_stop=comm_s_per_stop,
                             exact_limit=exact_limit)
            visit = ids[np.asarray(tour.order)]
            hover_xy = sub[np.asarray(tour.order)]
            dist = np.full(m, alt)          # overhead: slant = altitude
            legs = _leg_lengths(sub, tour.order)
        else:  # relay
            centroid = sub.mean(axis=0)
            tour = _relay_tour(centroid, base, m, params,
                               hover_s_per_stop, comm_s_per_stop)
            visit = ids
            hover_xy = np.broadcast_to(centroid, (1, 2)).copy()
            ground = np.linalg.norm(sub - centroid, axis=-1)
            dist = np.sqrt(ground ** 2 + alt ** 2)
            legs = np.zeros(m)              # the UAV stays parked
        # steady-state serve-window offsets: travel leg into each stop,
        # then its hover+comm dwell
        t = 0.0
        dwell = hover_s_per_stop + comm_s_per_stop
        for j, cid in enumerate(visit):
            t += legs[j] / params.V if serve_mode == "hover" else 0.0
            hover_start[cid] = t
            t += dwell
        duration = float(tour.tour_length / params.V + m * dwell)
        serve_dist[ids] = dist
        routes.append(UavRoute(uav=u, client_ids=tuple(int(c) for c in visit),
                               tour=tour, hover_xy=hover_xy,
                               serve_dist_m=dist,
                               round_duration_s=duration))

    rounds = min(r.tour.rounds for r in routes)
    e_first = float(sum(r.tour.e_first for r in routes))
    e_per_round = float(sum(r.tour.e_per_round for r in routes))
    e_return = float(sum(r.tour.e_return for r in routes))
    duration = max(r.round_duration_s for r in routes)
    battery = np.zeros((len(routes), rounds + 1))
    for u, r in enumerate(routes):
        battery[u, 0] = params.beta
        for k in range(rounds):
            battery[u, k + 1] = params.beta - r.tour.e_first \
                - k * r.tour.e_per_round
    first_leg_s = max(
        (r.tour.e_first - r.tour.e_per_round) / params.xi_m() for r in routes)
    round_start = first_leg_s + duration * np.arange(max(rounds, 0))
    return MissionTimeline(
        routes=tuple(routes), rounds=rounds, e_first_j=e_first,
        e_per_round_j=e_per_round, e_return_j=e_return, battery_j=battery,
        round_start_s=round_start, round_duration_s=duration,
        serve_dist_m=serve_dist, hover_start_s=hover_start)
