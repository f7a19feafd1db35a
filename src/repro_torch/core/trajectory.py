"""Algorithm 2 — Energy-Constrained UAV Tour Planning Using an Exact TSP Solver.

Exact TSP via Held–Karp dynamic programming, O(2^M · M^2) — the paper notes
deployments have only a few edge devices (farms up to 250 acres), so exact
solving is near-instant; we cap exact at M<=16 and fall back to
nearest-neighbour + 2-opt beyond that (the paper's own stated adaptation for
larger scales).

Also provides the greedy (nearest-neighbour) tour the baselines use.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .uav_energy import UAVParams, DEFAULT_UAV


def _dist_matrix(points: np.ndarray) -> np.ndarray:
    return np.linalg.norm(points[:, None] - points[None], axis=-1)


def held_karp(points: np.ndarray) -> tuple[list[int], float]:
    """Exact TSP cycle over all points. Returns (order, cycle_length)."""
    m = len(points)
    if m == 1:
        return [0], 0.0
    if m == 2:
        return [0, 1], 2 * float(np.linalg.norm(points[0] - points[1]))
    d = _dist_matrix(points)
    # DP over subsets containing node 0
    full = 1 << (m - 1)  # subsets of {1..m-1}
    INF = float("inf")
    dp = np.full((full, m - 1), INF)
    parent = np.full((full, m - 1), -1, dtype=np.int64)
    for j in range(m - 1):
        dp[1 << j, j] = d[0, j + 1]
    for mask in range(full):
        for j in range(m - 1):
            cur = dp[mask, j]
            if not np.isfinite(cur):
                continue
            for nxt in range(m - 1):
                if mask & (1 << nxt):
                    continue
                nm = mask | (1 << nxt)
                nd = cur + d[j + 1, nxt + 1]
                if nd < dp[nm, nxt]:
                    dp[nm, nxt] = nd
                    parent[nm, nxt] = j
    best, bj = INF, -1
    last_mask = full - 1
    for j in range(m - 1):
        tot = dp[last_mask, j] + d[j + 1, 0]
        if tot < best:
            best, bj = tot, j
    # reconstruct
    order = [bj + 1]
    mask = last_mask
    j = bj
    while True:
        pj = parent[mask, j]
        if pj < 0:
            break
        mask ^= 1 << j
        order.append(pj + 1)
        j = pj
    order.append(0)
    order.reverse()
    return order, float(best)


def nearest_neighbor_tour(points: np.ndarray, start: int = 0) -> tuple[list[int], float]:
    m = len(points)
    d = _dist_matrix(points)
    unvisited = set(range(m)) - {start}
    order = [start]
    while unvisited:
        last = order[-1]
        nxt = min(unvisited, key=lambda j: d[last, j])
        order.append(nxt)
        unvisited.remove(nxt)
    length = sum(d[order[i], order[i + 1]] for i in range(m - 1)) + d[order[-1], order[0]]
    return order, float(length)


def two_opt(points: np.ndarray, order: list[int], *, max_pass: int = 20) -> tuple[list[int], float]:
    d = _dist_matrix(points)
    order = order[:]
    m = len(order)

    def tour_len(o):
        return sum(d[o[i], o[(i + 1) % m]] for i in range(m))

    improved = True
    passes = 0
    while improved and passes < max_pass:
        improved = False
        passes += 1
        for i in range(1, m - 1):
            for k in range(i + 1, m):
                a, b = order[i - 1], order[i]
                c, e = order[k], order[(k + 1) % m]
                if d[a, c] + d[b, e] < d[a, b] + d[c, e] - 1e-12:
                    order[i:k + 1] = reversed(order[i:k + 1])
                    improved = True
    return order, float(tour_len(order))


def solve_tsp(points: np.ndarray, *, exact_limit: int = 16) -> tuple[list[int], float]:
    """Exact for small instances (the paper's regime), NN+2opt beyond.

    The fallback seeds 2-opt with the best nearest-neighbour tour over
    several start nodes (all of them up to 64 points, then a spread of 16)
    instead of always starting at node 0 — NN tour quality swings hard with
    the start, and the seed bounds the result: the returned cycle is never
    longer than the best seeding NN tour (and hence never longer than any
    single-start greedy baseline we improve on). Deterministic.
    """
    m = len(points)
    if m <= exact_limit:
        return held_karp(points)
    starts = range(m) if m <= 64 else range(0, m, max(m // 16, 1))
    order, _ = min((nearest_neighbor_tour(points, start=s) for s in starts),
                   key=lambda t: t[1])
    # 2-opt only ever applies improving moves, so the result is bounded by
    # the seed: <= best sampled NN tour <= the start-0 NN tour (m <= 64)
    return two_opt(points, order)


@dataclasses.dataclass
class TourPlan:
    order: list[int]          # tour over edge devices (indices into edge coords)
    tour_length: float        # cycle length D_pi [m]
    rounds: int               # gamma
    e_per_round: float        # J
    e_first: float            # J (base -> first device + full round)
    e_return: float           # J (last device -> base)
    total_energy: float       # J actually consumed for `rounds` rounds + return


def budget_rounds(beta: float, e_first: float, e_pi: float,
                  e_return: float) -> tuple[int, float]:
    """Closed form of Algorithm 2's budget loop (delayed-return strategy).

    The UAV flies base -> first device + one full round (``e_first``), then
    keeps adding ``e_pi``-cost rounds while it can still afford the return
    leg: ``gamma = 1 + floor((beta - e_first - e_return) / e_pi)``.
    Returns (rounds, total_energy_consumed); (0, 0.0) when even one round
    plus the return leg busts the budget.
    """
    if e_first + e_return > beta:
        return 0, 0.0
    extra = int(math.floor((beta - e_first - e_return) / e_pi)) if e_pi > 0 else 0
    rounds = 1 + max(extra, 0)
    return rounds, e_first + (rounds - 1) * e_pi + e_return


def _plan_from_order(order: list[int], d_pi: float, edge_coords: np.ndarray,
                     base: np.ndarray, params: UAVParams,
                     hover_s_per_stop: float, comm_s_per_stop: float) -> TourPlan:
    """Energy bookkeeping shared by the exact and greedy planners."""
    m = len(edge_coords)
    # per-round energy: movement + per-stop hover & comm (Alg. 2 line 6)
    e_pi = (d_pi / params.V) * params.xi_m() \
        + m * (hover_s_per_stop * params.xi_h + comm_s_per_stop * params.xi_c)
    first_dev = edge_coords[order[0]]
    last_dev = edge_coords[order[-1]]
    e_first = (np.linalg.norm(base - first_dev) / params.V) * params.xi_m() + e_pi
    e_return = (np.linalg.norm(last_dev - base) / params.V) * params.xi_m()
    rounds, total = budget_rounds(params.beta, e_first, e_pi, e_return)
    return TourPlan(order=order, tour_length=d_pi, rounds=rounds, e_per_round=e_pi,
                    e_first=e_first, e_return=e_return, total_energy=total)


def plan_tour(edge_coords: np.ndarray, base: np.ndarray, *,
              params: UAVParams = DEFAULT_UAV,
              hover_s_per_stop: float = 30.0, comm_s_per_stop: float = 10.0,
              exact_limit: int = 16) -> TourPlan:
    """Algorithm 2, including the delayed-return strategy."""
    order, d_pi = solve_tsp(edge_coords, exact_limit=exact_limit)
    return _plan_from_order(order, d_pi, edge_coords, base, params,
                            hover_s_per_stop, comm_s_per_stop)


def greedy_tour_plan(edge_coords: np.ndarray, base: np.ndarray, *,
                     params: UAVParams = DEFAULT_UAV,
                     hover_s_per_stop: float = 30.0,
                     comm_s_per_stop: float = 10.0) -> TourPlan:
    """Baseline: greedy nearest-neighbour visiting order (paper §IV-A:
    'the UAV follows a greedy approach to visit the edge devices')."""
    # start from device nearest to base
    start = int(np.linalg.norm(edge_coords - base, axis=-1).argmin())
    order, d_pi = nearest_neighbor_tour(edge_coords, start=start)
    return _plan_from_order(order, d_pi, edge_coords, base, params,
                            hover_s_per_stop, comm_s_per_stop)
