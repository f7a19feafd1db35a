"""Algorithm 1 — Optimized Edge Device Deployment and Sensor Assignment (CSR).

Faithful implementation of the paper's greedy max-coverage deployment with
the min-total-distance tie-break, plus the two baselines it compares against
(K-means with K=floor(sqrt(N)) grown until feasible, and a GASBAC-style
balanced-clustering heuristic).

Coordinates are in meters. ``field_acres`` helpers convert the paper's farm
sizes (1 acre = 4046.86 m²; a square farm is assumed, as in Fig. 2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

ACRE_M2 = 4046.8564224


def field_side_meters(acres: float) -> float:
    return math.sqrt(acres * ACRE_M2)


def uniform_grid_sensors(acres: float, n_sensors: int, *, jitter: float = 0.0,
                         seed: int = 0) -> np.ndarray:
    """Paper Fig. 2a/2c: uniform deployment at a fixed sensor density."""
    side = field_side_meters(acres)
    g = int(round(math.sqrt(n_sensors)))
    assert g * g == n_sensors, "uniform grid wants a square count (25/36/49 in the paper)"
    xs = (np.arange(g) + 0.5) * side / g
    pts = np.stack(np.meshgrid(xs, xs, indexing="ij"), axis=-1).reshape(-1, 2)
    if jitter > 0:
        rng = np.random.RandomState(seed)
        pts = pts + rng.uniform(-jitter, jitter, size=pts.shape)
    return pts


def random_sensors(acres: float, n_sensors: int, *, seed: int = 0) -> np.ndarray:
    """Paper Fig. 2b: random deployment."""
    side = field_side_meters(acres)
    rng = np.random.RandomState(seed)
    return rng.uniform(0, side, size=(n_sensors, 2))


# ---------------------------------------------------------------------------
# CSR adjacency (as the paper specifies)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CSRAdjacency:
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (nnz,)

    def neighbors(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i]:self.indptr[i + 1]]


def build_csr_adjacency(coords: np.ndarray, cr: float) -> CSRAdjacency:
    """A[s] = {u : d(s,u) <= CR} (self included — a device covers itself)."""
    d = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
    adj = d <= cr
    indptr = np.zeros(len(coords) + 1, dtype=np.int64)
    cols = []
    for i in range(len(coords)):
        nb = np.where(adj[i])[0]
        cols.append(nb)
        indptr[i + 1] = indptr[i] + len(nb)
    return CSRAdjacency(indptr=indptr, indices=np.concatenate(cols) if cols else np.zeros(0, np.int64))


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Deployment:
    coords: np.ndarray           # (N,2) all sensors
    edge_indices: np.ndarray     # (M,) indices into coords chosen as edge devices
    assignment: np.ndarray       # (N,) sensor -> edge-device index (into edge_indices)
    cr: float

    @property
    def edge_coords(self) -> np.ndarray:
        return self.coords[self.edge_indices]

    @property
    def loads(self) -> np.ndarray:
        return np.bincount(self.assignment, minlength=len(self.edge_indices))


def deploy_edge_devices(coords: np.ndarray, cr: float) -> Deployment:
    """Algorithm 1: greedy max-coverage with min-distance tie-break + balanced
    sensor→edge assignment."""
    n = len(coords)
    csr = build_csr_adjacency(coords, cr)
    uncovered = set(range(n))
    edges: list[int] = []

    def dist_to_edges(s: int) -> float:
        if not edges:
            return 0.0
        e = coords[np.asarray(edges)]
        return float(np.linalg.norm(e - coords[s], axis=-1).sum())

    while uncovered:
        best_cov = 0
        best_s: Optional[int] = None
        best_dist = float("inf")
        # iterate over uncovered candidates (paper: for each s in U)
        for s in sorted(uncovered):
            cov = sum(1 for u in csr.neighbors(s) if u in uncovered)
            if not edges:
                if cov > best_cov:
                    best_cov, best_s = cov, s
            else:
                ds = dist_to_edges(s)
                # paper line 13: |C| >= best and strictly smaller total distance
                if cov > best_cov or (cov == best_cov and ds < best_dist):
                    best_cov, best_s, best_dist = cov, s, ds
        assert best_s is not None
        edges.append(best_s)
        for u in csr.neighbors(best_s):
            uncovered.discard(u)

    edge_arr = np.asarray(edges)

    # Lines 21-26: assignment minimizing load, tie-broken by distance.
    assignment = np.full(n, -1, dtype=np.int64)
    loads = np.zeros(len(edges), dtype=np.int64)
    # edge devices are assigned to themselves
    for j, e in enumerate(edges):
        assignment[e] = j
        loads[j] += 1
    order = np.argsort(np.linalg.norm(coords - coords.mean(0), axis=-1))  # deterministic order
    for s in order:
        if assignment[s] >= 0:
            continue
        cand = [j for j, e in enumerate(edges)
                if np.linalg.norm(coords[s] - coords[e]) <= cr]
        if not cand:  # shouldn't happen (coverage constraint) but stay safe
            cand = list(range(len(edges)))
        # minimal current load, then shortest distance
        cand.sort(key=lambda j: (loads[j], np.linalg.norm(coords[s] - coords[edges[j]])))
        assignment[s] = cand[0]
        loads[cand[0]] += 1
    return Deployment(coords=coords, edge_indices=edge_arr, assignment=assignment, cr=cr)


# ---------------------------------------------------------------------------
# Baselines: K-means and GASBAC-style balanced clustering
# ---------------------------------------------------------------------------

def deploy_kmeans(coords: np.ndarray, cr: float, *, seed: int = 0,
                  max_iter: int = 100) -> Deployment:
    """Paper baseline: K = floor(sqrt(N)), incremented while any sensor is
    outside CR of its cluster head (the sensor closest to the centroid)."""
    n = len(coords)
    k = int(math.floor(math.sqrt(n)))
    rng = np.random.RandomState(seed)
    while True:
        # Lloyd's algorithm
        centroids = coords[rng.choice(n, size=k, replace=False)].copy()
        for _ in range(max_iter):
            d = np.linalg.norm(coords[:, None] - centroids[None], axis=-1)
            lab = d.argmin(1)
            new = np.stack([coords[lab == j].mean(0) if np.any(lab == j) else centroids[j]
                            for j in range(k)])
            if np.allclose(new, centroids):
                break
            centroids = new
        # cluster head = sensor nearest to the centroid
        heads = []
        for j in range(k):
            members = np.where(lab == j)[0]
            if len(members) == 0:
                continue
            hd = members[np.linalg.norm(coords[members] - centroids[j], axis=-1).argmin()]
            heads.append(hd)
        heads = np.asarray(sorted(set(heads)))
        d_head = np.linalg.norm(coords[:, None] - coords[heads][None], axis=-1)
        if (d_head.min(1) <= cr).all() or k >= n:
            assignment = d_head.argmin(1)
            return Deployment(coords=coords, edge_indices=heads,
                              assignment=assignment, cr=cr)
        k += 1


def deploy_gasbac(coords: np.ndarray, cr: float, *, seed: int = 0) -> Deployment:
    """GASBAC-style balanced clustering [Nguyen et al. 2023], adapted to a
    single UAV as the paper does: energy-balance-driven cluster formation —
    clusters are grown to equal size around farthest-point-sampled seeds,
    heads re-selected at the cluster medoid."""
    n = len(coords)
    k = max(1, int(round(math.sqrt(n))))
    rng = np.random.RandomState(seed)
    # farthest point sampling for seeds (balanced spatial spread)
    seeds = [int(rng.randint(n))]
    for _ in range(k - 1):
        d = np.min(np.linalg.norm(coords[:, None] - coords[np.asarray(seeds)][None], axis=-1), axis=1)
        seeds.append(int(d.argmax()))
    target = int(math.ceil(n / k))
    assignment = np.full(n, -1, dtype=np.int64)
    loads = np.zeros(k, dtype=np.int64)
    # balanced assignment: iterate sensors by distance to nearest seed
    d_seed = np.linalg.norm(coords[:, None] - coords[np.asarray(seeds)][None], axis=-1)
    order = np.argsort(d_seed.min(1))
    for s in order:
        pref = np.argsort(d_seed[s])
        for j in pref:
            if loads[j] < target:
                assignment[s] = j
                loads[j] += 1
                break
    # medoid heads; ensure CR feasibility by splitting overlong clusters
    heads = []
    for j in range(k):
        members = np.where(assignment == j)[0]
        if len(members) == 0:
            continue
        dm = np.linalg.norm(coords[members][:, None] - coords[members][None], axis=-1)
        heads.append(int(members[dm.sum(1).argmin()]))
    heads = np.asarray(heads)
    d_head = np.linalg.norm(coords[:, None] - coords[heads][None], axis=-1)
    # sensors outside CR of their head get the closest head (best-effort, as
    # GASBAC optimizes energy balance, not strict coverage)
    assignment = d_head.argmin(1)
    return Deployment(coords=coords, edge_indices=heads, assignment=assignment, cr=cr)


def coverage_ok(dep: Deployment) -> bool:
    """Eq. (4): every sensor within CR of its assigned edge device."""
    d = np.linalg.norm(dep.coords - dep.edge_coords[dep.assignment], axis=-1)
    return bool((d <= dep.cr + 1e-9).all())
