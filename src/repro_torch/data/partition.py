"""Client data partitioners.

The paper simulates non-IID by giving each of 4 clients data from exactly
3 of the 12 classes (Section IV-C). ``partition_non_iid`` reproduces that;
``partition_dirichlet`` is the standard generalization (spec-reachable via
``DataSpec(partition="dirichlet", dirichlet_alpha=...)``); ``partition_iid``
is the uniform split token pipelines use.
"""
from __future__ import annotations

import numpy as np

# ceiling on DISTINCT data partitions materialized for a sampled population
# (ClientSpec.population): partition construction is host-side Python over
# the partition count, so a million-client population shares
# min(population, n_samples, cap) distinct shards, cycled over population
# ids (pid -> pid % count — the same cycling device edge_profiles use).
# Data memory stays O(dataset); engine state stays O(cohort).
POPULATION_PARTITION_CAP = 1024


def population_partition_count(population: int, num_samples: int,
                               *, cap: int = POPULATION_PARTITION_CAP) -> int:
    """Distinct partitions to build for a ``population``-client fleet:
    every partition must be non-empty (``<= num_samples``) and host-side
    construction must stay cheap (``<= cap``)."""
    if population < 1:
        raise ValueError(f"population must be >= 1, got {population}")
    return max(1, min(population, num_samples, cap))


def partition_non_iid(labels: np.ndarray, num_clients: int,
                      classes_per_client: int, *, num_classes: int | None = None,
                      seed: int = 0) -> list[np.ndarray]:
    """Assign each client `classes_per_client` distinct classes (paper: 4×3).

    Returns a list of index arrays, one per client. Classes are dealt round-
    robin so every class is owned by >=1 client when
    num_clients*classes_per_client >= num_classes.
    """
    labels = np.asarray(labels)
    ncls = int(num_classes if num_classes is not None else labels.max() + 1)
    rng = np.random.RandomState(seed)
    class_order = rng.permutation(ncls)
    # deal classes to clients round-robin
    owners: list[list[int]] = [[] for _ in range(num_clients)]
    i = 0
    for _ in range(num_clients * classes_per_client):
        owners[i % num_clients].append(int(class_order[i % ncls]))
        i += 1
    out = []
    for cl in range(num_clients):
        mask = np.isin(labels, owners[cl])
        idx = np.where(mask)[0]
        rng.shuffle(idx)
        out.append(idx)
    return out


def partition_dirichlet(labels: np.ndarray, num_clients: int, *, alpha: float = 0.5,
                        seed: int = 0, min_size: int = 0) -> list[np.ndarray]:
    """Standard Dirichlet(alpha) label-skew partition (the paper's pest data
    is non-IID across farms; small alpha -> strong skew).

    ``min_size > 0`` rebalances after sampling: clients left below the floor
    (a real outcome at small alpha) steal indices from the largest partition
    so every client can fill minibatches. Rebalancing is deterministic given
    ``seed``.
    """
    labels = np.asarray(labels)
    ncls = int(labels.max() + 1)
    rng = np.random.RandomState(seed)
    client_idx: list[list[int]] = [[] for _ in range(num_clients)]
    for c in range(ncls):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for cl, part in enumerate(np.split(idx, cuts)):
            client_idx[cl].extend(part.tolist())
    if min_size > 0:
        if min_size * num_clients > len(labels):
            raise ValueError(f"cannot give {num_clients} clients "
                             f"{min_size} samples each from {len(labels)}")
        for cl in range(num_clients):
            while len(client_idx[cl]) < min_size:
                donor = max(range(num_clients), key=lambda d: len(client_idx[d]))
                client_idx[cl].append(client_idx[donor].pop())
    return [np.asarray(sorted(v)) for v in client_idx]


def partition_iid(num_samples: int, num_clients: int, *,
                  seed: int = 0) -> list[np.ndarray]:
    """Uniform random split (the token-stream pipelines, where labels carry
    no class structure to skew)."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(num_samples)
    return [np.sort(part) for part in np.array_split(order, num_clients)]
