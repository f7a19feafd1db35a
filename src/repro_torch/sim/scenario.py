"""Cohort sampling for population-scale fleets (``ClientSpec.population``).

Counterpart of the cohort half of ``repro.sim.scenario``:
``COHORT_DOWN_WEIGHT`` and ``sample_cohort``, the Gumbel top-k draw of a
round's ``num_clients`` participants out of ``population`` clients. The
port draws from a ``torch.Generator`` on the CPU, one generator a round
seeded from ``(seed, round)`` (``cohort_generator``), so a run can be
replayed from any round. It does not reproduce the reference's threefry
stream: parity runs feed the reference's cohorts in (``Plan.cohorts``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# relative sampling weight of a client whose availability state is DOWN at
# cohort-draw time (the reference's constant): such clients are drawn about
# 20x less often, never excluded
COHORT_DOWN_WEIGHT = 0.05

# the SeedSequence slot of the cohort stream, beside the spec's seed
_COHORT_STREAM = 3


def cohort_generator(seed: int, round_index: int) -> torch.Generator:
    """The CPU generator of round ``round_index``'s cohort draw."""
    state = np.random.SeedSequence([seed, _COHORT_STREAM, round_index])
    return torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


def sample_cohort(generator: torch.Generator, population: int, cohort: int,
                  weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Draw ``cohort`` distinct ids out of ``population``, sorted.

    Gumbel top-k: the ``cohort`` largest ``log w + G`` (``G = -log(-log
    u)``, ``u`` uniform in [1e-12, 1)) are an exact sample without
    replacement from the normalised ``weights`` (uniform when None). The
    ids return sorted, so ``cohort == population`` is the identity
    ``[0..population)`` whatever the generator or the weights."""
    if not 1 <= cohort <= population:
        raise ValueError(f"cohort size {cohort} must be in [1, {population}]")
    u = torch.rand(population, generator=generator, dtype=torch.float64)
    u = 1e-12 + u * (1.0 - 1e-12)
    gumbel = -torch.log(-torch.log(u))
    if weights is not None:
        w = torch.as_tensor(np.asarray(weights, np.float64))
        gumbel = gumbel + torch.log(torch.clamp(w, min=1e-12))
    ids = torch.topk(gumbel, cohort).indices
    return np.sort(ids.numpy())
