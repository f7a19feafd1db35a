"""Scenario specs: the stochastic mission environment as data.

Counterpart of ``repro.sim.scenario``. A ``ScenarioSpec`` names what the
idealised campaign holds constant: the air-to-ground channel
(``ChannelParams``), each client's availability from round to round
(``AvailabilityParams``) and the mission's shape (how many UAVs, where they
serve from). ``api.plan.compile_experiment`` lowers it: the channel's
rates re-bill the link each round (and, under adaptive cuts, set each
client's rate against the dwell deadline), and the availability trace
drives the fleet engines' client masks. The degenerate scenario (constant
channel, full availability, one UAV hovering overhead,
``degenerate_scenario()``) reproduces the idealised ``campaign_spec``
records.

Availability kinds:

  * ``"full"``      every client, every round (degenerate; draws nothing);
  * ``"bernoulli"`` an i.i.d. drop with probability ``p_drop`` a round;
  * ``"markov"``    a two-state Gilbert-Elliott process a client: an up
                    client fails with ``p_drop``, a down one recovers with
                    ``p_recover`` (bursty outages).

The draw and the rule are apart: ``availability_step`` applies the
reference's rule to the round's (clients,) float32 uniforms, which the
plan draws from the ``ENV_MASK`` stream (``streams.draw_env``) or a parity
test feeds from the reference.

The cohort half (``COHORT_DOWN_WEIGHT``, ``sample_cohort``): the Gumbel
top-k draw of a round's ``num_clients`` participants out of ``population``
clients, from the ``ENV_COHORT`` stream (``cohort_generator``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .channel import ChannelParams
from .streams import ENV_COHORT, env_generator


@dataclasses.dataclass(frozen=True)
class AvailabilityParams:
    kind: str = "full"        # "full" | "bernoulli" | "markov"
    p_drop: float = 0.0       # bernoulli: P(drop); markov: P(up -> down)
    p_recover: float = 0.5    # markov: P(down -> up)

    @property
    def is_stochastic(self) -> bool:
        return self.kind != "full"

    def validate(self) -> None:
        if self.kind not in ("full", "bernoulli", "markov"):
            raise ValueError(f"availability kind must be 'full', 'bernoulli' "
                             f"or 'markov', got {self.kind!r}")
        if not (0.0 <= self.p_drop <= 1.0 and 0.0 <= self.p_recover <= 1.0):
            raise ValueError("availability probabilities must be in [0, 1]")


def availability_init(num_clients: int) -> np.ndarray:
    """Round-0 prior state: every client up."""
    return np.ones((num_clients,), np.float32)


def availability_step(u, up_prev, params: AvailabilityParams):
    """One round of the availability process: ``(mask, new_state)``, both
    (clients,) float32 0/1. ``u`` is the round's float32 uniforms (unused
    by ``"full"``), ``up_prev`` the previous state (used by ``"markov"``).
    At least one client stays up: when the rule leaves none, the client
    with the largest uniform (the first of equals) stands in."""
    up_prev = np.asarray(up_prev, np.float32)
    if not params.is_stochastic:
        ones = np.ones_like(up_prev)
        return ones, ones
    u = np.asarray(u, np.float32)
    if u.shape != up_prev.shape:
        raise ValueError(f"availability draws of shape {u.shape} for a "
                         f"state of shape {up_prev.shape}")
    p_drop, p_recover = np.float32(params.p_drop), np.float32(params.p_recover)
    if params.kind == "bernoulli":
        up = (u >= p_drop).astype(np.float32)
    else:  # markov (Gilbert-Elliott)
        up = np.where(up_prev > 0, u >= p_drop,
                      u < p_recover).astype(np.float32)
    if up.sum() == 0:
        up = np.zeros_like(up)
        up[int(np.argmax(u))] = 1.0
    return up, up.copy()


def cohort_mask(mask: np.ndarray, cohort) -> np.ndarray:
    """A population-wide availability mask sliced to the cohort's slots.
    The trace keeps one client of the population up, not one of the
    cohort: an all-down cohort keeps slot 0."""
    mask = np.asarray(mask)[np.asarray(cohort)]
    if mask.sum() == 0:
        mask[0] = 1.0
    return mask


# relative sampling weight of a client whose availability state is DOWN at
# cohort-draw time (the reference's constant): such clients are drawn about
# 20x less often, never excluded
COHORT_DOWN_WEIGHT = 0.05


def cohort_generator(seed: int, round_index: int) -> torch.Generator:
    """The CPU generator of round ``round_index``'s cohort draw: the
    ``ENV_COHORT`` stream of environment seed ``seed``."""
    return env_generator(seed, ENV_COHORT, round_index)


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


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """The stochastic environment of one experiment.

    ``channel=None`` / ``availability=None`` keep the idealisation
    (the link policy's constant rate / every client every round); a bare
    ``ScenarioSpec()`` changes nothing but routes the mission through
    ``sim.mission.rollout_mission``."""
    channel: Optional[ChannelParams] = None
    availability: Optional[AvailabilityParams] = None
    num_uavs: int = 1
    serve_mode: str = "hover"   # "hover" (overhead) | "relay" (partition centroid)
    seed: int = 0               # channel + availability stream seed

    @property
    def needs_mask(self) -> bool:
        return self.availability is not None and self.availability.is_stochastic

    def validate(self, *, has_mission: bool) -> None:
        if self.num_uavs < 1:
            raise ValueError(f"num_uavs must be >= 1, got {self.num_uavs}")
        if self.serve_mode not in ("hover", "relay"):
            raise ValueError(f"serve_mode must be 'hover' or 'relay', "
                             f"got {self.serve_mode!r}")
        if self.channel is not None:
            self.channel.validate()
            if self.channel.kind == "a2g" and not has_mission:
                raise ValueError("an 'a2g' channel needs the mission geometry "
                                 "(client placements + UAV altitude); attach "
                                 "a MissionSpec or use kind='constant'")
        if self.availability is not None:
            self.availability.validate()
        if (self.num_uavs > 1 or self.serve_mode != "hover") \
                and not has_mission:
            raise ValueError("multi-UAV / relay scenarios describe a mission; "
                             "attach a MissionSpec")


def degenerate_scenario() -> ScenarioSpec:
    """The deterministic corner: constant channel, full availability, one
    UAV hovering overhead. Runs the whole scenario path and reproduces the
    idealised campaign's records."""
    return ScenarioSpec(channel=ChannelParams(kind="constant"),
                        availability=AvailabilityParams(kind="full"),
                        num_uavs=1, serve_mode="hover")
