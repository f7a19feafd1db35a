"""The environment's random streams: one slot a stream, one generator a round.

Counterpart of the fold-slot semantics of ``repro/keys.py``, not of the
module. The reference folds a per-round environment key (``round_env_key(
PRNGKey(env_seed), round)``) with one registered slot per stream:
availability masks (``ENV_MASK``), channel rate draws (``ENV_RATES``) and
cohort samples (``ENV_COHORT``), so the three streams never collide and a
Monte-Carlo sweep replays any of them from ``(env_seed, round)``. The port
keeps the registry, with the reference's names and values, and gives every
(env_seed, slot, round) its own CPU ``torch.Generator`` seeded from
``np.random.SeedSequence([env_seed, slot, round])`` (``env_generator``).
It does not reproduce threefry: parity tests feed the reference's draws
in (``Plan.env_draws``, ``Plan.cohorts``).

The environment seed is the scenario's (``ScenarioSpec.seed``) when one is
attached, and 0 without one, for masks, rates and cohorts alike; sweep
seed ``i`` of ``run_monte_carlo(plan, ..., seed=s)`` is environment seed
``scn.seed + s + i``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .channel import channel_draws


@dataclasses.dataclass(frozen=True)
class KeySlot:
    """One registered stream slot."""
    domain: str
    name: str
    value: int


_REGISTRY: dict[tuple[str, str], KeySlot] = {}


def register(domain: str, name: str, value: int) -> KeySlot:
    """Register a slot; raise if (domain, name) or (domain, value) is taken
    by another slot. Registering the same triple again returns it."""
    slot = KeySlot(domain, name, int(value))
    prev = _REGISTRY.get((domain, name))
    if prev is not None:
        if prev == slot:
            return prev
        raise ValueError(
            f"fold slot {domain}/{name} already registered with value "
            f"{prev.value}, refusing {slot.value}")
    for other in _REGISTRY.values():
        if other.domain == domain and other.value == slot.value:
            raise ValueError(
                f"fold value {slot.value} in domain {domain!r} already taken "
                f"by slot {other.name!r}, refusing {name!r}")
    _REGISTRY[(domain, name)] = slot
    return slot


def registered_slots() -> tuple[KeySlot, ...]:
    """All registered slots, in registration order."""
    return tuple(_REGISTRY.values())


# the reference's environment slots (repro/keys.py:118-123); the values are
# part of the stream layout
ENV_MASK = register("env", "mask", 1)
ENV_RATES = register("env", "rates", 2)
ENV_COHORT = register("env", "cohort", 3)


def env_generator(env_seed: int, slot: KeySlot,
                  round_index: int) -> torch.Generator:
    """The CPU generator of one environment stream in one round."""
    if slot.domain != "env" or _REGISTRY.get(("env", slot.name)) != slot:
        raise ValueError(f"{slot} is not a registered environment slot")
    state = np.random.SeedSequence([int(env_seed), slot.value,
                                    int(round_index)])
    return torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


@dataclasses.dataclass(frozen=True)
class EnvDraws:
    """One round's environment draws, float32 numpy: the availability
    process's uniforms in [0, 1) (``mask``, one a client of the trace: the
    population when one is declared) and the channel's standard normals and
    exponentials (one a client slot). A field the plan does not use is
    None."""
    mask: Optional[np.ndarray] = None
    normal: Optional[np.ndarray] = None
    exponential: Optional[np.ndarray] = None


def draw_env(env_seed: int, round_index: int, *, mask_n: int = 0,
             rates_n: int = 0) -> EnvDraws:
    """Round ``round_index``'s draws of environment seed ``env_seed``:
    ``mask_n`` uniforms from the ``ENV_MASK`` stream, and ``rates_n``
    normals, then ``rates_n`` exponentials, from the ``ENV_RATES`` stream
    (0: none)."""
    mask = normal = exponential = None
    if mask_n:
        mask = torch.rand(mask_n, generator=env_generator(
            env_seed, ENV_MASK, round_index), dtype=torch.float32).numpy()
    if rates_n:
        normal, exponential = channel_draws(
            env_generator(env_seed, ENV_RATES, round_index), (rates_n,))
    return EnvDraws(mask=mask, normal=normal, exponential=exponential)


def checked_draws(draws: EnvDraws, *, mask_n: int, rates_n: int,
                  where: str) -> EnvDraws:
    """``draws`` as float32 arrays, with a ValueError naming ``where`` when
    a field the round needs (``mask_n``/``rates_n`` > 0) is missing or not
    of that length."""
    out = {}
    for field, n in (("mask", mask_n), ("normal", rates_n),
                     ("exponential", rates_n)):
        a = getattr(draws, field, None)
        if not n:
            out[field] = None
            continue
        a = None if a is None else np.asarray(a, np.float32)
        if a is None or a.shape != (n,):
            raise ValueError(f"{where}.{field} is "
                             f"{None if a is None else a.shape}, want ({n},)")
        out[field] = a
    return EnvDraws(**out)
