"""``repro_torch.sim``: stochastic mission and channel scenarios over the engines.

Counterpart of ``repro.sim``. ``ScenarioSpec`` (channel, availability,
mission shape) rides on ``api.ExperimentSpec``; ``compile_experiment``
lowers it, so channel draws re-bill the link each round and availability
traces drive the fleet engines' client masks. ``run_monte_carlo`` sweeps
scenario seeds, on the fleet engines as one program a local step for all
seeds and clients, on the scan engines as one round shared by the seeds
(on ``fl/scan`` under a population, whose seeds draw their own cohorts,
one program a local step for all seeds). The deterministic corner
(``degenerate_scenario``) reproduces the idealised campaign's records.
"""
from .channel import (ChannelParams, deterministic_rate_bps, path_loss_db,
                      rates_from_draws, sample_rates_bps, slant_distance_m)
from .scenario import (AvailabilityParams, COHORT_DOWN_WEIGHT, ScenarioSpec,
                       availability_init, availability_step,
                       degenerate_scenario, sample_cohort)
from .mission import MissionTimeline, UavRoute, rollout_mission
from .monte_carlo import MonteCarloResult, run_monte_carlo
from .streams import ENV_COHORT, ENV_MASK, ENV_RATES, EnvDraws, env_generator

__all__ = [n for n in dir() if not n.startswith("_")]
