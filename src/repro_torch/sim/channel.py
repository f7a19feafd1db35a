"""Stochastic air-to-ground channel: each client's achievable rate a round.

Counterpart of ``repro.sim.channel``. The UAV-relay link budget:

    PL(d)  = PL_0 + 10 * alpha * log10(d / 1 m)          log-distance path loss
    X_sh   ~ N(0, sigma_sh^2)  [dB]                      log-normal shadowing
    |h|^2  ~ Exp(1)                                      Rayleigh fast fading
    SNR    = P_tx * 10^(-(PL + X_sh)/10) * |h|^2 / N_0
    R      = B * log2(1 + SNR)                           Shannon rate [bit/s]

with ``d`` the slant distance from the UAV's serving waypoint to the edge
device. ``"constant"`` channels return the link policy's nominal rate, and
an ``"a2g"`` channel without shadowing and fading is deterministic: the
degenerate corners, which draw nothing.

The draw and the rule are apart: ``rates_from_draws`` is the reference's
arithmetic in float32 on given standard normal and exponential draws (one
each a client), and ``sample_rates_bps`` draws them from the port's own
generator (the normals, then the exponentials) and applies it. A parity
test feeds the reference's draws to the rule.

The plan bills link time and energy at ``nominal / sampled`` times the
constants hoisted at the nominal (deterministic) rate; wire bytes do not
depend on the rate.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ChannelParams:
    """A2G link-budget parameters (defaults: 2.4 GHz-ish rural low-altitude)."""
    kind: str = "a2g"              # "a2g" | "constant"
    ref_loss_db: float = 40.0      # PL_0 at d0 = 1 m
    path_loss_exp: float = 2.2     # alpha (LoS-dominated air-to-ground)
    shadowing_sigma_db: float = 4.0
    fading: str = "rayleigh"       # "none" | "rayleigh"
    tx_power_dbm: float = 20.0
    noise_dbm: float = -96.0       # noise floor over `bandwidth_hz`
    bandwidth_hz: float = 20e6
    min_rate_bps: float = 1e4      # floor: a deep fade stalls, never divides by 0

    @property
    def is_stochastic(self) -> bool:
        return self.kind == "a2g" and (self.shadowing_sigma_db > 0.0
                                       or self.fading != "none")

    def validate(self) -> None:
        if self.kind not in ("a2g", "constant"):
            raise ValueError(f"channel kind must be 'a2g' or 'constant', "
                             f"got {self.kind!r}")
        if self.fading not in ("none", "rayleigh"):
            raise ValueError(f"fading must be 'none' or 'rayleigh', "
                             f"got {self.fading!r}")
        if self.shadowing_sigma_db < 0:
            raise ValueError("shadowing_sigma_db must be >= 0")


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def slant_distance_m(ground_m, altitude_m) -> np.ndarray:
    """3D UAV<->device distance from the ground offset and the altitude."""
    return np.sqrt(np.square(ground_m) + altitude_m ** 2)


# float32 log10 and log2 as the reference's compile to: the natural log
# times the constant's float32 reciprocal
_INV_LN10 = torch.tensor(np.float32(1.0 / np.log(10.0)))
_INV_LN2 = torch.tensor(np.float32(1.0 / np.log(2.0)))


def path_loss_db(params: ChannelParams, dist_m) -> torch.Tensor:
    d = torch.clamp(_f32(dist_m), min=1.0)
    return params.ref_loss_db + (10.0 * params.path_loss_exp) * (
        torch.log(d) * _INV_LN10)


def _snr_db(params: ChannelParams, dist_m) -> torch.Tensor:
    return params.tx_power_dbm - path_loss_db(params, dist_m) \
        - params.noise_dbm


def _shannon_rate_bps(params: ChannelParams, snr_db: torch.Tensor,
                      fade_power) -> torch.Tensor:
    # 10^x correctly rounded to float32 (from float64), as the reference's
    snr = torch.pow(10.0, (snr_db / 10.0).double()).float() * fade_power
    rate = params.bandwidth_hz * (torch.log(1.0 + snr) * _INV_LN2)
    return torch.clamp(rate, min=params.min_rate_bps)


def deterministic_rate_bps(params: ChannelParams, dist_m,
                           nominal_rate_bps: float) -> np.ndarray:
    """The channel's deterministic part (float32, shaped as ``dist_m``):
    the nominal rate for ``"constant"``, else the log-distance Shannon rate
    without shadowing and fading, strictly decreasing in distance. The
    link constants (and adaptive cuts' deadlines) are hoisted at it."""
    if params.kind == "constant":
        return np.full(np.shape(dist_m), nominal_rate_bps, np.float32)
    return _shannon_rate_bps(params, _snr_db(params, dist_m), 1.0).numpy()


def rates_from_draws(params: ChannelParams, dist_m, nominal_rate_bps: float,
                     normal, exponential) -> np.ndarray:
    """One round's per-client rates (float32) from standard normal and
    exponential draws shaped as ``dist_m``: shadowing ``sigma * normal``
    dB off the SNR, Rayleigh fading ``|h|^2 = exponential``. A
    deterministic channel ignores the draws."""
    if not params.is_stochastic:
        return deterministic_rate_bps(params, dist_m, nominal_rate_bps)
    snr_db = _snr_db(params, dist_m)
    if params.shadowing_sigma_db > 0.0:
        snr_db = snr_db - params.shadowing_sigma_db * _f32(normal)
    fade = _f32(exponential) if params.fading == "rayleigh" else 1.0
    return _shannon_rate_bps(params, snr_db, fade).numpy()


def channel_draws(generator: torch.Generator, shape) -> tuple:
    """A round's channel draws from ``generator``: ``shape`` standard
    normals, then ``shape`` exponentials (float32 numpy)."""
    normal = torch.randn(shape, generator=generator, dtype=torch.float32)
    exponential = torch.empty(shape, dtype=torch.float32).exponential_(
        generator=generator)
    return normal.numpy(), exponential.numpy()


def sample_rates_bps(generator: torch.Generator, params: ChannelParams,
                     dist_m, nominal_rate_bps: float) -> np.ndarray:
    """One draw of per-client rates (float32, shaped as ``dist_m``).
    Deterministic channels leave ``generator`` untouched and return the
    deterministic rate bit for bit."""
    if not params.is_stochastic:
        return deterministic_rate_bps(params, dist_m, nominal_rate_bps)
    return rates_from_draws(params, dist_m, nominal_rate_bps,
                            *channel_draws(generator, np.shape(dist_m)))
