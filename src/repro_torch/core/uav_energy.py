"""Rotary-wing UAV energy model — paper Eqs. (1)-(2), Table I constants.

Power model from Zeng, Xu, Zhang (TWC 2019), parameterized for the DJI
Matrice 350 RTK as in the paper.

xi_m(V): propulsion power at forward speed V [W]
xi_h   : hover power [W]
xi_c   : communication power [W] (radio front-end while exchanging data)
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class UAVParams:
    # Table I
    beta: float = 1.9e6          # energy capacity [J]
    V: float = 10.0              # cruise speed [m/s]
    v0: float = 5.5              # mean induced velocity in hover [m/s]
    U_tip: float = 180.0         # rotor tip speed [m/s]
    f: float = 0.8               # fuselage drag ratio
    r: float = 0.08              # rotor solidity
    rho: float = 1.225           # air density [kg/m^3]
    a: float = 0.7               # rotor disc area [m^2]
    delta: float = 0.011         # profile drag coefficient
    omega: float = 320.0         # blade angular velocity [rad/s]
    R: float = 0.45              # rotor radius [m]
    k: float = 0.15              # induced power correction
    W: float = 63.4              # weight [N]
    xi_c: float = 20.0           # communication power [W] (radio, typical)
    altitude: float = 30.0       # flight altitude h [m]

    @property
    def P0(self) -> float:
        """Blade profile power: (delta/8) * rho * r * a * Omega^3 R^3."""
        return (self.delta / 8.0) * self.rho * self.r * self.a * (self.omega ** 3) * (self.R ** 3)

    @property
    def Pi(self) -> float:
        """Induced power: (1+k) W^{3/2} / sqrt(2 rho a)."""
        return (1 + self.k) * (self.W ** 1.5) / math.sqrt(2 * self.rho * self.a)

    def xi_m(self, V: float | None = None) -> float:
        """Eq. (1): propulsion power at speed V [W]."""
        V = self.V if V is None else V
        blade = self.P0 * (1 + 3 * V ** 2 / self.U_tip ** 2)
        induced = self.Pi * math.sqrt(
            max(math.sqrt(1 + V ** 4 / (4 * self.v0 ** 4)) - V ** 2 / (2 * self.v0 ** 2), 0.0))
        parasite = 0.5 * self.f * self.rho * self.r * self.a * V ** 3
        return blade + induced + parasite

    @property
    def xi_h(self) -> float:
        """Eq. (2): hover power P0 + Pi [W]."""
        return self.P0 + self.Pi

    def reception_range(self, cr: float) -> float:
        """Rr = sqrt(CR^2 - h^2)."""
        return math.sqrt(max(cr ** 2 - self.altitude ** 2, 0.0))


DEFAULT_UAV = UAVParams()


def tour_energy(distance_m: float, n_hover: int, *, params: UAVParams = DEFAULT_UAV,
                hover_s_per_stop: float = 30.0, comm_s_per_stop: float = 10.0) -> dict:
    """Energy (J) for one tour: movement + hover + communication.

    T_m = D/V ; hover/comm per stop are deployment knobs (the paper's
    Table II varies only deployment, so these are held constant across
    methods, matching its controlled comparison).
    """
    t_m = distance_m / params.V
    t_h = n_hover * hover_s_per_stop
    t_c = n_hover * comm_s_per_stop
    e_m = t_m * params.xi_m()
    e_h = t_h * params.xi_h
    e_c = t_c * params.xi_c
    return {"E_move": e_m, "E_hover": e_h, "E_comm": e_c,
            "E_total": e_m + e_h + e_c,
            "T_move": t_m, "T_hover": t_h, "T_comm": t_c}
