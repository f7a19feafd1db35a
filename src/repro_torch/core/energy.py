"""EnergyTracker + cross-hardware scaling (paper Eq. 9) + CO2 accounting.

Client/server compute time is derived analytically from a roofline over
counted FLOPs/bytes (a copy of ``repro.core.energy``) — mirroring the
paper's own methodology, which scales measured A5000 times to a Jetson via
hardware-ratio exponents (Eq. 9). Here the "source" measurement is the
analytic roofline time on the server profile; Eq. 9 scales it to the edge
profile. Powers convert time to Joules, and grid carbon intensity converts
energy to grams of CO2.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    fp32_tflops: float        # FP32 throughput [TFLOP/s]
    mem_bw_gbs: float         # memory bandwidth [GB/s]
    tensor_tflops: float      # tensor-core/bf16 throughput [TFLOP/s]
    cpu_passmark: float
    power_w: float            # board power while busy [W]
    idle_power_w: float = 10.0


# Paper §IV-C / §IV-D profiles
RTX_A5000 = HardwareProfile("rtx_a5000", fp32_tflops=27.8, mem_bw_gbs=768.0,
                            tensor_tflops=216.0, cpu_passmark=35000.0,
                            power_w=230.0, idle_power_w=25.0)
JETSON_AGX_ORIN = HardwareProfile("jetson_agx_orin", fp32_tflops=2.7,
                                  mem_bw_gbs=51.2, tensor_tflops=21.6,
                                  cpu_passmark=2500.0, power_w=40.0,
                                  idle_power_w=5.0)
# TPU v5e — the dry-run target (bf16 peak; HBM bw; used by the roofline layer)
TPU_V5E = HardwareProfile("tpu_v5e", fp32_tflops=98.5, mem_bw_gbs=819.0,
                          tensor_tflops=197.0, cpu_passmark=20000.0,
                          power_w=200.0, idle_power_w=50.0)

# paper: CO2 proportional to energy; US-average grid ~0.474 kgCO2/kWh =>
# g per Joule:
CO2_G_PER_J = 0.474 * 1000.0 / 3.6e6


def scale_time(t_src_s: float, src: HardwareProfile, tgt: HardwareProfile, *,
               w1: float = 1.0, w2: float = 0.5, w3: float = 0.8, w4: float = 0.3,
               sf: float = 1.0, of: float = 1.0) -> float:
    """Paper Eq. (9): exponent-weighted hardware-ratio scaling."""
    return (t_src_s
            * (src.fp32_tflops / tgt.fp32_tflops) ** w1
            * (src.mem_bw_gbs / tgt.mem_bw_gbs) ** w2
            * (src.tensor_tflops / tgt.tensor_tflops) ** w3
            * (src.cpu_passmark / tgt.cpu_passmark) ** w4
            * sf * of)


def roofline_time(flops: float, bytes_moved: float, hw: HardwareProfile,
                  *, use_tensor: bool = True) -> float:
    """max(compute, memory) time [s] on `hw` for a kernel of given counts."""
    peak = (hw.tensor_tflops if use_tensor else hw.fp32_tflops) * 1e12
    t_c = flops / peak
    t_m = bytes_moved / (hw.mem_bw_gbs * 1e9)
    return max(t_c, t_m)


@dataclasses.dataclass
class EnergyRecord:
    label: str
    time_s: float
    energy_j: float
    co2_g: float


class EnergyTracker:
    """Algorithm 3's EnergyTracker: accumulates per-phase time/energy/CO2.

    ``track(label, flops, bytes)`` derives time analytically on the tracker's
    hardware profile; ``track_time(label, t)`` records an externally-supplied
    duration (e.g. a measured CPU run scaled via Eq. 9).
    """

    def __init__(self, hw: HardwareProfile, *, use_tensor: bool = True):
        self.hw = hw
        self.use_tensor = use_tensor
        self.records: list[EnergyRecord] = []

    def track(self, label: str, flops: float, bytes_moved: float) -> EnergyRecord:
        t = roofline_time(flops, bytes_moved, self.hw, use_tensor=self.use_tensor)
        return self.track_time(label, t)

    def track_time(self, label: str, t: float, *, count: int = 1) -> EnergyRecord:
        """Record ``count`` repetitions of a ``t``-second phase as one entry
        (the scanned trainers account a whole round of identical steps at
        once instead of per-step host round-trips)."""
        t = t * count
        e = t * self.hw.power_w
        rec = EnergyRecord(label=label, time_s=t, energy_j=e, co2_g=e * CO2_G_PER_J)
        self.records.append(rec)
        return rec

    def total(self) -> EnergyRecord:
        t = sum(r.time_s for r in self.records)
        e = sum(r.energy_j for r in self.records)
        return EnergyRecord(label="total", time_s=t, energy_j=e, co2_g=e * CO2_G_PER_J)

    def by_prefix(self, prefix: str) -> EnergyRecord:
        rs = [r for r in self.records if r.label.startswith(prefix)]
        t = sum(r.time_s for r in rs)
        e = sum(r.energy_j for r in rs)
        return EnergyRecord(label=prefix, time_s=t, energy_j=e, co2_g=e * CO2_G_PER_J)
