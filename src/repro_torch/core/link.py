"""UAV relay link model — paper Eq. (8): T_SL = L / R.

L is the smashed-data byte volume crossing the cut layer; R the effective
UAV<->edge data rate. The link also models the paper's stated future work —
activation compression — via int8 quantization (our Pallas kernel in
``repro.kernels.quant``) which shrinks L by ~4x vs f32 / ~2x vs bf16.

In the SPMD mapping, the link is the `pod`-axis resharding collective at the
cut; its byte volume is *measured* from the lowered HLO by the roofline
layer and fed back here for time/energy accounting.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    rate_bps: float = 100e6      # 100 Mb/s effective UAV<->edge rate
    compress: str = "none"       # "none" | "int8"
    radio_power_w: float = 2.0   # edge-device radio power while transmitting

    def wire_bytes(self, activation_bytes: float, dtype_bytes: int = 4, *,
                   scale_block: int = 256) -> float:
        """``scale_block`` is the number of elements sharing one f32 scale.
        The quant kernel emits one scale per row of the flattened
        (rows, last_dim) tensor, so callers that know the activation shape
        should pass ``scale_block=last_dim`` (``fleet.link`` does); the
        default 256 approximates wide activations."""
        if self.compress == "int8":
            # int8 payload + one f32 scale per scale_block elements
            return activation_bytes / dtype_bytes * (1.0 + 4.0 / scale_block)
        return activation_bytes

    def roundtrip_bytes(self, activation_bytes: float, dtype_bytes: int = 4,
                        *, scale_block: int = 256) -> float:
        """Wire bytes of one split step: smashed fwd + cut-gradient return."""
        return 2.0 * self.wire_bytes(activation_bytes, dtype_bytes,
                                     scale_block=scale_block)

    def transfer_time_s(self, activation_bytes: float, dtype_bytes: int = 4,
                        *, scale_block: int = 256) -> float:
        """Eq. (8): T_SL = L/R (R in bits/s)."""
        return 8.0 * self.wire_bytes(activation_bytes, dtype_bytes,
                                     scale_block=scale_block) / self.rate_bps

    def transfer_energy_j(self, activation_bytes: float, dtype_bytes: int = 4,
                          *, scale_block: int = 256) -> float:
        return self.transfer_time_s(activation_bytes, dtype_bytes,
                                    scale_block=scale_block) * self.radio_power_w


def smashed_bytes(batch: int, *feature_shape: int, dtype_bytes: int = 4) -> int:
    n = batch
    for s in feature_shape:
        n *= s
    return n * dtype_bytes
