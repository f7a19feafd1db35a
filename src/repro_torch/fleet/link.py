"""Compressed link boundary and its per-step wire bytes / time / energy.

Counterpart of ``repro.fleet.link``. The boundary is the straight-through
int8 compressor of ``kernels.quant.ops`` on the kernel path the plan
resolved (``"fused"`` or ``"xla"``). The reference quantizes rows of the
smashed tensor's last axis in its own layout; the boundary's ``layout``
says how the port's smashed tensor maps onto that:

- ``"nchw"`` (the CNNs): the reference is NHWC, so rows run over the
  CHANNEL axis. The port's smashed tensor is NCHW in channels_last memory,
  so the boundary takes the free NHWC view, quantizes its (N*H*W, C) rows,
  and hands back NCHW;
- ``"bsd"`` (the split LM): the (B, S, d_model) residual stream is in the
  reference's layout already; its (B*S, d) rows are quantized as they are.

Byte accounting follows ``core.link.LinkConfig.wire_bytes``: 1 byte per
element plus one f32 scale per quantizer row, ``scale_block`` = the last
dim of the reference's shape (channels, or d_model).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

from ..core.link import LinkConfig

BOUNDARY_LAYOUTS = ("nchw", "bsd")


@dataclasses.dataclass(frozen=True)
class SmashedSpec:
    """Shape (in the reference's layout: NHWC, or (B, S, d)) and element
    size of the smashed tensor — what ``jax.eval_shape`` gives the reference's link constants."""
    shape: tuple
    itemsize: int

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class FleetLink:
    """One edge<->server link: config + the kernel path of its compressor
    (``"fused"``: the CUDA kernel; ``"xla"``: the two-op plain path)."""
    config: LinkConfig = LinkConfig()
    kernel: str = "xla"

    @property
    def compressed(self) -> bool:
        return self.config.compress == "int8"

    def boundary(self, layout: str = "nchw") -> Optional[Callable]:
        """The smashed-tensor boundary fn for a smashed tensor in ``layout``
        (``"nchw"`` or ``"bsd"``), or None for an uncompressed link."""
        if layout not in BOUNDARY_LAYOUTS:
            raise ValueError(f"layout must be one of {BOUNDARY_LAYOUTS}, got "
                             f"{layout!r}")
        if not self.compressed:
            return None
        from ..kernels.quant.ops import make_link_compress
        compress = make_link_compress(kernel=self.kernel)
        if layout == "bsd":
            return compress

        def nchw_boundary(smashed):
            return compress(smashed.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return nchw_boundary

    # ---- per-step link constants (hoisted out of the hot loop) ----

    def step_wire_bytes(self, smashed: SmashedSpec) -> float:
        """Wire bytes of ONE split step: smashed fwd + cut-gradient return,
        both compressed when the link is int8; one scale per channel row."""
        sm_bytes = float(smashed.size) * smashed.itemsize
        return self.config.roundtrip_bytes(sm_bytes, smashed.itemsize,
                                           scale_block=smashed.shape[-1])

    def step_time_s(self, smashed: SmashedSpec) -> float:
        """Eq. (8) on the roundtrip wire volume."""
        sm_bytes = float(smashed.size) * smashed.itemsize
        return 2.0 * self.config.transfer_time_s(
            sm_bytes, smashed.itemsize, scale_block=smashed.shape[-1])

    def step_energy_j(self, smashed: SmashedSpec) -> float:
        """Radio energy of one step's link roundtrip (edge-side transmit)."""
        return self.step_time_s(smashed) * self.config.radio_power_w
