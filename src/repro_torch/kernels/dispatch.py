"""Which implementation of the int8 link boundary a plan runs.

Counterpart of ``repro.kernels.dispatch.resolve_link_kernel``; the only
place the port decides between a kernel and its plain path.

- ``"fused"`` -> the hand-written CUDA kernel (``kernels/quant/int8.py``).
  It runs on a CUDA device; on the CPU the wrapper takes the plain version
  of the same arithmetic, which is how the tests run it.
- ``"xla"``   -> the two-op plain quantize/dequantize (``kernels/quant/
  ref.py``; the name is the spec's, kept for the reference's sake).
- ``"auto"``  -> ``"fused"`` when the plan's device is CUDA, else ``"xla"``.
"""
from __future__ import annotations

import torch

LINK_KERNELS = ("auto", "xla", "fused")


def resolve_link_kernel(kind: str, device) -> str:
    """'auto'|'xla'|'fused' on ``device`` -> 'fused' or 'xla'. Raises for a
    CUDA device when CUDA is not available."""
    if kind not in LINK_KERNELS:
        raise ValueError(
            f"link_kernel must be one of {LINK_KERNELS}, got {kind!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"link kernel requested on {device}, but CUDA is "
                           f"not available")
    if kind == "auto":
        return "fused" if device.type == "cuda" else "xla"
    return kind
