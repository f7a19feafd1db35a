"""Which implementation of each kernel seam a plan runs.

Counterpart of ``repro.kernels.dispatch``; the only place the port decides
between a kernel and its plain path. Both seams take the plan's device.

Attention (``ModelSpec.attn_impl``):

- ``"pallas"`` -> the hand-written flash kernel (``kernels/attn/flash.py``;
  the name is the spec's). On a CUDA device it launches the kernel; on the
  CPU the wrapper takes its plain version, which is how the tests run it.
- ``"xla"``    -> the chunked online-softmax path in plain PyTorch
  (``models/attention.chunked_causal_attention``; the spec's default).
- ``"ref"``    -> the O(S^2) oracle (``kernels/attn/ref.py``) through the
  same seam the kernel path uses.
- ``"auto"``   -> ``"pallas"`` on CUDA, ``"xla"`` on the CPU.

int8 link boundary (``EngineSpec.link_kernel``):

- ``"fused"`` -> the hand-written CUDA kernel (``kernels/quant/int8.py``),
  or its plain version for a CPU tensor.
- ``"xla"``   -> the two-op plain quantize/dequantize (``kernels/quant/
  ref.py``).
- ``"auto"``  -> ``"fused"`` on CUDA, else ``"xla"``.
"""
from __future__ import annotations

import torch

ATTN_IMPLS = ("auto", "xla", "pallas", "ref")
LINK_KERNELS = ("auto", "xla", "fused")


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"kernel requested on {device}, but CUDA is not "
                           f"available")
    return device


def resolve_attn_impl(impl: str, device) -> str:
    """'auto'|'xla'|'pallas'|'ref' on ``device`` -> 'xla', 'pallas' or
    'ref'. Raises for a CUDA device when CUDA is not available."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{impl!r}")
    if impl == "auto":
        return "pallas" if _device(device).type == "cuda" else "xla"
    _device(device)
    return impl


def resolve_link_kernel(kind: str, device) -> str:
    """'auto'|'xla'|'fused' on ``device`` -> 'fused' or 'xla'. Raises for a
    CUDA device when CUDA is not available."""
    if kind not in LINK_KERNELS:
        raise ValueError(
            f"link_kernel must be one of {LINK_KERNELS}, got {kind!r}")
    device = _device(device)
    if kind == "auto":
        return "fused" if device.type == "cuda" else "xla"
    return kind
