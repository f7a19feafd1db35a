"""Straight-through int8 link compressor for split learning.

Counterpart of ``repro.kernels.quant.ops``. The forward quantizes and
dequantizes rows of the tensor's last axis; the backward is the identity
(straight-through estimator), so the split step keeps the compressed link
inside one autograd graph (and composes with ``torch.func.vmap`` and
``grad``: under ``vmap`` the batched dimension joins the rows, so a fleet of
clients is one launch). ``kernel`` picks the path: ``"fused"`` (the one
CUDA kernel, or its plain version for a CPU tensor) or ``"xla"`` (the
two-op quantize/dequantize of ``ref.py``; the name is the spec's).
"""
from __future__ import annotations

import torch

from .int8 import quant_dequant_int8
from .ref import dequantize_int8_ref, quantize_int8_ref

LINK_PATHS = ("xla", "fused")


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def quant_dequant(x: torch.Tensor, *, kernel: str = "xla") -> torch.Tensor:
    x2 = _rows(x)
    if kernel == "fused":
        y = quant_dequant_int8(x2, out_dtype=x.dtype)
    elif kernel == "xla":
        q, s = quantize_int8_ref(x2)
        y = dequantize_int8_ref(q, s, out_dtype=x.dtype)
    else:
        raise ValueError(f"kernel must be one of {LINK_PATHS}, got {kernel!r}")
    return y.reshape(x.shape)


class _StraightThroughInt8(torch.autograd.Function):
    """``torch.func``-ready (``forward`` without ``ctx``, ``setup_context``,
    an explicit ``vmap`` rule): rows are independent, so a vmapped client
    axis folds into the rows and every client's tensor goes through one
    ``quant_dequant`` (one kernel launch)."""

    @staticmethod
    def forward(x, kernel):
        return quant_dequant(x, kernel=kernel)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None   # straight-through

    @staticmethod
    def vmap(info, in_dims, x, kernel):
        if in_dims[0] is None:
            return _StraightThroughInt8.apply(x, kernel), None
        return _StraightThroughInt8.apply(x.movedim(in_dims[0], 0), kernel), 0


def make_link_compress(*, kernel: str = "xla"):
    """A straight-through int8 compressor bound to one kernel path."""
    if kernel not in LINK_PATHS:
        raise ValueError(f"kernel must be one of {LINK_PATHS}, got {kernel!r}")

    def compress(x: torch.Tensor) -> torch.Tensor:
        return _StraightThroughInt8.apply(x, kernel)
    return compress
