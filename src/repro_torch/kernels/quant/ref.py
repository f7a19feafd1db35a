"""Plain PyTorch int8 quantize / dequantize (the two-op link path).

Counterpart of ``repro.kernels.quant.ref``: per-row absmax scale over the
last axis, round half to even, clip to [-127, 127].
"""
from __future__ import annotations

import torch

from .int8 import row_scale


def quantize_int8_ref(x: torch.Tensor):
    """x (..., D) -> (codes int8 (..., D), scales f32 (..., 1)). A NaN code
    (a row holding NaN or inf) becomes 0, as XLA converts NaN to an
    integer; torch leaves that conversion to the device."""
    x = x.float()
    scale = row_scale(x)
    q = torch.clamp(torch.round(x / scale), -127, 127).nan_to_num(0.0)
    return q.to(torch.int8), scale


def dequantize_int8_ref(codes: torch.Tensor, scales: torch.Tensor, *,
                        out_dtype=torch.float32) -> torch.Tensor:
    return (codes.float() * scales).to(out_dtype)

