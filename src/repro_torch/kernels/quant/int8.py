"""Fused int8 link boundary: the CUDA kernel's wrapper and its plain version.

``quant_dequant_int8`` is the port of the JAX package's Pallas kernel
(``repro/kernels/quant/int8.py:104``, bodies ``:40`` and ``:48``): per row
of an (M, D) tensor, quantize to int8 with an absmax scale and dequantize
again, optionally adding a residual, in one pass. On a CUDA tensor it
launches ``csrc/quant_int8.cu`` (memory-bound; see the note in that file);
on a CPU tensor it runs ``quant_dequant_int8_plain``, the same arithmetic
in plain PyTorch ops. Any other device raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quant_dequant_int8_plain(x: torch.Tensor, *,
                             residual: torch.Tensor | None = None,
                             out_dtype: torch.dtype | None = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: the same f32 arithmetic,
    op by op. NaN propagates through the max, the scale floor and the clip
    (``amax`` and ``clamp`` propagate it).

    Two details follow what the JAX reference computes once XLA has
    compiled it: ``amax / 127`` is ``amax * f32(1/127)`` (XLA turns a
    division by a constant into a multiply), and the residual epilogue
    ``q * scale + residual`` is one fused multiply-add, rounded once (here
    evaluated in float64, where the product is exact)."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    scale = row_scale(xf)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    if residual is None:
        y = q * scale
    else:
        y = (q.double() * scale.double() + residual.double()).float()
    return y.to(out_dtype)


def row_scale(xf: torch.Tensor) -> torch.Tensor:
    """Per-row f32 scale ``max(absmax * f32(1/127), 1e-8)`` of an f32
    tensor's last axis, shared by the fused and the two-op paths."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    return torch.clamp(amax * (1.0 / 127.0), min=1e-8)


@functools.lru_cache(maxsize=None)
def _launcher():
    from ..build import load_library
    fn = load_library("quant_int8").quant_dequant_int8_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, residual, out_dtype):
    if x.dim() != 2:
        raise ValueError(f"quant_dequant_int8 takes a 2-D (M, D) tensor, got "
                         f"shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"quant_dequant_int8 takes float32/bfloat16, got "
                         f"{x.dtype} -> {out_dtype}")
    if not x.is_contiguous():
        raise ValueError("quant_dequant_int8 needs a contiguous tensor")
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device
                or not residual.is_contiguous()):
            raise ValueError("residual must be a contiguous tensor of x's "
                             "shape, dtype and device")


def quant_dequant_int8(x: torch.Tensor, *,
                       residual: torch.Tensor | None = None,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Fused int8 quant -> dequant (+ residual) of a contiguous (M, D) f32 or
    bf16 tensor. CUDA tensor: launches the kernel on the current stream and
    adds one to ``quant_dequant_int8.launches``. CPU tensor: the plain
    version. Anything else raises."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quant_dequant_int8_plain(x, residual=residual,
                                        out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant_dequant_int8 runs on CUDA (kernel) or CPU "
                         f"(plain version), not on {x.device}")
    _check(x, residual, out_dtype)
    m, d = x.shape
    out = torch.empty((m, d), dtype=out_dtype, device=x.device)
    if m == 0 or d == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(x.data_ptr(),
                          None if residual is None else residual.data_ptr(),
                          out.data_ptr(), m, d, _DTYPE_CODES[x.dtype],
                          _DTYPE_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"quant_dequant_int8 kernel launch failed: CUDA "
                           f"error {err}")
    quant_dequant_int8.launches += 1
    return out


# kernel launches since the last reset (CPU calls and failed launches do not
# count); chip_smoke.py zeroes it before the main path and reads it after
quant_dequant_int8.launches = 0
