"""int8 link boundary: the CUDA kernels' wrappers and their plain versions.

``quant_dequant_int8`` is the port of the JAX package's Pallas kernel
(``repro/kernels/quant/int8.py:104``, bodies ``:40`` and ``:48``): per row
of an (M, D) tensor, quantize to int8 with an absmax scale and dequantize
again, optionally adding a residual, in one pass. ``quantize_int8`` and
``dequantize_int8`` port the wire format's two halves (``int8.py:69`` and
``:87``, bodies ``:27`` and ``:36``): int8 codes (M, D) with f32 row scales
(M, 1), and ``codes * scale`` back in an output dtype. On a CUDA tensor
each launches its kernel in ``csrc/quant_int8.cu`` (memory-bound; see the
note in that file); on a CPU tensor it runs its plain version, the same
arithmetic in plain PyTorch ops (``quant_dequant_int8_plain`` here,
``ref.quantize_int8_ref`` and ``ref.dequantize_int8_ref`` for the halves).
Any other device raises: there is no fallback.
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


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the caller runs the plain version), True for
    a CUDA tensor; any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA (kernel) or CPU (plain "
                         f"version), not on {t.device}")
    return True


def _check(x: torch.Tensor, residual, out_dtype,
           name: str = "quant_dequant_int8"):
    if x.dim() != 2:
        raise ValueError(f"{name} takes a 2-D (M, D) tensor, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes float32/bfloat16, got {x.dtype} -> "
                         f"{out_dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
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
    if not _on_cuda("quant_dequant_int8", x):
        return quant_dequant_int8_plain(x, residual=residual,
                                        out_dtype=out_dtype)
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


@functools.lru_cache(maxsize=None)
def _wire_launchers():
    from ..build import load_library
    lib = load_library("quant_int8")
    quant, dequant = lib.quantize_int8_launch, lib.dequantize_int8_launch
    quant.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_void_p]
    dequant.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_void_p]
    quant.restype = dequant.restype = ctypes.c_int
    return quant, dequant


def quantize_int8(x: torch.Tensor):
    """x (M, D) f32/bf16 -> (codes int8 (M, D), scales f32 (M, 1)). CUDA
    tensor: launches the kernel on the current stream and adds one to
    ``quantize_int8.launches``. CPU tensor: ``ref.quantize_int8_ref``."""
    if not _on_cuda("quantize_int8", x):
        from .ref import quantize_int8_ref
        return quantize_int8_ref(x)
    _check(x, None, x.dtype, "quantize_int8")
    m, d = x.shape
    codes = torch.empty((m, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0 or d == 0:
        return codes, scales.fill_(1e-8)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _wire_launchers()[0](x.data_ptr(), codes.data_ptr(),
                                   scales.data_ptr(), m, d,
                                   _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"quantize_int8 kernel launch failed: CUDA error "
                           f"{err}")
    quantize_int8.launches += 1
    return codes, scales


def dequantize_int8(codes: torch.Tensor, scales: torch.Tensor, *,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """codes int8 (M, D), scales f32 (M, 1) -> codes * scales (M, D) in
    ``out_dtype`` (f32/bf16). CUDA tensors: launches the kernel and adds one
    to ``dequantize_int8.launches``. CPU tensors:
    ``ref.dequantize_int8_ref``."""
    if not _on_cuda("dequantize_int8", codes):
        from .ref import dequantize_int8_ref
        return dequantize_int8_ref(codes, scales, out_dtype=out_dtype)
    if codes.dim() != 2 or codes.dtype != torch.int8:
        raise ValueError(f"dequantize_int8 takes 2-D int8 codes, got "
                         f"{codes.dtype} of shape {tuple(codes.shape)}")
    m, d = codes.shape
    if (scales.shape != (m, 1) or scales.dtype != torch.float32
            or scales.device != codes.device):
        raise ValueError(f"dequantize_int8 takes f32 scales of shape "
                         f"({m}, 1) on the codes' device, got {scales.dtype} "
                         f"{tuple(scales.shape)} on {scales.device}")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"dequantize_int8 writes float32/bfloat16, not "
                         f"{out_dtype}")
    if not (codes.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize_int8 needs contiguous codes and scales")
    out = torch.empty((m, d), dtype=out_dtype, device=codes.device)
    if m == 0 or d == 0:
        return out
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = _wire_launchers()[1](codes.data_ptr(), scales.data_ptr(),
                                   out.data_ptr(), m, d,
                                   _DTYPE_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"dequantize_int8 kernel launch failed: CUDA "
                           f"error {err}")
    dequantize_int8.launches += 1
    return out


# kernel launches since the last reset; no path of the port calls these two
# (the reference's "xla" link runs their plain versions), so only the
# checks launch them
quantize_int8.launches = 0
dequantize_int8.launches = 0
