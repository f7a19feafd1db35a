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

``quant_int8_launch_plan`` is a plain-Python copy of the rule by which the
C launch functions choose between the fused and quantize kernels' vector
path (rows of whole 16-byte chunks, G lanes a row, V chunks a lane) and
their generic path; ``quant_int8_device_plan`` asks the compiled library
for the same plan, with the resident blocks an SM beside it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the launch plan's constants, as csrc/quant_int8.cu sets them
WARPS_PER_BLOCK = 8
THREADS = 32 * WARPS_PER_BLOCK
CHUNK_BYTES = 16        # a lane's load: 4 f32 or 8 bf16
VEC_MAX_CHUNKS = 8      # V, the chunks a lane holds, at most
_KERNEL_CODES = {("quant_dequant_int8", False): 0,
                 ("quant_dequant_int8", True): 1,
                 ("quantize_int8", False): 2}


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


def quant_int8_launch_plan(m: int, d: int, in_dtype: torch.dtype,
                           out_dtype: torch.dtype | None = None,
                           aligned: bool = True,
                           kernel: str = "quant_dequant_int8") -> dict:
    """The launch ``quant_dequant_int8`` or ``quantize_int8`` makes for an
    (m, d) input of ``in_dtype`` (``out_dtype`` matters to neither plan),
    with every pointer aligned to its access width (``aligned``) or not: a
    copy of ``make_plan`` in ``csrc/quant_int8.cu``.

    The vector path takes rows of C = d * size / 16 whole 16-byte chunks,
    C at most 32 * ``VEC_MAX_CHUNKS``: G lanes a row, G the smallest power
    of two >= C capped at 32, V = ceil(C / G) chunks a lane, 32 / G rows a
    warp. Anything else takes the generic path: a warp a row (G = 32, V =
    0). Returns ``path`` ("vector" or "generic"), ``lanes_per_row``,
    ``chunks_per_lane``, ``rows_per_block``, ``blocks`` and ``threads``."""
    if (kernel, False) not in _KERNEL_CODES:
        raise ValueError(f"no launch plan for kernel {kernel!r}")
    if m <= 0 or d <= 0:
        raise ValueError(f"an (M, D) input with M, D > 0, got ({m}, {d})")
    row_bytes = d * in_dtype.itemsize
    chunks = row_bytes // CHUNK_BYTES
    if (aligned and row_bytes % CHUNK_BYTES == 0
            and chunks <= 32 * VEC_MAX_CHUNKS):
        g = min(32, 1 << (chunks - 1).bit_length())
        plan = {"path": "vector", "lanes_per_row": g,
                "chunks_per_lane": -(-chunks // g),
                "rows_per_block": WARPS_PER_BLOCK * 32 // g}
    else:
        plan = {"path": "generic", "lanes_per_row": 32, "chunks_per_lane": 0,
                "rows_per_block": WARPS_PER_BLOCK}
    plan["blocks"] = -(-m // plan["rows_per_block"])
    plan["threads"] = THREADS
    return plan


@functools.lru_cache(maxsize=None)
def _plan_function():
    from ..build import load_library
    fn = load_library("quant_int8").quant_int8_launch_plan
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quant_int8_device_plan(m: int, d: int, in_dtype: torch.dtype,
                           out_dtype: torch.dtype | None = None,
                           aligned: bool = True,
                           kernel: str = "quant_dequant_int8",
                           residual: bool = False) -> dict:
    """``quant_int8_launch_plan``'s keys from the compiled library
    (``quant_int8_launch_plan`` in ``csrc/quant_int8.cu``) for the kernel
    with or without a residual, on the current CUDA device, and
    ``blocks_per_sm``: the resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    out = (ctypes.c_int64 * 7)()
    err = _plan_function()(m, d, _DTYPE_CODES[in_dtype],
                           _DTYPE_CODES[out_dtype or in_dtype], int(aligned),
                           _KERNEL_CODES[(kernel, residual)], out)
    if err != 0:
        raise RuntimeError(f"quant_int8_launch_plan for ({m}, {d}) {kernel} "
                           f"failed: CUDA error {err}")
    vector, g, v, rows, blocks, threads, resident = out
    return {"path": "vector" if vector else "generic", "lanes_per_row": g,
            "chunks_per_lane": v, "rows_per_block": rows, "blocks": blocks,
            "threads": threads, "blocks_per_sm": resident}


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
    bf16 tensor. CUDA tensor: launches the kernel on the current stream
    (the path ``quant_int8_launch_plan`` gives, with the alignment the
    launch function reads off the pointers) and adds one to
    ``quant_dequant_int8.launches``. CPU tensor: the plain version.
    Anything else raises."""
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
    tensor: launches the kernel on the current stream (its path as
    ``quant_dequant_int8``'s) and adds one to ``quantize_int8.launches``.
    CPU tensor: ``ref.quantize_int8_ref``."""
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
