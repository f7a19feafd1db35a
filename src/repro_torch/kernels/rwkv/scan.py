"""RWKV-6 WKV scan: the CUDA kernel's wrapper and its plain version.

``rwkv6_scan`` is the port of the JAX package's Pallas kernel
(``repro/kernels/rwkv/scan.py:51``, body ``_rwkv_kernel`` at ``:28``): per
(batch, head), the Finch recurrence from a zero state,

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

over (B, H, T, hd) r/k/v/w and an (H, hd) bonus u, giving y (B, H, T, hd)
f32 and, on request, the final state S_T (B, H, hd, hd). On a CUDA tensor
it launches ``csrc/rwkv6_scan.cu`` (see the note there), which takes f32
inputs and a head size that is a multiple of 16 up to 64, and raises on
anything else; on a CPU tensor it runs its plain version ``ref.rwkv6_scan_ref``. Any other
device raises: nothing falls back. Forward only; ``ops.wkv`` adds the
gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .ref import rwkv6_scan_ref

MAX_HEAD_DIM = 64


@functools.lru_cache(maxsize=None)
def _launcher():
    from ..build import load_library
    fn = load_library("rwkv6_scan").rwkv6_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w, u):
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan takes (B, H, T, hd) r/k/v/w, got "
                         f"shape {tuple(r.shape)}")
    b, h, t, hd = r.shape
    for name, a in (("k", k), ("v", v), ("w", w)):
        if a.shape != r.shape:
            raise ValueError(f"rwkv6_scan: {name} {tuple(a.shape)} != r "
                             f"{tuple(r.shape)}")
    if u.shape != (h, hd):
        raise ValueError(f"rwkv6_scan: u must be (H, hd) = {(h, hd)}, got "
                         f"{tuple(u.shape)}")
    for name, a in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if a.dtype != torch.float32:
            raise ValueError(f"rwkv6_scan's kernel takes float32 inputs, got "
                             f"{name} {a.dtype}")
        if a.device != r.device:
            raise ValueError("rwkv6_scan: inputs on different devices")
        if not a.is_contiguous():
            raise ValueError(f"rwkv6_scan needs contiguous inputs ({name} is "
                             f"not)")
    if hd % 16 or not 16 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan's kernel takes a head size that is a "
                         f"multiple of 16 up to {MAX_HEAD_DIM}, got {hd}")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *,
               return_state: bool = False):
    """y (B, H, T, hd) f32, and S_T with ``return_state``. CUDA tensors:
    launches the kernel on the current stream and adds one to
    ``rwkv6_scan.launches``. CPU tensors: the plain version."""
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, u, return_state=return_state)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on CUDA (kernel) or CPU (plain "
                         f"version), not on {r.device}")
    _check(r, k, v, w, u)
    b, h, t, hd = r.shape
    y = torch.empty_like(r)
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=r.device) if return_state else None)
    if b * h > 0 and t > 0:
        with torch.cuda.device(r.device):
            stream = torch.cuda.current_stream(r.device).cuda_stream
            err = _launcher()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                              w.data_ptr(), u.data_ptr(), y.data_ptr(),
                              None if state is None else state.data_ptr(),
                              b, h, t, hd, stream)
        if err != 0:
            raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                               f"{err}")
        rwkv6_scan.launches += 1
    return (y, state) if return_state else y


# kernel launches since the last reset (CPU calls and failed launches do not
# count); chip_smoke.py zeroes it before the RWKV path and reads it after
rwkv6_scan.launches = 0
