"""RWKV-6 WKV scan: the CUDA kernels' wrappers and their plain versions.

``rwkv6_scan`` is the port of the JAX package's Pallas kernel
(``repro/kernels/rwkv/scan.py:51``, body ``_rwkv_kernel`` at ``:28``): per
(batch, head), the Finch recurrence

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

over (B, H, T, hd) r/k/v/w and an (H, hd) bonus u, from a zero state or
from a carried S_0 (B, H, hd, hd) (``state=``: the reference's time mix
carries it in its own ``lax.scan``, ``repro/models/ssm.py:97-106``; a
decode step is T = 1 from it), giving y (B, H, T, hd) f32, on request the
final state S_T (B, H, hd, hd), and on request the states every
``CHECKPOINT_EVERY`` steps that the backward starts from (the first is
S_0). ``rwkv6_scan_bwd`` is its backward (the reference's is autodiff of
``lax.scan``, ``repro/kernels/rwkv/ref.py``): the gradients of all five
inputs from those checkpoints, and on request the cotangent of S_0.

On a CUDA tensor each launches its kernel (``csrc/rwkv6_scan.cu``,
``csrc/rwkv6_scan_bwd.cu``; see the notes there), which takes contiguous,
16-byte aligned f32 inputs and a head size that is a multiple of 16 from 16
to 256, and raises ``ValueError`` on anything else before any launch; on a
CPU tensor it runs its plain version (``ref.py``). Any other device raises:
nothing falls back. ``ops.wkv`` joins the two into a differentiable op.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .ref import CHECKPOINT_EVERY, rwkv6_scan_bwd_ref, rwkv6_scan_ref

MAX_HEAD_DIM = 256


def _library(name):
    """The kernel library, refused if its compiled-in checkpoint interval
    (``csrc/rwkv6_scan.h``) is not ``CHECKPOINT_EVERY``."""
    from ..build import load_library
    lib = load_library(name)
    lib.rwkv6_checkpoint_every.restype = ctypes.c_int
    if lib.rwkv6_checkpoint_every() != CHECKPOINT_EVERY:
        raise RuntimeError(f"{name} was built with a checkpoint interval of "
                           f"{lib.rwkv6_checkpoint_every()}, not "
                           f"{CHECKPOINT_EVERY}")
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_library():
    lib = _library("rwkv6_scan")
    lib.rwkv6_scan_launch.argtypes = [ctypes.c_void_p] * 9 \
        + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    lib.rwkv6_scan_launch.restype = ctypes.c_int
    lib.rwkv6_scan_launch_config.argtypes = [ctypes.c_int64] * 3 \
        + [ctypes.POINTER(ctypes.c_int64)]
    lib.rwkv6_scan_launch_config.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library():
    lib = _library("rwkv6_scan_bwd")
    lib.rwkv6_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 15 \
        + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    lib.rwkv6_scan_bwd_launch.restype = ctypes.c_int
    lib.rwkv6_scan_bwd_chunks.argtypes = [ctypes.c_int64]
    lib.rwkv6_scan_bwd_chunks.restype = ctypes.c_int
    lib.rwkv6_scan_bwd_scratch_floats.argtypes = [ctypes.c_int64] * 3
    lib.rwkv6_scan_bwd_scratch_floats.restype = ctypes.c_int64
    lib.rwkv6_scan_bwd_launch_config.argtypes = [ctypes.c_int64] * 3 \
        + [ctypes.POINTER(ctypes.c_int64)]
    lib.rwkv6_scan_bwd_launch_config.restype = ctypes.c_int
    return lib


def _check(r, k, v, w, u, **more):
    """What the kernels take: (B, H, T, hd) r/k/v/w (and any ``more`` of
    the same shape), u (H, hd), all f32, contiguous, 16-byte aligned, on
    one device; hd a multiple of 16 from 16 to ``MAX_HEAD_DIM``."""
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan takes (B, H, T, hd) r/k/v/w, got "
                         f"shape {tuple(r.shape)}")
    b, h, t, hd = r.shape
    same = {"k": k, "v": v, "w": w, **more}
    for name, a in same.items():
        if a.shape != r.shape:
            raise ValueError(f"rwkv6_scan: {name} {tuple(a.shape)} != r "
                             f"{tuple(r.shape)}")
    if u.shape != (h, hd):
        raise ValueError(f"rwkv6_scan: u must be (H, hd) = {(h, hd)}, got "
                         f"{tuple(u.shape)}")
    for name, a in (("r", r), *same.items(), ("u", u)):
        if a.dtype != torch.float32:
            raise ValueError(f"rwkv6_scan's kernels take float32 inputs, got "
                             f"{name} {a.dtype}")
        if a.device != r.device:
            raise ValueError("rwkv6_scan: inputs on different devices")
        if not a.is_contiguous():
            raise ValueError(f"rwkv6_scan needs contiguous inputs ({name} is "
                             f"not)")
        if a.data_ptr() % 16:
            raise ValueError(f"rwkv6_scan needs 16-byte aligned inputs "
                             f"({name} is not)")
    if hd % 16 or not 16 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan's kernels take a head size that is a "
                         f"multiple of 16 from 16 to {MAX_HEAD_DIM}, got {hd}")


def _check_state(a, name: str, shape, device):
    """A (B, H, hd, hd) state the kernels read or write: contiguous,
    16-byte aligned float32 of ``shape`` on ``device``."""
    if (a.shape != shape or a.dtype != torch.float32 or a.device != device
            or not a.is_contiguous() or a.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"float32 {shape} on {device}, got "
                         f"{a.dtype} {tuple(a.shape)} on {a.device}")


def _device(r, name):
    """True for the kernel (a CUDA tensor), False for the plain version (a
    CPU tensor, or a meta one, which carries shapes alone: the dry run's
    DTensors hold meta shards)."""
    if r.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{name} runs on CUDA (kernel) or CPU and meta "
                         f"(plain version), not on {r.device}")
    return r.device.type == "cuda"


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *, state=None,
               return_state: bool = False, checkpoints: bool = False):
    """y (B, H, T, hd) f32 from S_0 = ``state`` (B, H, hd, hd) f32 (None:
    0), and S_T with ``return_state``; with ``checkpoints``, ``(y, S_T or
    None, checkpoints)``, the checkpoints (B, H, ceil(T / C), hd, hd) f32
    being the states after 0, C, 2C, ... steps, C = ``CHECKPOINT_EVERY``
    (the first is S_0, bit for bit). CUDA tensors: launches the kernel on
    the current stream and adds one to ``rwkv6_scan.launches``. CPU
    tensors: the plain version."""
    if not _device(r, "rwkv6_scan"):
        return rwkv6_scan_ref(r, k, v, w, u, state=state,
                              return_state=return_state,
                              checkpoints=checkpoints)
    _check(r, k, v, w, u)
    b, h, t, hd = r.shape
    if state is not None:
        _check_state(state, "rwkv6_scan: state", (b, h, hd, hd), r.device)
    y = torch.empty_like(r)
    s_out = None
    if return_state:       # T = 0 launches nothing: S_T is then S_0
        s_out = (torch.zeros((b, h, hd, hd), dtype=torch.float32,
                             device=r.device) if state is None
                 else torch.empty_like(state) if t > 0 else state.clone())
    ckpt = (torch.empty((b, h, -(-t // CHECKPOINT_EVERY), hd, hd),
                        dtype=torch.float32, device=r.device)
            if checkpoints else None)
    if b * h > 0 and t > 0:
        with torch.cuda.device(r.device):
            err = _fwd_library().rwkv6_scan_launch(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None if state is None else state.data_ptr(),
                y.data_ptr(), None if s_out is None else s_out.data_ptr(),
                None if ckpt is None else ckpt.data_ptr(),
                b, h, t, hd, _stream(r.device))
        if err != 0:
            raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                               f"{err}")
        rwkv6_scan.launches += 1
    if checkpoints:
        return y, s_out, ckpt
    return (y, s_out) if return_state else y


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, gy: torch.Tensor, gs,
                   checkpoints: torch.Tensor, *, want_gs0: bool = False):
    """(dr, dk, dv, dw (B, H, T, hd), du (H, hd)) f32 for the cotangents
    ``gy`` of y and ``gs`` of S_T (None: 0), from the ``checkpoints`` that
    ``rwkv6_scan(..., checkpoints=True)`` returned; with ``want_gs0`` a
    sixth, dS_0 (B, H, hd, hd) f32, the cotangent of the state the scan
    started from. CUDA tensors: one launch of the backward kernel on the
    current stream (one more in ``rwkv6_scan_bwd.launches``), then du's
    per-(b, chunk) partials summed. CPU tensors: the plain version."""
    if not _device(r, "rwkv6_scan_bwd"):
        return rwkv6_scan_bwd_ref(r, k, v, w, u, gy, gs, checkpoints,
                                  want_gs0=want_gs0)
    _check(r, k, v, w, u, gy=gy)
    b, h, t, hd = r.shape
    if checkpoints is None:
        raise ValueError("rwkv6_scan_bwd needs the forward's checkpoints")
    _check_state(checkpoints, "rwkv6_scan_bwd: checkpoints",
                 (b, h, -(-t // CHECKPOINT_EVERY), hd, hd), r.device)
    if gs is not None:
        _check_state(gs, "rwkv6_scan_bwd: gs", (b, h, hd, hd), r.device)
    lib = _bwd_library()
    chunks = lib.rwkv6_scan_bwd_chunks(hd)
    new = torch.zeros if chunks > 1 else torch.empty     # > 1: atomicAdd
    dr, dk, dv, dw = (new(r.shape, dtype=torch.float32, device=r.device)
                      for _ in range(4))
    du_part = torch.empty((b, chunks, h, hd), dtype=torch.float32,
                          device=r.device)
    gs0 = (torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
           if want_gs0 else None)
    if b * h == 0 or t == 0:
        if want_gs0:           # no step: dS_0 is G_T
            gs0 = gs.clone() if gs is not None else torch.zeros_like(gs0)
        return (dr, dk, dv, dw, torch.zeros_like(u)) + (
            (gs0,) if want_gs0 else ())
    n_scratch = lib.rwkv6_scan_bwd_scratch_floats(b, h, hd)  # 0 at hd <= 64
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=r.device)
               if n_scratch else None)
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), gy.data_ptr(), None if gs is None else gs.data_ptr(),
            checkpoints.data_ptr(), dr.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(),
            None if gs0 is None else gs0.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, h, t, hd,
            _stream(r.device))
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd kernel launch failed: CUDA error "
                           f"{err}")
    rwkv6_scan_bwd.launches += 1
    grads = (dr, dk, dv, dw, du_part.sum(dim=(0, 1)))
    return grads + (gs0,) if want_gs0 else grads


def _launch_config(fn, name, batch, n_heads, hd) -> dict:
    cfg = (ctypes.c_int64 * 4)()
    err = fn(batch, n_heads, hd, cfg)
    if err != 0:
        raise RuntimeError(f"{name} launch config for hd {hd} failed: CUDA "
                           f"error {err}")
    return dict(zip(("blocks", "threads", "smem_bytes", "blocks_per_sm"),
                    cfg))


def rwkv6_scan_launch_config(batch: int, n_heads: int, hd: int) -> dict:
    """The launch ``rwkv6_scan(..., checkpoints=True)`` makes on the current
    CUDA device for (batch, n_heads, hd): ``blocks``, ``threads`` a block,
    ``smem_bytes`` of dynamic shared memory and ``blocks_per_sm`` resident
    at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return _launch_config(_fwd_library().rwkv6_scan_launch_config,
                          "rwkv6_scan", batch, n_heads, hd)


def rwkv6_scan_bwd_launch_config(batch: int, n_heads: int, hd: int) -> dict:
    """The launch ``rwkv6_scan_bwd`` makes, as ``rwkv6_scan_launch_config``
    gives the forward's."""
    return _launch_config(_bwd_library().rwkv6_scan_bwd_launch_config,
                          "rwkv6_scan_bwd", batch, n_heads, hd)


# kernel launches since the last reset (CPU calls and failed launches do not
# count); chip_smoke.py zeroes them before the RWKV path and reads them after
rwkv6_scan.launches = 0
rwkv6_scan_bwd.launches = 0
