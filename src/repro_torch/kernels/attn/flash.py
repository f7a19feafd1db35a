"""Flash attention: the CUDA kernel's wrapper, its plain version and its gradient.

``flash_attention`` is the port of the JAX package's Pallas kernel
(``repro/kernels/attn/flash.py:183``, body ``_flash_kernel`` at ``:35``):
online-softmax attention over (B, H, S, D) q and (B, H, Sk, D) k/v, with
causal and sliding-window masks on absolute positions and q scaled by
1/sqrt(d) before the product. It is differentiable through
``_FlashAttention``:

- forward: on a CUDA tensor the kernel ``csrc/flash_attn.cu`` (see the note
  there: both products on the tensor cores with ``mma.sync``, 3xTF32 for
  float32 so that it keeps float32 accuracy, bf16 MMAs for bfloat16; k/v
  tiles copied with ``cp.async`` into two stages, or at f32 head dims
  above 128 one k and one v stage copied in turns; 128 query rows a block,
  64 at f32 head dims above 208; head dims 16 to 256 in steps of 16),
  on a CPU tensor ``flash_attention_plain``; any other device raises, and
  nothing falls back;
- backward: the reference's closed form (``_flash_vjp_bwd``,
  ``flash.py:165-177``) in plain PyTorch on the saved q, k, v, o: the masked
  probabilities recomputed, dv, dp, delta = rowsum(dO * O), ds, dq, dk. The
  reference computes it outside Pallas too, so it is matrix products here
  (O(S^2) memory); a tiled backward kernel is later work.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .ref import flash_attention_ref, masked_probs

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
_INVALID_VALUE = 1   # cudaErrorInvalidValue: sizes the launcher refuses

# The plain version of the kernel is the O(S^2) masked softmax of the
# reference's oracle (``flash.py:139-151`` / ``ref.py``): the same function
# the kernel computes, with no tiling.
flash_attention_plain = flash_attention_ref


@functools.lru_cache(maxsize=None)
def _launcher():
    from ..build import load_library
    fn = load_library("flash_attn").flash_attn_fwd_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, H, S, D) q and "
                         "(B, H, Sk, D) k, v")
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32/bfloat16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q, k, v (the "
                         "kernel copies rows in 16-byte pieces)")
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a head dim that is a "
                         f"multiple of 16 up to {MAX_HEAD_DIM}, got {d}")
    if k.shape[2] < 1:
        raise ValueError("flash_attention needs at least one key")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Forward only. CUDA tensors: launches the kernel on the current stream
    and adds one to ``flash_attention.launches``. CPU tensors: the plain
    version. Anything else raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA (kernel) or CPU "
                         f"(plain version), not on {q.device}")
    _check(q, k, v, window)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b, h, s, k.shape[2], d,
                          _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d),
                          int(causal), -1 if window is None else int(window),
                          stream)
    if err == _INVALID_VALUE:
        # the checks above pass, so the launcher refused the sizes: its grid
        # has one block row per tile of query rows (the tile is the
        # kernel's own, by dtype and head dim), at most 65535 of them, and
        # B*H, S and Sk must fit its ints
        raise ValueError(f"flash_attention: the launcher refused q "
                         f"{tuple(q.shape)} {q.dtype}, Sk={k.shape[2]}: more "
                         f"query tiles than the grid's 65535, or a size past "
                         f"its int range")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


def flash_attention_bwd(q, k, v, o, g, *, causal: bool,
                        window: Optional[int]):
    """The reference's closed-form gradient (``_flash_vjp_bwd``), in f32,
    cast back to the inputs' dtypes. Returns (dq, dk, dv)."""
    d = q.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    gf, of = g.float(), o.float()
    p = masked_probs(qf, kf, causal=causal, window=window)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = torch.sum(gf * of, dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) / math.sqrt(d)
    dk = torch.matmul(ds.transpose(-1, -2), qf) / math.sqrt(d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """``torch.func``-ready (``forward`` without ``ctx``, ``setup_context``,
    an explicit ``vmap`` rule): the vmapped dimension folds into B,
    (C, B, H, S, D) -> (C*B, H, S, D), so all clients' attention is one
    kernel launch; the backward is the closed form under either."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return flash_attention_fwd(q, k, v, causal=causal, window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        ctx.save_for_backward(q, k, v, output)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, g):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, g, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        n = info.batch_size

        def fold(t, dim):
            t = (t.expand(n, *t.shape) if dim is None
                 else t.movedim(dim, 0))
            return t.reshape(n * t.shape[1], *t.shape[2:]).contiguous()

        qf, kf, vf = (fold(t, d) for t, d in zip((q, k, v), in_dims[:3]))
        o = _FlashAttention.apply(qf, kf, vf, causal, window)
        return o.reshape(n, -1, *o.shape[1:]), 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B,H,S,D); k, v (B,H,Sk,D), GQA heads already repeated ->
    (B,H,S,D) in q's dtype. Differentiable."""
    return _FlashAttention.apply(q, k, v, causal, window)


# kernel launches since the last reset (CPU calls and failed launches do not
# count); chip_smoke.py zeroes it before the main path and reads it after
flash_attention.launches = 0
