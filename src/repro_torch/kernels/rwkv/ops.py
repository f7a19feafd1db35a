"""The differentiable WKV scan the RWKV-6 time mix calls.

Counterpart of ``repro.kernels.rwkv.ops.wkv``. ``wkv`` keeps the kernel's
(B, H, T, hd) contract and goes through ``_WKV``:

- forward: ``scan.rwkv6_scan``, the CUDA kernel on a CUDA tensor and its
  plain version on a CPU tensor; when an input needs a gradient it also
  keeps the state every ``scan.CHECKPOINT_EVERY`` steps;
- backward: ``scan.rwkv6_scan_bwd``, the backward kernel on a CUDA tensor
  and its plain closed form ``ref.rwkv6_scan_bwd_ref`` on a CPU tensor,
  both recomputing the states from those checkpoints. This is what the
  reference's autodiff of ``lax.scan`` computes (its Pallas kernel has no
  backward).
"""
from __future__ import annotations

import torch

from .scan import rwkv6_scan, rwkv6_scan_bwd


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, return_state):
        ctx.set_materialize_grads(False)
        if not any(ctx.needs_input_grad[:5]):
            return rwkv6_scan(r, k, v, w, u, return_state=return_state)
        y, state, ckpt = rwkv6_scan(r, k, v, w, u, return_state=return_state,
                                    checkpoints=True)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        return (y, state) if return_state else y

    @staticmethod
    def backward(ctx, gy, gs=None):
        if gy is None and gs is None:
            return (None,) * 6
        *saved, ckpt = ctx.saved_tensors
        need = list(ctx.needs_input_grad[:5])
        if gy is None:        # S_T alone: it depends on neither r nor u
            need[0] = need[4] = False
            gy = torch.zeros(saved[0].shape, dtype=torch.float32,
                             device=saved[0].device)
        grads = rwkv6_scan_bwd(*saved, gy.contiguous(),
                               None if gs is None else gs.contiguous(), ckpt)
        return tuple(g.to(t.dtype) if n else None
                     for g, t, n in zip(grads, saved, need)) + (None,)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, return_state: bool = False):
    """r/k/v/w (B, H, T, hd), u (H, hd) -> y (B, H, T, hd) f32 (and the
    final state S_T (B, H, hd, hd) with ``return_state``), from S_0 = 0.
    Differentiable in all five inputs."""
    return _WKV.apply(r, k, v, w, u, return_state)
