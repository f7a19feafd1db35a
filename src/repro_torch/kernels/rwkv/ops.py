"""The differentiable WKV scan the RWKV-6 time mix calls.

Counterpart of ``repro.kernels.rwkv.ops.wkv``. ``wkv`` keeps the kernel's
(B, H, T, hd) contract and goes through ``_WKV``:

- forward: ``scan.rwkv6_scan``, the CUDA kernel on a CUDA tensor and its
  plain version on a CPU tensor;
- backward: the plain version recomputed under autograd and differentiated,
  which is what the reference's autodiff of ``lax.scan`` computes (its
  Pallas kernel has no backward). It holds one call's per-step
  intermediates while it runs; a backward kernel is later work.
"""
from __future__ import annotations

import torch

from .ref import rwkv6_scan_ref
from .scan import rwkv6_scan


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, return_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.return_state = return_state
        return rwkv6_scan(r, k, v, w, u, return_state=return_state)

    @staticmethod
    def backward(ctx, gy, gs=None):
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[:5])
                  if need]
        pairs = [(i, g) for i, g in enumerate((gy, gs)) if g is not None]
        grads = [None] * 6
        if not wanted or not pairs:
            return tuple(grads)
        saved = ctx.saved_tensors
        ins = [t.detach().requires_grad_(i in wanted)
               for i, t in enumerate(saved)]
        with torch.enable_grad():
            out = rwkv6_scan_ref(*ins, return_state=True)
            got = torch.autograd.grad([out[i] for i, _ in pairs],
                                      [ins[i] for i in wanted],
                                      [g for _, g in pairs],
                                      allow_unused=True)
        for i, g in zip(wanted, got):     # None: S_T alone needs no r or u
            grads[i] = None if g is None else g.to(saved[i].dtype)
        return tuple(grads)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, return_state: bool = False):
    """r/k/v/w (B, H, T, hd), u (H, hd) -> y (B, H, T, hd) f32 (and the
    final state S_T (B, H, hd, hd) with ``return_state``), from S_0 = 0.
    Differentiable in all five inputs."""
    return _WKV.apply(r, k, v, w, u, return_state)
