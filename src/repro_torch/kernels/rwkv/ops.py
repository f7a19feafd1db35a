"""The differentiable WKV scan the RWKV-6 time mix calls.

Counterpart of ``repro.kernels.rwkv.ops.wkv``, with the time mix's carried
state: ``wkv`` keeps the kernel's (B, H, T, hd) contract, optionally starts
from a state S_0 (the reference's ``lax.scan`` in
``repro.models.ssm._rwkv6_inner`` carries one), and goes through ``_WKV``:

- forward: ``scan.rwkv6_scan``, the CUDA kernel on a CUDA tensor and its
  plain version on a CPU tensor; when an input needs a gradient it also
  keeps the state every ``scan.CHECKPOINT_EVERY`` steps (the first is S_0);
- backward: ``scan.rwkv6_scan_bwd``, the backward kernel on a CUDA tensor
  and its plain closed form ``ref.rwkv6_scan_bwd_ref`` on a CPU tensor,
  both recomputing the states from those checkpoints, and giving dS_0 when
  S_0 needs a gradient. This is what the reference's autodiff of
  ``lax.scan`` computes (its Pallas kernel has no backward).
"""
from __future__ import annotations

import torch

from .scan import rwkv6_scan, rwkv6_scan_bwd


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, return_state):
        ctx.set_materialize_grads(False)
        if not any(ctx.needs_input_grad[:6]):
            return rwkv6_scan(r, k, v, w, u, state=s0,
                              return_state=return_state)
        y, state, ckpt = rwkv6_scan(r, k, v, w, u, state=s0,
                                    return_state=return_state,
                                    checkpoints=True)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        return (y, state) if return_state else y

    @staticmethod
    def backward(ctx, gy, gs=None):
        if gy is None and gs is None:
            return (None,) * 7
        *saved, ckpt = ctx.saved_tensors
        need = list(ctx.needs_input_grad[:6])
        if gy is None:        # S_T alone: it depends on neither r nor u
            need[0] = need[4] = False
            gy = torch.zeros(saved[0].shape, dtype=torch.float32,
                             device=saved[0].device)
        grads = rwkv6_scan_bwd(*saved, gy.contiguous(),
                               None if gs is None else gs.contiguous(), ckpt,
                               want_gs0=need[5])
        out = tuple(g.to(t.dtype) if n else None
                    for g, t, n in zip(grads, saved, need))
        return out + (grads[5] if need[5] else None, None)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, state: torch.Tensor | None = None,
        return_state: bool = False):
    """r/k/v/w (B, H, T, hd), u (H, hd) -> y (B, H, T, hd) f32 (and the
    final state S_T (B, H, hd, hd) with ``return_state``), from S_0 =
    ``state`` (B, H, hd, hd) f32, or 0 when it is None. Differentiable in
    all six inputs."""
    return _WKV.apply(r, k, v, w, u, state, return_state)
