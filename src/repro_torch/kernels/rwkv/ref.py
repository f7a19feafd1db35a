"""Plain PyTorch RWKV-6 WKV scan (the kernel's plain version).

Counterpart of ``repro.kernels.rwkv.ref.rwkv6_scan_ref``: a loop over time
with an f32 (B, H, hd, hd) state that starts from zero.
"""
from __future__ import annotations

import torch


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, *,
                   return_state: bool = False):
    """r/k/v/w (B, H, T, hd); u (H, hd) -> y (B, H, T, hd) f32, and with
    ``return_state`` also the final state S_T (B, H, hd, hd) f32:

        kv  = k_t^T v_t
        y_t = r_t (S + diag(u) kv)
        S   = diag(w_t) S + kv
    """
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    b, h, t, hd = rf.shape
    uu = u.float()[None, :, :, None]
    S = rf.new_zeros((b, h, hd, hd))
    ys = []
    # unbind, not indexing, along T: the backward of T index ops would
    # build and add a full (B, H, T, hd) gradient per step (O(T^2) bytes);
    # unbind's backward stacks the T slices once
    steps = zip(*(a.unbind(2) for a in (rf, kf, vf, wf)))
    for r_t, k_t, v_t, w_t in steps:                          # (B,H,hd) each
        kv = k_t[..., :, None] * v_t[..., None, :]            # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", r_t, S + uu * kv))
        S = w_t[..., :, None] * S + kv
    y = torch.stack(ys, dim=2) if ys else rf.new_zeros((b, h, 0, hd))
    return (y, S) if return_state else y
