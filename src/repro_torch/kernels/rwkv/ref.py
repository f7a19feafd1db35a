"""Plain PyTorch RWKV-6 WKV scan and its backward (the kernels' plain
versions).

``rwkv6_scan_ref`` is the counterpart of
``repro.kernels.rwkv.ref.rwkv6_scan_ref``: a loop over time with an f32
(B, H, hd, hd) state that starts from zero or from a given S_0 (the time
mix's carried state, ``repro.models.ssm._rwkv6_inner``'s ``lax.scan``). It
can also keep the state every ``CHECKPOINT_EVERY`` steps, as the forward
kernel does for the backward.

``rwkv6_scan_bwd_ref`` is the closed-form vector-Jacobian product of the
scan, the algorithm of ``csrc/rwkv6_scan_bwd.cu``: from those checkpoints
it recomputes each segment's states and sweeps back in time, ending on the
cotangent of S_0. It is not autograd; the reference's gradient is JAX's
autodiff of its ``lax.scan``.
"""
from __future__ import annotations

import torch

from ..scan_loop import scan_loop

# the state is kept every CHECKPOINT_EVERY steps for the backward, which
# recomputes each segment from it: 268 MB a call at (4, 64, 1024, 64). The
# kernels have the same number compiled in (csrc/rwkv6_scan.h).
CHECKPOINT_EVERY = 16


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, *, state=None,
                   return_state: bool = False, checkpoints: bool = False):
    """r/k/v/w (B, H, T, hd); u (H, hd) -> y (B, H, T, hd) f32, and with
    ``return_state`` also the final state S_T (B, H, hd, hd) f32, from S =
    ``state`` (B, H, hd, hd) (None: 0):

        kv  = k_t^T v_t
        y_t = r_t (S + diag(u) kv)
        S   = diag(w_t) S + kv

    With ``checkpoints`` it returns ``(y, S_T or None, checkpoints)``, the
    checkpoints (B, H, ceil(T / C), hd, hd) f32 being the states after 0,
    C, 2C, ... steps, C = ``CHECKPOINT_EVERY`` (the first is S_0).
    """
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    b, h, t, hd = rf.shape
    uu = u.float()[None, :, :, None]
    S = rf.new_zeros((b, h, hd, hd)) if state is None else state.float()

    def step(S, x):                                       # (B,H,hd) each
        r_t, k_t, v_t, w_t = x
        kv = k_t[..., :, None] * v_t[..., None, :]            # (B,H,hd,hd)
        y_t = torch.einsum("bhi,bhij->bhj", r_t, S + uu * kv)
        return w_t[..., :, None] * S + kv, y_t

    # unbind, not indexing, along T: the backward of T index ops would
    # build and add a full (B, H, T, hd) gradient per step (O(T^2) bytes);
    # unbind's backward stacks the T slices once
    S, y, ck = scan_loop(step, S, (rf, kf, vf, wf), dim=2,
                         site="rwkv6_scan_ref",
                         keep_every=CHECKPOINT_EVERY if checkpoints else 0)
    if y is None:
        y = rf.new_zeros((b, h, 0, hd))
    if checkpoints:
        if not len(ck):
            ck = rf.new_zeros((b, h, 0, hd, hd))
        return y, (S if return_state else None), ck
    return (y, S) if return_state else y


def rwkv6_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor, gy: torch.Tensor,
                       gs, checkpoints: torch.Tensor, *,
                       want_gs0: bool = False):
    """The gradients (dr, dk, dv, dw (B, H, T, hd), du (H, hd)), all f32, of
    ``rwkv6_scan_ref`` for the cotangents ``gy`` of y and ``gs`` of S_T
    (None: 0), from the ``checkpoints`` it kept every ``CHECKPOINT_EVERY``
    steps (the first being S_0, zero or carried); with ``want_gs0`` a sixth,
    dS_0 (B, H, hd, hd) f32, the G the sweep ends with. Going back in t,
    with G = dL/dS_t:

        dr_t = S_{t-1} gy_t + u k_t (gy_t . v_t)
        dk_t = G v_t + u r_t (gy_t . v_t)
        dv_t = G^T k_t + gy_t sum(u r_t k_t)
        dw_t = rowsum(G * S_{t-1})
        du  += sum_b r_t k_t (gy_t . v_t)      (accumulated in f64)
        G   <- diag(w_t) G + r_t^T gy_t

    S_{t-1} is recomputed forward from the segment's checkpoint, never by
    dividing by w (which may be 0).
    """
    rf, kf, vf, wf, gyf = (a.float() for a in (r, k, v, w, gy))
    uf = u.float()[None]                                      # (1, H, hd)
    b, h, t, hd = rf.shape
    du = torch.zeros_like(u, dtype=torch.float64)     # a sum over B and T
    G = (gs.float().clone() if gs is not None
         else rf.new_zeros((b, h, hd, hd)))
    C = CHECKPOINT_EVERY

    def segment(carry, x):
        """One segment of n <= C steps, from its checkpoint ck (B, H, 1,
        hd, hd), last step first: (dr, dk, dv, dw) (B, H, n, hd)."""
        G, du = carry
        r_s, k_s, v_s, w_s, gy_s, ck = x
        n = r_s.shape[2]
        states = [ck[:, :, 0].float()]                        # S^(t0 + s)
        for s in range(n - 1):
            states.append(w_s[:, :, s, :, None] * states[-1]
                          + k_s[:, :, s, :, None] * v_s[:, :, s, None, :])
        rows = []
        for s in reversed(range(n)):
            S = states[s]
            r_t, k_t, v_t, w_t, gy_t = (a[:, :, s]
                                        for a in (r_s, k_s, v_s, w_s, gy_s))
            gv = (gy_t * v_t).sum(-1, keepdim=True)           # (B, H, 1)
            rows.append((
                torch.einsum("bhij,bhj->bhi", S, gy_t) + uf * k_t * gv,
                torch.einsum("bhij,bhj->bhi", G, v_t) + uf * r_t * gv,
                torch.einsum("bhij,bhi->bhj", G, k_t)
                + gy_t * (uf * r_t * k_t).sum(-1, keepdim=True),
                (G * S).sum(-1)))
            du = du + (r_t * k_t * gv).sum(0).double()
            G = w_t[..., :, None] * G + r_t[..., :, None] * gy_t[..., None, :]
        rows.reverse()
        return (G, du), tuple(torch.stack(col, dim=2) for col in zip(*rows))

    (G, du), grads, _ = scan_loop(
        segment, (G, du), (rf, kf, vf, wf, gyf, checkpoints), dim=2,
        site="rwkv6_scan_bwd_ref", chunks=(C,) * 5 + (1,), reverse=True)
    dr, dk, dv, dw = (grads if grads is not None
                      else (torch.zeros_like(rf) for _ in range(4)))
    if want_gs0:
        return dr, dk, dv, dw, du.float(), G
    return dr, dk, dv, dw, du.float()
