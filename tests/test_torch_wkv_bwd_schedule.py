"""The WKV backward kernel's schedule (``csrc/rwkv6_scan_bwd.cu``) on the CPU.

The kernel computes the gradient of the RWKV-6 scan in another order than
its plain closed form ``rwkv6_scan_bwd_ref``. This file emulates that order
in float32 torch, batched over (B, H), and holds it, before any card time,
at the reference's 1e-4 against the closed form (on the same checkpoints)
and against ``jax.grad`` of the reference's oracle
(``repro.kernels.rwkv.ref.rwkv6_scan_ref``):

- segments of ``CHECKPOINT_EVERY`` steps, last first, each from the
  forward's checkpoint;
- at hd <= 64 (the kernel's resident path) the states in two levels:
  sub-checkpoints every ``SUB`` = 4 steps recomputed from the checkpoint,
  then each sub-segment swept back, last first, its last ``HELD`` = 2
  states recomputed again at once and each earlier one from the
  sub-checkpoint when its turn comes; at hd > 64 (the split path) the
  segment's states recomputed once;
- dr, dk and dw as partial sums over column chunks (16 columns at hd <= 64,
  64/32/16 above), the chunks' partials then added; dv_t as sums over the
  rows in warps of 32, the warps' parts then added;
- gv_t = gy_t . v_t and sum_i u r_t k_t formed once a step (resident) or a
  chunk at a time (split, where the bonus sits inside the chunk sums);
- du summed over T in float64 per (b, h), then over B.

The cases hit both edges of a sub-segment and of a segment (T = 1, 3, 4,
5, 15, 16, 17, 37), head sizes 16, 48, 64 and 256, w with exact zeros and
1e-30, and runs with and without a cotangent of S_T.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv.ref import rwkv6_scan_ref as ref_scan_oracle
from repro_torch.kernels.rwkv.ref import (CHECKPOINT_EVERY,
                                          rwkv6_scan_bwd_ref, rwkv6_scan_ref)

TOL = 1e-4
SUB = 4               # the kernel's sub-segment (csrc/rwkv6_scan_bwd.cu)
HELD = 2              # of its states, those the kernel holds in registers
CC = 16               # columns a thread holds on the resident path
RESIDENT_MAX_HD = 64  # the largest head size the resident path takes


def cols_of(hd: int) -> int:
    """The split path's column chunk at head size hd."""
    return 64 if hd % 64 == 0 else (32 if hd % 32 == 0 else 16)


def _chunk_sums(x, cw):
    """(..., hd) -> (..., hd // cw) partial sums over chunks of cw
    columns."""
    return x.unflatten(-1, (-1, cw)).sum(-1)


def _in_order(parts):
    """The parts along the last axis added one after another, as the
    kernel's epilogue (or its atomics) adds them."""
    acc = torch.zeros_like(parts[..., 0])
    for p in parts.unbind(-1):
        acc = acc + p
    return acc


def _row_sums_by_warp(x):
    """(B, H, hd, n) -> (B, H, n): sums over the rows in warps of 32 rows
    (padding rows hold 0), the warps' parts then added."""
    hd = x.shape[2]
    rows = -(-hd // 32) * 32
    x = torch.nn.functional.pad(x, (0, 0, 0, rows - hd))
    return _in_order(x.unflatten(2, (-1, 32)).sum(3).movedim(2, -1))


def emulate(r, k, v, w, u, gy, gs, ckpt):
    """The kernel's schedule of the backward: (dr, dk, dv, dw, du) f32 and
    the number of states it recomputed."""
    b, h, t, hd = r.shape
    resident = hd <= RESIDENT_MAX_HD
    sub = SUB if resident else CHECKPOINT_EVERY
    held = HELD if resident else CHECKPOINT_EVERY - 1
    cw = CC if resident else cols_of(hd)
    uu = u[None]                                              # (1, H, hd)
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros((b, h, hd), dtype=torch.float64)
    G = gs.clone() if gs is not None else r.new_zeros((b, h, hd, hd))
    advances = 0

    def advance(S, tt):
        nonlocal advances
        advances += 1
        return (w[:, :, tt, :, None] * S
                + k[:, :, tt, :, None] * v[:, :, tt, None, :])

    def step(S, tt):
        nonlocal G
        r_t, k_t, w_t, gy_t, v_t = (a[:, :, tt] for a in (r, k, w, gy, v))
        gyS = gy_t[:, :, None, :] * S
        Gv = G * v_t[:, :, None, :]
        GS = G * S
        if resident:
            gv = (gy_t * v_t).sum(-1, keepdim=True)           # once a step
            ruk = (uu * r_t * k_t).sum(-1, keepdim=True)
            dr[:, :, tt] = _in_order(_chunk_sums(gyS, cw)) + uu * k_t * gv
            dk[:, :, tt] = _in_order(_chunk_sums(Gv, cw)) + uu * r_t * gv
            dv[:, :, tt] = (_row_sums_by_warp(k_t[..., None] * G)
                            + gy_t * ruk)
            du.add_((r_t * k_t * gv).double())
        else:
            gv_c = _chunk_sums(gy_t * v_t, cw)[:, :, None, :]  # per chunk
            bonus = (uu * k_t)[..., None] * gv_c
            dr[:, :, tt] = _in_order(_chunk_sums(gyS, cw) + bonus)
            dk[:, :, tt] = _in_order(_chunk_sums(Gv, cw)
                                     + (uu * r_t)[..., None] * gv_c)
            dv[:, :, tt] = _row_sums_by_warp(
                k_t[..., None] * (G + (uu * r_t)[..., None]
                                  * gy_t[:, :, None, :]))
            du.add_(_in_order((r_t * k_t)[..., None] * gv_c).double())
        dw[:, :, tt] = _in_order(_chunk_sums(GS, cw))
        G = w_t[..., None] * G + r_t[..., None] * gy_t[:, :, None, :]

    for c in reversed(range(-(-t // CHECKPOINT_EVERY))):
        t0 = c * CHECKPOINT_EVERY
        n = min(CHECKPOINT_EVERY, t - t0)
        nsub = -(-n // sub)
        S = ckpt[:, :, c]
        subck = [S]                           # level 1: S_{t0 + sub q}
        for s in range(sub * (nsub - 1)):
            S = advance(S, t0 + s)
            if (s + 1) % sub == 0:
                subck.append(S)
        for q in reversed(range(nsub)):       # level 2: a sub-segment
            m = min(sub, n - q * sub)
            ta = t0 + q * sub
            states = [subck[q]]               # the last `held` at once
            if m > sub - held:
                for j in range(1, m):
                    states.append(advance(states[-1], ta + j - 1))
            for j in reversed(range(m)):
                if j < sub - held:            # the others when due
                    S = subck[q]
                    for jj in range(j):
                        S = advance(S, ta + jj)
                    states[j:] = [S]
                step(states[j], ta + j)
    return (dr, dk, dv, dw, du.sum(0).float()), advances


def _inputs(shape, seed, w_special):
    """The reference test's law (r, k, v 0.5 N(0, 1); w sigmoid(N(0, 1));
    u 0.3 N(0, 1)) with numpy; ``w_special``: every 5th channel of w
    exactly 0 and every 7th (from 1) 1e-30, as a decay exp(-exp(x))
    underflows. Then the cotangents gy and G_T, N(0, 1)."""
    b, h, t, hd = shape
    rng = np.random.RandomState(seed)
    r, k, v = (0.5 * rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    if w_special:
        w[..., ::5] = 0.0
        w[..., 1::7] = 1e-30
    u = (0.3 * rng.standard_normal((h, hd))).astype(np.float32)
    gy = rng.standard_normal(shape).astype(np.float32)
    gs = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    return (r, k, v, w, u), gy, gs


def _oracle_final_state(r, k, v, w, u):
    """S_T (B, H, hd, hd) through the reference's oracle, which returns y
    alone: one more step with k = 0 and r_T the m-th unit vector reads row
    m of S_T, for hd copies of the batch."""
    b, h, t, hd = r.shape

    def copies(a, last):                      # -> (hd * B, H, T + 1, hd)
        a = jnp.broadcast_to(a, (hd,) + a.shape)
        last = jnp.broadcast_to(last, (hd, b, h, 1, hd))
        return jnp.concatenate([a, last], axis=3).reshape(hd * b, h, t + 1,
                                                          hd)

    eye = jnp.eye(hd, dtype=jnp.float32)[:, None, None, None, :]
    zero = jnp.zeros((hd, b, h, 1, hd), jnp.float32)
    y = ref_scan_oracle(copies(r, eye), copies(k, zero), copies(v, zero),
                        copies(w, zero + 1.0), u)
    return y[:, :, t].reshape(hd, b, h, hd).transpose(1, 2, 0, 3)


# (B, H, T, hd), w with zeros and 1e-30, a cotangent of S_T
CASES = [((2, 2, 1, 16), False, True), ((1, 2, 3, 16), True, False),
         ((2, 1, 4, 16), False, True), ((1, 2, 5, 16), True, True),
         ((2, 1, 15, 16), False, False), ((1, 2, 16, 16), True, True),
         ((2, 1, 17, 16), False, True), ((1, 2, 37, 16), True, False),
         ((1, 2, 5, 48), True, True), ((1, 2, 17, 48), False, False),
         ((1, 2, 4, 64), False, True), ((1, 2, 17, 64), True, True),
         ((1, 1, 37, 64), True, False), ((1, 1, 5, 256), True, True),
         ((1, 1, 17, 256), False, False)]


@pytest.mark.parametrize("shape,w_special,final_state", CASES)
def test_kernel_schedule_matches_closed_form_and_jax_grad(shape, w_special,
                                                          final_state):
    b, h, t, hd = shape
    ins, gy, gs = _inputs(shape, seed=7 + t + hd, w_special=w_special)
    gs = gs if final_state else None
    tins = [torch.from_numpy(a) for a in ins]
    tgy = torch.from_numpy(gy)
    tgs = None if gs is None else torch.from_numpy(gs)
    _, _, ckpt = rwkv6_scan_ref(*tins, checkpoints=True)
    got, advances = emulate(*tins, tgy, tgs, ckpt)

    # the states recomputed: 1.75 a step in each full segment of the
    # resident path (12 sub-checkpoint steps, then 4 a sub-segment), 15 a
    # segment of 16 on the split path
    full = t // CHECKPOINT_EVERY
    if t % CHECKPOINT_EVERY == 0:
        per_segment = (28 if hd <= RESIDENT_MAX_HD else CHECKPOINT_EVERY - 1)
        assert advances == full * per_segment

    plain = rwkv6_scan_bwd_ref(*tins, tgy, tgs, ckpt)

    def loss(*a):
        out = jnp.sum(gy * ref_scan_oracle(*a))
        if gs is not None:
            out = out + jnp.sum(gs * _oracle_final_state(*a))
        return out

    # jit: one compile a shape, not one per op (5x faster here)
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*ins)
    for name, e, p, j in zip("rkvwu", got, plain, want):
        assert e.dtype == torch.float32 and e.shape == p.shape
        torch.testing.assert_close(e, p, atol=TOL, rtol=TOL,
                                   msg=lambda m: f"d{name} vs closed form: {m}")
        np.testing.assert_allclose(e.numpy(), np.asarray(j), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name} vs jax.grad")
