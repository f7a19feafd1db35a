"""The WKV forward kernel's schedule (``csrc/rwkv6_scan.cu``) on the CPU.

At head sizes up to 64 the kernel computes the scan in another order than
its plain version ``rwkv6_scan_ref``. This file emulates that order in
float32 torch, batched over (B, H), and holds it, before any card time, at
the reference's 1e-4 against the plain version and against the JAX
package's oracle (``repro.kernels.rwkv.ref.rwkv6_scan_ref``) and its Pallas
kernel in interpret mode (``repro.kernels.rwkv.scan.rwkv6_scan``):

- segments of ``CHECKPOINT_EVERY`` steps, staged into a ring of three
  buffers two segments ahead, with each row's 16-byte chunks at the
  kernel's swizzled places and read back from there by row slice;
- the bonus factored out of the row loop, y_t = r_t S_{t-1} + v_t (sum_i
  u_i r_i k_i), that scalar formed for segment c + 1 while segment c runs,
  in 16 lanes a step whose partial sums meet in an xor-shuffle tree;
- each thread's tile of RS rows x CS columns of S: its partial sums of
  r_t S_{t-1} over its rows in order, then added across the NQ row slices
  in the order of the kernel's reduce-scatter (slices NQ/2 apart first);
- y collected per segment and stored after the next barrier; each
  checkpoint staged at its segment's start and stored a segment later;
  one barrier a segment, T / C + 2 a call.

The cases hit both edges of a segment (T = 1, 15, 16, 17, 33, 37), head
sizes 16, 32, 48 and 64 (both tile shapes), and w with exact zeros and
1e-30, as a decay exp(-exp(x)) underflows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv.ref import rwkv6_scan_ref as ref_scan_oracle
from repro.kernels.rwkv.scan import rwkv6_scan as ref_scan_pallas
from repro_torch.kernels.rwkv.ref import CHECKPOINT_EVERY, rwkv6_scan_ref

TOL = 1e-4
NSTAGE = 3         # the kernel's staging ring
BONUS_LANES = 16   # lanes that form sum u r k for one step


def tile(hd: int):
    """(NQ, CS, RS): the threads that share a group of CS columns and the
    rows each of them holds, as ``Resident<HD>`` sets them."""
    nq = 8 if hd % 32 == 0 else 4
    cs = 4 if hd % 32 == 0 else 2
    return nq, cs, hd // nq


def swizzle(hd: int) -> list:
    """Where chunk c (4 floats) of a staged r, k or w row goes: chunk m4 of
    slice q = c // NC4 at m4 NQ + q."""
    nq, _, rs = tile(hd)
    nc4 = rs // 4
    return [(c % nc4) * nq + c // nc4 for c in range(hd // 4)]


def _fold(x):
    """Sum over the last axis as an xor tree adds lanes: the halves first
    (lanes n/2 apart), then quarters, down to neighbours."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def emulate(r, k, v, w, u):
    """The kernel's order of work: (y, S_T, checkpoints) f32 and the number
    of barriers a block passed."""
    b, h, t, hd = r.shape
    nq, cs, rs = tile(hd)
    row4 = hd // 4
    C = CHECKPOINT_EVERY
    n_seg = -(-t // C)
    swz = torch.tensor(swizzle(hd))
    # slice q reads its m4-th chunk at m4 NQ + q: its rows in order
    read = torch.tensor([[(m4 * nq + q) * 4 + e for m4 in range(rs // 4)
                          for e in range(4)] for q in range(nq)])
    ring = [None] * NSTAGE
    ruks, ybuf, ckbuf = [None, None], [None, None], [None, None]
    y = torch.full_like(r, float("nan"))
    ckpt = torch.full((b, h, n_seg, hd, hd), float("nan"))
    S = torch.zeros((b, h, nq, rs, hd))   # [slice, row of the slice, col]
    barriers = 0

    def seg_len(c):
        return min(C, t - c * C)

    def stage(c):
        n = seg_len(c)
        rows = slice(c * C, c * C + n)

        def swizzled(a):
            x = a[:, :, rows].unflatten(-1, (row4, 4))
            out = torch.full_like(x, float("nan"))
            out[..., swz, :] = x
            return out.flatten(-2)

        ring[c % NSTAGE] = {"seg": c, "r": swizzled(r), "k": swizzled(k),
                            "w": swizzled(w), "v": v[:, :, rows].clone()}

    def bonus(c):
        st = ring[c % NSTAGE]
        assert st["seg"] == c
        lanes = torch.zeros((b, h, seg_len(c), BONUS_LANES))
        for cc in range(row4):              # lane cc % 16 takes chunk cc
            at = slice(4 * swz[cc], 4 * swz[cc] + 4)
            ur = u[None, :, None, 4 * cc:4 * cc + 4] * st["r"][..., at]
            part = lanes[..., cc % BONUS_LANES]
            for e in range(4):
                part = part + ur[..., e] * st["k"][..., at][..., e]
            lanes[..., cc % BONUS_LANES] = part
        ruks[c & 1] = _fold(lanes)

    def store_y(c):
        y[:, :, c * C:c * C + seg_len(c)] = ybuf[c & 1]

    stage(0)
    barriers += 1
    bonus(0)
    if n_seg > 1:
        stage(1)
    for c in range(n_seg):
        barriers += 1
        if c + 2 < n_seg:
            stage(c + 2)                    # into segment c - 1's slot
        if c + 1 < n_seg:
            bonus(c + 1)
        if c > 0:
            store_y(c - 1)
            ckpt[:, :, c - 1] = ckbuf[(c - 1) & 1]
        ckbuf[c & 1] = S.reshape(b, h, hd, hd).clone()
        st = ring[c % NSTAGE]
        assert st["seg"] == c
        ys = []
        for s in range(seg_len(c)):
            rq, kq, wq = (st[a][:, :, s][..., read] for a in "rkw")
            vv = st["v"][:, :, s]
            acc = torch.zeros((b, h, nq, hd))
            for i in range(rs):              # the tile's rows in order
                acc = acc + rq[..., i, None] * S[..., i, :]
            kv = kq[..., None] * vv[:, :, None, None, :]
            S = wq[..., None] * S + kv
            ys.append(_fold(acc.movedim(2, -1)) + vv * ruks[c & 1][..., s,
                                                                   None])
        ybuf[c & 1] = torch.stack(ys, dim=2)
    barriers += 1
    ckpt[:, :, n_seg - 1] = ckbuf[(n_seg - 1) & 1]
    store_y(n_seg - 1)
    return y, S.reshape(b, h, hd, hd), ckpt, barriers


def _inputs(shape, seed, w_special):
    """The reference test's law (r, k, v 0.5 N(0, 1); w sigmoid(N(0, 1));
    u 0.3 N(0, 1)) with numpy; ``w_special``: every 5th channel of w
    exactly 0 and every 7th (from 1) 1e-30."""
    b, h, t, hd = shape
    rng = np.random.RandomState(seed)
    r, k, v = (0.5 * rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    if w_special:
        w[..., ::5] = 0.0
        w[..., 1::7] = 1e-30
    u = (0.3 * rng.standard_normal((h, hd))).astype(np.float32)
    return r, k, v, w, u


def _oracle_states(r, k, v, w, u, lengths):
    """The states after each of ``lengths`` steps (B, H, n, hd, hd) through
    the reference's oracle, which returns y alone: after a prefix of n
    steps, one more step with k = 0 and r the m-th unit vector reads row m
    of S_n, for hd copies of the batch."""
    b, h, t, hd = r.shape
    eye = jnp.eye(hd, dtype=jnp.float32)[:, None, None, None, :]
    zero = jnp.zeros((hd, b, h, 1, hd), jnp.float32)
    out = []
    for n in lengths:
        if n == 0:
            out.append(jnp.zeros((b, h, hd, hd), jnp.float32))
            continue

        def copies(a, last):                  # -> (hd * B, H, n + 1, hd)
            a = jnp.broadcast_to(a[:, :, :n], (hd, b, h, n, hd))
            last = jnp.broadcast_to(last, (hd, b, h, 1, hd))
            return jnp.concatenate([a, last], axis=3).reshape(hd * b, h,
                                                              n + 1, hd)

        y = ref_scan_oracle(copies(r, eye), copies(k, zero),
                            copies(v, zero), copies(w, zero + 1.0), u)
        out.append(y[:, :, n].reshape(hd, b, h, hd).transpose(1, 2, 0, 3))
    return jnp.stack(out, axis=2)


# (B, H, T, hd), w with zeros and 1e-30
CASES = [((2, 2, 1, 16), False), ((1, 2, 15, 16), True),
         ((2, 1, 16, 16), True), ((1, 2, 37, 16), False),
         ((1, 2, 17, 32), True), ((2, 1, 33, 32), False),
         ((2, 1, 16, 48), False), ((1, 2, 17, 48), True),
         ((1, 1, 37, 48), True), ((1, 2, 1, 64), True),
         ((2, 1, 15, 64), False), ((1, 2, 33, 64), True),
         ((1, 1, 37, 64), False)]


@pytest.mark.parametrize("shape,w_special", CASES)
def test_kernel_schedule_matches_plain_oracle_and_pallas(shape, w_special):
    b, h, t, hd = shape
    ins = _inputs(shape, seed=11 + t + hd, w_special=w_special)
    tins = [torch.from_numpy(a) for a in ins]
    y, st, ckpt, barriers = emulate(*tins)
    n_seg = -(-t // CHECKPOINT_EVERY)
    assert barriers == n_seg + 2            # one a segment, two around
    for name, a in (("y", y), ("S_T", st), ("checkpoints", ckpt)):
        assert a.dtype == torch.float32 and not a.isnan().any(), name

    want_y, want_s, want_c = rwkv6_scan_ref(*tins, return_state=True,
                                            checkpoints=True)
    for name, got, want in (("y", y, want_y), ("S_T", st, want_s),
                            ("checkpoints", ckpt, want_c)):
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL,
                                   msg=lambda m: f"{name} vs plain: {m}")

    oracle_y = ref_scan_oracle(*ins)
    pallas_y = ref_scan_pallas(*ins, interpret=True)
    states = _oracle_states(*ins, [c * CHECKPOINT_EVERY for c in range(n_seg)]
                            + [t])
    for name, got, want in (("y", y, oracle_y), ("y", y, pallas_y),
                            ("S_T", st, states[:, :, -1]),
                            ("checkpoints", ckpt, states[:, :, :-1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL, err_msg=f"{name} vs JAX")


def test_swizzle_puts_a_loads_chunks_side_by_side():
    """Each head size's swizzle is a permutation of a row's chunks, and the
    NQ slices' m4-th chunks land in one contiguous run: the broadcast
    LDS.128 of one m4 reads 16 NQ contiguous bytes."""
    for hd in (16, 32, 48, 64):
        nq, cs, rs = tile(hd)
        swz = swizzle(hd)
        assert sorted(swz) == list(range(hd // 4))
        assert rs % 4 == 0 and (hd // cs * nq) % 32 == 0
        for m4 in range(rs // 4):
            at = sorted(swz[q * (rs // 4) + m4] for q in range(nq))
            assert at == list(range(m4 * nq, m4 * nq + nq))
