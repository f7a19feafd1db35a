"""The float32 arithmetic of the flash kernel (``csrc/flash_attn.cu``), on the CPU.

The kernel runs both products of float32 attention on the tensor cores in
TF32 (10 mantissa bits), three times: each operand x is split into
hi = x rounded to TF32 (``cvt.rna.tf32.f32``: to nearest, ties away from
zero) and lo = x - hi, and a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi.
The MMA reads the top 19 bits of each operand, so the lo the kernel passes
unrounded is used truncated to TF32. This file emulates that scheme on the
bits with numpy (products exact and summed in float64, tiles carried in
float32, the kernel's 64-key online softmax and exp2) and pins, before any
card time, the accuracy the design relies on:

- the split: hi + lo reproduces x to 2^-22 relative with lo rounded to
  nearest, and to 2^-21 with lo truncated as the MMA reads it;
- 3xTF32 attention is within 2e-5 (the reference's float32 tolerance, which
  ``chip_smoke.py`` holds the kernel to) of ``flash_attention_plain`` over
  the CPU attention sweep's shapes and masks;
- a single TF32 pass is not, which is why the kernel takes three.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.attn.flash import flash_attention_plain

F32_ATOL = 2e-5
NEG_INF = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on the bits: add half a TF32 ulp (0x1000) to the
    magnitude, clear the 13 low bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_trunc(x: np.ndarray) -> np.ndarray:
    """How the MMA reads a float32 operand: its top 19 bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray, lo_rounding=tf32_trunc):
    """x = hi + lo with hi, lo TF32 values, as the kernel forms them
    (``lo_rounding=tf32_trunc``) or with lo rounded to nearest."""
    x = np.asarray(x, np.float32)
    hi = tf32_rna(x)
    return hi, lo_rounding(x - hi)      # x - hi is exact in float32


def matmul_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ah, al = split(a)
    bh, bl = split(b)
    f = np.float64
    out = (al.astype(f) @ bh.astype(f) + ah.astype(f) @ bl.astype(f)
           + ah.astype(f) @ bh.astype(f))
    return out.astype(np.float32)


def matmul_1xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (tf32_rna(a).astype(np.float64)
            @ tf32_rna(b).astype(np.float64)).astype(np.float32)


def attention_emulated(q, k, v, *, causal, window, matmul, block_k=64):
    """The kernel's float32 forward: q scaled by f32(1/sqrt(D)) first, an
    online softmax over ``block_k``-key tiles with the finite NEG_INF and
    exp as exp2(x log2 e) in float32, both products through ``matmul``."""
    s_len, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    qs = q * np.float32(1.0 / np.sqrt(d))
    m = np.full(q.shape[:-1] + (1,), NEG_INF, np.float32)
    l = np.zeros(q.shape[:-1] + (1,), np.float32)
    acc = np.zeros(q.shape, np.float32)
    qp = np.arange(s_len)[:, None]
    for k_lo in range(0, sk, block_k):
        kt, vt = k[..., k_lo:k_lo + block_k, :], v[..., k_lo:k_lo + block_k, :]
        s = matmul(qs, np.swapaxes(kt, -1, -2))
        kp = k_lo + np.arange(kt.shape[-2])[None, :]
        mask = np.ones((s_len, kt.shape[-2]), bool)
        if causal:
            mask &= qp >= kp
        if window is not None:
            mask &= (qp - kp) < window
        s = np.where(mask, s, NEG_INF)
        m_new = np.maximum(m, s.max(axis=-1, keepdims=True))
        p = np.exp2((s - m_new) * LOG2E).astype(np.float32)
        alpha = np.exp2((m - m_new) * LOG2E).astype(np.float32)
        l = l * alpha + p.sum(axis=-1, keepdims=True, dtype=np.float32)
        acc = acc * alpha + matmul(p, vt)
        m = m_new
    return acc / np.maximum(l, np.float32(1e-30))


def _qkv(s, sk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((1, 2, s, d)).astype(np.float32)
    k = rng.standard_normal((1, 2, sk, d)).astype(np.float32)
    v = rng.standard_normal((1, 2, sk, d)).astype(np.float32)
    return q, k, v


def _err(q, k, v, *, causal, window, matmul):
    got = attention_emulated(q, k, v, causal=causal, window=window,
                             matmul=matmul)
    want = flash_attention_plain(*(torch.tensor(a) for a in (q, k, v)),
                                 causal=causal, window=window).numpy()
    return float(np.abs(got - want).max())


def _samples(seed=0):
    """float32 values over many binades and signs, probabilities in [0, 1],
    and exact ties (low 13 bits 0x1000)."""
    rng = np.random.RandomState(seed)
    wide = (rng.standard_normal(4096)
            * 10.0 ** rng.uniform(-30, 30, 4096)).astype(np.float32)
    probs = rng.uniform(0, 1, 4096).astype(np.float32)
    ties = ((rng.standard_normal(512).astype(np.float32).view(np.uint32)
             & np.uint32(0xFFFFE000)) | np.uint32(0x1000)).view(np.float32)
    return np.concatenate([wide, probs, ties,
                           rng.standard_normal(4096).astype(np.float32)])


def test_tf32_rna_rounds_to_nearest_with_ties_away_from_zero():
    """The bit trick against rounding computed in float64 from the value."""
    x = _samples()
    x = x[x != 0]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(x.astype(np.float64)))) - 10)
    units = np.abs(x.astype(np.float64)) / ulp
    want = np.sign(x) * np.floor(units + 0.5) * ulp
    np.testing.assert_array_equal(tf32_rna(x).astype(np.float64), want)
    assert not np.any(tf32_rna(x).view(np.uint32) & np.uint32(0x1FFF))


@pytest.mark.parametrize("lo_rounding,bound", [(tf32_rna, 2.0 ** -22),
                                               (tf32_trunc, 2.0 ** -21)],
                         ids=["lo-rna", "lo-truncated-as-the-mma-reads-it"])
def test_hi_plus_lo_reproduces_x(lo_rounding, bound):
    x = _samples(1)
    hi, lo = split(x, lo_rounding)
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    x64 = x.astype(np.float64)
    rel = np.abs(hi.astype(np.float64) + lo.astype(np.float64) - x64)
    assert np.all(rel <= bound * np.abs(x64))


SWEEP = [(s, s, d, causal, window)
         for s in (7, 100, 257) for d in (32, 64, 128)
         for causal, window in ((True, None), (False, None), (True, 16),
                                (False, 100))]
SWEEP += [(100, 257, 64, True, None), (131, 1024, 32, True, 16),
          (7, 64, 128, False, None), (64, 96, 64, True, 100)]


@pytest.mark.parametrize("s,sk,d,causal,window", SWEEP)
def test_3xtf32_attention_is_within_the_f32_tolerance(s, sk, d, causal,
                                                       window):
    q, k, v = _qkv(s, sk, d, seed=s + 7 * d + sk)
    err = _err(q, k, v, causal=causal, window=window, matmul=matmul_3xtf32)
    assert err <= F32_ATOL, err


def test_one_tf32_pass_is_not_enough():
    """At the split LM's head dim and a causal mask, one TF32 pass is more
    than ten times the float32 tolerance from the plain version; 3xTF32 is
    well inside it at the same inputs. This is why the kernel takes three
    passes."""
    q, k, v = _qkv(257, 257, 64, seed=11)
    one = _err(q, k, v, causal=True, window=None, matmul=matmul_1xtf32)
    three = _err(q, k, v, causal=True, window=None, matmul=matmul_3xtf32)
    assert one > 10 * F32_ATOL, one
    assert three < F32_ATOL / 10, three


if __name__ == "__main__":
    # the errors behind the kernel's note and PERF.md:
    #   PYTHONPATH=src python tests/test_torch_flash_tf32.py
    three = [_err(*_qkv(s, sk, d, seed=s + 7 * d + sk), causal=c, window=w,
                  matmul=matmul_3xtf32) for s, sk, d, c, w in SWEEP]
    print(f"3xTF32 over the {len(SWEEP)}-case sweep: max |emulated - plain| "
          f"{max(three):.4e}")
    for s in (257, 1024):
        q, k, v = _qkv(s, s, 64, seed=11)
        print(f"S {s}, D 64, causal: one TF32 pass "
              f"{_err(q, k, v, causal=True, window=None, matmul=matmul_1xtf32):.4e}"
              f", 3xTF32 "
              f"{_err(q, k, v, causal=True, window=None, matmul=matmul_3xtf32):.4e}")
