"""Attention and the transformer layers of the port against the reference.

- ``kernels/attn/flash.py``: the port's ``flash_attention`` (on the CPU its
  forward is the kernel's plain version; its backward is the closed form)
  against the JAX package's Pallas ``flash_attention`` in interpret mode,
  over the reference's own sweep (``tests/test_kernels.py``): shapes,
  causal, window, S in {100, 131, 257, 7, 1}, Sk != S, bf16. Forward
  within 2e-5, gradients within 2e-4, bf16 within 3e-2: the reference's
  tolerances.
- ``kernels/attn/ops.attention`` with GQA (h, kh) in {(4, 2), (4, 1), (2, 2)}.
- ``models/attention.py``: ``chunked_causal_attention`` (block choice,
  ragged last blocks and window clip included) and ``reference_attention``,
  2e-5.
- ``models/modules.py``: RMSNorm, LayerNorm, RoPE, SwiGLU and GELU FFNs, 1e-6.

Inputs are standard normal from a numpy seed, handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as ref_attention
import repro.models.modules as ref_modules
from repro.kernels.attn.flash import flash_attention as ref_flash
from repro.kernels.attn.ops import attention as ref_ops_attention
from repro_torch.kernels.attn import flash as flash_mod
from repro_torch.kernels.attn.flash import (flash_attention,
                                            flash_attention_bwd,
                                            flash_attention_fwd,
                                            flash_attention_plain)
from repro_torch.kernels.attn.ops import attention
from repro_torch.kernels.dispatch import resolve_attn_impl
from repro_torch.models import modules as M
from repro_torch.models.attention import (chunked_causal_attention,
                                          gqa_repeat, reference_attention)


def _qkv(shape, kv_shape=None, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal(shape).astype(dtype)
    k = rng.standard_normal(kv_shape or shape).astype(dtype)
    v = rng.standard_normal(kv_shape or shape).astype(dtype)
    return q, k, v


def _loss_jax(fn):
    def f(q, k, v):
        o = fn(q, k, v)
        return (o * jnp.cos(o)).sum()      # a non-trivial cotangent
    return f


def _port_grads(q, k, v, **kw):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = flash_attention(qt, kt, vt, **kw)
    (o * torch.cos(o)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _check_flash(shape, causal, window, *, kv_shape=None, seed=0,
                 grad=True, block=64):
    q, k, v = _qkv(shape, kv_shape, seed)
    fn = lambda q_, k_, v_: ref_flash(  # noqa: E731
        q_, k_, v_, causal=causal, window=window, block_q=block,
        block_k=block, interpret=True)
    want = np.asarray(fn(q, k, v))
    got, grads = _port_grads(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, want, atol=2e-5)
    if grad:
        want_g = jax.grad(_loss_jax(fn), argnums=(0, 1, 2))(q, k, v)
        for g, w in zip(grads, want_g):
            np.testing.assert_allclose(g, np.asarray(w), atol=2e-4)


SWEEP = [
    ((1, 1, 128, 64), True, None),
    ((1, 1, 128, 64), False, 32),
    ((2, 2, 256, 32), True, 32),
    ((2, 2, 256, 32), False, 100),
    ((1, 4, 64, 128), False, None),
    ((1, 4, 64, 128), True, 100),
    ((2, 2, 96, 32), False, 16),
]


@pytest.mark.parametrize("shape,causal,window", SWEEP)
def test_flash_matches_pallas_in_interpret_mode(shape, causal, window):
    _check_flash(shape, causal, window)


@pytest.mark.parametrize("s,causal,window", [
    (100, True, None),     # the reference pads 100 -> 128; the port masks
    (131, True, 32),       # prime S > block, sliding window
    (257, False, None),    # prime S, bidirectional
    (7, True, None),       # S below one block
    (1, True, None),       # a single position
])
def test_flash_non_aligned_lengths(s, causal, window):
    _check_flash((2, 2, s, 32), causal, window, seed=3)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16)])
def test_flash_more_keys_than_queries(causal, window):
    """Sk != S: positions are absolute on both axes."""
    _check_flash((2, 2, 64, 32), causal, window, kv_shape=(2, 2, 96, 32),
                 seed=5)


def test_flash_bf16():
    q, k, v = (torch.tensor(a).to(torch.bfloat16)
               for a in _qkv((1, 2, 128, 64), seed=7))
    want = ref_flash(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in (q, k, v)), interpret=True, block_q=64,
                     block_k=64)
    got = flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 8)])
def test_closed_form_backward_equals_autograd_of_plain(causal, window):
    """The autograd.Function's backward (the reference's closed form) ==
    autograd through the plain version, in float64 to the last bits."""
    q, k, v = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
               for a in _qkv((1, 2, 40, 16), (1, 2, 48, 16), seed=2))
    o = flash_attention_plain(q, k, v, causal=causal, window=window)
    g = torch.cos(o.detach())
    want = torch.autograd.grad(o, (q, k, v), g)
    with torch.no_grad():
        got = flash_attention_bwd(q, k, v, o, g, causal=causal,
                                  window=window)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.double(), b, atol=1e-6, rtol=1e-6)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing():
    q, k, v = (torch.tensor(a) for a in _qkv((1, 1, 16, 16)))
    before = flash_mod.flash_attention.launches
    out = flash_attention_fwd(q, k, v)
    torch.testing.assert_close(out, flash_attention_plain(q, k, v),
                               atol=0, rtol=0)
    assert flash_mod.flash_attention.launches == before
    with pytest.raises(ValueError):
        flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("h,kh", [(4, 2), (4, 1), (2, 2)])
def test_ops_attention_gqa(h, kh):
    rng = np.random.RandomState(3)
    q = rng.standard_normal((2, 64, h, 32)).astype(np.float32)
    k = rng.standard_normal((2, 64, kh, 32)).astype(np.float32)
    v = rng.standard_normal((2, 64, kh, 32)).astype(np.float32)
    want = ref_ops_attention(q, k, v, use_pallas=True, interpret=True)
    want_g = jax.grad(lambda q_: ref_ops_attention(
        q_, k, v, use_pallas=True, interpret=True).sum())(q)
    for use_kernel in (True, False):
        qt = torch.tensor(q, requires_grad=True)
        out = attention(qt, torch.tensor(k), torch.tensor(v),
                        use_kernel=use_kernel)
        out.sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   atol=2e-5)
        np.testing.assert_allclose(qt.grad.numpy(), np.asarray(want_g),
                                   atol=2e-4)


@pytest.mark.parametrize("s,kw", [
    (64, dict(q_block=16, kv_block=32)),
    (64, dict(q_block=16, kv_block=16, window=8)),
    (48, dict(q_block=32, kv_block=64, window=20)),   # blocks shrink to 16
    (40, dict(causal=False)),
    (24, dict(q_block=8, kv_block=8, window=5, causal=False)),
    # ragged last blocks here (the reference's halve to 2)
    (50, dict(q_block=16, kv_block=32)),
    (50, dict(q_block=16, kv_block=32, window=7)),
    (50, dict(q_block=16, kv_block=32, causal=False)),
])
def test_chunked_causal_attention(s, kw):
    rng = np.random.RandomState(s)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    want = ref_attention.chunked_causal_attention(q, k, v, **kw)
    got = chunked_causal_attention(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    win, causal = kw.get("window"), kw.get("causal", True)
    oracle = reference_attention(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), window=win, causal=causal)
    np.testing.assert_allclose(
        oracle.numpy(),
        np.asarray(ref_attention.reference_attention(
            q, k, v, window=win, causal=causal)), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=2e-5)


def test_gqa_repeat():
    kv = np.random.RandomState(0).standard_normal((2, 5, 3, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        gqa_repeat(torch.tensor(kv), 3).numpy(),
        np.asarray(ref_attention.gqa_repeat(kv, 3)))


def test_resolve_attn_impl():
    assert resolve_attn_impl("auto", "cpu") == "xla"
    for impl in ("xla", "pallas", "ref"):
        assert resolve_attn_impl(impl, "cpu") == impl
    with pytest.raises(ValueError):
        resolve_attn_impl("flash", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_attn_impl("pallas", "cuda")


def _np(t):
    return t.detach().numpy()


def test_norms_rope_and_ffns():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
    d = x.shape[-1]
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    rms = M.RMSNorm(d)
    ln = M.LayerNorm(d)
    with torch.no_grad():
        rms.scale.copy_(torch.tensor(scale))
        ln.scale.copy_(torch.tensor(scale))
        ln.bias.copy_(torch.tensor(bias))
    np.testing.assert_allclose(
        _np(rms(torch.tensor(x))),
        np.asarray(ref_modules.rmsnorm_apply({"scale": scale}, x)),
        atol=1e-6)
    np.testing.assert_allclose(
        _np(ln(torch.tensor(x))),
        np.asarray(ref_modules.layernorm_apply(
            {"scale": scale, "bias": bias}, x)), atol=1e-6)

    pos = np.broadcast_to(np.arange(6, dtype=np.int32) * 37, (2, 6))
    np.testing.assert_allclose(
        _np(M.apply_rope(torch.tensor(x), torch.tensor(pos), theta=500.0)),
        np.asarray(ref_modules.apply_rope(x, pos, theta=500.0)), atol=1e-5)

    ffn_in = rng.standard_normal((3, 8)).astype(np.float32)
    w = {n: (rng.standard_normal(s) / 3).astype(np.float32) for n, s in
         [("gate", (8, 12)), ("up", (8, 12)), ("down", (12, 8))]}
    sw = M.SwiGLU(8, 12, dtype=torch.float32)
    with torch.no_grad():
        for n, a in w.items():
            getattr(sw, n).w.copy_(torch.tensor(a))
    np.testing.assert_allclose(
        _np(sw(torch.tensor(ffn_in))),
        np.asarray(ref_modules.swiglu_ffn_apply(
            {n: {"w": a} for n, a in w.items()}, ffn_in)), atol=1e-6)
    gf = M.GeluFFN(8, 12, dtype=torch.float32)
    b_up = (0.1 * rng.standard_normal(12)).astype(np.float32)
    b_down = (0.1 * rng.standard_normal(8)).astype(np.float32)
    with torch.no_grad():
        gf.up.w.copy_(torch.tensor(w["up"]))
        gf.up.b.copy_(torch.tensor(b_up))
        gf.down.w.copy_(torch.tensor(w["down"]))
        gf.down.b.copy_(torch.tensor(b_down))
    np.testing.assert_allclose(
        _np(gf(torch.tensor(ffn_in))),
        np.asarray(ref_modules.gelu_ffn_apply(
            {"up": {"w": w["up"], "b": b_up},
             "down": {"w": w["down"], "b": b_down}}, ffn_in)), atol=1e-6)
