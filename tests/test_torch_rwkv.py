"""RWKV-6 in the port against the reference: the WKV scan, its gradient,
the time mix and the channel mix.

- ``wkv`` (on the CPU: the kernel's plain version) against the reference's
  Pallas ``rwkv6_scan`` in interpret mode and its oracle ``rwkv6_scan_ref``,
  at the shapes of ``tests/test_kernels.py:273`` and a ragged T, atol/rtol
  1e-4 (the reference's own tolerance for its kernel);
- ``_WKV``'s gradient (on the CPU: the backward kernel's plain closed
  form ``rwkv6_scan_bwd_ref``, recomputing from checkpoints) against
  ``jax.grad`` of ``rwkv6_scan_ref``, 1e-4, at head sizes 16 to 256, with
  and without a cotangent of the final state S_T, at T = 1 and at T that
  the checkpoint interval does not divide, and with w holding exact zeros
  and values near 1e-30;
- the scan from a carried state S_0: y and S_T against a float64 loop
  from S_0 written here, the first checkpoint S_0 bit for bit, and the
  six gradients (r, k, v, w, u and dS_0, the plain closed form's) against
  that loop's, 1e-4, at T = 1 (a decode step) and T on the edges of the
  16-step checkpoint segment, hd 16 to 256;
- ``rwkv6_apply`` (output and the final state S_T the reference's
  ``lax.scan`` returns) and ``rwkv6_ffn_apply`` against the reference, with
  the reference's weights carried over by ``convert.model_from_reference``:
  f32 to 1e-4, bf16 to one bf16 rounding at the output's scale; and
  ``rwkv6_apply`` from a nonzero carried state (S and the token shift's
  x_prev), y and S_T to 1e-4 in f32, with the gradients of x, of the
  state's S and x_prev and of every time-mix parameter against
  ``jax.grad`` of the reference's time mix from the same state;
- what the slice refuses: a device other than CUDA or the CPU (the
  kernel's own refusals of a head size or dtype need the card:
  ``test_torch_cuda.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rwkv6_7b as ref_rwkv6_7b
from repro.kernels.rwkv.ref import rwkv6_scan_ref as ref_scan_oracle
from repro.kernels.rwkv.scan import rwkv6_scan as ref_scan_pallas
from repro.models.ssm import rwkv6_apply as ref_rwkv6_apply
from repro.models.ssm import rwkv6_ffn_apply as ref_rwkv6_ffn_apply
from repro.models.transformer import model_init as ref_model_init
from repro_torch.configs import rwkv6_7b
from repro_torch.convert import model_from_reference
from repro_torch.kernels.rwkv.ops import wkv
from repro_torch.kernels.rwkv.ref import rwkv6_scan_ref
from repro_torch.kernels.rwkv.scan import CHECKPOINT_EVERY, rwkv6_scan
from repro_torch.models.ssm import (rwkv6_apply, rwkv6_empty_state,
                                    rwkv6_ffn_apply)

# (B, H, T, hd): the reference test's shapes, then ragged and odd T
SCAN_SHAPES = [(1, 1, 32, 8), (2, 2, 64, 16), (1, 3, 128, 32),
               (2, 2, 37, 16), (1, 2, 1, 32), (1, 2, 20, 128),
               (1, 1, 9, 256)]
TOL = 1e-4


def _scan_inputs(shape, seed=0, w_zeros=False):
    """The reference test's law: r, k, v 0.5 N(0, 1); w sigmoid(N(0, 1));
    u 0.3 N(0, 1); made with numpy. ``w_zeros``: every 5th channel of w
    exactly 0 and every 7th (from 1) 1e-30, as a decay exp(-exp(x))
    underflows."""
    b, h, t, hd = shape
    rng = np.random.RandomState(seed + t)
    r, k, v = (0.5 * rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    if w_zeros:
        w[..., ::5] = 0.0
        w[..., 1::7] = 1e-30
    u = (0.3 * rng.standard_normal((h, hd))).astype(np.float32)
    return r, k, v, w, u


def _scan_f64(r, k, v, w, u, s0=None):
    """y and S_T of the recurrence in float64 from S_0 = ``s0`` (None: 0),
    a plain loop over numpy inputs written here (neither the port's nor the
    reference's code), as torch tensors that take gradients; the leaves
    are r, k, v, w, u (and S_0 when given)."""
    leaves = [torch.from_numpy(a).double().requires_grad_(True)
              for a in (r, k, v, w, u) + (() if s0 is None else (s0,))]
    rr, kk, vv, ww, uu = leaves[:5]
    b, h, t, hd = rr.shape
    S = rr.new_zeros((b, h, hd, hd)) if s0 is None else leaves[5]
    ys = []
    for i in range(t):
        kv = kk[:, :, i, :, None] * vv[:, :, i, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", rr[:, :, i],
                               S + uu[None, :, :, None] * kv))
        S = ww[:, :, i, :, None] * S + kv
    return leaves, torch.stack(ys, dim=2), S


def _oracle_final_state(r, k, v, w, u):
    """S_T (B, H, hd, hd) read through the reference's oracle, which returns
    y alone: one more step with k = 0 gives y_T[j] = sum_i r_T[i] S_T[i][j],
    so hd copies of the batch, copy m with r_T the m-th unit vector, read
    row m of S_T."""
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


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_wkv_plain_matches_pallas_interpret_and_oracle(shape):
    ins = _scan_inputs(shape)
    got = wkv(*(torch.from_numpy(a) for a in ins))
    want_oracle = np.asarray(ref_scan_oracle(*ins))
    want_pallas = np.asarray(ref_scan_pallas(*ins, block_t=16,
                                             interpret=True))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), want_oracle, atol=TOL, rtol=TOL)


def test_wkv_final_state_is_the_last_step_of_the_recurrence():
    """S_T extends the scan by nothing: running one more step from it gives
    the same y as the T+1-step scan."""
    ins = [torch.from_numpy(a) for a in _scan_inputs((2, 2, 13, 16))]
    y, st = rwkv6_scan(*(a[:, :, :12] if a.dim() == 4 else a for a in ins),
                       return_state=True)
    r, k, v, w, u = (a[:, :, 12] if a.dim() == 4 else a for a in ins)
    kv = k[..., :, None] * v[..., None, :]
    y_last = torch.einsum("bhi,bhij->bhj", r, st + u[None, :, :, None] * kv)
    full = rwkv6_scan_ref(*ins)
    torch.testing.assert_close(y, full[:, :, :12], atol=0, rtol=0)
    torch.testing.assert_close(y_last, full[:, :, 12], atol=1e-6, rtol=1e-6)


def test_scan_checkpoints_are_the_states_every_interval():
    """``checkpoints`` keeps S after 0, C, 2C, ... steps (C =
    ``CHECKPOINT_EVERY``): each equals the final state of the scan cut
    there, and the last one starts the ragged last segment."""
    ins = [torch.from_numpy(a) for a in _scan_inputs((2, 2, 37, 16))]
    y, st, ckpt = rwkv6_scan(*ins, return_state=True, checkpoints=True)
    assert ckpt.shape == (2, 2, 3, 16, 16) and ckpt.dtype == torch.float32
    torch.testing.assert_close(y, rwkv6_scan_ref(*ins), atol=0, rtol=0)
    assert not ckpt[:, :, 0].any()
    for c in (1, 2):
        cut = [a[:, :, :c * CHECKPOINT_EVERY] if a.dim() == 4 else a
               for a in ins]
        _, want = rwkv6_scan_ref(*cut, return_state=True)
        torch.testing.assert_close(ckpt[:, :, c], want, atol=0, rtol=0)
    assert rwkv6_scan(*ins, checkpoints=True)[1] is None
    _, st_only = rwkv6_scan(*ins, return_state=True)
    torch.testing.assert_close(st, st_only, atol=0, rtol=0)


@pytest.mark.parametrize("shape,final_state,w_zeros", [
    ((2, 2, 24, 16), False, False), ((1, 3, 7, 32), False, False),
    ((2, 2, 1, 16), True, False), ((1, 2, 37, 16), True, True),
    ((1, 2, 20, 64), True, False), ((1, 2, 20, 64), False, True),
    ((1, 1, 20, 128), True, False), ((1, 1, 1, 256), True, False)])
def test_wkv_gradient_matches_jax_grad_of_the_oracle(shape, final_state,
                                                     w_zeros):
    """The loss sum(y cos y), plus sum(G_T * S_T) for a fixed random G_T
    with ``final_state``; T = 1 and T = 20, 37 (not multiples of the
    checkpoint interval 16) included."""
    ins = _scan_inputs(shape, seed=5, w_zeros=w_zeros)
    b, h, t, hd = shape
    gs = np.random.RandomState(9).standard_normal(
        (b, h, hd, hd)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, st = wkv(*leaves, return_state=True)
    loss = (y * torch.cos(y)).sum()
    if final_state:
        loss = loss + (st * torch.from_numpy(gs)).sum()
    loss.backward()

    def loss(*a):
        yj = ref_scan_oracle(*a)
        out = jnp.sum(yj * jnp.cos(yj))
        if final_state:
            out = out + jnp.sum(gs * _oracle_final_state(*a))
        return out

    want = jax.block_until_ready(jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*ins))
    for name, got, w in zip("rkvwu", leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("shape,final_state", [
    ((1, 1, 20, 128), True), ((1, 1, 20, 256), False),
    ((1, 1, 20, 256), True)])
def test_wkv_gradient_at_large_head_sizes_against_float64(shape,
                                                           final_state):
    """At hd 128 and 256, with the reference test's law and w holding exact
    zeros and 1e-30, the port's gradient and ``jax.grad`` of the oracle are
    each held against a float64 gradient (``_scan_f64``), and against each
    other, at the file's TOL, for the loss sum(G_y * y) (plus sum(G_T * S_T)
    with ``final_state``), G_y and G_T fixed and random: the
    vector-Jacobian product the backward kernel computes.

    The loss sum(y cos y) of the test above is not held here at T = 20: |y|
    reaches 15 at hd 256, and its cotangent cos y - y sin y carries the
    forward's f32 rounding of y into the gradient multiplied by up to
    |2 sin y + y cos y| (17 there), so two f32 gradients with different
    summation orders land apart by more than TOL although each forward is
    within TOL (``test_wkv_plain_matches_pallas_interpret_and_oracle``).
    That reading, the two f32 gradients' distance from float64 for that
    loss in units of the tolerance, is printed and not asserted."""
    ins = _scan_inputs(shape, seed=5, w_zeros=True)
    b, h, t, hd = shape
    rng = np.random.RandomState(11)
    gy = rng.standard_normal(shape).astype(np.float32)
    gs = rng.standard_normal((b, h, hd, hd)).astype(np.float32)

    def port_grad(cot):                      # cot(y, S_T) -> loss, torch
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
        cot(*wkv(*leaves, return_state=True)).backward()
        return [a.grad.double() for a in leaves]

    def oracle_grad(cot):                    # the same loss, in jax
        def loss(*a):
            st = _oracle_final_state(*a) if final_state else 0.0
            return cot(ref_scan_oracle(*a), st)
        got = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*ins)
        return [torch.from_numpy(np.array(g)).double() for g in got]

    def f64_grad(cot):
        leaves, y, st = _scan_f64(*ins)
        cot(y, st).backward()
        return [a.grad for a in leaves]

    def linear(y, st):
        out = (y * _like(y, gy)).sum()
        return out + (st * _like(st, gs)).sum() if final_state else out

    def y_cos_y(y, st):
        cos = torch.cos if isinstance(y, torch.Tensor) else jnp.cos
        out = (y * cos(y)).sum()
        return out + (st * _like(st, gs)).sum() if final_state else out

    def tol_units(got, want):        # max |got - want| / (TOL + TOL |want|)
        return max(float(((a - b).abs() / (TOL + TOL * b.abs())).max())
                   for a, b in zip(got, want))

    port, oracle, exact = (f(linear) for f in (port_grad, oracle_grad,
                                               f64_grad))
    for name, p, o, e in zip("rkvwu", port, oracle, exact):
        torch.testing.assert_close(p, e, atol=TOL, rtol=TOL,
                                   msg=lambda m: f"port {name}: {m}")
        torch.testing.assert_close(o, e, atol=TOL, rtol=TOL,
                                   msg=lambda m: f"reference {name}: {m}")
        torch.testing.assert_close(p, o, atol=TOL, rtol=TOL,
                                   msg=lambda m: f"{name}: {m}")
    exact_c = f64_grad(y_cos_y)
    print(f"[float64] {shape} G_T={final_state} torch threads "
          f"{torch.get_num_threads()}: sum(G_y y) port "
          f"{tol_units(port, exact):.3f}, reference "
          f"{tol_units(oracle, exact):.3f} TOL from float64; sum(y cos y) "
          f"port {tol_units(port_grad(y_cos_y), exact_c):.3f}, reference "
          f"{tol_units(oracle_grad(y_cos_y), exact_c):.3f}")


def _like(x, a):
    """The numpy array ``a`` as the array kind of ``x`` (torch or jax)."""
    if isinstance(x, torch.Tensor):
        return torch.from_numpy(a).to(x.dtype)
    return jnp.asarray(a)


def test_wkv_gradient_through_the_final_state_alone():
    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in _scan_inputs((1, 2, 9, 16), seed=6)]
    _, st = wkv(*ins, return_state=True)
    (st * st).sum().backward()
    plain = [a.detach().clone().requires_grad_(True) for a in ins]
    _, st_plain = rwkv6_scan_ref(*plain, return_state=True)
    (st_plain * st_plain).sum().backward()
    for got, want in zip(ins, plain):
        torch.testing.assert_close(got.grad, want.grad, atol=1e-6, rtol=1e-6)


def _configs(dtype, head_dim=None):
    ref = dataclasses.replace(ref_rwkv6_7b.reduced(), dtype=dtype,
                              head_dim=head_dim)
    port = dataclasses.replace(rwkv6_7b.reduced(), dtype=dtype,
                               head_dim=head_dim)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _reference_layer(ref_cfg, port_cfg, seed=0):
    """The reference's first RWKV layer (as numpy) and the port's, carried
    over through ``model_from_reference``. The LoRA's B (zero at init) and
    the norm scales and biases are moved off their init so that they
    count."""
    params = ref_model_init(ref_cfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a)
        key = jax.tree_util.keystr(path)
        if any(s in key for s in ("w_lora_b", "scale", "bias")):
            return (a.astype(np.float32)
                    + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)
    model = model_from_reference(params, port_cfg)
    ref_layer = jax.tree_util.tree_map(lambda a: a[0], params["groups"][0])
    return ref_layer, model.groups[0][0]


def _x(cfg, dtype, seed=3):
    x = np.random.RandomState(seed).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _close(got: torch.Tensor, want, dtype):
    """f32: 1e-4. bf16: within one bf16 rounding (2^-8 relative) of the
    output's largest magnitude, twice over for the operands' own rounding
    at another place in the two frameworks."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("head_dim", [None, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_and_final_state_match_reference(dtype, head_dim):
    ref_cfg, cfg = _configs(dtype, head_dim)
    ref_layer, layer = _reference_layer(ref_cfg, cfg)
    xj, xt = _x(cfg, ref_cfg.param_dtype)
    want, ref_state = jax.block_until_ready(ref_rwkv6_apply(
        ref_layer["mix"], xj, head_size=ref_cfg.hd))
    got, state = rwkv6_apply(layer.mix, xt, head_size=cfg.hd)
    assert got.dtype == xt.dtype and state["S"].dtype == torch.float32
    _close(got, want, dtype)
    np.testing.assert_allclose(state["S"].detach().numpy(),
                               np.asarray(ref_state["S"]),
                               atol=TOL, rtol=TOL)
    assert torch.equal(state["x_prev"], xt[:, -1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_reference(dtype):
    ref_cfg, cfg = _configs(dtype)
    ref_layer, layer = _reference_layer(ref_cfg, cfg, seed=1)
    xj, xt = _x(cfg, ref_cfg.param_dtype, seed=4)
    pj, pt = _x(cfg, ref_cfg.param_dtype, seed=5)
    want = jax.block_until_ready(
        ref_rwkv6_ffn_apply(ref_layer["ffn"], xj, pj[:, 0]))
    got = rwkv6_ffn_apply(layer.ffn, xt, pt[:, 0])
    assert got.dtype == xt.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("head_dim", [None, 64])
def test_time_mix_from_a_carried_state_matches_reference(head_dim):
    """From a nonzero state (S ~ N(0, 0.5^2), x_prev ~ N(0, 1)) in f32:
    y and S_T to 1e-4, then for the loss sum(G_y y) + sum(G_S S_T) with
    fixed random cotangents, the gradients of x, of S_0 and x_prev, and
    of every parameter of the time mix against ``jax.grad`` of the
    reference's ``rwkv6_apply`` from the same state, to 1e-4."""
    ref_cfg, cfg = _configs("float32", head_dim)
    ref_layer, layer = _reference_layer(ref_cfg, cfg, seed=2)
    xj, xt = _x(cfg, jnp.float32, seed=6)
    rng = np.random.RandomState(7)
    b, h, hd = xt.shape[0], cfg.d_model // cfg.hd, cfg.hd
    s0 = (0.5 * rng.standard_normal((b, h, hd, hd))).astype(np.float32)
    xp = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(tuple(xt.shape)).astype(np.float32)
    gs = rng.standard_normal(s0.shape).astype(np.float32)
    ref_mix = jax.tree_util.tree_map(jnp.asarray, ref_layer["mix"])

    def ref_loss(p, x, S, x_prev):
        y, st = ref_rwkv6_apply(p, x, {"S": S, "x_prev": x_prev},
                                head_size=ref_cfg.hd)
        return jnp.sum(y * gy) + jnp.sum(st["S"] * gs), (y, st["S"])

    (_, (want_y, want_s)), want_g = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2, 3), has_aux=True))(
            ref_mix, xj, jnp.asarray(s0), jnp.asarray(xp))
    x = xt.clone().requires_grad_(True)
    state = {"S": torch.from_numpy(s0).requires_grad_(True),
             "x_prev": torch.from_numpy(xp).requires_grad_(True)}
    y, st = rwkv6_apply(layer.mix, x, state, head_size=cfg.hd)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(st["S"].detach().numpy(), np.asarray(want_s),
                               atol=TOL, rtol=TOL)
    assert torch.equal(st["x_prev"], xt[:, -1])
    ((y * torch.from_numpy(gy)).sum()
     + (st["S"] * torch.from_numpy(gs)).sum()).backward()
    got = {"x": x.grad, "S_0": state["S"].grad,
           "x_prev": state["x_prev"].grad}
    want = {"x": want_g[1], "S_0": want_g[2], "x_prev": want_g[3]}
    for path, g in jax.tree_util.tree_flatten_with_path(want_g[0])[0]:
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        want[name] = g
        got[name] = layer.mix.get_parameter(name).grad
    assert len(got) == len(want) == 18      # 15 leaves of the mix, 3 inputs
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(g),
                                   atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 2, 1, 16), (1, 2, 17, 64),
                                   (1, 1, 1, 256), (1, 1, 16, 256)])
def test_wkv_from_a_carried_state_and_its_six_gradients(shape):
    """``wkv(state=S_0)``: y and S_T against the float64 loop from S_0,
    the plain scan's first checkpoint S_0 bit for bit, and the gradients of
    r, k, v, w, u and S_0 for sum(G_y y) + sum(G_T S_T) against the loop's,
    all at 1e-4; w holds exact zeros."""
    ins = _scan_inputs(shape, seed=8, w_zeros=True)
    b, h, t, hd = shape
    rng = np.random.RandomState(12)
    s0 = (0.5 * rng.standard_normal((b, h, hd, hd))).astype(np.float32)
    gy = rng.standard_normal(shape).astype(np.float32)
    gs = rng.standard_normal(s0.shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins + (s0,)]
    y, st = wkv(*leaves[:5], state=leaves[5], return_state=True)
    ((y * torch.from_numpy(gy)).sum()
     + (st * torch.from_numpy(gs)).sum()).backward()
    exact, y64, st64 = _scan_f64(*ins, s0=s0)
    ((y64 * torch.from_numpy(gy).double()).sum()
     + (st64 * torch.from_numpy(gs).double()).sum()).backward()
    torch.testing.assert_close(y.detach().double(), y64.detach(), atol=TOL,
                               rtol=TOL)
    torch.testing.assert_close(st.detach().double(), st64.detach(), atol=TOL,
                               rtol=TOL)
    for name, got, want in zip(("r", "k", "v", "w", "u", "S_0"), leaves,
                               exact):
        torch.testing.assert_close(got.grad.double(), want.grad, atol=TOL,
                                   rtol=TOL, msg=lambda m: f"{name}: {m}")
    _, _, ckpt = rwkv6_scan(*(torch.from_numpy(a) for a in ins),
                            state=torch.from_numpy(s0), checkpoints=True)
    assert torch.equal(ckpt[:, :, 0], torch.from_numpy(s0))


def test_empty_state_shapes():
    st = rwkv6_empty_state(3, 128, head_size=32, dtype=torch.bfloat16)
    assert st["S"].shape == (3, 4, 32, 32) and st["S"].dtype == torch.float32
    assert st["x_prev"].shape == (3, 128)
    assert st["x_prev"].dtype == torch.bfloat16


class _OnAnotherDevice(torch.Tensor):
    """A tensor that reports a device other than CUDA, the CPU and meta
    (no op runs on it)."""

    @staticmethod
    def __new__(cls, a):
        return torch.Tensor._make_wrapper_subclass(
            cls, a.shape, dtype=torch.float32, device="hpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on another device")


def test_scan_wrapper_refuses_other_devices():
    ins = [_OnAnotherDevice(a) for a in _scan_inputs((1, 1, 4, 16))]
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan(*ins)
    # a meta tensor takes the plain version, which carries shapes alone
    meta = [torch.from_numpy(a).to("meta")
            for a in _scan_inputs((1, 1, 4, 16))]
    y = rwkv6_scan(*meta)
    assert y.is_meta and tuple(y.shape) == (1, 1, 4, 16)
