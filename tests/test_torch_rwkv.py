"""RWKV-6 in the port against the reference: the WKV scan, its gradient,
the time mix and the channel mix.

- ``wkv`` (on the CPU: the kernel's plain version) against the reference's
  Pallas ``rwkv6_scan`` in interpret mode and its oracle ``rwkv6_scan_ref``,
  at the shapes of ``tests/test_kernels.py:273`` and a ragged T, atol/rtol
  1e-4 (the reference's own tolerance for its kernel);
- ``_WKV``'s gradient against ``jax.grad`` of ``rwkv6_scan_ref``, 1e-4;
- ``rwkv6_apply`` (output and the final state S_T the reference's
  ``lax.scan`` returns) and ``rwkv6_ffn_apply`` against the reference, with
  the reference's weights carried over by ``convert.model_from_reference``:
  f32 to 1e-4, bf16 to one bf16 rounding at the output's scale;
- what the slice refuses: a carried state, and a device other than CUDA
  or the CPU (the kernel's own refusals of a head size or dtype need the
  card: ``test_torch_cuda.py``).
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
from repro_torch.kernels.rwkv.scan import rwkv6_scan
from repro_torch.models.ssm import (rwkv6_apply, rwkv6_empty_state,
                                    rwkv6_ffn_apply)

# (B, H, T, hd): the reference test's shapes, then ragged and odd T
SCAN_SHAPES = [(1, 1, 32, 8), (2, 2, 64, 16), (1, 3, 128, 32),
               (2, 2, 37, 16), (1, 2, 1, 32)]
TOL = 1e-4


def _scan_inputs(shape, seed=0):
    """The reference test's law: r, k, v 0.5 N(0, 1); w sigmoid(N(0, 1));
    u 0.3 N(0, 1); made with numpy."""
    b, h, t, hd = shape
    rng = np.random.RandomState(seed + t)
    r, k, v = (0.5 * rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, hd))).astype(np.float32)
    return r, k, v, w, u


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


@pytest.mark.parametrize("shape", [(2, 2, 24, 16), (1, 3, 7, 32)])
def test_wkv_gradient_matches_jax_grad_of_the_oracle(shape):
    ins = _scan_inputs(shape, seed=5)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y = wkv(*leaves)
    (y * torch.cos(y)).sum().backward()

    def loss(*a):
        yj = ref_scan_oracle(*a)
        return jnp.sum(yj * jnp.cos(yj))

    want = jax.block_until_ready(jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*ins))
    for name, got, w in zip("rkvwu", leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=name)


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


def test_time_mix_refuses_a_carried_state():
    _, cfg = _configs("float32", 64)
    layer = model_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_model_init(
            _configs("float32", 64)[0], jax.random.PRNGKey(0))),
        cfg).groups[0][0]
    x = torch.zeros(1, 4, cfg.d_model)
    state = rwkv6_empty_state(1, cfg.d_model, head_size=cfg.hd)
    with pytest.raises(NotImplementedError, match="item 17"):
        rwkv6_apply(layer.mix, x, state, head_size=cfg.hd)


def test_empty_state_shapes():
    st = rwkv6_empty_state(3, 128, head_size=32, dtype=torch.bfloat16)
    assert st["S"].shape == (3, 4, 32, 32) and st["S"].dtype == torch.float32
    assert st["x_prev"].shape == (3, 128)
    assert st["x_prev"].dtype == torch.bfloat16


def test_scan_wrapper_refuses_other_devices():
    ins = [torch.from_numpy(a).to("meta") for a in _scan_inputs((1, 1, 4, 16))]
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan(*ins)
