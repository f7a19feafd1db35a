"""The port's int8 link boundary against the reference's Pallas kernel.

On the CPU the port's ``quant_dequant_int8`` runs its plain version, which
must be bit-equal to ``repro.kernels.quant.int8.quant_dequant_int8`` in
interpret mode, as ``quantize_int8`` / ``dequantize_int8`` (the wire
format's halves) must be to the reference's two Pallas kernels, ragged M
and NaN/inf rows included; the two-op path must be bit-equal to what the reference's
two-op path computes (``quant_dequant(use_pallas=False)``, jitted). The CUDA
kernel against the plain version is in ``test_torch_cuda.py`` (on a Hopper
card) and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet.link import FleetLink as RefFleetLink
from repro.core.link import LinkConfig as RefLinkConfig
from repro.kernels.quant.int8 import dequantize_int8 as ref_dequantize
from repro.kernels.quant.int8 import quant_dequant_int8 as ref_fused
from repro.kernels.quant.int8 import quantize_int8 as ref_quantize_kernel
from repro.kernels.quant.ops import quant_dequant as ref_quant_dequant
from repro.kernels.quant.ref import quantize_int8_ref as ref_quantize
from repro_torch.core.link import LinkConfig
from repro_torch.fleet.link import FleetLink, SmashedSpec
from repro_torch.kernels.dispatch import resolve_link_kernel
from repro_torch.kernels.quant.int8 import (dequantize_int8,
                                            quant_dequant_int8, quantize_int8)
from repro_torch.kernels.quant.ops import make_link_compress, quant_dequant
from repro_torch.kernels.quant.ref import quantize_int8_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(m, d, dtype, seed=0):
    """Rows of very different magnitudes, in ``dtype`` on both sides (the
    bf16 rounding happens once, in JAX, and is carried over exactly)."""
    rng = np.random.RandomState(seed + 7 * m + d)
    x = (rng.standard_normal((m, d))
         * rng.uniform(0.01, 10.0, size=(m, 1))).astype(np.float32)
    r = rng.standard_normal((m, d)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    xj, rj = jnp.asarray(x).astype(jdt), jnp.asarray(r).astype(jdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    rt = torch.from_numpy(np.array(rj.astype(jnp.float32))).to(tdt)
    return xj, rj, xt, rt


def _np(a):
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jax.Array) \
        else a.float().numpy()


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 32, 256])
@pytest.mark.parametrize("m", [1, 7, 509])
def test_plain_fused_is_bit_equal_to_pallas_interpret(m, d, dtype, residual):
    xj, rj, xt, rt = _inputs(m, d, dtype)
    want = ref_fused(xj, residual=rj if residual else None, interpret=True)
    got = quant_dequant_int8(xt, residual=rt if residual else None)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 32, 256])
@pytest.mark.parametrize("m", [1, 7, 509])
def test_two_op_path_is_bit_equal_to_reference(m, d, dtype):
    xj, _, xt, _ = _inputs(m, d, dtype)
    np.testing.assert_array_equal(
        _np(quant_dequant(xt, kernel="xla")), _np(ref_quant_dequant(xj)))
    q, s = quantize_int8_ref(xt)
    qj, sj = jax.jit(ref_quantize)(xj)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("residual", [False, True])
def test_nan_inf_and_zero_rows_match_pallas_interpret(residual):
    xj, rj, xt, rt = _inputs(6, 32, "float32", seed=1)
    x = np.array(xj)
    x[1, 5] = np.nan
    x[3, 0] = np.inf
    x[4, :] = 0.0
    x[5, 7] = -np.inf
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = _np(ref_fused(xj, residual=rj if residual else None,
                         interpret=True))
    got = _np(quant_dequant_int8(xt, residual=rt if residual else None))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all()               # NaN spreads over its row
    np.testing.assert_array_equal(got, want)    # NaN positions included
    if not residual:
        np.testing.assert_array_equal(got[4], np.zeros(32, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 32, 576])
@pytest.mark.parametrize("m", [1, 7, 300, 509])
def test_wire_pair_plain_is_bit_equal_to_pallas_interpret(m, d, dtype):
    """Codes, scales and the dequantized rows (f32 and bf16) of the plain
    versions against ``quantize_int8`` / ``dequantize_int8`` in interpret
    mode; M = 300 and 509 are ragged against the kernels' 256-row blocks."""
    xj, _, xt, _ = _inputs(m, d, dtype, seed=3)
    want_q, want_s = ref_quantize_kernel(xj, interpret=True)
    q, scales = quantize_int8(xt)
    assert q.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_s))
    for jdt, tdt in DTYPES.values():
        want = ref_dequantize(want_q, want_s, out_dtype=jdt, interpret=True)
        got = dequantize_int8(q, scales, out_dtype=tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(_np(got), _np(want))


def test_wire_pair_nan_inf_and_zero_rows_match_pallas_interpret():
    xj, _, _, _ = _inputs(6, 32, "float32", seed=2)
    x = np.array(xj)
    x[1, 5] = np.nan
    x[3, 0] = np.inf
    x[4, :] = 0.0
    want_q, want_s = ref_quantize_kernel(jnp.asarray(x), interpret=True)
    q, scales = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_s))
    assert (q[1] == 0).all() and np.isnan(scales[1, 0])
    want = ref_dequantize(want_q, want_s, interpret=True)
    np.testing.assert_array_equal(dequantize_int8(q, scales).numpy(),
                                  np.asarray(want))


def test_wire_pair_wrappers_take_only_cpu_or_cuda_tensors():
    for fn, args in ((quantize_int8, (torch.empty(4, 8, device="meta"),)),
                     (dequantize_int8, (torch.empty(4, 8, dtype=torch.int8,
                                                    device="meta"),
                                        torch.empty(4, 1, device="meta")))):
        with pytest.raises(ValueError, match="not on meta"):
            fn(*args)
    before = (quantize_int8.launches, dequantize_int8.launches)
    dequantize_int8(*quantize_int8(torch.ones(4, 8)))
    assert (quantize_int8.launches, dequantize_int8.launches) == before


def test_straight_through_backward_is_identity():
    x = torch.randn(2, 4, 4, 16, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    g = torch.randn(2, 4, 4, 16, generator=torch.Generator().manual_seed(1))
    for kernel in ("fused", "xla"):
        x.grad = None
        y = make_link_compress(kernel=kernel)(x)
        assert not torch.equal(y, x)
        y.backward(g)
        assert torch.equal(x.grad, g)


def test_wrapper_takes_only_cpu_or_cuda_tensors():
    with pytest.raises(ValueError, match="not on meta"):
        quant_dequant_int8(torch.empty(4, 8, device="meta"))
    # the plain version runs for a CPU tensor and nothing is launched
    before = quant_dequant_int8.launches
    quant_dequant_int8(torch.ones(4, 8))
    assert quant_dequant_int8.launches == before


def test_resolve_link_kernel():
    assert resolve_link_kernel("auto", "cpu") == "xla"
    assert resolve_link_kernel("fused", "cpu") == "fused"
    assert resolve_link_kernel("xla", "cpu") == "xla"
    with pytest.raises(ValueError):
        resolve_link_kernel("pallas", "cpu")
    if not torch.cuda.is_available():
        # a CUDA request on a box without CUDA raises: no silent fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_link_kernel("fused", "cuda")


@pytest.mark.parametrize("kernel", ["fused", "xla"])
def test_link_boundary_quantizes_channel_rows(kernel):
    """The port's NCHW smashed tensor is quantized over its channels, as
    the reference quantizes rows of its NHWC last axis."""
    rng = np.random.RandomState(5)
    sm = (rng.standard_normal((2, 4, 4, 16))
          * rng.uniform(0.1, 5.0, size=(2, 4, 4, 1))).astype(np.float32)
    ref_b = RefFleetLink(config=RefLinkConfig(compress="int8"),
                         use_pallas=kernel == "fused").boundary()
    want = np.asarray(ref_b(jnp.asarray(sm)))
    port_b = FleetLink(config=LinkConfig(compress="int8"),
                       kernel=kernel).boundary()
    nchw = torch.from_numpy(sm).permute(0, 3, 1, 2)
    got = port_b(nchw).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_link_constants_match_reference():
    sd = jax.ShapeDtypeStruct((16, 28, 28, 32), jnp.float32)
    spec = SmashedSpec(shape=(16, 28, 28, 32), itemsize=4)
    for compress in ("none", "int8"):
        ref = RefFleetLink(config=RefLinkConfig(compress=compress))
        port = FleetLink(config=LinkConfig(compress=compress))
        assert port.step_wire_bytes(spec) == ref.step_wire_bytes(sd)
        assert port.step_time_s(spec) == ref.step_time_s(sd)
        assert port.step_energy_j(spec) == ref.step_energy_j(sd)
    assert FleetLink().boundary() is None

