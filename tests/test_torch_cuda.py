"""Tests of the port that need a Hopper card (``cuda`` marker).

This file imports no jax and nothing of the JAX package, so it runs on the
machine with the card, where jax is not installed. There ``tests/conftest``
(which imports jax) must be left out:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Elsewhere the ``cuda`` tests skip; the others run everywhere. Whether a card
is present is decided inside the ``hopper`` fixture, never at import.
"""
import pytest
import torch

from repro_torch import api
from repro_torch.kernels.quant.int8 import (quant_dequant_int8,
                                            quant_dequant_int8_plain)


def hopper_available() -> bool:
    """True on a CUDA device of compute capability 9.0 (H100/H200)."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0))


@pytest.fixture
def hopper():
    if not hopper_available():
        pytest.skip("needs a CUDA device of capability (9, 0)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _same(a, b) -> bool:
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def test_hopper_available_needs_a_capability_9_device():
    if not torch.cuda.is_available():
        assert not hopper_available()
    else:
        assert hopper_available() == (
            torch.cuda.get_device_capability() == (9, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_bit_equal_to_plain(hopper, dtype, residual):
    g = torch.Generator(device=hopper).manual_seed(0)
    for m, d in [(1, 8), (7, 16), (509, 32), (12544, 32), (2048, 256)]:
        x = (torch.randn(m, d, device=hopper, generator=g) * 3).to(dtype)
        x[0, 0] = float("nan")
        r = (torch.randn(m, d, device=hopper, generator=g).to(dtype)
             if residual else None)
        before = quant_dequant_int8.launches
        got = quant_dequant_int8(x, residual=r)
        want = quant_dequant_int8_plain(x, residual=r)
        torch.cuda.synchronize()
        assert quant_dequant_int8.launches == before + 1
        assert got.dtype == dtype and _same(got, want)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(hopper):
    x = torch.randn(64, 32, device=hopper)
    before = quant_dequant_int8.launches
    for bad in (x.t(), x.reshape(8, 8, 32), x.half()):
        with pytest.raises(ValueError):
            quant_dequant_int8(bad)
    with pytest.raises(ValueError):
        quant_dequant_int8(x, residual=torch.randn(64, 16, device=hopper))
    assert quant_dequant_int8.launches == before


@pytest.mark.cuda
def test_main_path_launches_the_kernel_once_per_split_step(hopper):
    spec = api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(image_size=16, n_train=96, n_test=24),
        clients=api.ClientSpec(num_clients=3),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", link_kernel="fused"),
        global_rounds=2, local_steps=2, batch_size=4)
    plan = api.compile_experiment(spec)
    assert plan.device.type == "cuda"
    quant_dequant_int8.launches = 0
    _, recs = plan.run()
    assert quant_dequant_int8.launches == 2 * 2 * 3
    assert all(torch.isfinite(torch.tensor(r.loss)) for r in recs)
