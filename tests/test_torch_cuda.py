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
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.attn.flash import (flash_attention,
                                            flash_attention_fwd,
                                            flash_attention_plain)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_flash_kernel_matches_plain(hopper, dtype, atol):
    g = torch.Generator(device=hopper).manual_seed(0)
    for (s, sk, d, causal, window) in [(1, 1, 32, True, None),
                                       (7, 7, 64, True, None),
                                       (100, 100, 128, False, 16),
                                       (131, 257, 64, True, 100),
                                       (257, 257, 32, False, None)]:
        q, k, v = (torch.randn(2, 3, n, d, device=hopper, generator=g
                               ).to(dtype) for n in (s, sk, sk))
        before = flash_attention.launches
        got = flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=0)


@pytest.mark.cuda
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(hopper):
    q = torch.randn(1, 2, 16, 64, device=hopper)
    before = flash_attention.launches
    for bad in ((q.transpose(2, 3), q, q), (q.half(), q.half(), q.half()),
                (q[..., :40].contiguous(),) * 3,
                (q, q[:, :1].contiguous(), q[:, :1].contiguous())):
        with pytest.raises(ValueError):
            flash_attention_fwd(*bad)
    assert flash_attention.launches == before


@pytest.mark.cuda
def test_lm_main_path_launches_the_flash_kernel(hopper):
    arch = ArchConfig(name="tinylm", family="dense", n_layers=3, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      dtype="bfloat16")
    spec = api.ExperimentSpec(
        model=api.ModelSpec(family="transformer", arch=arch,
                            attn_impl="pallas"),
        data=api.DataSpec(kind="tokens", partition="iid", seq_len=64,
                          n_train=32, n_test=8),
        clients=api.ClientSpec(num_clients=2),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", link_kernel="fused"),
        global_rounds=2, local_steps=2, batch_size=4)
    plan = api.compile_experiment(spec)
    flash_attention.launches = 0
    quant_dequant_int8.launches = 0
    _, recs = plan.run()
    steps = 2 * 2 * 2                     # rounds x local steps x clients
    evals = 2 * 1                         # one chunk of 8 sequences a round
    assert flash_attention.launches == 3 * (steps + evals)
    assert quant_dequant_int8.launches == steps
    assert all(torch.isfinite(torch.tensor(r.loss)) for r in recs)
