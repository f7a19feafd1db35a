"""Tests of the port that need a Hopper card (``cuda`` marker).

This file imports no jax and nothing of the JAX package, so it runs on the
machine with the card, where jax is not installed. There ``tests/conftest``
(which imports jax) must be left out:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Elsewhere the ``cuda`` tests skip; the others run everywhere. Whether a card
is present is decided inside the ``hopper`` fixture, never at import.
"""
import copy

import pytest
import torch

from repro_torch import api
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.attn.flash import (flash_attention,
                                            flash_attention_fwd,
                                            flash_attention_plain)
from repro_torch.kernels.quant.int8 import (dequantize_int8,
                                            quant_dequant_int8,
                                            quant_dequant_int8_plain,
                                            quant_int8_device_plan,
                                            quant_int8_launch_plan,
                                            quantize_int8)
from repro_torch.kernels.quant.ref import (dequantize_int8_ref,
                                           quantize_int8_ref)
from repro_torch.kernels.rwkv.ops import wkv
from repro_torch.kernels.rwkv.ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref
from repro_torch.kernels.rwkv.scan import (CHECKPOINT_EVERY, _bwd_library,
                                           rwkv6_scan, rwkv6_scan_bwd,
                                           rwkv6_scan_bwd_launch_config,
                                           rwkv6_scan_launch_config)

SUB_SEGMENT = 4   # csrc/rwkv6_scan_bwd.cu's SUB: states held in registers


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
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_flash_kernel_head_dim_128_ragged_keys(hopper, dtype, atol):
    """D = 128 (one m16 tile a warp, 8 warps) with S = 131 queries over
    Sk = 1024 keys: ragged on both axes."""
    g = torch.Generator(device=hopper).manual_seed(3)
    for causal, window in ((True, None), (False, None), (True, 100)):
        q, k, v = (torch.randn(2, 3, n, 128, device=hopper, generator=g
                               ).to(dtype) for n in (131, 1024, 1024))
        got = flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_flash_kernel_fully_masked_rows_are_finite(hopper, dtype, atol):
    """S 1024 over Sk 100 keys, window 16, causal: rows from 115 on see no
    key. Every output is finite; the rows that see a key equal the plain
    version (the others differ by design: ROADMAP queue 3)."""
    g = torch.Generator(device=hopper).manual_seed(4)
    q, k, v = (torch.randn(2, 3, n, 64, device=hopper, generator=g
                           ).to(dtype) for n in (1024, 100, 100))
    got = flash_attention_fwd(q, k, v, causal=True, window=16)
    want = flash_attention_plain(q, k, v, causal=True, window=16)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got[:, :, :115].float(),
                               want[:, :, :115].float(), atol=atol, rtol=0)
    # what the kernel gives a row that sees no key (csrc/flash_attn.cu's
    # note): the mean over the 64-key tiles its 128-row block does not skip,
    # keys past Sk counted as zeros, or 0 when the block skips every tile.
    # Block 0 loads tiles 0-1 (keys 0-127), block 1 tile 1 (keys 64-127),
    # blocks 2.. none.
    vf = v.float()
    for rows, keys, slots in ((slice(115, 128), slice(0, 100), 128),
                              (slice(128, 256), slice(64, 100), 64)):
        mean = vf[:, :, keys].sum(dim=2, keepdim=True) / slots
        torch.testing.assert_close(got[:, :, rows].float(),
                                   mean.expand_as(got[:, :, rows]),
                                   atol=atol, rtol=0)
    assert not got[:, :, 256:].float().any()


@pytest.mark.cuda
def test_flash_one_call_is_one_launch(hopper):
    """A differentiable call launches the forward kernel once; its backward
    (the closed form in plain PyTorch) launches nothing."""
    q, k, v = (torch.randn(1, 2, 300, 64, device=hopper, requires_grad=True)
               for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    out.sum().backward()
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


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
def test_flash_wrapper_rejects_inputs_not_16_byte_aligned(hopper):
    """The kernel copies rows in 16-byte pieces: a contiguous view that
    starts 4 bytes into its storage is refused before any launch."""
    buf = torch.randn(1 * 2 * 16 * 64 + 1, device=hopper)
    q = buf[1:].view(1, 2, 16, 64)
    ok = torch.randn(1, 2, 16, 64, device=hopper)
    before = flash_attention.launches
    for bad in ((q, ok, ok), (ok, q, ok), (ok, ok, q)):
        with pytest.raises(ValueError, match="aligned"):
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wire_pair_is_bit_equal_to_plain(hopper, dtype):
    g = torch.Generator(device=hopper).manual_seed(0)
    for m, d in [(1, 8), (7, 16), (509, 32), (12544, 32), (8192, 576)]:
        x = (torch.randn(m, d, device=hopper, generator=g) * 3).to(dtype)
        x[0, 0] = float("nan")
        before = (quantize_int8.launches, dequantize_int8.launches)
        codes, scales = quantize_int8(x)
        want_c, want_s = quantize_int8_ref(x)
        for out_dtype in (torch.float32, torch.bfloat16):
            got = dequantize_int8(codes, scales, out_dtype=out_dtype)
            want = dequantize_int8_ref(codes, scales, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert got.dtype == out_dtype and _same(got, want)
        assert torch.equal(codes, want_c) and _same(scales, want_s)
        assert (quantize_int8.launches, dequantize_int8.launches) == \
            (before[0] + 1, before[1] + 2)


def _int8_rows(m, d, dtype, dev, g, misaligned=False):
    """(m, d) rows with a NaN, an inf and a zero row; ``misaligned``: a
    contiguous view one element past an allocation."""
    flat = torch.empty(m * d + 1, dtype=dtype, device=dev)
    x = flat[int(misaligned):][:m * d].view(m, d)
    x.copy_(torch.randn(m, d, device=dev, generator=g)
            * torch.rand(m, 1, device=dev, generator=g) * 5)
    x[1, 0], x[2, d - 1], x[3] = float("nan"), float("inf"), 0.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_int8_kernels_bit_equal_on_both_paths(hopper, in_dtype):
    """Widths on the generic path (3, 1028, 33) and the vector path (36,
    576, 1000; 2048 is each, by dtype), a misaligned view, every out dtype,
    with and without a residual: the fused kernel and quantize_int8 give
    their plain versions' bits."""
    g = torch.Generator(device=hopper).manual_seed(0)
    cases = [(509, d, False) for d in (3, 33, 36, 576, 1000, 1028, 2048)]
    cases += [(509, 32, True), (7, 576, True)]
    paths = set()
    for m, d, misaligned in cases:
        x = _int8_rows(m, d, in_dtype, hopper, g, misaligned)
        r = _int8_rows(m, d, in_dtype, hopper, g, misaligned)
        aligned = x.data_ptr() % 16 == 0
        assert aligned != misaligned
        paths.add(quant_int8_launch_plan(m, d, in_dtype,
                                         aligned=aligned)["path"])
        for out_dtype in (torch.float32, torch.bfloat16):
            for res in (None, r):
                got = quant_dequant_int8(x, residual=res, out_dtype=out_dtype)
                want = quant_dequant_int8_plain(x, residual=res,
                                                out_dtype=out_dtype)
                torch.cuda.synchronize()
                assert got.dtype == out_dtype and _same(got, want), \
                    (m, d, misaligned, out_dtype, res is not None)
        codes, scales = quantize_int8(x)
        want_c, want_s = quantize_int8_ref(x)
        torch.cuda.synchronize()
        assert torch.equal(codes, want_c) and _same(scales, want_s)
    assert paths == {"generic", "vector"}


@pytest.mark.cuda
def test_int8_launch_plan_mirror_matches_library(hopper):
    for d in (1, 3, 4, 8, 32, 36, 576, 1000, 1024, 1028, 2048):
        for in_dtype in (torch.float32, torch.bfloat16):
            for aligned in (True, False):
                for kernel, res in (("quant_dequant_int8", False),
                                    ("quant_dequant_int8", True),
                                    ("quantize_int8", False)):
                    want = quant_int8_launch_plan(509, d, in_dtype,
                                                  aligned=aligned,
                                                  kernel=kernel)
                    got = quant_int8_device_plan(509, d, in_dtype,
                                                 aligned=aligned,
                                                 kernel=kernel, residual=res)
                    assert {k: got[k] for k in want} == want
                    assert got["blocks_per_sm"] >= 1
    plan = quant_int8_device_plan(12544, 32, torch.float32)
    sms = torch.cuda.get_device_properties(hopper).multi_processor_count
    assert plan["blocks"] <= plan["blocks_per_sm"] * sms     # one wave


def _wkv_inputs(shape, dev, g):
    b, h, t, hd = shape
    r, k, v = (0.5 * torch.randn(shape, device=dev, generator=g)
               for _ in range(3))
    w = torch.sigmoid(torch.randn(shape, device=dev, generator=g))
    return r, k, v, w, 0.3 * torch.randn(h, hd, device=dev, generator=g)


@pytest.mark.cuda
def test_wkv_kernel_matches_plain(hopper):
    g = torch.Generator(device=hopper).manual_seed(0)
    for shape in [(1, 1, 1, 16), (2, 3, 7, 32), (2, 2, 100, 48),
                  (1, 4, 1024, 64), (2, 2, 37, 80), (2, 3, 100, 128),
                  (2, 1, 64, 256), (1, 2, 33, 256)]:
        ins = _wkv_inputs(shape, hopper, g)
        before = rwkv6_scan.launches
        y, st = rwkv6_scan(*ins, return_state=True)
        want_y, want_s = rwkv6_scan_ref(*ins, return_state=True)
        torch.cuda.synchronize()
        assert rwkv6_scan.launches == before + 1
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(st, want_s, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 48, 64, 128, 256])
def test_wkv_kernel_checkpoints_match_plain(hopper, hd):
    """The call that writes the backward's checkpoints: y, S_T and every
    checkpoint within 1e-4 of the plain loop's, at T = 1, 15, 16, 17, 33
    and 37 (one step, both edges of a 16-step segment, a T that the
    interval does not divide), with w holding exact zeros and 1e-30."""
    g = torch.Generator(device=hopper).manual_seed(6)
    for t in (1, CHECKPOINT_EVERY - 1, CHECKPOINT_EVERY, CHECKPOINT_EVERY + 1,
              2 * CHECKPOINT_EVERY + 1, 2 * CHECKPOINT_EVERY + 5):
        r, k, v, w, u = _wkv_inputs((2, 3, t, hd), hopper, g)
        w[..., ::5] = 0.0
        w[..., 1::7] = 1e-30
        got = rwkv6_scan(r, k, v, w, u, return_state=True, checkpoints=True)
        want = rwkv6_scan_ref(r, k, v, w, u, return_state=True,
                              checkpoints=True)
        torch.cuda.synchronize()
        assert got[2].shape == (2, 3, -(-t // CHECKPOINT_EVERY), hd, hd)
        for name, a, b_ in zip(("y", "S_T", "checkpoints"), got, want):
            torch.testing.assert_close(
                a, b_, atol=1e-4, rtol=1e-4,
                msg=lambda m: f"{name} at T {t}: {m}")


@pytest.mark.cuda
def test_wkv_kernel_repeat_calls_are_bit_equal(hopper):
    """No atomics: two calls on the same inputs give the same bits, with
    and without the checkpoints, on both paths (hd 64 and 128)."""
    g = torch.Generator(device=hopper).manual_seed(7)
    for shape in [(2, 8, 300, 64), (1, 2, 100, 128)]:
        ins = _wkv_inputs(shape, hopper, g)
        for ckpt in (False, True):
            first = rwkv6_scan(*ins, return_state=True, checkpoints=ckpt)
            second = rwkv6_scan(*ins, return_state=True, checkpoints=ckpt)
            torch.cuda.synchronize()
            for a, b_ in zip(first, second):
                if a is not None:
                    assert torch.equal(a, b_), f"{shape} differs"


@pytest.mark.cuda
def test_wkv_forward_launch_config_is_one_wave_at_hd_64(hopper):
    """At the rwkv6-7b shape every (b, h) of the forward is resident at
    once: one block per (b, h), enough of them a SM for one wave."""
    cfg = rwkv6_scan_launch_config(4, 64, 64)
    sms = torch.cuda.get_device_properties(hopper).multi_processor_count
    assert cfg["blocks"] == 256 and cfg["threads"] % 32 == 0
    assert cfg["blocks_per_sm"] * sms >= cfg["blocks"]


@pytest.mark.cuda
def test_wkv_gradient_matches_autograd_of_plain(hopper):
    g = torch.Generator(device=hopper).manual_seed(1)
    ins = _wkv_inputs((2, 3, 64, 64), hopper, g)
    grads = []
    for fn in (wkv, rwkv6_scan_ref):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        y, st = fn(*leaves, return_state=True)
        ((y * torch.cos(y)).sum() + (st * st).sum()).backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 48, 64, 80, 96, 112, 128, 256])
def test_wkv_backward_kernel_matches_plain_and_autograd(hopper, hd):
    """The backward kernel against its plain closed form on the same
    checkpoints and against autograd of the plain loop, all five
    gradients, with and without a cotangent of S_T, at T = 1, 4, 5, 16,
    17 and 37 (one step, the edges of the 4-step sub-segments and of the
    16-step segments, and a T that the checkpoint interval does not
    divide), and w with exact zeros and values near 1e-30; one launch per
    call. At hd <= 64 (no atomics) a second call gives the same bits."""
    g = torch.Generator(device=hopper).manual_seed(4)
    for t in (1, SUB_SEGMENT, SUB_SEGMENT + 1, CHECKPOINT_EVERY,
              CHECKPOINT_EVERY + 1, 2 * CHECKPOINT_EVERY + 5):
        r, k, v, w, u = _wkv_inputs((2, 3, t, hd), hopper, g)
        w[..., ::5] = 0.0
        w[..., 1::7] = 1e-30
        gy = torch.randn(r.shape, device=hopper, generator=g)
        for gs in (None,
                   torch.randn((2, 3, hd, hd), device=hopper, generator=g)):
            _, _, ckpt = rwkv6_scan(r, k, v, w, u, checkpoints=True)
            before = rwkv6_scan_bwd.launches
            got = rwkv6_scan_bwd(r, k, v, w, u, gy, gs, ckpt)
            torch.cuda.synchronize()
            assert rwkv6_scan_bwd.launches == before + 1
            if hd <= 64:
                again = rwkv6_scan_bwd(r, k, v, w, u, gy, gs, ckpt)
                torch.cuda.synchronize()
                for name, a, b_ in zip("rkvwu", got, again):
                    assert torch.equal(a, b_), f"d{name} at T {t} differs"
            plain = rwkv6_scan_bwd_ref(r, k, v, w, u, gy, gs, ckpt)
            leaves = [a.clone().requires_grad_(True) for a in (r, k, v, w, u)]
            y, st = rwkv6_scan_ref(*leaves, return_state=True)
            torch.autograd.backward([y, st] if gs is not None else [y],
                                    [gy, gs] if gs is not None else [gy])
            for name, a, b_, leaf in zip("rkvwu", got, plain, leaves):
                # T = 1 without G_T: w reaches only S_T, so autograd
                # leaves its gradient None, i.e. 0
                want = (leaf.grad if leaf.grad is not None
                        else torch.zeros_like(leaf))
                torch.testing.assert_close(
                    a, b_, atol=1e-4, rtol=1e-4,
                    msg=lambda m: f"{name} at T {t}: {m}")
                torch.testing.assert_close(
                    a, want, atol=1e-4, rtol=1e-4,
                    msg=lambda m: f"{name} at T {t}: {m}")


@pytest.mark.cuda
def test_wkv_backward_launch_config_is_one_wave_at_hd_64(hopper):
    """At the rwkv6-7b shape every (b, h) of the backward is resident at
    once: 256 blocks of 256 threads, 2 a SM, and no scratch."""
    cfg = rwkv6_scan_bwd_launch_config(4, 64, 64)
    sms = torch.cuda.get_device_properties(hopper).multi_processor_count
    assert cfg["blocks"] == 256 and cfg["threads"] == 256
    assert cfg["blocks_per_sm"] * sms >= cfg["blocks"]
    assert _bwd_library().rwkv6_scan_bwd_scratch_floats(4, 64, 64) == 0


@pytest.mark.cuda
def test_wkv_wrapper_rejects_what_the_kernel_does_not_take(hopper):
    ins = _wkv_inputs((1, 2, 8, 64), hopper,
                      torch.Generator(device=hopper).manual_seed(2))
    before = rwkv6_scan.launches, rwkv6_scan_bwd.launches
    bad_cases = [
        [a.to(torch.bfloat16) for a in ins],                  # dtype
        [a[..., :40].contiguous() if a.dim() == 4 else a[:, :40].contiguous()
         for a in ins],                                       # hd 40
        [torch.cat([a.repeat(1, 1, 1, 4), a[..., :16]], -1).contiguous()
         if a.dim() == 4 else
         torch.cat([a.repeat(1, 4), a[:, :16]], -1).contiguous()
         for a in ins],                                       # hd 272
        [a.transpose(2, 3) if a.dim() == 4 else a for a in ins],
        [a.transpose(-1, -2).contiguous().transpose(-1, -2)
         for a in ins],                       # layout: same shape, strided
    ]
    for bad in bad_cases:
        with pytest.raises(ValueError):
            rwkv6_scan(*bad)
        # checkpoints of the right shape, so only the bad input can refuse
        b, h, t, hd = bad[0].shape
        ckpt = torch.zeros((b, h, -(-t // CHECKPOINT_EVERY), hd, hd),
                           device=hopper)
        with pytest.raises(ValueError):
            rwkv6_scan_bwd(*bad, bad[0], None, ckpt)
    # checkpoints the kernel copies 16 bytes at a time: 4 bytes off
    _, _, ckpt = rwkv6_scan(*ins, checkpoints=True)
    off = torch.zeros(ckpt.numel() + 1, device=hopper)[1:].view(ckpt.shape)
    off.copy_(ckpt)
    assert off.is_contiguous() and off.data_ptr() % 16
    before = rwkv6_scan.launches, rwkv6_scan_bwd.launches
    with pytest.raises(ValueError):
        rwkv6_scan_bwd(*ins, ins[0], None, off)
    assert (rwkv6_scan.launches, rwkv6_scan_bwd.launches) == before


@pytest.mark.cuda
def test_rwkv_train_step_launches_the_wkv_kernel_per_layer(hopper):
    from repro_torch.configs import rwkv6_7b
    from repro_torch.launch.train import train
    cfg = rwkv6_7b.reduced()
    assert cfg.hd == 256
    rwkv6_scan.launches = rwkv6_scan_bwd.launches = 0
    losses = train(cfg, steps=2, batch=2, seq=32, log_every=1,
                   device=hopper,
                   generator=torch.Generator(device=hopper).manual_seed(0))
    assert rwkv6_scan.launches == cfg.n_layers * 2
    assert rwkv6_scan_bwd.launches == cfg.n_layers * 2
    assert all(torch.isfinite(torch.tensor(losses)))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 48, 64, 128, 256])
def test_wkv_kernel_from_a_carried_state_matches_plain(hopper, hd):
    """The forward from S_0 != 0 at T = 1 (a decode step), 3, 16 and 17:
    y, S_T and the checkpoints within 1e-4 of the plain loop from the same
    S_0, the first checkpoint S_0 bit for bit, one launch a call."""
    g = torch.Generator(device=hopper).manual_seed(8)
    for t in (1, 3, CHECKPOINT_EVERY, CHECKPOINT_EVERY + 1):
        r, k, v, w, u = _wkv_inputs((2, 3, t, hd), hopper, g)
        s0 = 0.5 * torch.randn((2, 3, hd, hd), device=hopper, generator=g)
        before = rwkv6_scan.launches
        got = rwkv6_scan(r, k, v, w, u, state=s0, return_state=True,
                         checkpoints=True)
        want = rwkv6_scan_ref(r, k, v, w, u, state=s0, return_state=True,
                              checkpoints=True)
        torch.cuda.synchronize()
        assert rwkv6_scan.launches == before + 1
        assert torch.equal(got[2][:, :, 0], s0)
        for name, a, b_ in zip(("y", "S_T", "checkpoints"), got, want):
            torch.testing.assert_close(
                a, b_, atol=1e-4, rtol=1e-4,
                msg=lambda m: f"{name} at T {t}: {m}")
    # a state the kernel does not take is refused before any launch
    off = torch.zeros(s0.numel() + 1, device=hopper)[1:].view(s0.shape)
    before = rwkv6_scan.launches
    for bad in (s0.to(torch.bfloat16), s0[:1], s0.transpose(2, 3), off):
        with pytest.raises(ValueError, match="state"):
            rwkv6_scan(r, k, v, w, u, state=bad)
    assert rwkv6_scan.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
def test_wkv_backward_kernel_gives_the_state_cotangent(hopper, hd):
    """The backward kernel with ``want_gs0``: the six gradients (dS_0
    included) against its plain closed form and against autograd of the
    plain loop from S_0, at T = 1, 5 and 17, with and without G_T;
    without ``want_gs0`` the five others are the same bits."""
    g = torch.Generator(device=hopper).manual_seed(9)
    for t in (1, SUB_SEGMENT + 1, CHECKPOINT_EVERY + 1):
        r, k, v, w, u = _wkv_inputs((2, 3, t, hd), hopper, g)
        s0 = 0.5 * torch.randn((2, 3, hd, hd), device=hopper, generator=g)
        gy = torch.randn(r.shape, device=hopper, generator=g)
        for gs in (None,
                   torch.randn((2, 3, hd, hd), device=hopper, generator=g)):
            _, _, ckpt = rwkv6_scan(r, k, v, w, u, state=s0,
                                    checkpoints=True)
            got = rwkv6_scan_bwd(r, k, v, w, u, gy, gs, ckpt, want_gs0=True)
            five = rwkv6_scan_bwd(r, k, v, w, u, gy, gs, ckpt)
            plain = rwkv6_scan_bwd_ref(r, k, v, w, u, gy, gs, ckpt,
                                       want_gs0=True)
            leaves = [a.clone().requires_grad_(True)
                      for a in (r, k, v, w, u, s0)]
            y, st = rwkv6_scan_ref(*leaves[:5], state=leaves[5],
                                   return_state=True)
            torch.autograd.backward([y, st] if gs is not None else [y],
                                    [gy, gs] if gs is not None else [gy])
            torch.cuda.synchronize()
            assert len(got) == 6 and len(five) == 5
            if hd <= 64:                 # no atomics: the same bits
                for a, b_ in zip(got, five):
                    assert torch.equal(a, b_)
            for name, a, b_, leaf in zip(("r", "k", "v", "w", "u", "S_0"),
                                         got, plain, leaves):
                want = (leaf.grad if leaf.grad is not None
                        else torch.zeros_like(leaf))
                for other in (b_, want):
                    torch.testing.assert_close(
                        a, other, atol=1e-4, rtol=1e-4,
                        msg=lambda m: f"d{name} at T {t}: {m}")


@pytest.mark.cuda
def test_serve_on_card_matches_cpu(hopper):
    """Reduced rwkv6-7b (head size 256: the column-split kernels) and
    SmolLM served on the card and on the CPU from the same weights and
    prompts: every step's logits within 1e-4, the tokens equal, and one
    WKV launch a layer a step on the card."""
    from repro_torch.configs import rwkv6_7b, smollm_135m
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import default_cut_layer, model_init
    for cfg in (rwkv6_7b.reduced(), smollm_135m.reduced()):
        cut = default_cut_layer(cfg, 0.15)
        model = model_init(cfg, torch.Generator().manual_seed(0),
                           cut_layer=cut)
        prompts = torch.randint(0, cfg.vocab, (2, 6),
                                generator=torch.Generator().manual_seed(1))
        want, want_logits = generate(cfg, model, prompts, 5, cut_layer=cut,
                                     keep_logits=True)
        rwkv6_scan.launches = 0
        got, logits = generate(cfg, model.to(hopper), prompts.to(hopper), 5,
                               cut_layer=cut, keep_logits=True)
        torch.cuda.synchronize()
        if cfg.ssm_kind == "rwkv6":
            assert rwkv6_scan.launches == cfg.n_layers * 11
        torch.testing.assert_close(logits.cpu(), want_logits, atol=1e-4,
                                   rtol=1e-4)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-moe-16b", "arctic-480b",
                                  "jamba-1.5-large-398b"])
def test_moe_and_mamba_on_card_match_cpu(hopper, name):
    """The MoE FFN (at the config's capacity and at 0.5, where picks drop)
    and the Mamba mixer of the reduced config on the card against the same
    weights and inputs on the CPU, outputs, aux and the gradients of every
    leaf and of x within 1e-4, or 2e-5 of the tensor's largest magnitude
    where that is larger (f32, TF32 off: the gradients of sum(y^2) reach
    a few hundred, and the CPU's own f32 result is up to 2.8e-6 of a
    tensor's largest magnitude from a float64 one; the MoE scatter
    accumulates with atomics on the card, so its f32 sums run in another
    order)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.ssm import mamba_apply
    from repro_torch.models.transformer import model_init
    cfg = ARCHS[name].reduced()
    model = model_init(cfg, torch.Generator().manual_seed(0))
    moe = next(m for m in model.modules() if type(m).__name__ == "MoE")
    mixers = [m for m in model.modules() if type(m).__name__ == "Mamba"]
    x = torch.randn(2, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    runs = [(moe, lambda m, xx, cf=cf: moe_apply(
        m, xx, top_k=cfg.top_k, capacity_factor=cf))
        for cf in (cfg.capacity_factor, 0.5)]
    if mixers:
        runs.append((mixers[0], lambda m, xx: (mamba_apply(
            m, xx, expand=cfg.ssm_expand, state_dim=cfg.ssm_state_dim,
            conv_width=cfg.ssm_conv_width)[0], torch.zeros(()))))
    for module, fn in runs:
        results = []
        for dev in ("cpu", hopper):
            m = copy.deepcopy(module).to(dev)
            xx = x.detach().to(dev).requires_grad_(True)
            y, aux = fn(m, xx)
            (y.square().sum() + aux).backward()
            results.append([y.detach(), aux.detach(), xx.grad] + [
                p.grad for _, p in sorted(m.named_parameters())])
        for got, want in zip(results[1], results[0]):
            scale = float(want.abs().max())
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                       atol=max(1e-4, 2e-5 * scale))


# ---------------------------------------------------------------------------
# the fleet engines' vmap rules and an sl/vmap plan on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_int8_vmap_rule_on_card_is_one_launch(hopper):
    """The int8 boundary vmapped over 4 clients (the MobileNetV2 cut's NHWC
    rows, NaN rows included) is bit-equal to the plain version client by
    client, in ONE kernel launch."""
    from torch.func import vmap
    from repro_torch.kernels.quant.ops import make_link_compress
    g = torch.Generator(device=hopper).manual_seed(0)
    x = torch.randn(4, 16, 28, 28, 32, device=hopper, generator=g) * 3
    x[1, 0, 2, 3, 5] = float("nan")
    x[3, 2, 0, 0, :] = 0.0
    compress = make_link_compress(kernel="fused")
    before = quant_dequant_int8.launches
    got = vmap(compress)(x)
    torch.cuda.synchronize()
    assert quant_dequant_int8.launches == before + 1
    want = torch.stack([quant_dequant_int8_plain(x[c].reshape(-1, 32))
                        .reshape(x.shape[1:]) for c in range(4)])
    assert _same(got, want)


@pytest.mark.cuda
def test_flash_vmap_rule_on_card_is_one_launch(hopper):
    """flash attention vmapped over 4 clients: one launch at (4 B, H, S, D),
    within 2e-5 of the plain version client by client."""
    from torch.func import vmap
    g = torch.Generator(device=hopper).manual_seed(1)
    q, k, v = (torch.randn(4, 2, 3, 257, 64, device=hopper, generator=g)
               for _ in range(3))
    before = flash_attention.launches
    got = vmap(lambda a, b, c: flash_attention(a, b, c, causal=True))(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = torch.stack([flash_attention_plain(q[c], k[c], v[c], causal=True)
                        for c in range(4)])
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_sl_vmap_plan_with_dropout_on_card_matches_cpu(hopper):
    """tinycnn ``sl/vmap`` with dropout, int8 on the fused kernel: the card
    run against the same plan on the CPU (its plain version), losses within
    ``FLEET_EQUIV_ATOL``, active clients and wire bytes exactly; one int8
    launch per local step for all clients."""
    from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
    spec = api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(image_size=16, n_train=96, n_test=24),
        clients=api.ClientSpec(num_clients=3, dropout_rate=0.34),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", client_axis="vmap",
                              link_kernel="fused"),
        global_rounds=3, local_steps=2, batch_size=4)
    gpu = api.compile_experiment(spec)
    quant_dequant_int8.launches = 0
    _, rec_gpu = gpu.run()
    assert quant_dequant_int8.launches == 3 * 2
    _, rec_cpu = api.compile_experiment(spec, device="cpu").run()
    for a, b in zip(rec_gpu, rec_cpu):
        assert a.engine == b.engine == "sl/vmap"
        assert a.active_clients == b.active_clients
        assert a.link_bytes == b.link_bytes
        assert abs(a.loss - b.loss) <= FLEET_EQUIV_ATOL


@pytest.mark.cuda
def test_hetero_sl_vmap_plan_on_card_matches_cpu(hopper):
    """tinycnn ``sl/vmap`` with per-client cuts (edges Jetson and MCU, an
    int8 link at 1 Mb/s on the fused kernel: cuts [2, 1, 2, 1], two
    buckets) and dropout: the card run against the same plan on the CPU,
    the cuts, active clients and wire bytes exactly, losses within
    ``FLEET_EQUIV_ATOL``; one int8 launch a local step a bucket."""
    from repro_torch.core.energy import HardwareProfile, JETSON_AGX_ORIN
    from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
    mcu = HardwareProfile("mcu-class", fp32_tflops=0.02, mem_bw_gbs=2.0,
                          tensor_tflops=0.04, cpu_passmark=400.0,
                          power_w=2.0)
    spec = api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(image_size=16, n_train=96, n_test=24),
        clients=api.ClientSpec(num_clients=4, dropout_rate=0.3,
                               edge_profiles=(JETSON_AGX_ORIN, mcu)),
        cut_policy=api.CutPolicy(mode="adaptive"),
        link_policy=api.LinkPolicy(compress="int8", rate_bps=1e6),
        engine=api.EngineSpec(kind="sl", client_axis="vmap",
                              link_kernel="fused"),
        global_rounds=3, local_steps=2, batch_size=4)
    gpu = api.compile_experiment(spec)
    cpu = api.compile_experiment(spec, device="cpu")
    assert gpu.cut_of_client == cpu.cut_of_client == [2, 1, 2, 1]
    quant_dequant_int8.launches = 0
    _, rec_gpu = gpu.run()
    assert quant_dequant_int8.launches == 3 * 2 * 2
    _, rec_cpu = cpu.run()
    for a, b in zip(rec_gpu, rec_cpu):
        assert a.active_clients == b.active_clients
        assert a.link_bytes == b.link_bytes
        assert abs(a.loss - b.loss) <= FLEET_EQUIV_ATOL


@pytest.mark.cuda
def test_chunked_lm_loss_on_card_matches_cpu(hopper):
    """The split LM's chunked server loss at SmolLM-135M's width, 2
    clients x 4 x 1024 token rows (d 576, vocab 49,152), vmapped over the
    clients with a shared head as the fleet engines take it: the card's
    losses and gradients against the same function on the CPU."""
    from repro_torch.fleet.hetero import chunked_lm_loss
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 4, 1024, 576, generator=g)
    head = 0.02 * torch.randn(576, 49152, generator=g)
    t = torch.randint(0, 49152, (2, 4, 1024), generator=g)
    w = torch.tensor([0.5, 1.0])
    out = []
    for dev in ("cuda", "cpu"):
        hh = h.to(dev).requires_grad_()
        hd = head.to(dev).requires_grad_()
        losses = torch.func.vmap(chunked_lm_loss, in_dims=(0, None, 0))(
            hh, hd, t.to(dev))
        grads = torch.autograd.grad((losses * w.to(dev)).sum(), [hh, hd])
        out.append([x.detach().cpu() for x in (losses, *grads)])
    for a, b in zip(*out):
        assert torch.isfinite(a).all()
        assert float((a - b).norm() / b.norm()) < 1e-5


# ---------------------------------------------------------------------------
# Monte-Carlo sweeps: the seed axis on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_int8_nested_vmap_rule_on_card_is_one_launch(hopper):
    """The int8 boundary vmapped over 3 seeds of 4 clients (the fleet
    engines' seed axis, outermost): both levels fold into the rows, ONE
    launch, bit-equal to the plain version seed by seed, client by client
    (NaN, inf and zero rows included)."""
    from torch.func import vmap
    from repro_torch.kernels.quant.ops import make_link_compress
    g = torch.Generator(device=hopper).manual_seed(3)
    x = torch.randn(3, 4, 16, 28, 28, 32, device=hopper, generator=g) * 3
    x[2, 1, 0, 2, 3, 5] = float("nan")
    x[0, 3, 1, 0, 0, 0] = float("inf")
    x[1, 2, 2, 0, 0, :] = 0.0
    compress = make_link_compress(kernel="fused")
    before = quant_dequant_int8.launches
    got = vmap(vmap(compress))(x)
    torch.cuda.synchronize()
    assert quant_dequant_int8.launches == before + 1
    want = torch.stack([torch.stack([
        quant_dequant_int8_plain(x[s, c].reshape(-1, 32)).reshape(x.shape[2:])
        for c in range(4)]) for s in range(3)])
    assert _same(got, want)


@pytest.mark.cuda
def test_seed_axis_sweep_on_card_matches_the_per_seed_loop(hopper):
    """tinycnn ``sl/vmap`` under a stochastic scenario (a2g channel, markov
    availability, two relaying UAVs): the sweep on the seed axis against
    the per-seed loop, both on the card, masks and bills exactly, losses
    within ``FLEET_EQUIV_ATOL``; one int8 launch a local step for all
    seeds and clients."""
    import numpy as np
    from repro_torch import sim
    from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
    spec = api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(image_size=16, n_train=96, n_test=24),
        clients=api.ClientSpec(num_clients=4),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", client_axis="vmap",
                              link_kernel="fused"),
        mission=api.MissionSpec(),
        scenario=sim.ScenarioSpec(
            channel=sim.ChannelParams(kind="a2g"),
            availability=sim.AvailabilityParams(kind="markov", p_drop=0.4,
                                                p_recover=0.6),
            num_uavs=2, serve_mode="relay", seed=1),
        global_rounds=2, local_steps=2, batch_size=4)
    plan = api.compile_experiment(spec)
    quant_dequant_int8.launches = 0
    v = sim.run_monte_carlo(plan, 3, rounds=2, mode="vmap")
    assert quant_dequant_int8.launches == 2 + 2 * 2    # warm-up + sweep
    loop = sim.run_monte_carlo(plan, 3, rounds=2, mode="loop")
    for k in v.stacks:
        if k in ("loss", "final_accuracy"):
            assert np.abs(v.stacks[k] - loop.stacks[k]).max() <= (
                FLEET_EQUIV_ATOL if k == "loss" else 1.0 / 24 + 1e-12), k
        else:
            np.testing.assert_array_equal(v.stacks[k], loop.stacks[k], k)


# ---------------------------------------------------------------------------
# run telemetry (repro_torch.obs) on the card
# ---------------------------------------------------------------------------

class _ListSink:
    run_dir = None

    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)


@pytest.mark.cuda
def test_fence_books_the_device_wait_on_cuda(hopper):
    """Queued 4096^2 matmuls: the span's fence waits for them, so its
    ``sync_s`` is above 0 and at most its ``dur_s``; ``fenced`` times the
    work, not the launch."""
    from repro_torch.obs.timeline import Timeline, fenced
    a = torch.randn(4096, 4096, device=hopper)
    torch.cuda.synchronize()
    sink = _ListSink()
    with Timeline(sink).span("round/execute") as sp:
        y = a
        for _ in range(4):
            y = y @ a
        sp.fence({"out": (y, [a])})
    ev = sink.events[0]
    assert 0 < ev["sync_s"] <= ev["dur_s"]
    _, wall = fenced(lambda: a @ a @ a)
    assert wall > 1e-4


@pytest.mark.cuda
def test_tensor_bytes_on_cuda_tensors(hopper):
    from repro_torch.obs import tensor_bytes
    from repro_torch.optim.optimizers import FunctionalAdamW
    params = {"w": torch.zeros(5, 2, device=hopper)}
    tree = {"a": torch.zeros(4, 4, device=hopper),
            "b": [torch.zeros(3, dtype=torch.bfloat16, device=hopper)],
            "c": torch.zeros(2), "st": FunctionalAdamW().init(params)}
    assert tensor_bytes(tree) == 64 + 6 + 8 + (4 + 2 * 40)


@pytest.mark.cuda
def test_profiler_captures_the_int8_kernel(hopper, tmp_path):
    from repro_torch.obs.profiler import ProfilerCapture
    x = torch.randn(1024, 32, device=hopper)
    a = torch.randn(2048, 2048, device=hopper)
    quant_dequant_int8(x)                       # built before the window
    cap = ProfilerCapture((0, 0), str(tmp_path / "prof"), cuda=True)
    cap.round_started(0)
    for _ in range(10):                         # a window of milliseconds
        quant_dequant_int8(a @ a[:, :32])
    torch.cuda.synchronize()
    cap.round_finished(0)
    assert cap.status == f"captured -> {tmp_path / 'prof'}"
    import collections
    import json
    with open(cap.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("quant_dequant_int8" in k for k in kernels), (
        kernels, collections.Counter(e.get("cat") for e in events))


def _tiny_sl_vmap(dropout=0.34):
    return api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(image_size=16, n_train=96, n_test=24),
        clients=api.ClientSpec(num_clients=3, dropout_rate=dropout),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", client_axis="vmap",
                              link_kernel="fused"),
        global_rounds=2, local_steps=2, batch_size=4)


@pytest.mark.cuda
def test_taps_add_no_host_syncs_to_a_raw_round(hopper):
    """``Plan.raw_round`` with the full tap set runs as many synchronizing
    CUDA operations as without (``torch.cuda.set_sync_debug_mode``), a
    client masked; and as many int8 launches."""
    from repro_torch.obs import MetricsConfig, ObsConfig
    from repro_torch.obs.timeline import count_host_syncs
    spec = _tiny_sl_vmap()
    mask = torch.tensor([1.0, 0.0, 1.0], device=hopper)
    counts, launches = [], []
    for obs in (ObsConfig(enabled=False, metrics=MetricsConfig()), None):
        plan = api.compile_experiment(spec, obs=obs)
        for _ in range(2):                      # the second call counted
            st = plan.init()
            batches = plan.round_batches(st)
            torch.cuda.synchronize()
            quant_dequant_int8.launches = 0
            out, n = count_host_syncs(
                lambda: plan.raw_round(st.engine_state, batches, mask))
            torch.cuda.synchronize()
        counts.append(n)
        launches.append(quant_dequant_int8.launches)
        assert len(out) == (3 if obs else 2)
    assert counts[0] == counts[1]
    assert launches == [2, 2]


@pytest.mark.cuda
def test_nan_localized_on_card_as_on_cpu(hopper):
    """A NaN at (client 2, step 1) passes through the fused int8 kernel
    (NaN rows stay NaN) and is localized there, card and CPU alike."""
    from repro_torch.obs import MetricsConfig, ObsConfig
    found = []
    for device in ("cuda", "cpu"):
        plan = api.compile_experiment(
            _tiny_sl_vmap(dropout=0.0), device=device,
            obs=ObsConfig(enabled=False, metrics=MetricsConfig()))
        st = plan.init()
        st, _ = plan.run_round(st, with_eval=False)
        batches = plan.round_batches(st)
        bx = batches["inputs"].clone()
        bx[2, 1] = float("nan")
        st, rec = plan.run_round(st, {"inputs": bx,
                                      "targets": batches["targets"]},
                                 with_eval=False)
        found.append((rec.metrics["health/first_step"],
                      rec.metrics["health/first_client"],
                      rec.metrics["health/nonfinite"]))
    assert found[0] == found[1] and found[0][:2] == (1, 2)
