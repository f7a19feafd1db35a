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
from repro_torch.kernels.quant.int8 import (dequantize_int8,
                                            quant_dequant_int8,
                                            quant_dequant_int8_plain,
                                            quantize_int8)
from repro_torch.kernels.quant.ref import (dequantize_int8_ref,
                                           quantize_int8_ref)
from repro_torch.kernels.rwkv.ops import wkv
from repro_torch.kernels.rwkv.ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref
from repro_torch.kernels.rwkv.scan import (CHECKPOINT_EVERY, _bwd_library,
                                           rwkv6_scan, rwkv6_scan_bwd,
                                           rwkv6_scan_bwd_launch_config)

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
