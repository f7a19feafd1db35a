"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``); TF32 off for convs
   and matmuls, so float32 means float32;
2. build every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together), with each kernel's
   registers and spills from ``ptxas`` and the count of tensor-core MMA
   instructions (HMMA) in the flash kernels' SASS (``cuobjdump``);
3. each kernel against its plain PyTorch version on the card over the
   shapes of its sweep and its main paths' shapes: the int8 link kernel and
   the wire format's quantize/dequantize pair bit for bit (NaN positions
   included), the flash attention kernel within the reference's own
   tolerances (f32 2e-5, bf16 3e-2), a case with fully masked rows
   (finite everywhere, the rows that see a key equal), and its gradient
   (kernel forward + closed-form backward) against autograd through the
   plain version; the
   WKV scan kernel within the reference's atol/rtol 1e-4 at head sizes 16
   to 256, its final state S_T too; the WKV backward kernel's five
   gradients (with a cotangent of S_T, with w holding exact zeros, and at T
   on the edges of its 4-step sub-segments and 16-step segments) against
   autograd of the plain loop, and at the rwkv6-7b shape against its plain
   closed form, within 1e-4, two calls there giving the same bits;
4. each kernel's time at its main paths' shapes, beside its plain
   version's time, its bound and, where one PyTorch call computes the same
   function, that call's time; the memory-bound int8 kernels are timed
   with the L2 cold (inputs rotated through 256 MiB), as their bytes bound
   assumes; the flash kernel's bound is its 3xTF32 tensor-core work, and
   it is timed in bf16 beside SDPA too (informational); the WKV backward's
   launch (blocks, threads, shared bytes, resident blocks a SM) is printed;
5. the CNN path: ``sl/scan`` (Algorithm 3) on MobileNetV2 at 224x224,
   4 clients, batch 16, 2 local steps, 2 rounds, int8 link on the fused
   kernel, UAV mission; with the kernel's launch count over exactly that
   run, one more round under the profiler (device busy share and the
   kernels that take the device's time), and a tinycnn run on the card held
   against the same run on the CPU;
6. ``fl/scan`` on the same spec for one round (and one profiled): SL's
   client energy per round must be below FL's;
7. the split-LM path: SmolLM-135M at full width (30 layers, d 576,
   vocab 49,152), sequences of 1024 tokens, batch 8, 4 clients, cut 8/30,
   int8 link on the fused kernel, attention on the flash kernel, 2 rounds;
   with both kernels' launch counts over exactly that run, the "pallas"
   plan's FLOP bill against the "ref" plan's, one profiled round, and a
   reduced SmolLM on the card held against the same run on the CPU;
8. the RWKV path: ``repro_torch.launch.train.train`` on rwkv6-7b at full
   width (d 4096, 64 heads of 64, d_ff 14336, vocab 65,536, bf16) cut to 4
   of its 32 layers, cut 1, batch 4 x 1024 tokens, AdamW, 3 steps, the
   parameters drawn on the card; with the WKV kernel's launch count over
   exactly those steps (4 x 3 forward and 4 x 3 backward), the peak
   memory, one profiled step, and the reduced rwkv6-7b (head size 256) on
   the card held against the same run on the CPU; the wire-format pair's
   launch counts cover paths 5 to 8;
9. one JSON line listing the kernels, then the card, then the result line.

It imports nothing of JAX or of the JAX package. Without a CUDA device it
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12            # H100 SXM FP32 rate outside tensor cores
TF32_FLOP_PER_S = 495e12           # H100 SXM dense TF32 tensor-core rate
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core rate
SWEEP_M = (1, 7, 509, 2048, 12544)
SWEEP_D = (8, 16, 32, 256)
MAIN_M, MAIN_D = 12544, 32         # MobileNetV2 cut at batch 16, 224x224
LM_M, LM_D = 8 * 1024, 576         # SmolLM-135M cut: batch 8 x 1024 tokens
# the flash kernel's sweep: S, head dims, masks; Sk != S in extra pairs
FLASH_S = (1, 7, 100, 131, 257, 1024)
FLASH_SK_PAIRS = ((100, 257), (131, 1024), (7, 64))
FLASH_D = (32, 64, 128)
FLASH_WINDOWS = (None, 16, 100)
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
FLASH_MAIN = (8, 9, 1024, 64)      # SmolLM-135M attention at batch 8
# S, Sk, window of a causal case with fully masked rows: rows from
# Sk + window - 1 = 115 on see no key
FLASH_MASKED = (1024, 100, 16)
# the WKV kernel's sweep (at B, H = 2, 3) and the rwkv6-7b training shape
WKV_T = (1, 7, 64, 1000, 1024)
WKV_HD = (16, 32, 64, 128, 256)
WKV_MAIN = (4, 64, 1024, 64)
WKV_TOL = 1e-4                     # atol and rtol, the reference's own
L2_ROTATE_BYTES = 256 * 2 ** 20    # > 5x the H100's 50 MB L2
RWKV_LAYERS = 4                    # of rwkv6-7b's 32: the only cut


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal values with NaN in the same places."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def check_quant_kernel(dev) -> float:
    from repro_torch.kernels.quant.int8 import (quant_dequant_int8,
                                                quant_dequant_int8_plain)
    g = torch.Generator(device=dev).manual_seed(0)
    cases = 0
    max_err = 0.0
    for m in SWEEP_M:
        for d in SWEEP_D:
            for dtype in (torch.float32, torch.bfloat16):
                for residual in (False, True):
                    x = (torch.randn(m, d, device=dev, generator=g)
                         * torch.rand(m, 1, device=dev, generator=g) * 10
                         ).to(dtype)
                    r = (torch.randn(m, d, device=dev, generator=g).to(dtype)
                         if residual else None)
                    got = quant_dequant_int8(x, residual=r)
                    want = quant_dequant_int8_plain(x, residual=r)
                    torch.cuda.synchronize()
                    if not same(got, want):
                        raise AssertionError(
                            f"quant_dequant_int8 kernel != plain at M={m} "
                            f"D={d} {dtype} residual={residual}")
                    max_err = max(max_err, float(
                        (got.float() - want.float()).abs().max()))
                    cases += 1
    for dtype in (torch.float32, torch.bfloat16):       # the split LM's cut
        x = torch.randn(LM_M, LM_D, device=dev, generator=g).to(dtype)
        got, want = quant_dequant_int8(x), quant_dequant_int8_plain(x)
        torch.cuda.synchronize()
        if not same(got, want):
            raise AssertionError(f"quant_dequant_int8 kernel != plain at "
                                 f"M={LM_M} D={LM_D} {dtype}")
        max_err = max(max_err, float((got.float() - want.float()).abs().max()))
        cases += 1
    x = torch.randn(64, 32, device=dev, generator=g)
    x[3, 5] = float("nan")
    x[9, 0] = float("inf")
    x[10, :] = 0.0
    got, want = quant_dequant_int8(x), quant_dequant_int8_plain(x)
    torch.cuda.synchronize()
    if not same(got, want) or not torch.isnan(got[3]).all():
        raise AssertionError("quant_dequant_int8: NaN/inf rows differ")
    print(f"[check] quant_dequant_int8: {cases + 1} cases bit-equal to the "
          f"plain version (NaN and inf rows included)")
    return max_err


def time_ms(fn, iters=200, warmup=20) -> float:
    """Per-call time of ``fn`` from CUDA events around ``iters`` eager
    calls: host dispatch included (it sets the time when it is slower
    than the device)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=200) -> float:
    """Per-call device time of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so no host dispatch sits between the kernels. The
    input stays in L2, as the smashed tensor does when the link follows the
    client's last conv."""
    for _ in range(3):
        fn()                      # warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return time_ms(graph.replay, iters=5, warmup=1) / iters


def device_ms_cold(fn, make_inputs, nbytes: int) -> float:
    """Per-call device time of ``fn(*inputs)`` with the L2 cold: ``n`` input
    sets from ``make_inputs()``, enough that the ``n * nbytes`` bytes the
    calls move (inputs and outputs) exceed ``L2_ROTATE_BYTES``, called in
    turn inside one CUDA graph with every output kept alive. Each call then
    reads and writes memory that no call since its last turn touched, so a
    memory-bound kernel is timed against device memory, as its bound is."""
    n = max(2, -(-L2_ROTATE_BYTES // nbytes))
    sets = [make_inputs() for _ in range(n)]
    for ins in sets[:2]:
        fn(*ins)                  # warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*ins) for ins in sets]
    graph.replay()
    torch.cuda.synchronize()
    ms = time_ms(graph.replay, iters=20, warmup=2) / n
    del graph, outs, sets
    torch.cuda.empty_cache()
    return ms


def cold_and_warm(label: str, kernel, plain, make_inputs, nbytes: int,
                  bound_ms: float) -> dict:
    """A memory-bound kernel and its plain version at L2-cold device time
    (``device_ms_cold``; in turns kernel, plain, plain, kernel, each keeping
    its best), which is what the bytes bound compares with; beside them the
    kernel's L2-resident time (one input replayed, ``device_ms``) and both
    eager times."""
    k1, p1, p2, k2 = (device_ms_cold(kernel, make_inputs, nbytes),
                      device_ms_cold(plain, make_inputs, nbytes),
                      device_ms_cold(plain, make_inputs, nbytes),
                      device_ms_cold(kernel, make_inputs, nbytes))
    kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
    ins = make_inputs()
    warm_ms = device_ms(lambda: kernel(*ins))
    print(f"[time] {label}, device time per call, L2 cold (CUDA graph over "
          f"inputs rotated through {L2_ROTATE_BYTES / 2 ** 20:.0f} MiB): "
          f"kernel {kernel_ms:.6f} ms ({k1:.6f}, {k2:.6f}), plain "
          f"{plain_ms:.6f} ms ({p1:.6f}, {p2:.6f}); bound {bound_ms:.6f} ms "
          f"(bytes: {nbytes / 1e6:.2f} MB at 3.35 TB/s), kernel at "
          f"{100 * bound_ms / kernel_ms:.1f}% of it; L2-resident (one input "
          f"replayed): kernel {warm_ms:.6f} ms; eager per call (host dispatch "
          f"included): kernel {time_ms(lambda: kernel(*ins)):.6f} ms, plain "
          f"{time_ms(lambda: plain(*ins)):.6f} ms")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def time_quant_kernel(dev, m=MAIN_M, d=MAIN_D) -> dict:
    from repro_torch.kernels.quant.int8 import (quant_dequant_int8,
                                                quant_dequant_int8_plain)
    nbytes = 2 * m * d * 4                      # x read, the f32 result written
    return cold_and_warm(f"quant_dequant_int8 M={m} D={d} f32",
                         quant_dequant_int8, quant_dequant_int8_plain,
                         lambda: (torch.randn(m, d, device=dev),), nbytes,
                         nbytes / HBM_BYTES_PER_S * 1e3)


def check_flash_kernel(dev) -> dict:
    """The flash kernel against its plain version over the sweep and at the
    split LM's shape ``FLASH_MAIN``, in f32 and bf16 (standard normal
    inputs), then its gradient (kernel forward + closed-form backward)
    against autograd through the plain version, ``FLASH_MAIN`` included.
    Returns the largest |kernel - plain| per dtype over all these cases."""
    from repro_torch.kernels.attn.flash import (flash_attention,
                                                flash_attention_fwd,
                                                flash_attention_plain)
    g = torch.Generator(device=dev).manual_seed(1)
    pairs = [(s, s) for s in FLASH_S] + list(FLASH_SK_PAIRS)
    errs = {name: 0.0 for name in FLASH_ATOL}
    cases = 0
    for s, sk in pairs:
        for d in FLASH_D:
            for causal in (True, False):
                for window in FLASH_WINDOWS:
                    for dtype in (torch.float32, torch.bfloat16):
                        q = torch.randn(2, 3, s, d, device=dev,
                                        generator=g).to(dtype)
                        k, v = (torch.randn(2, 3, sk, d, device=dev,
                                            generator=g).to(dtype)
                                for _ in range(2))
                        got = flash_attention_fwd(q, k, v, causal=causal,
                                                  window=window)
                        want = flash_attention_plain(q, k, v, causal=causal,
                                                     window=window)
                        torch.cuda.synchronize()
                        name = str(dtype).split(".")[-1]
                        err = float((got.float() - want.float()).abs().max())
                        if not (got.dtype == dtype and err <= FLASH_ATOL[name]):
                            raise AssertionError(
                                f"flash_attention kernel != plain at S={s} "
                                f"Sk={sk} D={d} causal={causal} "
                                f"window={window} {name}: {err}")
                        errs[name] = max(errs[name], err)
                        cases += 1
    b, h, s, d = FLASH_MAIN                 # the split LM's own shape
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(b, h, s, d, device=dev, generator=g).to(dtype)
                   for _ in range(3))
        got = flash_attention_fwd(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        err = float((got.float() - want.float()).abs().max())
        print(f"[check] flash_attention at the main path's shape {FLASH_MAIN} "
              f"{name} causal: max_abs_err {err:.3e} (atol "
              f"{FLASH_ATOL[name]:g})")
        if not (got.dtype == dtype and err <= FLASH_ATOL[name]):
            raise AssertionError(f"flash_attention kernel != plain at "
                                 f"{FLASH_MAIN} {name}: {err}")
        errs[name] = max(errs[name], err)
        cases += 1
    # fully masked rows: finite everywhere (no NaN from 0/0), and the rows
    # that see a key equal the plain version; the rows that see none differ
    # by design (the kernel: the mean over its live tiles or 0; the plain
    # version: the mean over all Sk values; ROADMAP queue 3)
    s, sk, window = FLASH_MASKED
    qp = torch.arange(s, device=dev)[:, None]
    kp = torch.arange(sk, device=dev)[None, :]
    sees = ((qp >= kp) & (qp - kp < window)).any(dim=1)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(2, 3, s, 64, device=dev, generator=g).to(dtype)
        k, v = (torch.randn(2, 3, sk, 64, device=dev, generator=g).to(dtype)
                for _ in range(2))
        got = flash_attention_fwd(q, k, v, causal=True, window=window)
        want = flash_attention_plain(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        err = float((got.float() - want.float())[:, :, sees].abs().max())
        finite = bool(torch.isfinite(got.float()).all())
        print(f"[check] flash_attention fully masked rows (S {s}, Sk {sk}, "
              f"window {window}, causal) {name}: all finite {finite}; "
              f"{int(sees.sum())} rows that see a key: max_abs_err {err:.3e} "
              f"(atol {FLASH_ATOL[name]:g})")
        if not (finite and err <= FLASH_ATOL[name]):
            raise AssertionError(f"flash_attention with fully masked rows "
                                 f"{name}: finite {finite}, err {err}")
        errs[name] = max(errs[name], err)
        cases += 1
    print(f"[check] flash_attention: {cases} cases within the reference's "
          f"tolerances of the plain version; max_abs_err f32 "
          f"{errs['float32']:.3e} (atol 2e-5), bf16 {errs['bfloat16']:.3e} "
          f"(atol 3e-2)")
    gmax = 0.0
    for shape, causal, window in (((2, 3, 257, 64), True, None),
                                  ((2, 3, 131, 128), False, 16),
                                  ((2, 3, 100, 32), True, 100),
                                  (FLASH_MAIN, True, None)):
        ins = [torch.randn(*shape, device=dev, generator=g) for _ in range(3)]
        grads = []
        for fn in (flash_attention, flash_attention_plain):
            leaves = [t.clone().requires_grad_(True) for t in ins]
            o = fn(*leaves, causal=causal, window=window)
            (o * torch.cos(o)).sum().backward()
            grads.append([t.grad for t in leaves])
        for got, want in zip(*grads):
            err = float((got - want).abs().max())
            if not err <= 2e-4:
                raise AssertionError(f"flash_attention gradient differs at "
                                     f"{shape}: {err}")
            gmax = max(gmax, err)
        del grads
    print(f"[check] flash_attention gradients (kernel forward + closed-form "
          f"backward) vs autograd of the plain version, {FLASH_MAIN} "
          f"included: max_abs_err "
          f"{gmax:.3e} (atol 2e-4)")
    return errs


def time_flash_kernel(dev) -> dict:
    """The flash kernel at the split LM's shape (f32, causal) beside its
    plain version and ``F.scaled_dot_product_attention(is_causal=True)``,
    the library yardstick (timed here only; the port never calls it), in
    turns; then the same shape in bf16, kernel beside SDPA (informational:
    no path runs it). The f32 bound is the 3xTF32 tensor-core work the
    kernel does (3 TF32 products per f32 product); the FP32 bound of the
    first, SIMT version is printed beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels.attn.flash import (flash_attention_fwd,
                                                flash_attention_plain)
    b, h, s, d = FLASH_MAIN
    q, k, v = (torch.randn(b, h, s, d, device=dev) for _ in range(3))
    kernel = lambda: flash_attention_fwd(q, k, v, causal=True)   # noqa: E731
    plain = lambda: flash_attention_plain(q, k, v, causal=True)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(               # noqa: E731
        q, k, v, is_causal=True)
    k1, p1, l1 = (device_ms(kernel, iters=20), device_ms(plain, iters=20),
                  device_ms(sdpa, iters=20))
    l2, p2, k2 = (device_ms(sdpa, iters=20), device_ms(plain, iters=20),
                  device_ms(kernel, iters=20))
    kernel_ms, plain_ms, lib_ms = min(k1, k2), min(p1, p2), min(l1, l2)
    flops = 2.0 * b * h * d * s * (s + 1)      # causal halves of 2 products
    nbytes = 4 * b * h * s * d * 4             # q, k, v read; out written
    tf32_ms = 3 * flops / TF32_FLOP_PER_S * 1e3
    fp32_ms = flops / FP32_FLOP_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(tf32_ms, bytes_ms)
    print(f"[time] flash_attention {FLASH_MAIN} f32 causal, device time per "
          f"call (CUDA graph): kernel {kernel_ms:.6f} ms ({k1:.6f}, "
          f"{k2:.6f}), plain {plain_ms:.6f} ms ({p1:.6f}, {p2:.6f}), SDPA "
          f"{lib_ms:.6f} ms ({l1:.6f}, {l2:.6f}); kernel/SDPA "
          f"{kernel_ms / lib_ms:.3f}; bound {bound_ms:.6f} ms (operations, "
          f"3xTF32: 3 x {flops / 1e9:.3f} GFLOP at 495 TFLOP/s = "
          f"{tf32_ms:.6f} ms; bytes: {nbytes / 1e6:.1f} MB = "
          f"{bytes_ms:.6f} ms), kernel at {100 * bound_ms / kernel_ms:.1f}% "
          f"of it; the first version's FP32 bound {fp32_ms:.6f} ms "
          f"({flops / 1e9:.3f} GFLOP at 67 TFLOP/s)")
    print(f"[time] flash_attention eager per call (host dispatch included): "
          f"kernel {time_ms(kernel, iters=20, warmup=3):.6f} ms, plain "
          f"{time_ms(plain, iters=20, warmup=3):.6f} ms, SDPA "
          f"{time_ms(sdpa, iters=20, warmup=3):.6f} ms")
    del q, k, v
    qb, kb, vb = (torch.randn(b, h, s, d, device=dev).to(torch.bfloat16)
                  for _ in range(3))
    kernel = lambda: flash_attention_fwd(qb, kb, vb, causal=True)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(                 # noqa: E731
        qb, kb, vb, is_causal=True)
    k1, l1, l2, k2 = (device_ms(kernel, iters=20), device_ms(sdpa, iters=20),
                      device_ms(sdpa, iters=20), device_ms(kernel, iters=20))
    bf_ops_ms = flops / BF16_FLOP_PER_S * 1e3
    bf_bytes_ms = nbytes / 2 / HBM_BYTES_PER_S * 1e3
    print(f"[time] flash_attention {FLASH_MAIN} bf16 causal (no path runs "
          f"it), device time per call (CUDA graph): kernel "
          f"{min(k1, k2):.6f} ms ({k1:.6f}, {k2:.6f}), SDPA {min(l1, l2):.6f}"
          f" ms ({l1:.6f}, {l2:.6f}); bound {max(bf_ops_ms, bf_bytes_ms):.6f}"
          f" ms (operations {bf_ops_ms:.6f} ms at 989 TFLOP/s bf16, bytes "
          f"{bf_bytes_ms:.6f} ms)")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "library_ms": lib_ms}


def check_wire_kernels(dev) -> float:
    """``quantize_int8`` / ``dequantize_int8`` against their plain versions,
    bit for bit: codes, scales (NaN in the same places) and the
    dequantized rows in f32 and bf16, over the fused kernel's sweep, the two
    link shapes, and rows holding NaN, inf and zeros. Returns the largest
    |kernel - plain| over the dequantized values (0 when bit-equal)."""
    from repro_torch.kernels.quant.int8 import dequantize_int8, quantize_int8
    from repro_torch.kernels.quant.ref import (dequantize_int8_ref,
                                               quantize_int8_ref)
    g = torch.Generator(device=dev).manual_seed(2)
    shapes = [(m, d) for m in SWEEP_M for d in SWEEP_D] + [
        (MAIN_M, MAIN_D), (LM_M, LM_D)]
    cases = 0
    max_err = 0.0
    for m, d in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(m, d, device=dev, generator=g)
                 * torch.rand(m, 1, device=dev, generator=g) * 10).to(dtype)
            if m >= 4:                         # NaN, inf and all-zero rows
                x[1, 0] = float("nan")
                x[2, d - 1] = float("inf")
                x[3, :] = 0.0
            codes, scales = quantize_int8(x)
            want_c, want_s = quantize_int8_ref(x)
            torch.cuda.synchronize()
            if not (codes.dtype == torch.int8 and torch.equal(codes, want_c)
                    and same(scales, want_s)):
                raise AssertionError(f"quantize_int8 kernel != plain at M={m} "
                                     f"D={d} {dtype}")
            for out_dtype in (torch.float32, torch.bfloat16):
                got = dequantize_int8(codes, scales, out_dtype=out_dtype)
                want = dequantize_int8_ref(codes, scales, out_dtype=out_dtype)
                torch.cuda.synchronize()
                if not (got.dtype == out_dtype and same(got, want)):
                    raise AssertionError(f"dequantize_int8 kernel != plain at "
                                         f"M={m} D={d} {out_dtype}")
                max_err = max(max_err, float(
                    (got.float() - want.float()).nan_to_num(0.0).abs().max()))
                cases += 1
    print(f"[check] quantize_int8/dequantize_int8: {cases} cases bit-equal to "
          f"the plain versions (codes, scales, f32/bf16 rows; NaN, inf and "
          f"zero rows included), the link shapes ({MAIN_M}, {MAIN_D}) and "
          f"({LM_M}, {LM_D}) among them")
    return max_err


def wkv_inputs(shape, dev, g):
    """The reference test's law (tests/test_kernels.py:276-283): r, k, v
    0.5 N(0, 1); w sigmoid(N(0, 1)); u 0.3 N(0, 1)."""
    b, h, t, hd = shape
    r, k, v = (0.5 * torch.randn(shape, device=dev, generator=g)
               for _ in range(3))
    w = torch.sigmoid(torch.randn(shape, device=dev, generator=g))
    u = 0.3 * torch.randn(h, hd, device=dev, generator=g)
    return r, k, v, w, u


def check_wkv_kernel(dev) -> tuple:
    """The WKV kernel against its plain version over T x hd at (B, H) = (2,
    3) and at the rwkv6-7b shape ``WKV_MAIN``, y and the final state S_T,
    within atol/rtol ``WKV_TOL``; then ``ops.wkv``'s gradients (forward
    kernel + backward kernel) against autograd of the plain loop, with a
    cotangent of S_T and with w holding exact zeros, at head sizes 32 to
    256, and the backward kernel against its plain closed form at
    ``WKV_MAIN``. Returns the largest |kernel - plain| of the forward (y,
    S_T) and of the backward (the five gradients)."""
    from repro_torch.kernels.rwkv.ops import wkv
    from repro_torch.kernels.rwkv.ref import (rwkv6_scan_bwd_ref,
                                              rwkv6_scan_ref)
    from repro_torch.kernels.rwkv.scan import rwkv6_scan, rwkv6_scan_bwd
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = [(2, 3, t, hd) for t in WKV_T for hd in WKV_HD] + [WKV_MAIN]
    max_err = 0.0
    for shape in shapes:
        ins = wkv_inputs(shape, dev, g)
        y, st = rwkv6_scan(*ins, return_state=True)
        want_y, want_s = rwkv6_scan_ref(*ins, return_state=True)
        torch.cuda.synchronize()
        for name, got, want in (("y", y, want_y), ("S_T", st, want_s)):
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=WKV_TOL, rtol=WKV_TOL):
                raise AssertionError(f"rwkv6_scan kernel != plain at {shape} "
                                     f"({name}): max_abs_err {err}")
            max_err = max(max_err, err)
        if shape == WKV_MAIN:
            print(f"[check] rwkv6_scan at the main path's shape {WKV_MAIN} "
                  f"f32: max_abs_err y {float((y - want_y).abs().max()):.3e}, "
                  f"S_T {float((st - want_s).abs().max()):.3e} (atol/rtol "
                  f"{WKV_TOL:g})")
        del ins, y, st, want_y, want_s
    print(f"[check] rwkv6_scan: {len(shapes)} shapes (T {WKV_T} x hd "
          f"{WKV_HD}, and {WKV_MAIN}) within atol/rtol {WKV_TOL:g} of the "
          f"plain version, y and S_T; max_abs_err {max_err:.3e}")

    def check(label, got, want, shape):
        errs = []
        for name, a, b in zip("rkvwu", got, want):
            err = float((a - b).abs().max())
            if not torch.allclose(a, b, atol=WKV_TOL, rtol=WKV_TOL):
                raise AssertionError(f"wkv gradient d{name} != {label} at "
                                     f"{shape}: max_abs_err {err}")
            errs.append(err)
        return max(errs)

    gmax = 0.0
    # T at the edges of the backward's 4-step sub-segments and 16-step
    # segments among them: (2, 3, 17, 64), (1, 2, 5, 48)
    grad_shapes = [(2, 3, 64, 64), (1, 2, 100, 32), (2, 3, 40, 48),
                   (1, 2, 50, 128), (2, 2, 37, 256), (2, 3, 17, 64),
                   (1, 2, 5, 48)]
    for n, shape in enumerate(grad_shapes):
        ins = list(wkv_inputs(shape, dev, g))
        if n % 2 == 0:                      # decays that underflowed to 0
            ins[3][..., ::5] = 0.0
            ins[3][..., 1::7] = 1e-30
        grads = []
        for fn in (wkv, rwkv6_scan_ref):
            leaves = [t.clone().requires_grad_(True) for t in ins]
            y, st = fn(*leaves, return_state=True)
            ((y * torch.cos(y)).sum() + (st * st).sum()).backward()
            grads.append([t.grad for t in leaves])
        gmax = max(gmax, check("autograd of the plain loop", *grads, shape))
    print(f"[check] wkv gradients (forward kernel + backward kernel) vs "
          f"autograd of the plain loop, y and S_T cotangents, w with exact "
          f"zeros in {(len(grad_shapes) + 1) // 2} of {len(grad_shapes)} "
          f"shapes {grad_shapes}: max_abs_err {gmax:.3e} (atol/rtol "
          f"{WKV_TOL:g})")
    ins = wkv_inputs(WKV_MAIN, dev, g)
    gy = torch.randn(WKV_MAIN, device=dev, generator=g)
    b, h, _, hd = WKV_MAIN
    gs = torch.randn((b, h, hd, hd), device=dev, generator=g)
    _, _, ckpt = rwkv6_scan(*ins, checkpoints=True)
    got = rwkv6_scan_bwd(*ins, gy, gs, ckpt)
    want = rwkv6_scan_bwd_ref(*ins, gy, gs, ckpt)
    torch.cuda.synchronize()
    main_err = check("the plain closed form", got, want, WKV_MAIN)
    print(f"[check] rwkv6_scan_bwd at the main path's shape {WKV_MAIN} f32, "
          f"with G_T, vs its plain closed form on the same checkpoints: "
          f"max_abs_err {main_err:.3e} (atol/rtol {WKV_TOL:g})")
    again = rwkv6_scan_bwd(*ins, gy, gs, ckpt)       # hd 64: no atomics
    torch.cuda.synchronize()
    for name, a, b_ in zip("rkvwu", got, again):
        if not torch.equal(a, b_):
            raise AssertionError(f"rwkv6_scan_bwd d{name} at {WKV_MAIN}: two "
                                 f"calls on the same inputs differ")
    print(f"[check] rwkv6_scan_bwd at {WKV_MAIN}: two calls give bit-equal "
          f"gradients")
    return max_err, max(gmax, main_err)


def time_wire_kernels(dev, m, d) -> dict:
    """quantize_int8 and dequantize_int8 at (m, d) f32 beside their plain
    versions; both move m*d*(4 + 1) + 4*m bytes."""
    from repro_torch.kernels.quant.int8 import dequantize_int8, quantize_int8
    from repro_torch.kernels.quant.ref import (dequantize_int8_ref,
                                               quantize_int8_ref)
    nbytes = m * d * 5 + 4 * m
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3

    def x_only():
        return (torch.randn(m, d, device=dev),)

    def codes_and_scales():
        return quantize_int8(torch.randn(m, d, device=dev))

    return {name: cold_and_warm(f"{name} M={m} D={d} f32", kernel, plain,
                                make, nbytes, bound_ms)
            for name, kernel, plain, make in (
                ("quantize_int8", quantize_int8, quantize_int8_ref, x_only),
                ("dequantize_int8", dequantize_int8, dequantize_int8_ref,
                 codes_and_scales))}


def time_wkv_kernel(dev) -> dict:
    """The WKV kernel at the rwkv6-7b shape beside its plain version (a
    loop of about 6 small kernels per step). No single PyTorch call
    computes this function. The bound: bytes 5*B*H*T*hd*4 (r, k, v, w read,
    y written) at 3.35 TB/s, against operations B*H*T*(5*hd^2 + 3*hd) (the
    least a step needs: kv, the w*S + kv update and r.S as FMAs, the bonus
    as (r . (u*k)) v) at 67 TFLOP/s FP32."""
    from repro_torch.kernels.rwkv.ref import rwkv6_scan_ref
    from repro_torch.kernels.rwkv.scan import CHECKPOINT_EVERY, rwkv6_scan
    g = torch.Generator(device=dev).manual_seed(4)
    ins = wkv_inputs(WKV_MAIN, dev, g)
    kernel = lambda: rwkv6_scan(*ins)                 # noqa: E731
    plain = lambda: rwkv6_scan_ref(*ins)              # noqa: E731
    k1, p1, p2, k2 = (device_ms(kernel, iters=20), device_ms(plain, iters=1),
                      device_ms(plain, iters=1), device_ms(kernel, iters=20))
    kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
    b, h, t, hd = WKV_MAIN
    nbytes = 5 * b * h * t * hd * 4
    flops = b * h * t * (5 * hd * hd + 3 * hd)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[time] rwkv6_scan {WKV_MAIN} f32, device time per call (CUDA "
          f"graph): kernel {kernel_ms:.6f} ms ({k1:.6f}, {k2:.6f}), plain "
          f"{plain_ms:.6f} ms ({p1:.6f}, {p2:.6f}); bound {bound_ms:.6f} ms "
          f"(bytes: {nbytes / 1e6:.1f} MB = {bytes_ms:.6f} ms; operations: "
          f"{flops / 1e9:.3f} GFLOP at 67 TFLOP/s = {ops_ms:.6f} ms); kernel "
          f"at {100 * bound_ms / kernel_ms:.1f}% of its bound")
    print(f"[time] rwkv6_scan eager per call (host dispatch included): "
          f"kernel {time_ms(kernel, iters=20, warmup=3):.6f} ms, plain "
          f"{time_ms(plain, iters=2, warmup=1):.6f} ms")
    ckpt_ms = device_ms(lambda: rwkv6_scan(*ins, checkpoints=True),
                        iters=20)
    print(f"[time] rwkv6_scan {WKV_MAIN} writing the backward's checkpoints "
          f"every {CHECKPOINT_EVERY} steps (as a training step runs it): "
          f"{ckpt_ms:.6f} ms device")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def time_wkv_bwd(dev) -> dict:
    """The WKV backward kernel at the rwkv6-7b shape (no cotangent of S_T,
    as in training) beside its plain closed form on the same checkpoints.
    No single PyTorch call computes it. The bound: bytes 9*B*H*T*hd*4 (r, k,
    v, w, gy read, dr, dk, dv, dw written) plus the checkpoints read once,
    at 3.35 TB/s, against operations 14*hd^2 per (b, h, t) at 67 TFLOP/s
    FP32 (recomputing S: 3 hd^2; dr, dk, dv, dw: 2 hd^2 each; the G update:
    3 hd^2)."""
    from repro_torch.kernels.rwkv.ref import rwkv6_scan_bwd_ref
    from repro_torch.kernels.rwkv.scan import (rwkv6_scan, rwkv6_scan_bwd,
                                               rwkv6_scan_bwd_launch_config)
    g = torch.Generator(device=dev).manual_seed(5)
    ins = wkv_inputs(WKV_MAIN, dev, g)
    gy = torch.randn(WKV_MAIN, device=dev, generator=g)
    _, _, ckpt = rwkv6_scan(*ins, checkpoints=True)
    args = (*ins, gy, None, ckpt)
    kernel = lambda: rwkv6_scan_bwd(*args)            # noqa: E731
    plain = lambda: rwkv6_scan_bwd_ref(*args)         # noqa: E731
    k1, p1, p2, k2 = (device_ms(kernel, iters=10), device_ms(plain, iters=1),
                      device_ms(plain, iters=1), device_ms(kernel, iters=10))
    kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
    b, h, t, hd = WKV_MAIN
    nbytes = 9 * b * h * t * hd * 4 + ckpt.numel() * 4
    flops = 14 * b * h * t * hd * hd
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[time] rwkv6_scan_bwd {WKV_MAIN} f32, device time per call (CUDA "
          f"graph): kernel {kernel_ms:.6f} ms ({k1:.6f}, {k2:.6f}), plain "
          f"{plain_ms:.6f} ms ({p1:.6f}, {p2:.6f}); bound {bound_ms:.6f} ms "
          f"(bytes: {nbytes / 1e6:.1f} MB = {bytes_ms:.6f} ms, checkpoints "
          f"{ckpt.numel() * 4 / 1e6:.1f} MB of it; operations: "
          f"{flops / 1e9:.3f} GFLOP at 67 TFLOP/s = {ops_ms:.6f} ms); kernel "
          f"at {100 * bound_ms / kernel_ms:.1f}% of its bound")
    print(f"[time] rwkv6_scan_bwd eager per call (host dispatch included): "
          f"kernel {time_ms(kernel, iters=10, warmup=2):.6f} ms")
    cfg = rwkv6_scan_bwd_launch_config(b, h, hd)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[launch] rwkv6_scan_bwd {WKV_MAIN}: {cfg['blocks']} blocks of "
          f"{cfg['threads']} threads, {cfg['smem_bytes']} bytes of dynamic "
          f"shared memory, {cfg['blocks_per_sm']} resident a SM x {sms} SMs "
          f"= {cfg['blocks_per_sm'] * sms} slots")
    if cfg["blocks_per_sm"] * sms < cfg["blocks"]:
        raise AssertionError(f"rwkv6_scan_bwd at {WKV_MAIN} needs more than "
                             f"one wave: {cfg}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def main_spec(api, kind: str, rounds: int):
    return api.ExperimentSpec(
        model=api.ModelSpec(name="mobilenetv2", num_classes=12),
        data=api.DataSpec(image_size=224),
        clients=api.ClientSpec(num_clients=4),
        cut_policy=api.CutPolicy(fraction=0.25),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind=kind, client_axis="scan",
                              link_kernel="fused"),
        mission=api.MissionSpec(),
        global_rounds=rounds, local_steps=2, batch_size=16)


def run_plan(plan, label: str):
    """Run the plan's rounds; print each record and its wall time."""
    state = plan.init()
    records = []
    for _ in range(plan.num_rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, rec = plan.run_round(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[{label}] round {rec.round} wall_s={wall:.4f} "
              f"record={json.dumps(rec.to_dict())}")
        if not math.isfinite(rec.loss):
            raise AssertionError(f"{label}: non-finite loss {rec.loss}")
        records.append(rec)
    return state, records


def profile_call(fn, label: str, what: str, top: int = 12, cpu=True):
    """``fn()`` once under ``torch.profiler``: the device's busy share of its
    wall time and the kernels that take the most device time. (Profiling
    slows the host side, so the busy share is a lower bound.) ``cpu=False``
    traces the device alone: the busy share needs no host operator events,
    and a call of ~100,000 small kernels takes a minute to read back with
    them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    t_read = time.perf_counter()
    per_kernel: dict = {}
    for e in prof.events():              # device-side events: the kernels
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            t_us, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (t_us + e.time_range.elapsed_us(), n + 1)
    rows = [(t_us, name, n) for name, (t_us, n) in per_kernel.items()]
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        print(f"[profile] {label}: the profiler recorded no device time "
              f"(device busy share not measured)")
        return
    print(f"[profile] {label}: {what} wall {wall_us / 1e3:.3f} ms under the "
          f"profiler, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}%); trace read in "
          f"{time.perf_counter() - t_read:.1f} s")
    for t_us, key, count in sorted(rows, reverse=True)[:top]:
        print(f"[profile] {label}: {t_us / 1e3:9.3f} ms "
              f"{100 * t_us / busy_us:5.1f}%  x{count:<5d} {key[:90]}")


def check_against_cpu(api):
    """tinycnn on the card (fused kernel) vs the same plan on the CPU (its
    plain version): same params and data; losses agree within 1e-3, wire
    bytes and the contraction FLOP counts exactly."""
    spec = api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(image_size=16, n_train=96, n_test=24),
        clients=api.ClientSpec(num_clients=3),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", link_kernel="fused"),
        global_rounds=2, batch_size=4)
    gpu = api.compile_experiment(spec)
    cpu = api.compile_experiment(spec, device="cpu")
    _, rec_gpu = gpu.run()
    _, rec_cpu = cpu.run()
    for g, c in zip(rec_gpu, rec_cpu):
        if abs(g.loss - c.loss) > 1e-3 or g.link_bytes != c.link_bytes:
            raise AssertionError(f"card vs CPU records differ: {g} vs {c}")
    k = gpu.cut_of_client[0]
    if [f.contraction for f in gpu.flops[k][:2]] != \
            [f.contraction for f in cpu.flops[k][:2]]:
        raise AssertionError("card vs CPU contraction FLOP counts differ")
    print(f"[check] tinycnn sl/scan int8 on the card == on the CPU "
          f"(losses {[round(r.loss, 6) for r in rec_gpu]} vs "
          f"{[round(r.loss, 6) for r in rec_cpu]})")


def lm_spec(api, arch, attn_impl: str, *, seq_len=1024, n_train=96,
            n_test=16, num_clients=4, batch_size=8, mission=True):
    return api.ExperimentSpec(
        model=api.ModelSpec(family="transformer", arch=arch,
                            attn_impl=attn_impl),
        data=api.DataSpec(kind="tokens", partition="iid", seq_len=seq_len,
                          n_train=n_train, n_test=n_test),
        clients=api.ClientSpec(num_clients=num_clients),
        cut_policy=api.CutPolicy(fraction=0.25),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", client_axis="scan",
                              link_kernel="fused"),
        mission=api.MissionSpec() if mission else None,
        global_rounds=2, local_steps=2, batch_size=batch_size, seed=0)


def run_lm_path(api) -> dict:
    """SmolLM-135M at full width through both kernels: launch counts over
    exactly the 2-round run, the FLOP bill against the "ref" plan's, one
    profiled round. Returns the launch counts."""
    from repro_torch.api.plan import LM_EVAL_CHUNK
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels.attn.flash import flash_attention
    from repro_torch.kernels.quant.int8 import quant_dequant_int8

    t0 = time.perf_counter()
    lm = api.compile_experiment(lm_spec(api, smollm_135m, "pallas"))
    k = lm.cut_of_client[0]
    fl_c, fl_s, smashed = lm.flops[k]
    print(f"[lm] compiled in {time.perf_counter() - t0:.2f} s: "
          f"{smollm_135m.name} {smollm_135m.n_layers} layers, d "
          f"{smollm_135m.d_model}, vocab {smollm_135m.vocab}; cut {k}/"
          f"{smollm_135m.n_layers}, smashed {smashed.shape}; FLOPs per split "
          f"step client {float(fl_c):.6g}, server {float(fl_s):.6g}")
    flash_attention.launches = 0
    quant_dequant_int8.launches = 0
    lm_state, _ = run_plan(lm, "lm")
    launches = {"flash_attention": flash_attention.launches,
                "quant_dequant_int8": quant_dequant_int8.launches}
    spec = lm.spec
    steps = spec.local_steps * spec.clients.num_clients
    chunks = -(-len(lm.x_test) // LM_EVAL_CHUNK)
    n_layers = smollm_135m.n_layers
    want = {"flash_attention": lm.num_rounds * n_layers * (steps + chunks),
            "quant_dequant_int8": lm.num_rounds * steps}
    print(f"[lm] launches over the {lm.num_rounds}-round run: {launches} "
          f"(want {want}: {n_layers} x {steps} split steps + {n_layers} x "
          f"{chunks} evaluation chunks per round; one int8 boundary per "
          f"step)")
    if lm.num_rounds != 2 or launches != want:
        raise AssertionError(f"split-LM path launches {launches}, want {want}")
    profile_call(lambda: lm.run_round(lm_state), "lm", "round")
    del lm, lm_state
    torch.cuda.empty_cache()

    ref = api.compile_experiment(lm_spec(api, smollm_135m, "ref"))
    ref_flops = ref.flops[ref.cut_of_client[0]][:2]
    print(f"[lm] FLOPs per split step, pallas plan {[float(fl_c), float(fl_s)]}"
          f" == ref plan {[float(f) for f in ref_flops]}")
    if [float(fl_c), float(fl_s)] != [float(f) for f in ref_flops]:
        raise AssertionError("the pallas plan's FLOP bill differs from the "
                             "ref plan's")
    del ref
    torch.cuda.empty_cache()

    small = dict(seq_len=64, n_train=32, n_test=8, num_clients=2,
                 batch_size=4, mission=False)
    spec = lm_spec(api, smollm_135m.reduced(), "pallas", **small)
    _, rec_gpu = api.compile_experiment(spec).run()
    _, rec_cpu = api.compile_experiment(spec, device="cpu").run()
    for g, c in zip(rec_gpu, rec_cpu):
        if abs(g.loss - c.loss) > 1e-3 or g.link_bytes != c.link_bytes:
            raise AssertionError(f"reduced LM card vs CPU records differ: "
                                 f"{g} vs {c}")
    print(f"[check] reduced SmolLM sl/scan pallas+int8 on the card == on the "
          f"CPU (losses {[round(r.loss, 6) for r in rec_gpu]} vs "
          f"{[round(r.loss, 6) for r in rec_cpu]})")
    return launches


def run_rwkv_path() -> int:
    """rwkv6-7b at full width, cut to ``RWKV_LAYERS`` layers, through the
    port's trainer: 3 steps of 4 x 1024 tokens with the WKV forward and
    backward launch counts over exactly those steps, the peak memory, one
    profiled step, and the reduced rwkv6-7b (head size 256) on the card
    against the same run on the CPU. Returns the launch counts."""
    import dataclasses
    import gc

    from repro_torch.configs import rwkv6_7b
    from repro_torch.kernels.rwkv.scan import rwkv6_scan, rwkv6_scan_bwd
    from repro_torch.launch.train import cuda_hardware_profile, train, \
        train_step
    from repro_torch.models.transformer import default_cut_layer, model_init
    from repro_torch.optim import AdamW

    dev = torch.device("cuda")
    cfg = dataclasses.replace(rwkv6_7b, n_layers=RWKV_LAYERS)
    steps, batch, seq = 3, 4, 1024
    print(f"[rwkv] {cfg.name} at full width (d {cfg.d_model}, "
          f"{cfg.d_model // cfg.hd} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.dtype}), cut to {cfg.n_layers} of "
          f"{rwkv6_7b.n_layers} layers (the only cut from the published "
          f"model); batch {batch} x {seq} tokens, {steps} steps")
    torch.cuda.reset_peak_memory_stats()
    rwkv6_scan.launches = rwkv6_scan_bwd.launches = 0
    t0 = time.perf_counter()
    losses = train(cfg, steps=steps, batch=batch, seq=seq, lr=3e-4,
                   client_fraction=0.15, device=dev, log_every=1,
                   generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rwkv6_scan": rwkv6_scan.launches,
                "rwkv6_scan_bwd": rwkv6_scan_bwd.launches}
    want = cfg.n_layers * steps
    peak = torch.cuda.max_memory_allocated()
    print(f"[rwkv] losses {losses}; train() took {wall:.2f} s (init "
          f"included); peak memory {peak / 2 ** 30:.2f} GiB "
          f"({peak} bytes); WKV launches over the {steps} steps: "
          f"{launches} (want {cfg.n_layers} layers x {steps} steps = {want} "
          f"each)")
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        raise AssertionError(f"rwkv: losses {losses}")
    if set(launches.values()) != {want}:
        raise AssertionError(f"rwkv path launched the WKV kernels "
                             f"{launches} times, want {want} each")
    gc.collect()
    torch.cuda.empty_cache()
    stamp("RWKV training run")

    # one more step under the profiler, on a fresh model after a warm step
    cut = default_cut_layer(cfg, 0.15)
    model = model_init(cfg, torch.Generator(device=dev).manual_seed(1),
                       cut_layer=cut)
    opt = AdamW(model.parameters(), 3e-4, weight_decay=0.01)
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), device=dev,
                           generator=g)
    batch_ = {"tokens": tokens, "labels": tokens}
    train_step(cfg, model, opt, batch_, cut_layer=cut)
    profile_call(lambda: train_step(cfg, model, opt, batch_, cut_layer=cut),
                 "rwkv", "step", top=20, cpu=False)    # the WKV kernels too
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    stamp("RWKV profiled step")

    small = rwkv6_7b.reduced()
    kw = dict(steps=2, batch=2, seq=64, lr=3e-4, client_fraction=0.15,
              log_every=1, hardware=cuda_hardware_profile(dev))
    gpu = train(small, device=dev, generator=torch.Generator().manual_seed(0),
                **kw)
    cpu = train(small, device="cpu",
                generator=torch.Generator().manual_seed(0), **kw)
    if any(abs(a - b) > 1e-3 for a, b in zip(gpu, cpu)) or len(gpu) != 2:
        raise AssertionError(f"reduced RWKV on the card {gpu} != on the CPU "
                             f"{cpu}")
    print(f"[check] reduced rwkv6-7b (hd {small.hd}) trained on the card "
          f"== on the CPU: losses {gpu} vs {cpu} (atol 1e-3)")
    return launches


def demangle(names):
    """C++ names as ``c++filt`` prints them, or as they are without it."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def print_ptxas(logs: dict):
    """Each kernel's registers, stack and spills from the ``-Xptxas=-v``
    build logs (empty when the library was already built)."""
    for lib, log in logs.items():
        rows, name = [], None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name = m.group(1)
                rows.append([name, ""])
            elif name and ("spill" in line or "registers" in line):
                rows[-1][1] += line.strip().replace("ptxas info    : ", "") \
                    + " "
        for (_, props), pretty in zip(rows, demangle([r[0] for r in rows])):
            print(f"[ptxas] {lib}: {pretty.replace('(anonymous namespace)::', '')}"
                  f": {props.strip()}")


def print_hmma(lib: str):
    """The count of tensor-core MMA instructions (HMMA) in each kernel of
    ``lib``'s SASS, from ``cuobjdump -sass``, where the toolkit has it."""
    from repro_torch.kernels.build import library_path, nvcc_path
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        print(f"[sass] {lib}: no cuobjdump beside nvcc")
        return
    sass = subprocess.run([tool, "-sass", str(library_path(lib))],
                          capture_output=True, text=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    for (_, n), pretty in zip(counts.items(), demangle(list(counts))):
        print(f"[sass] {lib}: "
              f"{pretty.replace('(anonymous namespace)::', '')}: {n} HMMA")


T_START = time.perf_counter()


def stamp(phase: str):
    """The script's elapsed host time at the end of a phase."""
    print(f"[phase] {phase} done at {time.perf_counter() - T_START:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build_all     # the port, or fail
    card = card_line()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = build_all()
    print(f"[setup] built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    print_ptxas(logs)
    print_hmma("flash_attn")

    stamp("build")

    max_err = check_quant_kernel(dev)
    wire_err = check_wire_kernels(dev)
    flash_err = check_flash_kernel(dev)
    wkv_err, wkv_bwd_err = check_wkv_kernel(dev)
    stamp("kernel checks")
    time_quant_kernel(dev)
    timing = time_quant_kernel(dev, LM_M, LM_D)
    time_wire_kernels(dev, MAIN_M, MAIN_D)
    wire_timing = time_wire_kernels(dev, LM_M, LM_D)
    flash_timing = time_flash_kernel(dev)
    wkv_timing = time_wkv_kernel(dev)
    wkv_bwd_timing = time_wkv_bwd(dev)
    stamp("kernel times")

    import repro_torch.api as api
    from repro_torch.kernels.quant.int8 import (dequantize_int8,
                                                quant_dequant_int8,
                                                quantize_int8)

    # the wire pair's counts cover every main path (CNN, split LM, RWKV)
    # and nothing else: the checks and times above come before the reset
    quantize_int8.launches = 0
    dequantize_int8.launches = 0
    t0 = time.perf_counter()
    sl = api.compile_experiment(main_spec(api, "sl", rounds=2))
    print(f"[sl] compiled in {time.perf_counter() - t0:.2f} s: cut after "
          f"{sl.stages[sl.cut_of_client[0] - 1].name}, smashed "
          f"{sl.flops[sl.cut_of_client[0]][2].shape}")
    quant_dequant_int8.launches = 0
    sl_state, sl_recs = run_plan(sl, "sl")
    launches = quant_dequant_int8.launches
    spec = sl.spec
    want = (sl.num_rounds * spec.local_steps * spec.clients.num_clients)
    print(f"[sl] quant_dequant_int8 launches on the CNN path: {launches} "
          f"(want {want})")
    if sl.num_rounds != 2 or launches != want:
        raise AssertionError(f"main path launched the kernel {launches} "
                             f"times over {sl.num_rounds} rounds, want {want}")
    profile_call(lambda: sl.run_round(sl_state), "sl", "round")
    check_against_cpu(api)

    fl = api.compile_experiment(main_spec(api, "fl", rounds=1))
    fl_state, fl_recs = run_plan(fl, "fl")
    profile_call(lambda: fl.run_round(fl_state), "fl", "round")
    sl_client = sl_recs[0].client_energy_j
    fl_client = fl_recs[0].client_energy_j
    print(f"[fl] client energy per round: SL {sl_client:.6g} J < "
          f"FL {fl_client:.6g} J")
    if not sl_client < fl_client:
        raise AssertionError("SL client energy is not below FL's")

    stamp("CNN paths")
    lm_launches = run_lm_path(api)
    stamp("split-LM path")
    rwkv_launches = run_rwkv_path()
    stamp("RWKV path")
    wire_launches = {"quantize_int8": quantize_int8.launches,
                     "dequantize_int8": dequantize_int8.launches}
    print(f"[paths] wire-format pair launches over the CNN, split-LM and "
          f"RWKV paths: {wire_launches} (no path of the port calls them)")

    # launches: the counts over the split-LM path's run for the two kernels
    # on it (the CNN path's int8 count is checked above), over the RWKV
    # path's 3 steps for the WKV kernels, over all three paths for the
    # wire-format pair
    wire = [{"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/quant_int8.cu",
             "replaces": f"src/repro/kernels/quant/int8.py:{line}",
             "launches": wire_launches[name], "max_abs_err": wire_err,
             "ms": wire_timing[name]["ms"],
             "plain_ms": wire_timing[name]["plain_ms"],
             "bound_ms": wire_timing[name]["bound_ms"], "bound_by": "bytes",
             "library_ms": None}
            for name, line in (("quantize_int8", 27), ("dequantize_int8", 36))]
    kernels = [{"name": "quant_dequant_int8", "route": "cuda",
                "source": "src/repro_torch/csrc/quant_int8.cu",
                "replaces": "src/repro/kernels/quant/int8.py:40",
                "launches": lm_launches["quant_dequant_int8"],
                "max_abs_err": max_err,
                "ms": timing["ms"], "plain_ms": timing["plain_ms"],
                "bound_ms": timing["bound_ms"], "bound_by": "bytes",
                "library_ms": None},
               {"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attn.cu",
                "replaces": "src/repro/kernels/attn/flash.py:35",
                "launches": lm_launches["flash_attention"],
                "max_abs_err": flash_err["float32"],
                "ms": flash_timing["ms"],
                "plain_ms": flash_timing["plain_ms"],
                "bound_ms": flash_timing["bound_ms"],
                "bound_by": "operations",
                "library_ms": flash_timing["library_ms"]},
               *wire,
               {"name": "rwkv6_scan", "route": "cuda",
                "source": "src/repro_torch/csrc/rwkv6_scan.cu",
                "replaces": "src/repro/kernels/rwkv/scan.py:28",
                "launches": rwkv_launches["rwkv6_scan"],
                "max_abs_err": wkv_err,
                "ms": wkv_timing["ms"], "plain_ms": wkv_timing["plain_ms"],
                "bound_ms": wkv_timing["bound_ms"],
                "bound_by": wkv_timing["bound_by"], "library_ms": None},
               {"name": "rwkv6_scan_bwd", "route": "cuda",
                "source": "src/repro_torch/csrc/rwkv6_scan_bwd.cu",
                # the reference's gradient: JAX's autodiff of this oracle's
                # lax.scan (its Pallas kernel has no backward)
                "replaces": "src/repro/kernels/rwkv/ref.py:9",
                "launches": rwkv_launches["rwkv6_scan_bwd"],
                "max_abs_err": wkv_bwd_err,
                "ms": wkv_bwd_timing["ms"],
                "plain_ms": wkv_bwd_timing["plain_ms"],
                "bound_ms": wkv_bwd_timing["bound_ms"],
                "bound_by": wkv_bwd_timing["bound_by"], "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
