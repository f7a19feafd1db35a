"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``); TF32 off for convs
   and matmuls, so float32 means float32;
2. build every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card over the
   shapes of its sweep and its main paths' shapes: the int8 link kernel bit
   for bit (NaN positions included), the flash attention kernel within the
   reference's own tolerances (f32 2e-5, bf16 3e-2), and its gradient
   (kernel forward + closed-form backward) against autograd through the
   plain version;
4. each kernel's time at its main paths' shapes, beside its plain
   version's time, its bound and, where one PyTorch call computes the same
   function, that call's time;
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
8. one JSON line listing the kernels, then the card, then the result line.

It imports nothing of JAX or of the JAX package. Without a CUDA device it
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12            # H100 SXM FP32 rate outside tensor cores
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


def time_quant_kernel(dev, m=MAIN_M, d=MAIN_D) -> dict:
    from repro_torch.kernels.quant.int8 import (quant_dequant_int8,
                                                quant_dequant_int8_plain)
    x = torch.randn(m, d, device=dev)
    kernel = lambda: quant_dequant_int8(x)            # noqa: E731
    plain = lambda: quant_dequant_int8_plain(x)       # noqa: E731
    # in turns: kernel, plain, plain, kernel; each keeps its best
    k1, p1, p2, k2 = (device_ms(kernel), device_ms(plain), device_ms(plain),
                      device_ms(kernel))
    kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
    bound_ms = 2 * m * d * 4 / HBM_BYTES_PER_S * 1e3
    print(f"[time] quant_dequant_int8 M={m} D={d} f32, device "
          f"time per call (CUDA graph): kernel {kernel_ms:.6f} ms "
          f"({k1:.6f}, {k2:.6f}), plain {plain_ms:.6f} ms ({p1:.6f}, "
          f"{p2:.6f}), bound {bound_ms:.6f} ms (bytes)")
    print(f"[time] quant_dequant_int8 eager per call (host dispatch "
          f"included): kernel {time_ms(kernel):.6f} ms, plain "
          f"{time_ms(plain):.6f} ms")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


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
    the library yardstick (timed here only; the port never calls it)."""
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
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"[time] flash_attention {FLASH_MAIN} f32 causal, device time per "
          f"call (CUDA graph): kernel {kernel_ms:.6f} ms ({k1:.6f}, "
          f"{k2:.6f}), plain {plain_ms:.6f} ms ({p1:.6f}, {p2:.6f}), SDPA "
          f"{lib_ms:.6f} ms ({l1:.6f}, {l2:.6f}); bound {bound_ms:.6f} ms "
          f"(operations: {flops / 1e9:.3f} GFLOP at 67 TFLOP/s = "
          f"{ops_ms:.6f} ms; bytes: {nbytes / 1e6:.1f} MB = "
          f"{bytes_ms:.6f} ms); kernel at "
          f"{100 * bound_ms / kernel_ms:.1f}% of its bound")
    print(f"[time] flash_attention eager per call (host dispatch included): "
          f"kernel {time_ms(kernel, iters=20, warmup=3):.6f} ms, plain "
          f"{time_ms(plain, iters=20, warmup=3):.6f} ms, SDPA "
          f"{time_ms(sdpa, iters=20, warmup=3):.6f} ms")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "library_ms": lib_ms}


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


def profile_round(plan, state, label: str, top: int = 12):
    """One more round under ``torch.profiler``: the device's busy share of
    the round's wall time and the kernels that take the most device time.
    (Profiling slows the host side, so the busy share is a lower bound.)"""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plan.run_round(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
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
    print(f"[profile] {label}: round wall {wall_us / 1e3:.3f} ms under the "
          f"profiler, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}%)")
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
    profile_round(lm, lm_state, "lm")
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
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    max_err = check_quant_kernel(dev)
    flash_err = check_flash_kernel(dev)
    time_quant_kernel(dev)
    timing = time_quant_kernel(dev, LM_M, LM_D)
    flash_timing = time_flash_kernel(dev)

    import repro_torch.api as api
    from repro_torch.kernels.quant.int8 import quant_dequant_int8

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
    profile_round(sl, sl_state, "sl")
    check_against_cpu(api)

    fl = api.compile_experiment(main_spec(api, "fl", rounds=1))
    fl_state, fl_recs = run_plan(fl, "fl")
    profile_round(fl, fl_state, "fl")
    sl_client = sl_recs[0].client_energy_j
    fl_client = fl_recs[0].client_energy_j
    print(f"[fl] client energy per round: SL {sl_client:.6g} J < "
          f"FL {fl_client:.6g} J")
    if not sl_client < fl_client:
        raise AssertionError("SL client energy is not below FL's")

    lm_launches = run_lm_path(api)

    # launches: the counts over the split-LM path's run, the path both
    # kernels are on (the CNN path's int8 count is checked above)
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
                "library_ms": flash_timing["library_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
