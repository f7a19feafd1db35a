"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``); TF32 off for convs
   and matmuls, so float32 means float32;
2. build every CUDA kernel of the port from ``src/repro_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, bit for bit
   (NaN positions included), over the shapes of the sweep;
4. each kernel's time at the main path's shape, beside its plain version's
   time and its bound;
5. the main path: ``sl/scan`` (Algorithm 3) on MobileNetV2 at 224x224,
   4 clients, batch 16, 2 local steps, 2 rounds, int8 link on the fused
   kernel, UAV mission; with the kernel's launch count over exactly that
   run, one more round under the profiler (device busy share and the
   kernels that take the device's time), and a tinycnn run on the card held
   against the same run on the CPU;
6. ``fl/scan`` on the same spec for one round (and one profiled): SL's
   client energy per round must be below FL's;
7. one JSON line listing the kernels, then the card, then the result line.

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
SWEEP_M = (1, 7, 509, 2048, 12544)
SWEEP_D = (8, 16, 32, 256)
MAIN_M, MAIN_D = 12544, 32         # MobileNetV2 cut at batch 16, 224x224


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


def time_quant_kernel(dev) -> dict:
    from repro_torch.kernels.quant.int8 import (quant_dequant_int8,
                                                quant_dequant_int8_plain)
    x = torch.randn(MAIN_M, MAIN_D, device=dev)
    kernel = lambda: quant_dequant_int8(x)            # noqa: E731
    plain = lambda: quant_dequant_int8_plain(x)       # noqa: E731
    # in turns: kernel, plain, plain, kernel; each keeps its best
    k1, p1, p2, k2 = (device_ms(kernel), device_ms(plain), device_ms(plain),
                      device_ms(kernel))
    kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
    bound_ms = 2 * MAIN_M * MAIN_D * 4 / HBM_BYTES_PER_S * 1e3
    print(f"[time] quant_dequant_int8 M={MAIN_M} D={MAIN_D} f32, device "
          f"time per call (CUDA graph): kernel {kernel_ms:.6f} ms "
          f"({k1:.6f}, {k2:.6f}), plain {plain_ms:.6f} ms ({p1:.6f}, "
          f"{p2:.6f}), bound {bound_ms:.6f} ms (bytes)")
    print(f"[time] quant_dequant_int8 eager per call (host dispatch "
          f"included): kernel {time_ms(kernel):.6f} ms, plain "
          f"{time_ms(plain):.6f} ms")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    dev = torch.device("cuda")

    from repro_torch.kernels.build import build_all
    t0 = time.perf_counter()
    logs = build_all()
    print(f"[setup] built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    max_err = check_quant_kernel(dev)
    timing = time_quant_kernel(dev)

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
    print(f"[sl] quant_dequant_int8 launches: {launches} (want {want})")
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

    kernels = [{"name": "quant_dequant_int8", "route": "cuda",
                "source": "src/repro_torch/csrc/quant_int8.cu",
                "replaces": "src/repro/kernels/quant/int8.py:40",
                "launches": launches, "max_abs_err": max_err,
                "ms": timing["ms"], "plain_ms": timing["plain_ms"],
                "bound_ms": timing["bound_ms"], "bound_by": "bytes",
                "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
