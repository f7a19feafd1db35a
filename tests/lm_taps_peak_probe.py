"""Peak device memory of SmolLM-135M on ``sl/vmap`` with the metrics bus.

Not collected by pytest; run on the card from the repository root:

    python tests/lm_taps_peak_probe.py [--batches 8 4 2] [--rounds 1]

For each batch size: one plan (``chip_smoke.lm_spec``: full width, 1024
tokens, 4 clients, int8 link on the fused kernel, flash attention), rounds
without evaluation, once without taps and once with
``ObsConfig(enabled=False, metrics=MetricsConfig())``; prints each run's
peak (``torch.cuda.max_memory_allocated``) or, when it runs out of device
memory, the peak reached and the allocation that failed. The per-client
gradients of the server tier (a batched backward over the clients) are
what the taps add.
"""
import argparse
import gc
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 4, 2])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import chip_smoke
    import repro_torch.api as api
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels.build import build_all
    from repro_torch.obs import MetricsConfig, ObsConfig
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(chip_smoke.card_line())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    for batch in args.batches:
        for taps in (False, True):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            obs = (ObsConfig(enabled=False, metrics=MetricsConfig())
                   if taps else None)
            label = f"batch {batch} taps {'on' if taps else 'off'}"
            try:
                plan = api.compile_experiment(chip_smoke.lm_spec(
                    api, smollm_135m, "pallas", client_axis="vmap",
                    batch_size=batch), obs=obs)
                state = plan.init()
                for _ in range(args.rounds):
                    state, rec = plan.run_round(state, with_eval=False)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                print(f"[lm-taps] {label}: fits, peak {peak / 2 ** 30:.2f} "
                      f"GiB ({peak} bytes), loss {rec.loss:.6f}"
                      + (f", grad_norm_server/mean "
                         f"{rec.metrics['grad_norm_server/mean']:.6g}"
                         if taps else ""))
            except torch.cuda.OutOfMemoryError as e:
                peak = torch.cuda.max_memory_allocated()
                first = str(e).splitlines()[0]
                print(f"[lm-taps] {label}: out of device memory, peak "
                      f"reached {peak / 2 ** 30:.2f} GiB ({peak} bytes); "
                      f"{first[:300]}")
            finally:
                plan = state = None


if __name__ == "__main__":
    main()
