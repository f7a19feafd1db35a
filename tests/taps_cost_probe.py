"""What the metrics bus costs an engine round, tap by tap, on the card.

Not collected by pytest; run on the card from the repository root:

    python tests/taps_cost_probe.py

MobileNetV2 on ``sl/vmap`` (``chip_smoke.main_spec``, dropout 0.25, one
client masked): ``Plan.raw_round`` timed with ``obs.timeline.time_fenced``
(3 back to back, after a warm-up call), 3 times in turns, without taps and
with four tap selections; then one raw round with the full tap set under
``torch.profiler``: the device's busy time, the kernel launches and the
operators by host time.
"""
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.obs import MetricsConfig, ObsConfig  # noqa: E402
from repro_torch.obs.timeline import time_fenced  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(cs.card_line())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    spec = cs.main_spec(api, "sl", 2, client_axis="vmap", dropout_rate=0.25)
    variants = {
        "off": None,
        # statistics of the smashed tensor alone: no per-client backward
        "smashed": MetricsConfig(taps=("smashed", "quant_error"),
                                 nan_guard=False),
        # with a client masked, its update row needs its own gradient
        "update_norms": MetricsConfig(taps=("update_norms",),
                                      nan_guard=False),
        "grad_norms": MetricsConfig(taps=("grad_norms",), nan_guard=False),
        "nan_guard": MetricsConfig(taps=(), nan_guard=True),
        "full": MetricsConfig(),
    }
    plans = {name: api.compile_experiment(spec, obs=None if cfg is None
                                          else ObsConfig(enabled=False,
                                                         metrics=cfg))
             for name, cfg in variants.items()}
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device="cuda")
    times = {name: [] for name in plans}
    for _ in range(3):
        for name, plan in plans.items():
            st = plan.init()
            batches = plan.round_batches(st)
            plan.raw_round(st.engine_state, batches, mask)
            times[name].append(time_fenced(
                lambda: plan.raw_round(st.engine_state, batches, mask),
                repeats=3) / 3)
    for name, t in times.items():
        print(f"[taps-cost] {name}: raw_round {[round(x, 4) for x in t]} s")
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    for name in ("off", "full"):
        plan = plans[name]
        st = plan.init()
        batches = plan.round_batches(st)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA,
                                 ProfilerActivity.CPU]) as prof:
            plan.raw_round(st.engine_state, batches, mask)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        busy = sum(e.self_device_time_total for e in ka
                   if e.device_type == cuda)
        launches = sum(e.count for e in ka if e.device_type == cuda)
        print(f"[taps-cost] {name}: device busy {busy / 1e3:.3f} ms, "
              f"{launches} kernels, in one profiled raw round")
        print(ka.table(sort_by="cpu_time_total", row_limit=12))

if __name__ == "__main__":
    main()
