"""Where the peak device memory of the ``[encdec]`` training paths goes.

Not collected by pytest; run on the card from the repository root:

    python tests/encdec_peak_probe.py [--paths lm train whisper] [--top 12]

Each path runs as ``chip_smoke.py``'s ``[encdec]`` phase runs it:

- ``lm``: pixtral-12b cut to 4 of its 40 layers as the split-LM plan on
  the flash kernel (``sl/scan``, 2 clients, batch 2 x 1024, 1 round, int8
  link); ``memory_allocated`` after the compile, after ``plan.init()`` and
  after the round, and the bytes of the engine's per-client and server
  modules, their gradients and their optimizer state, counted from the
  tensors;
- ``train``: the same 4 layers through ``launch.train.train`` (batch 2 x
  (1024 patch + 1024 text), 3 steps);
- ``whisper``: whisper-tiny through ``launch.train.train`` (batch 8 x 448
  over 1500 frames, 3 steps).

The caching allocator's history is recorded over each run
(``torch.cuda.memory._record_memory_history``, Python stacks). Replaying
it gives the blocks live at the peak, grouped by the innermost frame of
the port's code (or this probe's, or ``chip_smoke.py``'s) that allocated
them, with the innermost frame of all beside it (the torch function that
made the block: ``__deepcopy__``, ``_multi_tensor_adamw``, ``backward``).
The groups sum to ``torch.cuda.max_memory_allocated``.
"""
import argparse
import collections
import dataclasses
import gc
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

MAX_ENTRIES = 4_000_000
OWN = ("repro_torch", "chip_smoke", "encdec_peak_probe")


def gib(n: int) -> str:
    return f"{n / 2 ** 30:.3f} GiB"


def site(frames) -> tuple:
    """(the innermost frame of our code, the innermost frame of all)."""
    def name(f):
        path = f["filename"]
        for mark in ("repro_torch/", "site-packages/", "tests/"):
            if mark in path:
                path = path.split(mark, 1)[1]
        return f"{path}:{f['line']} {f['name']}"
    own = next((f for f in frames if any(o in f["filename"] for o in OWN)),
               None)
    return (name(own) if own else "(no frame of the port)",
            frames[0]["name"] if frames else "?")


def live_at_peak(trace) -> tuple:
    """Replay one device's alloc/free events: the peak of the live bytes
    and the live blocks then, as {(site, op): bytes}."""
    live, total, peak, at = {}, 0, 0, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            total += e["size"]
        elif e["action"] == "free_completed" and e["addr"] in live:
            total -= live.pop(e["addr"])
        if total > peak:
            peak, at = total, i
    blocks = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            blocks[e["addr"]] = e
        elif e["action"] == "free_completed":
            blocks.pop(e["addr"], None)
    groups = collections.Counter()
    for e in blocks.values():
        groups[site(e.get("frames", []))] += e["size"]
    last = site(trace[at].get("frames", [])) if at >= 0 else None
    return peak, groups, last


def recorded(label: str, fn, top: int):
    """Run ``fn`` with the allocator's history on and print the breakdown
    of its peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python",
        max_entries=MAX_ENTRIES)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    dev = torch.cuda.current_device()
    trace = snap["device_traces"][dev]
    peak = torch.cuda.max_memory_allocated()
    replayed, groups, last = live_at_peak(trace)
    print(f"[peak] {label}: max_memory_allocated {gib(peak)} ({peak} B), "
          f"{gib(base)} allocated before; replayed peak of the "
          f"{len(trace)} events {gib(replayed)}"
          + (" (the history wrapped: the breakdown is partial)"
             if len(trace) >= MAX_ENTRIES else "")
          + f"; the block that reached it: {last}")
    for (own, op), n in groups.most_common(top):
        print(f"[peak] {label}:   {gib(n):>11} {100 * n / replayed:5.1f}%  "
              f"{own}  <- {op}")
    rest = sum(n for _, n in groups.most_common()[top:])
    print(f"[peak] {label}:   {gib(rest):>11} {100 * rest / replayed:5.1f}%  "
          f"the other {max(0, len(groups) - top)} sites")


def tensor_bytes(tensors) -> int:
    seen, n = set(), 0
    for t in tensors:
        if torch.is_tensor(t) and t.is_cuda and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            n += t.numel() * t.element_size()
    return n


def module_bytes(m) -> dict:
    params = list(m.parameters())
    return {"params": tensor_bytes(params),
            "grads": tensor_bytes(p.grad for p in params)}


def opt_bytes(opt) -> int:
    return tensor_bytes(v for s in opt.state.values() for v in s.values())


def lm_path(top: int):
    import chip_smoke
    import repro_torch.api as api
    from repro_torch.api.plan import LM_EVAL_CHUNK
    from repro_torch.configs import pixtral_12b
    cfg = dataclasses.replace(pixtral_12b, n_layers=chip_smoke.PIXTRAL_LAYERS)
    spec = dataclasses.replace(
        chip_smoke.lm_spec(api, cfg, "pallas", n_train=16,
                           n_test=LM_EVAL_CHUNK, num_clients=2,
                           batch_size=2), global_rounds=1)
    held = {}

    def run():
        plan = api.compile_experiment(spec)
        torch.cuda.synchronize()
        marks = [("compile", torch.cuda.memory_allocated())]
        state = plan.init()
        torch.cuda.synchronize()
        marks.append(("init", torch.cuda.memory_allocated()))
        state, rec = plan.run_round(state)
        torch.cuda.synchronize()
        marks.append(("round", torch.cuda.memory_allocated()))
        print(f"[peak] lm: allocated after "
              + ", ".join(f"{k} {gib(v)}" for k, v in marks)
              + f"; round loss {rec.loss:.4f}")
        st = state.engine_state
        rows = {}
        for c, (m, o) in enumerate(zip(st.clients, st.client_opts)):
            rows[f"client {c}"] = {**module_bytes(m), "adamw": opt_bytes(o)}
        rows["server"] = {**module_bytes(st.server),
                          "adamw": opt_bytes(st.server_opt)}
        for k, v in rows.items():
            print(f"[peak] lm: {k}: "
                  + ", ".join(f"{a} {gib(b)}" for a, b in v.items()))
        held["plan"] = (plan, state)

    recorded("lm", run, top)
    held.clear()


def train_path(name: str, top: int):
    import chip_smoke
    from repro_torch.configs import pixtral_12b, whisper_tiny
    from repro_torch.launch.train import train
    if name == "train":
        cfg = dataclasses.replace(pixtral_12b,
                                  n_layers=chip_smoke.PIXTRAL_LAYERS)
        n = chip_smoke.PIXTRAL_TRAIN
    else:
        cfg, n = whisper_tiny, chip_smoke.WHISPER_TRAIN
    dev = torch.device("cuda")
    recorded(name, lambda: train(
        cfg, lr=3e-4, client_fraction=0.15, device=dev, log_every=1,
        generator=torch.Generator(device=dev).manual_seed(0), **n), top)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", nargs="+", default=["lm", "train", "whisper"],
                    choices=["lm", "train", "whisper"])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    import chip_smoke
    from repro_torch.kernels.build import build_all
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(chip_smoke.card_line())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    for path in args.paths:
        if path == "lm":
            lm_path(args.top)
        else:
            train_path(path, args.top)


if __name__ == "__main__":
    main()
