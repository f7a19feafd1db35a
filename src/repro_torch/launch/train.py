"""End-to-end trainer of the port: a transformer config split at a
client fraction, trained with AdamW on both tiers.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 50 --batch 8 --seq 128 --reduced

Counterpart of ``repro.launch.train``, with the reference's flags and
loop: ``default_cut_layer`` places the cut, ``model_init`` draws the
model, each step is ``lm_loss`` -> backward -> ``clip_by_global_norm(1.0)``
-> ``AdamW(lr, weight_decay=0.01)``, and an ``EnergyTracker`` bills each
step's fenced wall time. It runs on the card (``device="cuda"``, the CLI's
only device) unless a caller of ``train`` asks for the CPU. Where it
differs from the reference:

- the tokens come from the port's own ``synthetic_tokens`` with a numpy
  generator seeded by (the torch generator's seed, step), not threefry;
  the frontends' stand-ins (``patch_embeds`` (B, frontend_tokens, d) for
  pixtral-12b, ``frames`` (B, enc_seq_len, d) for whisper-tiny), 0.02 x a
  normal draw as in the reference, come from that generator too, after
  the tokens;
- each step's window is fenced with ``torch.cuda.synchronize()``;
- energy is billed at the card's power limit (``cuda_hardware_profile``),
  not at the reference's TPU v5e profile; a CPU run names its profile.

``--ckpt PATH`` (``train(ckpt=)``) saves the trained parameters after the
last step as the reference does: the reference's ``model_init`` tree
(``convert.model_to_reference``) with the meta ``{"arch", "steps",
"loss"}``, in its msgpack format (``checkpoint.save_checkpoint``), so
``repro.checkpoint.restore_checkpoint`` reads the file into its
``model_init`` tree and ``convert.model_from_reference`` of the restored
tree gives the port's model back.

Memory (bf16 weights and gradients and f32 AdamW moments: 12 bytes a
parameter; arithmetic from the configs, not a measurement):

- rwkv6-7b at its 32 layers needs about 87 GB, more than one 80 GB card
  holds (``launch.serve`` holds its 15 GB of bf16 weights alone and serves
  it whole). ``chip_smoke.py`` calls ``train`` on rwkv6-7b cut to 4
  layers, and on its reduced config, whose head size 256 the WKV kernels
  take (they take 16 to 256).
- deepseek-moe-16b has 16.11B parameters (32.2 GB in bf16): an MoE layer
  is 587.9M, the dense layer 0 25.4M, the tied embedding 209.7M. Whole, it
  needs ~193 GB to train; cut to 4 layers (layer 0 dense, 3 MoE; the cut
  at 1) it is 2.0B parameters, ~24 GB, and a step at batch 4 x 1024 does
  about 13.5 TFLOP with C = 480 slots an expert. ``chip_smoke.py`` trains
  it so.
- jamba-1.5-large-398b: one MoE sub-layer is 9.66B parameters (19.3 GB
  in bf16), one super-block 44.2B (88.3 GB, 82.3 GiB), more than the
  card holds, so no
  jamba model trains or serves at full width on one card; arctic-480b's
  MoE layer is 13.4B (26.8 GB). Both run as their reduced configs.
- pixtral-12b: a decoder layer is 285.7M parameters, the tied embedding
  671.1M (131,072 x 5120); whole (12.10B, 24.2 GB in bf16) it needs ~145
  GB to train. Cut to 4 layers it is 1.81B, ~22 GB; ``chip_smoke.py``
  trains it so at batch 2 x (1024 patch + 1024 text) positions, and serves
  it whole, text only.
- whisper-tiny (4 + 4 layers, d 384, 1500 frames) is 36.5M parameters,
  trained and served whole.

The step's log line adds the routers' auxiliary loss (``aux``) for an MoE
config.
"""
from __future__ import annotations

import argparse
import math
import subprocess
import time

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from ..configs import ARCHS
from ..configs.base import ArchConfig
from ..convert import model_to_reference
from ..core.energy import EnergyTracker, HardwareProfile
from ..obs.timeline import fenced
from ..data.synthetic import synthetic_tokens
from ..models.transformer import Model, default_cut_layer, lm_loss, model_init
from ..optim import AdamW, clip_by_global_norm


def cuda_hardware_profile(device=None) -> HardwareProfile:
    """The card as an energy profile: its name from
    ``torch.cuda.get_device_name``, its power from ``nvidia-smi``'s
    ``power.limit``; the rates from NVIDIA's H100 SXM data sheet (67 TFLOP/s
    FP32, 3.35 TB/s HBM3, 989 TFLOP/s dense bf16 tensor cores). The data
    sheet gives no CPU score or idle power: those are NaN, and the trainer
    bills time x power only."""
    index = torch.device("cuda" if device is None else device).index
    if index is None:
        index = torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
         "nounits", "-i", str(index)], capture_output=True, text=True,
        check=True, timeout=60)
    return HardwareProfile(torch.cuda.get_device_name(index),
                           fp32_tflops=67.0, mem_bw_gbs=3350.0,
                           tensor_tflops=989.0, cpu_passmark=math.nan,
                           power_w=float(out.stdout.strip().splitlines()[0]),
                           idle_power_w=math.nan)


def train_step(cfg: ArchConfig, model: Model, opt: AdamW, batch: dict, *,
               cut_layer: int, grads_out: list | None = None):
    """One step: the loss and its gradient, the global-norm clip at 1.0,
    then AdamW. Returns (loss, gnorm, {"ce", "aux"}) as detached 0-d
    tensors on the model's device. With ``grads_out`` (a list) a copy of
    each parameter's gradient before the clip is appended to it, in
    ``model.parameters()``'s order."""
    opt.zero_grad(set_to_none=True)
    loss, metrics = lm_loss(cfg, model, batch, cut_layer=cut_layer)
    loss.backward()
    if grads_out is not None:
        grads_out.extend(p.grad.clone() for p in model.parameters())
    gnorm = clip_by_global_norm([p.grad for p in model.parameters()], 1.0)
    opt.step()
    return (loss.detach(), gnorm,
            {k: v.detach() for k, v in metrics.items()})


def step_batch(cfg: ArchConfig, rng: np.random.Generator, batch: int,
               seq: int, device) -> dict:
    """One step's batch on ``device``: ``batch`` x ``seq`` synthetic tokens
    (``tokens`` and ``labels``), then from the same ``rng`` the frontend's
    f32 stand-ins, 0.02 x N(0, 1): ``patch_embeds`` (batch,
    frontend_tokens, d) for a ``patch_embed`` config, ``frames`` (batch,
    enc_seq_len, d) for an enc-dec one."""
    tokens = torch.from_numpy(synthetic_tokens(rng, batch, seq, cfg.vocab))
    out = {"tokens": tokens, "labels": tokens}
    if cfg.frontend == "patch_embed":
        out["patch_embeds"] = torch.from_numpy(0.02 * rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model), dtype=np.float32))
    if cfg.enc_dec:
        out["frames"] = torch.from_numpy(0.02 * rng.standard_normal(
            (batch, cfg.enc_seq_len, cfg.d_model), dtype=np.float32))
    return {k: v.to(device) for k, v in out.items()}


def train(cfg: ArchConfig, *, steps: int = 50, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, client_fraction: float = 0.15,
          device="cuda", generator: torch.Generator | None = None,
          log_every: int = 10,
          hardware: HardwareProfile | None = None,
          ckpt: str | None = None,
          model_out: list | None = None) -> list[float]:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` synthetic
    tokens and return the losses. The model is drawn from ``generator``
    (default: seed 0 on ``device``) on the generator's device and moved to
    ``device``. ``hardware`` is the energy profile; it defaults to the card
    on CUDA and must be given on the CPU. With ``ckpt`` the parameters are
    saved there after the last step (the module docstring); with
    ``model_out`` (a list) the trained model is appended to it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train(device='cuda') needs a CUDA device; pass "
                           "device='cpu' to run on the CPU")
    if hardware is None:
        if device.type != "cuda":
            raise ValueError("on the CPU, pass hardware=HardwareProfile(...) "
                             "to bill energy at a stated device's power")
        hardware = cuda_hardware_profile(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cut = default_cut_layer(cfg, client_fraction)
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} cut={cut} "
          f"(client fraction {client_fraction})")
    model = model_init(cfg, generator, cut_layer=cut, device=device)
    opt = AdamW(model.parameters(), lr, weight_decay=0.01)
    tracker = EnergyTracker(hardware)
    seed = generator.initial_seed()
    losses = []
    # the log line's running time since the first step: a progress
    # stamp; each step's own window is fenced below
    t0 = time.perf_counter()  # repro: ignore[raw-timer] -- progress stamp for the log line, not a measurement
    for step in range(steps):
        # the step window: the batch is on the device (fenced) before it
        # opens, and it closes on the step's fenced outputs
        data, _ = fenced(lambda: step_batch(
            cfg, np.random.default_rng([seed, step]), batch, seq, device))
        (loss, gnorm, metrics), dt = fenced(lambda: train_step(
            cfg, model, opt, data, cut_layer=cut))
        tracker.track_time(f"step{step}", dt)
        losses.append(float(loss))
        if step % log_every == 0 or step == steps - 1:
            aux = (f" aux {float(metrics['aux']):.4f}" if cfg.n_experts
                   else "")
            since = time.perf_counter() - t0  # repro: ignore[raw-timer] -- progress stamp for the log line, not a measurement
            print(f"[train] step {step:4d} loss {losses[-1]:.4f}{aux} gnorm "
                  f"{float(gnorm):.3f} ({since:.1f}s; step {dt:.4f}s)")
    tot = tracker.total()
    print(f"[train] done: final loss {losses[-1]:.4f} (first {losses[0]:.4f})"
          f" wall {tot.time_s:.1f}s energy~{tot.energy_j / 1e3:.2f}kJ "
          f"co2~{tot.co2_g:.3f}g (billed at {hardware.name}, "
          f"{hardware.power_w:g} W)")
    if ckpt:
        save_checkpoint(ckpt, model_to_reference(model, cfg),
                        meta={"arch": cfg.name, "steps": steps,
                              "loss": losses[-1]})
        print(f"[train] checkpoint -> {ckpt}")
    if model_out is not None:
        model_out.append(model)
    return losses


def main(argv=None, **overrides):
    """The CLI; ``overrides`` go to ``train`` as they are (a caller's
    ``device="cpu"`` and ``hardware=``, say)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--client-fraction", type=float, default=0.15)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduced config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    kw = dict(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
              client_fraction=args.client_fraction,
              log_every=args.log_every, ckpt=args.ckpt)
    return train(cfg, **{**kw, **overrides})


if __name__ == "__main__":
    main()
