"""Where the rwkv6-7b loss rise comes from: the port's trainer on the card
at full width over a few depths, token counts and parameter dtypes.

    python tests/rwkv_loss_rise_probe.py

Not collected by pytest (it needs a CUDA card and about 45 GB of device
memory). ``chip_smoke.py`` trains rwkv6-7b (d 4096, 64 heads of 64, d_ff
14336, vocab 65,536) cut to 4 layers on 4 x 1024 tokens with AdamW at lr
3e-4, and its loss about doubles after the first step. This script runs
``repro_torch.launch.train.train`` from the same seed on that setting,
then on it in float32 (is it bf16 rounding?), with 2 layers (depth?), on
4 x 256 tokens (batch size?), at lr 3e-5, and with the WKV forward's y
scaled by 1 + 2^-20 (how far does a change of y's rounding, as from
another order of its sums, move the losses?), and prints each setting's
losses on one line. It imports neither jax nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import rwkv6_7b                     # noqa: E402
from repro_torch.kernels.rwkv import ops                     # noqa: E402
from repro_torch.launch.train import train                   # noqa: E402

STEPS, LR = 3, 3e-4                # chip_smoke.py's run
NUDGE = 1.0 + 2.0 ** -20           # y's relative change in the last setting
# (label, layers, batch, seq, dtype, lr factor, y scaled by NUDGE)
SETTINGS = (("chip_smoke's", 4, 4, 1024, "bfloat16", 1.0, False),
            ("float32", 4, 4, 1024, "float32", 1.0, False),
            ("2 layers", 2, 4, 1024, "bfloat16", 1.0, False),
            ("4 x 256 tokens", 4, 4, 256, "bfloat16", 1.0, False),
            ("lr / 10", 4, 4, 1024, "bfloat16", 0.1, False),
            ("WKV y x (1 + 2^-20)", 4, 4, 1024, "bfloat16", 1.0, True))


def nudged(scan):
    """``scan`` with its y (the first output) scaled by ``NUDGE``."""
    def call(*args, **kwargs):
        out = scan(*args, **kwargs)
        if isinstance(out, tuple):
            return (out[0] * NUDGE,) + out[1:]
        return out * NUDGE
    return call


def main():
    if not torch.cuda.is_available():
        sys.exit("rwkv_loss_rise_probe: needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    scan = ops.rwkv6_scan
    for label, layers, batch, seq, dtype, lr_factor, nudge in SETTINGS:
        cfg = dataclasses.replace(rwkv6_7b, n_layers=layers, dtype=dtype)
        lr = LR * lr_factor
        ops.rwkv6_scan = nudged(scan) if nudge else scan
        losses = train(cfg, steps=STEPS, batch=batch, seq=seq, lr=lr,
                       client_fraction=0.15, device=dev, log_every=1,
                       generator=torch.Generator(device=dev).manual_seed(0))
        ops.rwkv6_scan = scan
        print(f"[probe] {label}: {layers} layers, batch {batch} x {seq}, "
              f"{dtype}, lr {lr:g}: losses {losses}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
