"""rwkv6-7b at its published width: the port's trainer step against the
reference's, on the CPU, over a few steps.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/rwkv_full_width_witness.py \
        [--layers 2] [--batch 2] [--seq 32] [--tokens synthetic|uniform] \
        [--grads]

Not collected by pytest: at 2 layers it holds two copies of a
0.70e9-parameter model and the AdamW moments of one (a peak of 15.5 GB of
host memory on 2 x 32 tokens, 21.8 GB on 4 x 256) and takes minutes.

Both sides start from the reference's ``model_init`` weights (bf16, d
4096, 64 heads of 64, d_ff 14336, vocab 65,536, depth cut to
``--layers``), see the same tokens
(by default the port trainer's skewed ``synthetic_tokens``, the data of
``chip_smoke.py``'s run), and take the reference trainer's step
(``repro/launch/train.py``: value_and_grad of ``lm_loss``,
``clip_by_global_norm(1.0)``, ``adamw(lr, weight_decay=0.01)``). It
prints each step's loss and gradient norm on both sides and their
differences, so a loss that rises after the first AdamW step can be told
apart from a fault of the port: a fault shows as a gap between the two
columns, the optimizer's own overshoot in both alike. ``--grads`` instead
holds the step-0 gradient of each side, in bf16 and in f32, against the
reference's f32 gradient, which tells bf16 rounding from a fault of
either side.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import os
import sys
import time

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import repro.configs as ref_configs                          # noqa: E402
from repro.models.transformer import default_cut_layer as ref_cut  # noqa: E402
from repro.models.transformer import lm_loss as ref_lm_loss  # noqa: E402
from repro.models.transformer import model_init as ref_model_init  # noqa: E402
from repro.optim import adamw, apply_updates, clip_by_global_norm  # noqa: E402
import repro_torch.configs as configs                        # noqa: E402
from repro_torch.convert import model_from_reference         # noqa: E402
from repro_torch.data.synthetic import synthetic_tokens      # noqa: E402
from repro_torch.launch.train import train_step              # noqa: E402
from repro_torch.models.transformer import lm_loss           # noqa: E402
from repro_torch.optim import AdamW                          # noqa: E402

# the reference trainer's recipe: 3 steps at its default lr, seed 0
STEPS, LR, SEED = 3, 3e-4, 0


def _gradients(dtype, layers, tokens, seed):
    """Step-0 loss and gradients of reference and port (each as the port's
    state dict, f32) at ``dtype``, from the reference's weights."""
    cfg = dataclasses.replace(configs.rwkv6_7b, n_layers=layers, dtype=dtype)
    ref = dataclasses.replace(ref_configs.rwkv6_7b, n_layers=layers,
                              dtype=dtype)
    cut = ref_cut(ref, 0.15)
    params = ref_model_init(ref, jax.random.PRNGKey(seed), cut_layer=cut)
    batch = {"tokens": tokens, "labels": tokens}
    (ref_loss, _), grads = jax.value_and_grad(
        lambda p: ref_lm_loss(ref, p, batch, cut_layer=cut),
        has_aux=True)(params)
    ref_g = {k: v.float() for k, v in model_from_reference(
        jax.tree_util.tree_map(np.asarray, grads), cfg, cut
    ).state_dict().items()}
    del grads
    model = model_from_reference(jax.tree_util.tree_map(np.asarray, params),
                                 cfg, cut)
    del params
    tb = torch.from_numpy(tokens)
    loss, _ = lm_loss(cfg, model, {"tokens": tb, "labels": tb},
                      cut_layer=cut)
    loss.backward()
    port_g = {k: p.grad.float() for k, p in model.named_parameters()}
    return float(ref_loss), ref_g, float(loss.detach()), port_g


def compare_gradients(args, tokens):
    """The step-0 gradient of both sides in bf16 and in f32, each held
    against the reference's f32 gradient: relative error per leaf and over
    the whole gradient."""
    ref32_loss, truth, port32_loss, port32 = _gradients(
        "float32", args.layers, tokens, SEED)
    ref16_loss, ref16, port16_loss, port16 = _gradients(
        "bfloat16", args.layers, tokens, SEED)
    print(f"[witness] step-0 loss: float32 reference {ref32_loss:.6f} port "
          f"{port32_loss:.6f}; bfloat16 reference {ref16_loss:.6f} port "
          f"{port16_loss:.6f}")
    sums = dict.fromkeys(("port f32", "reference bf16", "port bf16",
                          "f32"), 0.0)
    for key, t in truth.items():
        errs = {name: float((g[key] - t).norm())
                for name, g in (("port f32", port32),
                                ("reference bf16", ref16),
                                ("port bf16", port16))}
        for name, e in errs.items():
            sums[name] += e * e
        norm = float(t.norm())
        sums["f32"] += norm * norm
        print(f"[witness] {key:30s} |g| {norm:10.5f}; relative error "
              f"against the f32 reference: " + ", ".join(
                  f"{name} {e / max(norm, 1e-30):.3e}"
                  for name, e in errs.items()))
    print("[witness] whole gradient, relative error against the f32 "
          "reference: " + ", ".join(
              f"{name} {(sums[name] / sums['f32']) ** 0.5:.4e}"
              for name in ("port f32", "reference bf16", "port bf16")))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--tokens", choices=("synthetic", "uniform"),
                    default="synthetic",
                    help="the trainer's skewed synthetic tokens (the "
                         "data of chip_smoke.py's run), or uniform ids")
    ap.add_argument("--grads", action="store_true",
                    help="compare the step-0 gradients in bf16 and f32 "
                         "instead of training")
    args = ap.parse_args(argv)
    vocab = configs.rwkv6_7b.vocab
    if args.tokens == "synthetic":      # the port trainer's data, per step
        batches = [synthetic_tokens(np.random.default_rng([SEED, step]),
                                    args.batch, args.seq, vocab)
                   for step in range(STEPS)]
    else:
        rng = np.random.default_rng(SEED)
        batches = [rng.integers(0, vocab, size=(args.batch, args.seq),
                                dtype=np.int32) for _ in range(STEPS)]
    if args.grads:
        return compare_gradients(args, batches[0])

    cfg = dataclasses.replace(configs.rwkv6_7b, n_layers=args.layers)
    ref = dataclasses.replace(ref_configs.rwkv6_7b, n_layers=args.layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    cut = ref_cut(ref, 0.15)
    print(f"[witness] {cfg.name} d {cfg.d_model}, {cfg.d_model // cfg.hd} "
          f"heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; {cfg.n_layers} layers, cut {cut}; batch "
          f"{args.batch} x {args.seq} {args.tokens} tokens, lr {LR}, "
          f"{STEPS} steps", flush=True)

    params = ref_model_init(ref, jax.random.PRNGKey(SEED),
                            cut_layer=cut)
    model = model_from_reference(jax.tree_util.tree_map(np.asarray, params),
                                 cfg, cut)

    # the reference trainer's step, as repro/launch/train.py jits it (its
    # inputs donated here, which changes no value and halves the memory)
    opt = adamw(LR, weight_decay=0.01)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def ref_step(params, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: ref_lm_loss(ref, p, batch, cut_layer=cut),
            has_aux=True)(params)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss, gnorm

    ref_rows = []
    opt_state = opt.init(params)
    for step, tokens in enumerate(batches):
        t0 = time.perf_counter()
        params, opt_state, loss, gnorm = ref_step(
            params, opt_state, {"tokens": tokens, "labels": tokens})
        ref_rows.append((float(loss), float(gnorm)))
        print(f"[witness] reference step {step}: loss {ref_rows[-1][0]:.6f} "
              f"gnorm {ref_rows[-1][1]:.6f} ({time.perf_counter() - t0:.1f} "
              f"s)", flush=True)
    del params, opt_state, ref_step
    gc.collect()

    port_rows = []
    popt = AdamW(model.parameters(), LR, weight_decay=0.01)
    for step, tokens in enumerate(batches):
        t0 = time.perf_counter()
        tb = torch.from_numpy(tokens)
        loss, gnorm = train_step(cfg, model, popt,
                                 {"tokens": tb, "labels": tb}, cut_layer=cut)
        port_rows.append((float(loss), float(gnorm)))
        print(f"[witness] port step {step}: loss {port_rows[-1][0]:.6f} "
              f"gnorm {port_rows[-1][1]:.6f} ({time.perf_counter() - t0:.1f} "
              f"s)", flush=True)

    for step, ((rl, rg), (pl, pg)) in enumerate(zip(ref_rows, port_rows)):
        print(f"[witness] step {step}: loss reference {rl:.6f} port {pl:.6f} "
              f"|diff| {abs(rl - pl):.6f}; gnorm reference {rg:.6f} port "
              f"{pg:.6f} |diff| {abs(rg - pg):.6f}")


if __name__ == "__main__":
    main()
