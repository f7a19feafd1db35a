"""Which op makes the reference's bf16 RWKV gradient differ from the port's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/rwkv_bf16_grad_bisect.py \
        [--layers 2] [--batch 2] [--seq 32]

Not collected by pytest; run by hand, alone (a peak of about 16 GB of host
memory at its defaults, and a few minutes). It takes the step-0 setting of
``rwkv_full_width_witness.py --grads --tokens uniform``: rwkv6-7b at full
width cut to ``--layers``, the reference's weights, uniform token ids.

1. The op. In bfloat16, XLA on the CPU computes ``jax.nn.sigmoid`` as
   1 / (1 + exp(-x)) with each of exp, add and divide rounded to bf16 (the
   compiled HLO converts to bf16 after each); ``torch.sigmoid`` rounds the
   result once. The script checks that the three-rounding form in torch is
   bit-equal to the reference's sigmoid over a grid of inputs.
2. Its weight. It prints the whole-gradient error of the port's bf16
   gradient against the reference's f32 gradient with the port's sigmoid
   as it is and with the reference's form swapped in at the two places the
   RWKV block uses one: ``silu`` (the time mix's output gate) and the
   channel mix's receptance, alone and together, beside the reference's
   own bf16 error.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import rwkv_full_width_witness as witness                    # noqa: E402
import repro_torch.configs as configs                        # noqa: E402
import repro_torch.models.modules as M                       # noqa: E402
import repro_torch.models.ssm as ssm                         # noqa: E402
from repro.models.transformer import default_cut_layer as ref_cut  # noqa: E402
from repro.models.transformer import model_init as ref_model_init  # noqa: E402
import repro.configs as ref_configs                          # noqa: E402
from repro_torch.convert import model_from_reference         # noqa: E402
from repro_torch.models.transformer import lm_loss           # noqa: E402


def reference_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's bf16 logistic: exp, add and divide each rounded."""
    return 1 / (1 + torch.exp(-x))


def check_the_op():
    x = np.linspace(-12, 12, 200_001).astype(np.float32)
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(x).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for name, got in (("torch.sigmoid", torch.sigmoid(xt)),
                      ("1 / (1 + exp(-x)) in bf16", reference_sigmoid(xt))):
        got = got.float().numpy()
        print(f"[bisect] {name:26s} vs jax.nn.sigmoid in bf16 over "
              f"{x.size} points in [-12, 12]: bit-equal share "
              f"{np.mean(got == want):.4f}, max |diff| "
              f"{np.abs(got - want).max():.3e}")


class _Torch:
    """``torch`` as ``ssm`` sees it, with ``sigmoid`` swapped."""

    def __init__(self, sigmoid):
        self.sigmoid = sigmoid

    def __getattr__(self, name):
        return getattr(torch, name)


def port_bf16_gradient(params, cfg, cut, tokens, *, gate, receptance):
    """The port's step-0 bf16 gradient (f32 copies), with the reference's
    sigmoid in the time mix's gate and/or the channel mix's receptance."""
    silu, ssm_torch = M.silu, ssm.torch
    if gate:
        M.silu = lambda x: x * reference_sigmoid(x)
    if receptance:
        ssm.torch = _Torch(reference_sigmoid)
    try:
        model = model_from_reference(params, cfg, cut)
        tb = torch.from_numpy(tokens)
        loss, _ = lm_loss(cfg, model, {"tokens": tb, "labels": tb},
                          cut_layer=cut)
        loss.backward()
        return {k: p.grad.float() for k, p in model.named_parameters()}
    finally:
        M.silu, ssm.torch = silu, ssm_torch


def relative(grad, truth):
    num = sum(float((grad[k] - t).norm()) ** 2 for k, t in truth.items())
    den = sum(float(t.norm()) ** 2 for t in truth.values())
    return (num / den) ** 0.5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args(argv)
    check_the_op()
    tokens = np.random.default_rng(witness.SEED).integers(
        0, configs.rwkv6_7b.vocab, size=(args.batch, args.seq),
        dtype=np.int32)
    _, truth, _, _ = witness._gradients("float32", args.layers, tokens,
                                        witness.SEED)
    _, ref16, _, port16 = witness._gradients("bfloat16", args.layers, tokens,
                                             witness.SEED)
    print(f"[bisect] whole gradient, relative error against the f32 "
          f"reference: reference bf16 {relative(ref16, truth):.4e}, port "
          f"bf16 as it is {relative(port16, truth):.4e}")
    del ref16, port16
    cfg = dataclasses.replace(configs.rwkv6_7b, n_layers=args.layers,
                              dtype="bfloat16")
    ref = dataclasses.replace(ref_configs.rwkv6_7b, n_layers=args.layers,
                              dtype="bfloat16")
    cut = ref_cut(ref, 0.15)
    params = jax.tree_util.tree_map(np.asarray, ref_model_init(
        ref, jax.random.PRNGKey(witness.SEED), cut_layer=cut))
    for gate, receptance in ((True, False), (False, True), (True, True)):
        grad = port_bf16_gradient(params, cfg, cut, tokens, gate=gate,
                                  receptance=receptance)
        where = " and ".join(n for n, on in (("time-mix gate (silu)", gate),
                                             ("channel-mix receptance",
                                              receptance)) if on)
        u = sorted(k for k in grad if k.endswith("mix.u"))[-1]
        u_err = float((grad[u] - truth[u]).norm() / truth[u].norm())
        print(f"[bisect] port bf16 with the reference's sigmoid in the "
              f"{where}: {relative(grad, truth):.4e} (the last layer's "
              f"{u}: {u_err:.3e})")


if __name__ == "__main__":
    main()
