"""The MoE dispatch and combine, this tree against another checkout's, bit
for bit. On the card (not collected by pytest):

    python tests/moe_dispatch_bitequal_probe.py --other _archive/parent

Each tree runs in a process of its own (both packages are named
``repro_torch``) and writes its outputs to a ``.pt`` file, from the same
seeded weights and inputs: one deepseek-moe-16b MoE layer at its published
width (d 2048, 64 experts of 1408, top 6, 2 shared, bf16) over 4 x 256
tokens, ``dispatch_table``'s table and gate at the config's capacity 1.25
(where picks drop) and ``moe_apply``'s output and ``aux`` there and at a
capacity that drops nothing; and the reduced deepseek-moe-16b's ``lm_loss``
with every gradient, and ``generate``'s 4 greedy tokens and their logits.
Each call runs twice in each tree. The combine's f32 scatter-add
accumulates with atomics on the card, so the outputs are compared twice:
under ``torch.use_deterministic_algorithms(True)``, where they must hold
the same bits (the script exits non-zero if not), and under the default
algorithms, where the script prints whether each tree repeats its own bits
and how far the trees are apart.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = (4, 256)


def _run(dev) -> dict:
    from repro_torch.configs import deepseek_moe_16b as cfg
    from repro_torch.launch.serve import generate
    from repro_torch.models.moe import (MoE, _router, capacity_of,
                                        dispatch_table, moe_apply)
    from repro_torch.models.transformer import (default_cut_layer, lm_loss,
                                                model_init)
    e, k = cfg.n_experts, cfg.top_k
    with torch.device(dev):
        moe = MoE(cfg.d_model, e, cfg.moe_d_ff, k,
                  n_shared=cfg.n_shared_experts, dtype=torch.bfloat16)
    moe.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    b, s = TOKENS
    t = b * s
    x = torch.randn(b, s, cfg.d_model, device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev).manual_seed(1))
    res = {}
    with torch.no_grad():
        top_p, top_i, _ = _router(moe, x.reshape(t, -1), k)
        res["table, gate"] = list(dispatch_table(
            top_p, top_i, e, capacity_of(t, k, e, cfg.capacity_factor)))
        for factor in (cfg.capacity_factor, e / k):
            res[f"moe_apply at {factor:g}"] = list(
                moe_apply(moe, x, top_k=k, capacity_factor=factor))
    small = cfg.reduced()
    cut = default_cut_layer(small, 0.15)
    model = model_init(small, torch.Generator(device=dev).manual_seed(0),
                       cut_layer=cut, device=dev)
    tokens = torch.randint(0, small.vocab, (2, 16), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    loss, metrics = lm_loss(small, model, {"tokens": tokens,
                                           "labels": tokens}, cut_layer=cut)
    loss.backward()
    res["reduced lm_loss, aux, gradients"] = [
        loss.detach(), metrics["aux"].detach(),
        *(p.grad for p in model.parameters())]
    with torch.no_grad():
        res["reduced generate"] = list(generate(
            small, model, tokens[:, :8], 4, cut_layer=cut, keep_logits=True))
    torch.cuda.synchronize()
    return {key: [v.detach().cpu() for v in vs] for key, vs in res.items()}


def dump(src: str, out: str):
    """Run both modes twice with the package under ``src``; save them."""
    sys.path.insert(0, src)
    dev = torch.device("cuda")
    runs = {}
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic",
                                           warn_only=True)
        runs[mode] = [_run(dev) for _ in range(2)]
    torch.save(runs, out)


def _same(a: list, b: list) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.float().nan_to_num(0.0), y.float().nan_to_num(0.0))
        for x, y in zip(a, b))


def _gap(a: list, b: list) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="a checkout of the repo (holding src/) to compare")
    ap.add_argument("--dump", nargs=2, metavar=("SRC", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dump:
        dump(*args.dump)
        return 0
    if not torch.cuda.is_available():
        print("moe_dispatch_bitequal_probe: no CUDA device", file=sys.stderr)
        return 2
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        for root in (ROOT, os.path.abspath(args.other)):
            out = os.path.join(tmp, f"{len(outs)}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--other", root, "--dump",
                            os.path.join(root, "src"), out], check=True,
                           timeout=900)
            outs.append(torch.load(out))
    mine, other = outs
    bad = []
    for mode in ("default", "deterministic"):
        for key in mine[mode][0]:
            repeats = [_same(o[mode][0][key], o[mode][1][key])
                       for o in (mine, other)]
            equal = _same(mine[mode][0][key], other[mode][0][key])
            print(f"[moe-probe] {mode}: {key}: this tree == other "
                  f"{equal} (max gap {_gap(mine[mode][0][key], other[mode][0][key]):.3e}); "
                  f"each tree repeats its bits {repeats}")
            if mode == "deterministic" and not equal:
                bad.append(key)
            if mode == "default" and all(repeats) and not equal:
                bad.append(f"{key} (default)")
    print(f"[moe-probe] {'bit-equal' if not bad else f'differ: {bad}'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
