"""SmolLM-135M at its published width: the port's split-LM round against the
reference's, on the CPU, from the same parameters and tokens.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lm_full_width_witness.py \
        [--seq 64] [--clients 4] [--batch 4] [--rounds 2] [--lr 1e-3]

Not collected by pytest: it compiles and runs two 30-layer models (about
a minute of compile for the reference, a few GB of host memory).

Both sides run ``sl/scan`` as ``chip_smoke.py``'s split-LM phase does
(SmolLM-135M: 30 layers, d 576, 9/3 heads of 64, vocab 49,152, bf16 block
params; cut 0.25, int8 link, 2 local steps a client, the spec's default
lr), with shorter sequences and fewer of them: the reference's plan makes
the token data and the initial parameters, and the port's plan takes both
(``convert.lm_from_reference``). The attention is the plain chunked path
on both sides (``attn_impl="xla"``) and the link the two-op int8 round trip
(``link_kernel="xla"``), which the kernels equal (``tests/test_torch_*``).
It prints each round's record on both sides, so a loss that rises on the
card can be told apart from a fault of the port: a fault shows as a gap
between the two streams, the recipe's own rise in both alike.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import repro.api as R                                        # noqa: E402
from repro.configs import smollm_135m as ref_smollm          # noqa: E402
import repro_torch.api as T                                  # noqa: E402
from repro_torch.configs import smollm_135m                  # noqa: E402
from repro_torch.convert import lm_from_reference            # noqa: E402


def spec(api, arch, args):
    return api.ExperimentSpec(
        model=api.ModelSpec(family="transformer", arch=arch,
                            attn_impl="xla"),
        data=api.DataSpec(kind="tokens", partition="iid", seq_len=args.seq,
                          n_train=args.clients * args.batch * 2,
                          n_test=args.batch),
        clients=api.ClientSpec(num_clients=args.clients),
        cut_policy=api.CutPolicy(fraction=0.25),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", client_axis="scan",
                              link_kernel="xla"),
        global_rounds=args.rounds, local_steps=2, batch_size=args.batch,
        lr=args.lr, seed=0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="the spec's default, as chip_smoke.py runs it")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    ref_plan = R.compile_experiment(spec(R, ref_smollm, args))
    data = (ref_plan.x_train, ref_plan.y_train, ref_plan.x_test,
            ref_plan.y_test)
    port_plan = T.compile_experiment(spec(T, smollm_135m, args), data=data,
                                     device="cpu")
    if port_plan.cut_of_client != ref_plan.cut_of_client:
        raise SystemExit(f"cuts differ: {port_plan.cut_of_client} vs "
                         f"{ref_plan.cut_of_client}")
    port_plan.params0 = lm_from_reference(
        *jax.tree_util.tree_map(np.asarray, ref_plan.params0), smollm_135m)
    print(f"[witness] {smollm_135m.name}: {smollm_135m.n_layers} layers, d "
          f"{smollm_135m.d_model}, vocab {smollm_135m.vocab}; cut "
          f"{port_plan.cut_of_client[0]}; {args.clients} clients x batch "
          f"{args.batch} x {args.seq} tokens, 2 local steps, lr {args.lr}, "
          f"{args.rounds} rounds (set up in {time.perf_counter() - t0:.1f} "
          f"s)", flush=True)
    rows = {}
    for name, plan in (("reference", ref_plan), ("port", port_plan)):
        t0 = time.perf_counter()
        _, recs = plan.run()
        rows[name] = [(float(r.loss), float(r.accuracy)) for r in recs]
        print(f"[witness] {name}: {len(recs)} rounds in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    for i, ((rl, ra), (pl, pa)) in enumerate(zip(rows["reference"],
                                                 rows["port"])):
        print(f"[witness] round {i}: loss reference {rl:.6f} port {pl:.6f} "
              f"|diff| {abs(rl - pl):.6f}; accuracy reference {ra:.6f} "
              f"port {pa:.6f}")


if __name__ == "__main__":
    main()
