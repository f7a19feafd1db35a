"""The WKV kernels without a carried state, this tree against another
checkout's, bit for bit. On the card (not collected by pytest):

    python tests/wkv_null_state_bitequal_probe.py --other _archive/parent

Each tree runs in a process of its own (both packages are named
``repro_torch``), builds its kernels into its own ``src/repro_torch/_build``
and writes its outputs to a ``.pt`` file: the forward (y, S_T and the
backward's checkpoints) at the rwkv6-7b training shape (4, 64, 1024, 64) and
at the reduced rwkv6-7b's (2, 1, 64, 256) (the column-split kernel), and the
backward's five gradients at (4, 64, 1024, 64), with and without a cotangent
of S_T, all from the same seeded inputs. The two files must hold the same
bits; the script exits non-zero if they do not.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_SHAPES = ((4, 64, 1024, 64), (2, 1, 64, 256))
BWD_SHAPE = (4, 64, 1024, 64)


def dump(src: str, out: str):
    """Run the kernels of the package under ``src`` and save the outputs."""
    sys.path.insert(0, src)
    from repro_torch.kernels.rwkv.scan import rwkv6_scan, rwkv6_scan_bwd
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for shape in FWD_SHAPES:
        b, h, _, hd = shape
        r, k, v = (0.5 * torch.randn(shape, device=dev, generator=g)
                   for _ in range(3))
        w = torch.sigmoid(torch.randn(shape, device=dev, generator=g))
        u = 0.3 * torch.randn(h, hd, device=dev, generator=g)
        y, st, ck = rwkv6_scan(r, k, v, w, u, return_state=True,
                               checkpoints=True)
        res[f"fwd{shape}"] = [y, st, ck, *rwkv6_scan(r, k, v, w, u,
                                                     return_state=True)]
        if shape == BWD_SHAPE:
            gy = torch.randn(shape, device=dev, generator=g)
            gs = torch.randn((b, h, hd, hd), device=dev, generator=g)
            res["bwd"] = list(rwkv6_scan_bwd(r, k, v, w, u, gy, None, ck))
            res["bwd with G_T"] = list(rwkv6_scan_bwd(r, k, v, w, u, gy, gs,
                                                      ck))
    torch.cuda.synchronize()
    torch.save({key: [t.cpu() for t in ts] for key, ts in res.items()}, out)


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
        print("wkv_null_state_bitequal_probe: no CUDA device", file=sys.stderr)
        return 2
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, root in (("this tree", ROOT),
                           ("other", os.path.abspath(args.other))):
            out = os.path.join(tmp, f"{len(outs)}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--other", root, "--dump",
                            os.path.join(root, "src"), out], check=True,
                           timeout=900)
            outs[name] = torch.load(out)
    mine, other = outs["this tree"], outs["other"]
    differ = [f"{key}[{i}]" for key in mine
              for i, (a, b) in enumerate(zip(mine[key], other[key]))
              if not torch.equal(a, b)]
    print(f"[bitequal] {torch.cuda.get_device_name(0)}: the WKV kernels with "
          f"no carried state, this tree vs {args.other}: "
          f"{sum(len(v) for v in mine.values())} outputs compared "
          f"({', '.join(mine)}); differing: {differ or 'none'}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
