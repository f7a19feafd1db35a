#!/usr/bin/env python
"""repro_torch_lint: the port's static-analysis gate (counterpart of
``tools/repro_lint.py``).

    PYTHONPATH=src python tools/repro_torch_lint.py --ast --audit
    PYTHONPATH=src python tools/repro_torch_lint.py --ast --paths src/repro_torch/sim
    PYTHONPATH=src python tools/repro_torch_lint.py --audit --variant sl/vmap
    PYTHONPATH=src python tools/repro_torch_lint.py --ast --json results/lint.json

Two passes (``src/repro_torch/analyze``):

* ``--audit``: compile the engine-variant matrix (fl/sl x scan/vmap/
  shard_map, dropout, population cohorts, the flash and fused int8 kernels,
  the metrics twins, the Monte-Carlo seed-axis rounds) on ``--device`` and
  run one raw round of each under the runtime audit: host syncs, float64
  tensors, collectives off the plan's group, kernel calls and launches
  against the engine's design; plus the environment stream registry.
* ``--ast``: lint the source tree for the port's hazards (branches on a
  vmapped function's parameters, raw timers, constants rebuilt in loops,
  bare excepts, labels crossing the link, host syncs in vmapped functions
  and round and step bodies).

The reference's ``--jaxpr`` has no meaning here: there is no jaxpr. Exit
status: 0 iff zero findings. ``--json PATH`` also writes the findings
report.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch_lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--audit", action="store_true",
                    help="pass 1: runtime audit of the compiled variant "
                         "matrix")
    ap.add_argument("--ast", action="store_true",
                    help="pass 2: stdlib-ast lint over --paths")
    ap.add_argument("--paths", nargs="*", default=["src/repro_torch"],
                    help="files/dirs for --ast (default: src/repro_torch)")
    ap.add_argument("--variant", default=None,
                    help="audit only variants whose name contains this "
                         "substring (e.g. 'sl/vmap', 'mc/')")
    ap.add_argument("--no-mc", action="store_true",
                    help="skip the Monte-Carlo rollout audits")
    ap.add_argument("--device", default="auto",
                    help="the device the audited plans run on: cuda, cpu "
                         "(the kernels' plain versions) or auto (default: "
                         "cuda where there is a card, else cpu)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the findings report as JSON")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print findings only, no per-check progress")
    args = ap.parse_args(argv)
    if not (args.audit or args.ast):
        ap.error("nothing to do: pass --audit and/or --ast")

    from repro_torch.analyze import Report, audit_all, lint_paths
    combined = Report()

    if args.ast:
        report = lint_paths([REPO_ROOT / p for p in args.paths],
                            repo_root=REPO_ROOT)
        if not args.quiet:
            print(f"[ast]   linted {len(report.checked)} files: "
                  f"{len(report.findings)} finding(s)")
        combined.extend(report)

    if args.audit:
        import torch
        device = args.device
        if device == "auto":
            device = "cuda" if torch.cuda.is_available() else "cpu"
        if not args.quiet:
            print(f"[audit] device {device}"
                  + (f" ({torch.cuda.get_device_name(0)})"
                     if device.startswith("cuda") else ""))

        def progress(name, report):
            if not args.quiet:
                for line in report.checked:
                    print(f"[audit] {line}")
        combined.extend(audit_all(mc=not args.no_mc, match=args.variant,
                                  device=device, on_entry=progress))

    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(combined.to_dict(), indent=2) + "\n")
        if not args.quiet:
            print(f"[lint]  report -> {out}")

    for f in combined.findings:
        print(f)
    n = len(combined.findings)
    print(f"[lint]  {n} finding(s) across {len(combined.checked)} "
          f"checked target(s)")
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
