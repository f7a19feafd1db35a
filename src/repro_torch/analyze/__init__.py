"""``repro_torch.analyze``: static and runtime analysis of the port
(counterpart of ``repro.analyze``).

Two passes, one CLI (``tools/repro_torch_lint.py``):

* **Pass 1 (runtime audit, ``audit``)**: one raw round of every compiled
  engine variant and the Monte-Carlo seed-axis round, run under a
  ``TorchDispatchMode``: no host sync in the round, no float64 tensor, every
  collective on the plan's fleet group, each kernel seam's Function (and,
  on the card, its kernel) run as often as the engine's design says; and
  the environment stream registry (``sim/streams``) collision-free.
* **Pass 2 (AST lint, ``ast_lint``)**: the source hazards with a PyTorch
  meaning: branches on a vmapped function's parameters, raw timers,
  constants rebuilt in loops, bare excepts, labels crossing the link, and
  host syncs in vmapped functions and round and step bodies.
"""

from .ast_lint import NOT_PORTED, RULES, lint_file, lint_paths, lint_source
from .audit import (RoundAudit, audit_call, audit_keys, audit_mc,
                    audit_mc_round, audit_plan, audit_round,
                    example_round_args, expected_calls)
from .findings import Finding, Report
from .variants import (METRICS_TWINS, audit_all, compiled_variants,
                       mc_specs, variant_specs)

__all__ = [
    "Finding", "Report", "RULES", "NOT_PORTED",
    "lint_file", "lint_paths", "lint_source",
    "RoundAudit", "audit_call", "audit_round", "audit_plan",
    "audit_mc_round", "audit_mc", "audit_keys", "audit_all",
    "example_round_args", "expected_calls",
    "METRICS_TWINS", "variant_specs", "mc_specs", "compiled_variants",
]
