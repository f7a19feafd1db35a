"""``repro_torch.obs.metrics`` — the in-round metrics bus every engine can
carry.

Counterpart of ``repro.obs.metrics``. Everything that decides
accuracy-per-joule — gradient magnitudes per tier, smashed-activation
statistics at the link, the int8 quantization error, per-client loss
spread under dropout — happens inside a round's loop over steps x clients.
This module adds an **off-by-default, fixed-shape** tap channel to the
round builders:

* taps are selected when the plan is compiled (``compile_experiment(spec,
  obs=ObsConfig(metrics=MetricsConfig(taps=...)))``); a plan compiled
  without a ``MetricsConfig`` runs the same tensor operations as a plan
  without telemetry;
* every tap value is a 0-d (or per-client) float32 tensor on the round's
  device, stacked beside the loss stack and pulled with it once a round —
  never read to the host inside the round;
* tap stacks are fixed-shape a round (leading step/client axes match the
  loss layout: SL ``(local_rounds, clients)``, FL ``(clients, steps)``;
  the one-update-a-step channels of the fleet engines are
  ``(local_rounds,)``), with a leading seed axis on a Monte-Carlo sweep's
  seed axis.

The host side (``summarize_round_metrics``, numpy, a copy of the
reference's pinned by ``tests/test_torch_copies.py``) reduces the raw tap
arrays to the flat JSON-able scalar dict surfaced as
``RoundRecord.metrics`` and streamed as the sink's ``metrics`` event; the
same reduction runs on a Monte-Carlo sweep's per-seed stacks, so seed 0 of
a sweep reproduces the plan's own metric stream.

Tap selection (``MetricsConfig.taps``) and what each computes:

=============  =============================================================
user tap       channel(s)
=============  =============================================================
grad_norms     ``grad_norm_client`` (+ ``grad_norm_server`` for SL): L2
               norm of each tier's gradient of ONE client's loss, per
               (step, client slot)
update_norms   ``update_norm_client`` / ``update_norm_server``: L2 norm of
               the optimizer's update ``(-lr * delta)`` in the parameter's
               dtype (server / EPSL-shared client updates are
               one-per-step scalars on the fleet engines)
smashed        ``smashed_mean`` / ``smashed_std`` / ``smashed_absmax``: the
               raw smashed activation entering the link boundary (SL only)
quant_error    ``quant_error``: RMS of (dequantized - raw) at the boundary
               — only with an int8 link
loss_spread    host-side only: std of per-client losses per step, averaged
               over the round's steps (from the loss stack)
mask           host-side only: active-slot tally + fraction of the round's
               client mask
=============  =============================================================

plus the training-health monitor (``nan_guard=True``): a per-(step, client)
``nonfinite`` flag — loss or either tier's gradient went NaN/inf — that the
host localizes to the FIRST bad (round, step, client slot).
``on_nonfinite="record"`` books it into ``RoundRecord.metrics`` under
``health/*``; ``"raise"`` raises :class:`NonfiniteError` carrying the
coordinate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["MetricsConfig", "NonfiniteError", "TAPS", "engine_tap_names",
           "split_step_tap_names", "step_taps", "tree_norm", "tree_nonfinite",
           "smashed_tap_values", "summarize_round_metrics",
           "first_nonfinite_coord"]

# the user-facing tap vocabulary (MetricsConfig.taps)
TAPS = ("grad_norms", "update_norms", "smashed", "quant_error",
        "loss_spread", "mask")


@dataclasses.dataclass(frozen=True)
class MetricsConfig:
    """Compile-time tap selection for the in-graph metrics bus.

    ``taps`` picks from :data:`TAPS`; inapplicable taps are skipped per
    engine (FL has no link boundary; ``quant_error`` needs an int8 link),
    never errors. ``nan_guard`` lowers the per-(step, client) nonfinite
    flag; ``on_nonfinite`` picks the host policy when it fires.
    """
    taps: Tuple[str, ...] = TAPS
    nan_guard: bool = True
    on_nonfinite: str = "record"     # "record" | "raise"

    def __post_init__(self):
        unknown = [t for t in self.taps if t not in TAPS]
        if unknown:
            raise ValueError(f"unknown metrics taps {unknown}; pick from "
                             f"{TAPS}")
        if self.on_nonfinite not in ("record", "raise"):
            raise ValueError(f"on_nonfinite must be 'record' or 'raise', "
                             f"got {self.on_nonfinite!r}")


class NonfiniteError(RuntimeError):
    """The health monitor found a NaN/inf and the plan was compiled with
    ``on_nonfinite="raise"``. Carries the first bad coordinate."""

    def __init__(self, *, round_index: int, step: int, client: int,
                 count: int):
        self.round_index = round_index
        self.step = step
        self.client = client
        self.count = count
        super().__init__(
            f"nonfinite loss/gradient first at round={round_index} "
            f"step={step} client_slot={client} ({count} flagged slot-steps "
            f"this round)")


def engine_tap_names(cfg: Optional[MetricsConfig], *, kind: str,
                     has_link: bool) -> Tuple[str, ...]:
    """The in-graph tap channels ``cfg`` lowers to for one engine.

    ``kind`` is the engine family ('fl' | 'sl'); ``has_link`` whether the
    plan's link boundary transforms the smashed tensor (int8). Empty tuple
    (metrics off, or nothing applicable) means the round builders emit the
    bit-identical tap-free program.
    """
    if cfg is None:
        return ()
    names = []
    if "grad_norms" in cfg.taps:
        names.append("grad_norm_client")
        if kind == "sl":
            names.append("grad_norm_server")
    if "update_norms" in cfg.taps:
        names.append("update_norm_client")
        if kind == "sl":
            names.append("update_norm_server")
    if kind == "sl" and "smashed" in cfg.taps:
        names += ["smashed_mean", "smashed_std", "smashed_absmax"]
    if kind == "sl" and has_link and "quant_error" in cfg.taps:
        names.append("quant_error")
    if cfg.nan_guard:
        names.append("nonfinite")
    return tuple(names)


def split_step_tap_names(names: Tuple[str, ...]) -> Tuple[str, ...]:
    """The subset of engine tap channels computed INSIDE ``SplitStep.
    loss_fn`` (they need the smashed tensor, which only exists there) —
    carried out through the step's aux dict."""
    return tuple(n for n in names
                 if n.startswith("smashed_") or n == "quant_error")


# ---------------------------------------------------------------------------
# in-round tap helpers (torch; every value a float32 tensor on the round's
# device, never read to the host here)
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    """The tensors of a tensor, dict, list or tuple (nested)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _reduce_rows(x: torch.Tensor, lead: int) -> torch.Tensor:
    """Sum over every axis of ``x`` after the first ``lead``."""
    dims = tuple(range(lead, x.dim()))
    return x.sum(dim=dims) if dims else x


def tree_norm(tree, lead: int = 0) -> torch.Tensor:
    """Global L2 norm of a tree's tensors, accumulated in float32; with
    ``lead`` the first ``lead`` axes (client, seed) are kept: one norm a
    row."""
    return torch.sqrt(sum(_reduce_rows(torch.square(x.float()), lead)
                          for x in _leaves(tree)))


def tree_nonfinite(tree, lead: int = 0) -> torch.Tensor:
    """1.0 where any element of the tree (of the row, with ``lead``) is
    NaN/inf, else 0.0."""
    bad = sum(_reduce_rows((~torch.isfinite(x.float())).float(), lead)
              for x in _leaves(tree))
    return (bad > 0).float()


@torch.no_grad()
def smashed_tap_values(names, smashed: torch.Tensor,
                       boundary_out: torch.Tensor) -> dict:
    """The ``SplitStep.loss_fn`` taps: statistics of the raw smashed
    activation entering the link, and the RMS quantization error the
    boundary introduced (``boundary_out`` is the post-boundary tensor —
    the same tensor when the link is transparent)."""
    out = {}
    flat = smashed.detach().float().reshape(-1)
    if "smashed_mean" in names:
        out["smashed_mean"] = flat.mean()
    if "smashed_std" in names:
        out["smashed_std"] = flat.std(correction=0)
    if "smashed_absmax" in names:
        out["smashed_absmax"] = flat.abs().max()
    if "quant_error" in names:
        err = boundary_out.detach().float().reshape(-1) - flat
        out["quant_error"] = torch.sqrt(torch.mean(torch.square(err)))
    return out


@torch.no_grad()
def step_taps(names, *, loss=None, aux_taps=None, g_c=None, g_s=None,
              up_c=None, up_s=None) -> dict:
    """One (step, client)'s tap dict from whatever the round body has in
    hand. Channels not in ``names`` cost nothing; channels whose source
    argument is None are skipped (e.g. no server tier in FL)."""
    out = {}
    if "grad_norm_client" in names and g_c is not None:
        out["grad_norm_client"] = tree_norm(g_c)
    if "grad_norm_server" in names and g_s is not None:
        out["grad_norm_server"] = tree_norm(g_s)
    if "update_norm_client" in names and up_c is not None:
        out["update_norm_client"] = tree_norm(up_c)
    if "update_norm_server" in names and up_s is not None:
        out["update_norm_server"] = tree_norm(up_s)
    if "nonfinite" in names:
        # an L2 norm is NaN/inf exactly when its source tree holds a
        # NaN/inf element (or its square-sum overflowed float32 — itself
        # a training-health event), so already-tapped norms double as the
        # guard; only trees WITHOUT a tapped norm pay the elementwise pass
        bad = None
        if loss is not None:
            bad = (~torch.isfinite(loss.detach())).float()
        for k, tree in (("grad_norm_client", g_c),
                        ("grad_norm_server", g_s)):
            if k in out:
                flag = (~torch.isfinite(out[k])).float()
            elif tree is not None:
                flag = tree_nonfinite(tree)
            else:
                continue
            bad = flag if bad is None else torch.maximum(bad, flag)
        out["nonfinite"] = bad if bad is not None else torch.zeros(())
    if aux_taps:
        for k in ("smashed_mean", "smashed_std", "smashed_absmax",
                  "quant_error"):
            if k in names and k in aux_taps:
                out[k] = aux_taps[k]
    return out


def stack_taps(rows: list, dim: int = 0) -> dict:
    """A list of tap dicts (one a step) -> one dict of stacked tensors."""
    return {k: torch.stack([r[k] for r in rows], dim=dim) for k in rows[0]}


# ---------------------------------------------------------------------------
# host-side summarization (numpy only: runs on pulled arrays, also inside
# MonteCarloResult.records_for_seed on the per-seed stacks)
# ---------------------------------------------------------------------------

def _time_major(arr, kind: str):
    """Tap/loss arrays in (step, client) order: SL rounds already emit
    (local_rounds, clients); FL rounds emit (clients, steps)."""
    import numpy as np
    a = np.asarray(arr)
    if kind == "fl" and a.ndim == 2:
        return a.T
    return a


def first_nonfinite_coord(flags, kind: str):
    """``(step, client, count)`` of the FIRST flagged (time-major) slot in
    one round's nonfinite tap, or ``None`` when the round is clean."""
    import numpy as np
    a = _time_major(flags, kind)
    bad = np.argwhere(np.asarray(a) > 0)
    if bad.size == 0:
        return None
    step = int(bad[0][0])
    client = int(bad[0][1]) if a.ndim == 2 else -1
    return step, client, int((np.asarray(a) > 0).sum())


def summarize_round_metrics(cfg: MetricsConfig, taps: Optional[dict], *,
                            losses, kind: str, n: int,
                            active: int) -> dict:
    """Reduce one round's raw tap arrays to the flat JSON-able scalar dict
    carried by ``RoundRecord.metrics``.

    ``taps`` is the engine's tap pytree for the round (possibly ``None``
    when nothing lowered in-graph); ``losses`` the round's raw loss stack
    in engine layout; ``active``/``n`` the surviving/total client slots.
    Purely numpy — byte-for-byte reproducible on a Monte-Carlo sweep's
    per-seed stacks (``MonteCarloResult.records_for_seed``).
    """
    import numpy as np
    out = {}
    for name in sorted(taps or ()):
        if name == "nonfinite":
            continue
        v = np.asarray(taps[name])
        out[f"{name}/mean"] = float(v.mean())
        out[f"{name}/max"] = float(v.max())
    if "loss_spread" in cfg.taps:
        lm = _time_major(losses, kind)
        if lm.ndim == 2 and lm.shape[1] > 0:
            out["loss/spread"] = float(np.std(lm, axis=1).mean())
    if "mask" in cfg.taps:
        out["mask/active"] = int(active)
        out["mask/fraction"] = float(active / n) if n else 0.0
    if taps and "nonfinite" in taps:
        coord = first_nonfinite_coord(taps["nonfinite"], kind)
        if coord is None:
            out["health/nonfinite"] = 0
            out["health/first_step"] = -1
            out["health/first_client"] = -1
        else:
            step, client, count = coord
            out["health/nonfinite"] = count
            out["health/first_step"] = step
            out["health/first_client"] = client
    return out
