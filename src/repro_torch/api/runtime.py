"""Experiment runtime helpers of the port (host half of ``repro.api.runtime``).

  * ``round_batches``        — one global round of minibatch stacks with a
                               leading client axis; the numpy ``RandomState``
                               call sequence of the reference, so both
                               packages draw the same batches
                               (``round_batch_indices``: the indices alone,
                               for a cohort's gather)
  * ``client_step_time_s``   — A5000-roofline seconds scaled to an edge
                               profile via paper Eq. (9)
  * ``count_fl_step_flops`` / ``count_sl_step_flops`` /
    ``count_split_step_flops`` — the symmetric per-step FLOP accounting, on
                               the port's own counter (``core.flops``)
  * ``metrics_from_predictions`` — the paper's Fig. 3 radar metrics of
                               predicted labels, from class counts
                               (``bincount``), so a vocabulary of 49,152
                               classes costs a few array passes
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.deployment import field_side_meters
from ..core.energy import (HardwareProfile, JETSON_AGX_ORIN, RTX_A5000,
                           scale_time)
from ..core.flops import count_flops
from ..core.split import apply_stages, to_port_layout
from ..fleet.link import SmashedSpec
from ..models.cnn import cross_entropy_loss


def round_batch_indices(parts, batch_size, steps, rng, *,
                        shrink: bool = False) -> np.ndarray:
    """The sample indices of one global round: ``(partitions, steps, b)``,
    one ``rng.choice`` per partition in order (the reference's call
    sequence). Sampling is with replacement; ``shrink`` caps the batch at
    the smallest partition (the legacy behaviour)."""
    empty = [ci for ci, idx in enumerate(parts) if len(idx) == 0]
    if empty:
        raise ValueError(f"clients {empty} drew no data; increase the "
                         f"training set or classes_per_client")
    bs = min(batch_size, min(len(idx) for idx in parts)) if shrink \
        else batch_size
    return np.stack([rng.choice(idx, size=(steps, bs), replace=True)
                     for idx in parts])


def round_batches(x, y, parts, batch_size, steps, rng, *,
                  shrink: bool = False):
    """One global round of minibatches as numpy arrays stacked on a leading
    client axis: ``((clients, steps, b, ...), (clients, steps, b))``
    (``round_batch_indices`` gathered)."""
    sel = round_batch_indices(parts, batch_size, steps, rng, shrink=shrink)
    return x[sel], y[sel]


def client_coords(acres: float, n: int, *, seed: int = 0) -> np.ndarray:
    """``n`` edge-device positions on a square farm: a jittered uniform grid
    over the next square count, truncated to ``n`` (deterministic)."""
    side = field_side_meters(acres)
    g = int(math.ceil(math.sqrt(n)))
    xs = (np.arange(g) + 0.5) * side / g
    pts = np.stack(np.meshgrid(xs, xs, indexing="ij"), axis=-1).reshape(-1, 2)
    rng = np.random.RandomState(seed)
    pts = pts + rng.uniform(-0.05, 0.05, size=pts.shape) * side / g
    return pts[:n]


def roofline_s(flops: float, hw: HardwareProfile) -> float:
    return flops / (hw.fp32_tflops * 1e12)


def client_step_time_s(flops: float,
                       edge: HardwareProfile = JETSON_AGX_ORIN) -> float:
    """Edge-device seconds per step: A5000 roofline scaled via Eq. (9)."""
    return scale_time(roofline_s(flops, RTX_A5000), RTX_A5000, edge)


def mission_max_link_s(hover_s_per_stop: float, comm_s_per_stop: float,
                       local_steps: int) -> float:
    """Per-step link deadline implied by the UAV's dwell at one stop."""
    return (hover_s_per_stop + comm_s_per_stop) / max(local_steps, 1)


def _params(stages):
    return [p for s in stages for p in s.parameters()]


def count_fl_step_flops(stages, bx: torch.Tensor, by: torch.Tensor):
    """FLOPs of one full-model training step (forward + the gradients of
    every parameter) on one NHWC minibatch."""
    params = _params(stages)

    def step(xx, yy):
        loss = cross_entropy_loss(apply_stages(stages, to_port_layout(xx)), yy)
        torch.autograd.grad(loss, params)
    return count_flops(step, bx, by)


def count_sl_step_flops(client_stages, server_stages, bx, by):
    """Per-tier FLOPs of one split step, counted symmetrically with
    ``count_fl_step_flops``. client: prefix forward + the backward that
    turns a cut gradient into client-param gradients; server: suffix
    forward + backward w.r.t. the server params AND the smashed input.
    The link boundary is excluded (the byte accounting prices it).
    Returns (client_flops, server_flops, SmashedSpec of the cut)."""
    cp, sp = _params(client_stages), _params(server_stages)
    with torch.no_grad():
        sm = apply_stages(client_stages, to_port_layout(bx))
    smashed = SmashedSpec(shape=tuple(sm.permute(0, 2, 3, 1).shape),
                          itemsize=sm.element_size())
    cut_grad = torch.zeros_like(sm)

    def client_step(xx, ct):
        out = apply_stages(client_stages, to_port_layout(xx))
        torch.autograd.grad(out, cp, grad_outputs=ct)

    def server_step(s, yy):
        s = s.detach().requires_grad_(True)
        loss = cross_entropy_loss(apply_stages(server_stages, s), yy)
        torch.autograd.grad(loss, sp + [s])

    return (count_flops(client_step, bx, cut_grad),
            count_flops(server_step, cut_grad, by), smashed)


def count_split_step_flops(step, client, server, bx, by):
    """``count_sl_step_flops`` for any ``SplitStep`` over a client and a
    server module (the split LM): the same symmetric accounting, driven
    through the step's own ``client_fwd`` / ``server_loss``. The link
    boundary is excluded on both sides. Returns (client_flops,
    server_flops, SmashedSpec of the smashed tensor as it is)."""
    cp, sp = list(client.parameters()), list(server.parameters())
    with torch.no_grad():
        sm = step.client_fwd(client, bx)
    smashed = SmashedSpec(shape=tuple(sm.shape), itemsize=sm.element_size())
    cut_grad = torch.zeros_like(sm)

    def client_step(xx, ct):
        out = step.client_fwd(client, xx)
        torch.autograd.grad(out, cp, grad_outputs=ct)

    def server_step(s, yy):
        s = s.detach().requires_grad_(True)
        loss, _ = step.server_loss(server, s, yy)
        torch.autograd.grad(loss, sp + [s])

    return (count_flops(client_step, bx, cut_grad),
            count_flops(server_step, cut_grad, by), smashed)


def accuracy_from_logits(logits: torch.Tensor, labels: torch.Tensor):
    """Scalar held-out accuracy, on the logits' device."""
    return (logits.argmax(dim=-1) == labels).float().mean()


def metrics_from_predictions(pred, labels, num_classes: int) -> dict:
    """Accuracy / macro precision / recall / F1 / multiclass MCC of integer
    predictions against integer labels: the reference's
    ``classification_metrics`` per-class loop (``repro/api/runtime.py:187``)
    in counts: per class tp = bincount of the hits, tp + fp = bincount of the
    predictions, tp + fn = bincount of the labels; the same float64
    arithmetic per class, so the same numbers."""
    pred = np.asarray(pred).reshape(-1)
    y = np.asarray(labels).reshape(-1)
    hit = pred == y
    acc = float(hit.mean())
    tp = np.bincount(y[hit], minlength=num_classes).astype(float)
    t_k = np.bincount(y, minlength=num_classes).astype(float)
    p_k = np.bincount(pred, minlength=num_classes).astype(float)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(p_k > 0, tp / p_k, 0.0)
        r = np.where(t_k > 0, tp / t_k, 0.0)
        f1 = np.where(p + r > 0, 2 * p * r / (p + r), 0.0)
    n = len(y)
    c = float(hit.sum())
    s2 = n * n
    num = c * n - float(t_k @ p_k)
    den = np.sqrt(max(s2 - float(p_k @ p_k), 0.0)) * \
        np.sqrt(max(s2 - float(t_k @ t_k), 0.0))
    mcc = num / den if den else 0.0
    return {"accuracy": acc, "precision": float(np.mean(p)),
            "recall": float(np.mean(r)), "f1": float(np.mean(f1)),
            "mcc": float(mcc)}
