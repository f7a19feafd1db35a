"""The loop of the long recurrences' plain versions, one step a token.

``scan_loop`` is the loop of the WKV scan's plain forward and backward
(``kernels/rwkv/ref.py``) and of Mamba's selective scan
(``models/ssm._mamba_inner``), in the manner of the reference's
``lax.scan``: ``carry, y = step(carry, x)`` over the pieces of ``xs``
along ``dim``, the ys joined along ``dim`` in the order of the pieces.

Off the dry run it is a plain Python loop, op for op the loops these
functions ran before it. The dry run (``launch.dryrun``) installs a
``scaler`` for its trace (``scaled``): there a loop of 4,096 or 32,768
steps a layer, each a handful of DTensor ops, would take minutes, so the
scaler traces one step at its real shapes, counts its FLOPs and
collectives once for every step, and returns outputs of the loop's
shapes (``launch.dryrun.ScaledLoops``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

_SCALER: Optional[Callable] = None


@contextlib.contextmanager
def scaled(scaler: Callable):
    """Route every ``scan_loop`` of the block to ``scaler``, called with
    ``scan_loop``'s own arguments."""
    global _SCALER
    prev, _SCALER = _SCALER, scaler
    try:
        yield scaler
    finally:
        _SCALER = prev


def _pieces(t: torch.Tensor, dim: int, chunk: Optional[int]) -> tuple:
    """``t``'s pieces along ``dim``: single steps (``unbind``) when
    ``chunk`` is None, else runs of ``chunk`` steps (``split``); none for
    an empty ``dim``."""
    if chunk is None or not t.shape[dim]:
        return t.unbind(dim)
    return t.split(chunk, dim)


def scan_loop(step: Callable, carry, xs: tuple, *, dim: int, site: str,
              chunks: Optional[tuple] = None, reverse: bool = False,
              keep_every: int = 0):
    """Run ``carry, y = step(carry, x)`` over the pieces of the tensors
    ``xs`` along ``dim`` (``x`` a tuple, one piece of each tensor; with
    ``chunks``, one ``split`` size a tensor, else each is unbound), last
    piece first with ``reverse``. Returns ``(carry, ys, kept)``: ``ys``
    the steps' outputs (a tensor or a tuple of them) joined along ``dim``,
    stacked for single steps and concatenated for runs, in the order of
    the pieces (None for no piece); ``kept`` the carries before steps 0,
    ``keep_every``, 2 ``keep_every``, ... stacked along ``dim`` (None
    without ``keep_every``; an empty list for no piece). ``site`` names
    the loop in the dry run's records."""
    if _SCALER is not None:
        return _SCALER(step, carry, xs, dim=dim, site=site, chunks=chunks,
                       reverse=reverse, keep_every=keep_every)
    steps = list(zip(*(_pieces(t, dim, c)
                       for t, c in zip(xs, chunks or (None,) * len(xs)))))
    order = range(len(steps) - 1, -1, -1) if reverse else range(len(steps))
    ys, kept = [], []
    for i, at in enumerate(order):
        if keep_every and i % keep_every == 0:
            kept.append(carry)
        carry, y = step(carry, steps[at])
        ys.append(y)
    if reverse:
        ys.reverse()
    return carry, _join(ys, dim, chunks is not None), (
        (torch.stack(kept, dim=dim) if kept else []) if keep_every else None)


def _join(ys: list, dim: int, cat: bool):
    """The steps' outputs joined along ``dim`` (None for no step)."""
    if not ys:
        return None
    glue = torch.cat if cat else torch.stack
    if isinstance(ys[0], tuple):
        return tuple(glue(col, dim=dim) for col in zip(*ys))
    return glue(ys, dim=dim)
