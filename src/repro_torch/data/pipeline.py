"""Sharding a client-stacked batch over the fleet mesh (counterpart of
``repro.data.pipeline.shard_batch``).

The reference places a host batch on its mesh sharded on ``data``, each
device holding its block of the leading axis. A rank of the port's data
group takes its own block: rows ``[rank * k, (rank + 1) * k)`` of the
client axis, ``k = clients / size``, as views. ``BatchIterator`` is not
ported yet (ROADMAP queue 1 item 17.3).
"""
from __future__ import annotations

import torch


def _rows(n: int, mesh) -> slice:
    """The rank's block of ``n`` client rows; ``n`` must divide over the
    mesh's data size (no padding, the reference's rule)."""
    size = 1 if mesh is None else mesh.size
    if n % size:
        raise ValueError(f"{n} clients do not divide over data={size}")
    k = n // size
    rank = 0 if mesh is None else mesh.rank
    return slice(rank * k, (rank + 1) * k)


def shard_batch(batch, mesh, *, dim: int = 0):
    """The rank's rows (along ``dim``, the client axis) of every tensor of
    ``batch`` (a tensor, or dicts, tuples and lists of them), as views; the
    batch itself on the single-rank mesh."""
    if isinstance(batch, torch.Tensor):
        rows = _rows(batch.shape[dim], mesh)
        return batch.narrow(dim, rows.start, rows.stop - rows.start)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, dim=dim) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh, dim=dim) for v in batch)
    raise TypeError(f"cannot shard {type(batch).__name__}")
