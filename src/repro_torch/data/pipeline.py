"""Batching and sharding (counterpart of ``repro.data.pipeline``).

``BatchIterator`` is the reference's numpy iterator, carried over as it is:
the same ``RandomState`` permutation each epoch, so the same batches for a
seed. ``shard_batch`` places a client-stacked batch over the fleet mesh.

The reference places a host batch on its mesh sharded on ``data``, each
device holding its block of the leading axis. A rank of the port's data
group takes its own block: rows ``[rank * k, (rank + 1) * k)`` of the
client axis, ``k = clients / size``, as views.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


class BatchIterator:
    """Epoch-shuffling minibatch iterator over in-memory arrays."""

    def __init__(self, arrays: tuple, batch_size: int, *, seed: int = 0,
                 drop_last: bool = True):
        self.arrays = tuple(np.asarray(a) for a in arrays)
        n = self.arrays[0].shape[0]
        assert all(a.shape[0] == n for a in self.arrays)
        self.n = n
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[tuple]:
        order = self.rng.permutation(self.n)
        stop = self.n - (self.n % self.batch_size) if self.drop_last else self.n
        for i in range(0, stop, self.batch_size):
            sel = order[i:i + self.batch_size]
            yield tuple(a[sel] for a in self.arrays)

    def steps_per_epoch(self) -> int:
        return self.n // self.batch_size


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
