"""Checkpoints in the reference's format (counterpart of
``repro.checkpoint.ckpt``), with placement-aware restore.

One msgpack file holds ``{"meta": {...}, "leaves": {path: {"dtype",
"shape", "data"}}}``: ``path`` the ``/``-joined keys of the leaf in the
tree (dict keys, list indices, NamedTuple or dataclass field names), the
leaves in the order JAX flattens the tree (a dict's keys sorted),
``dtype`` numpy's ``dtype.str`` (``"<f4"``, ``"|i1"``, ...) or
``"bfloat16"`` with the bits stored as uint16, ``data`` the C-order bytes.
The bytes are those the reference writes for the same tree, and each
package reads the other's files.

The port carries its own msgpack codec (``checkpoint.msgpack``; the card's
host has no ``msgpack`` package) and streams: the writer copies one leaf at
a time to the host and writes its body straight to the file (a ``Stacked``
leaf one row at a time, so a stacked copy is never made), and the reader
reads each leaf's body straight into a numpy buffer and places it before it
reads the next, skipping the leaves ``like`` does not hold. The write goes to ``path + ".tmp"`` and is
moved over ``path`` by ``os.replace``, so a reader never sees half a file.

A leaf may be a torch tensor (on any device; a ``DTensor`` is gathered
whole), a ``Stacked`` one, a numpy array (a bfloat16 one from ``ml_dtypes``
too) or a Python scalar; ``None`` holds no leaf, as in JAX.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import msgpack

_BF16 = "bfloat16"


class Stacked:
    """A leaf given as its rows: tensors of one shape and dtype (or
    ``Stacked`` leaves of one shape themselves) that, stacked on a new
    leading axis, make the leaf. The writer copies one row at a time to the
    host, so the stacked leaf is never made whole; ``stack()`` makes it.
    ``shape``, ``dtype``, ``device`` and ``is_meta`` are the leaf's, so a
    meta one serves as a ``like`` leaf."""

    def __init__(self, rows):
        self.rows = list(rows)
        first = self.rows[0]
        for row in self.rows[1:]:
            if tuple(row.shape) != tuple(first.shape) \
                    or row.dtype != first.dtype:
                raise ValueError(f"Stacked rows differ: {tuple(row.shape)} "
                                 f"{row.dtype} vs {tuple(first.shape)} "
                                 f"{first.dtype}")
        self.shape = torch.Size((len(self.rows),) + tuple(first.shape))
        self.dtype, self.device = first.dtype, first.device
        self.is_meta = first.is_meta

    def leaves(self):
        """The plain rows in C order (those of nested rows expanded)."""
        for row in self.rows:
            if isinstance(row, Stacked):
                yield from row.leaves()
            else:
                yield row

    def stack(self) -> torch.Tensor:
        return torch.stack([r.stack() if isinstance(r, Stacked) else r
                            for r in self.rows])


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(key, child) pairs in JAX's flatten order, or None for a leaf."""
    if isinstance(node, OrderedDict):
        return list(node.items())
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _walk(node, prefix: tuple, is_leaf):
    if node is None:
        return
    kids = None if is_leaf is not None and is_leaf(node) else _children(node)
    if kids is None:
        yield prefix, node
        return
    for key, child in kids:
        yield from _walk(child, prefix + (str(key),), is_leaf)


def tree_flatten_with_paths(tree: Any, *,
                            is_leaf: Optional[Callable[[Any], bool]] = None
                            ) -> dict:
    """``{"a/b/0": leaf, ...}`` in JAX's flatten order."""
    return {"/".join(path): leaf for path, leaf in _walk(tree, (), is_leaf)}


def tree_unflatten_like(like: Any, values: dict, *,
                        is_leaf: Optional[Callable[[Any], bool]] = None
                        ) -> Any:
    """``like``'s structure with the leaf at each path replaced by
    ``values[path]`` (the inverse of ``tree_flatten_with_paths``)."""
    return _rebuild(like, (), values, is_leaf)


def _rebuild(node, prefix: tuple, values: dict, is_leaf):
    if node is None:
        return None
    kids = None if is_leaf is not None and is_leaf(node) else _children(node)
    if kids is None:
        return values["/".join(prefix)]
    new = {key: _rebuild(child, prefix + (str(key),), values, is_leaf)
           for key, child in kids}
    if isinstance(node, dict):
        return type(node)((k, new[k]) for k in node)
    if _is_namedtuple(node):
        return type(node)(*new.values())
    if isinstance(node, (list, tuple)):
        return type(node)(new[i] for i in range(len(node)))
    return type(node)(**new)


def _c_order(a: np.ndarray) -> np.ndarray:
    """``a`` in C order, 0-d kept 0-d (``np.ascontiguousarray`` makes it
    1-d)."""
    return a if a.flags.c_contiguous else a.copy(order="C")


def _host_array(x) -> tuple[np.ndarray, str]:
    """A leaf as a C-order host array and its format dtype string."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if hasattr(t, "full_tensor"):                    # a DTensor
            t = t.full_tensor()
        if t.is_meta:
            raise ValueError("a meta tensor holds no data to save")
        t = t.cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.asarray(x)
        if a.dtype.name == _BF16:
            return _c_order(a).view(np.uint16), _BF16
    a = _c_order(a)
    return a, a.dtype.str


def _host_parts(leaf) -> tuple:
    """(shape, format dtype string, body bytes, the host arrays whose bytes
    in turn are the body): a ``Stacked`` leaf's rows each copied to the
    host as the iterator reaches it."""
    if not isinstance(leaf, Stacked):
        a, dtype = _host_array(leaf)
        return a.shape, dtype, a.nbytes, iter([a])
    rows = leaf.leaves()
    first, dtype = _host_array(next(rows))
    shape = tuple(leaf.shape)
    return (shape, dtype, first.itemsize * math.prod(shape),
            itertools.chain([first], (_host_array(r)[0] for r in rows)))


def save_checkpoint(path: str, tree: Any, *,
                    meta: Optional[dict] = None) -> None:
    """Write ``tree`` and ``meta`` (a dict of str, int, float, bool, None,
    lists and dicts) to ``path``, atomically."""
    flat = tree_flatten_with_paths(tree)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        w = f.write
        w(msgpack.map_header(2))
        msgpack.pack("meta", w)
        msgpack.pack(meta or {}, w)
        msgpack.pack("leaves", w)
        w(msgpack.map_header(len(flat)))
        for key, leaf in flat.items():
            shape, dtype, nbytes, parts = _host_parts(leaf)
            msgpack.pack(key, w)
            w(msgpack.map_header(3))
            msgpack.pack("dtype", w)
            msgpack.pack(dtype, w)
            msgpack.pack("shape", w)
            msgpack.pack([int(n) for n in shape], w)
            msgpack.pack("data", w)
            w(msgpack.bin_header(nbytes))
            for a in parts:
                w(memoryview(a.reshape(-1).view(np.uint8)))
    os.replace(tmp, path)  # atomic


def _decode_leaf(d: dict) -> torch.Tensor:
    shape = tuple(d["shape"])
    data = d["data"]
    if isinstance(data, bytes):
        data = np.frombuffer(data, dtype=np.uint8).copy()
    if d["dtype"] == _BF16:
        return torch.from_numpy(data.view(np.int16).reshape(shape)).view(
            torch.bfloat16)
    a = data.view(np.dtype(d["dtype"])).reshape(shape)
    if not a.dtype.isnative:
        a = a.astype(a.dtype.newbyteorder("="))
    return torch.from_numpy(a)


def _read(path: str, wanted: Optional[set] = None,
          meta_only: bool = False, on_leaf=None) -> tuple[dict, dict]:
    """(meta, {path: tensor}) for the leaves in ``wanted`` (all when None),
    each body read straight into its own buffer; with ``on_leaf(path,
    tensor)``, what it returns is kept instead, before the next leaf is
    read."""
    meta, leaves = {}, {}
    with open(path, "rb") as f:
        r = msgpack.Reader(f)
        for _ in range(r.map_len()):
            section = r.read()
            if section == "meta":
                meta = r.read()
                if meta_only:
                    break
            elif section == "leaves" and not meta_only:
                for _ in range(r.map_len()):
                    key = r.read()
                    keep = wanted is None or key in wanted
                    d = r.read(bin_into=lambda n: np.empty(n, np.uint8),
                               skip=not keep)
                    if keep:
                        t = _decode_leaf(d)
                        del d
                        leaves[key] = t if on_leaf is None else on_leaf(key,
                                                                        t)
            else:
                r.read(skip=True)
    return meta, leaves


def _is_placement(x) -> bool:
    """A leaf of ``shardings``: a device, or a (DeviceMesh, placements)
    pair."""
    if isinstance(x, (torch.device, str)):
        return True
    if not (isinstance(x, tuple) and len(x) == 2):
        return False
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(x[0], DeviceMesh)


def _place(t: torch.Tensor, sh, ref) -> torch.Tensor:
    if isinstance(sh, (torch.device, str)):
        return t.to(sh)
    if sh is not None:
        from torch.distributed.tensor import distribute_tensor
        mesh, placements = sh
        return distribute_tensor(t.to(mesh.device_type), mesh,
                                 list(placements))
    if isinstance(ref, (torch.Tensor, Stacked)) and not ref.is_meta:
        return t.to(ref.device)
    return t


def restore_checkpoint(path: str, like: Any, *, shardings: Any = None
                       ) -> Any:
    """The leaves of ``like`` (a tree of tensors, arrays or anything with a
    ``shape``; meta tensors give shapes alone) read from ``path``, as torch
    tensors in ``like``'s structure and the file's dtypes. Each leaf goes
    straight to its target: ``shardings`` is a tree like ``like`` of a
    ``torch.device`` (``.to(device)``), a ``(DeviceMesh, placements)`` pair
    (``distribute_tensor``) or None; without one a leaf goes to its
    ``like`` leaf's device, or stays on the host (a meta, numpy or other
    ``like`` leaf). Raises ``KeyError`` for a leaf the file lacks and
    ``ValueError`` for a shape that differs, as the reference does (the
    first of them in ``like``'s order, once the file is read)."""
    flat_like = tree_flatten_with_paths(like)
    flat_shard = (tree_flatten_with_paths(shardings, is_leaf=_is_placement)
                  if shardings is not None else {})
    mismatched = {}

    def place(key, t):
        ref = flat_like[key]
        if tuple(t.shape) != tuple(ref.shape):
            mismatched[key] = tuple(t.shape)
            return None
        return _place(t, flat_shard.get(key), ref)
    _, out = _read(path, wanted=set(flat_like), on_leaf=place)
    for key, ref in flat_like.items():
        if key not in out:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if key in mismatched:
            raise ValueError(f"shape mismatch at {key}: ckpt "
                             f"{mismatched[key]} vs model "
                             f"{tuple(ref.shape)}")
    return tree_unflatten_like(like, out)


def checkpoint_meta(path: str) -> dict:
    """The ``meta`` map of the checkpoint at ``path`` (no leaf is read)."""
    return _read(path, meta_only=True)[0]
