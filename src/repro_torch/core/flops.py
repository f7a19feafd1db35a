"""FLOP counting for the energy/time bill: a ``TorchDispatchMode`` counter.

The reference bills from XLA's ``cost_analysis()`` on its host backend
(``repro.core.flops.flops_of``), a number PyTorch cannot reproduce: on
MobileNetV2 it is 4-5x the convolutions' own work. The port counts by the
reference's analytic rules instead (``repro/core/flops.py:40-87``), at the
level of the ATen ops that actually run, forward and backward:

- convolution and matrix product: ``2 * out * K`` with K the contraction
  length (per group), for the forward op and for each gradient the
  backward computes (input gradient: out = the input, K = kh*kw*Cout/g;
  weight gradient: out = the kernel, K = N*Ho*Wo) — the same counts the
  reference's jaxpr gets from the transposed convolutions of its VJP. The
  reference's convolutions pad inside the op; the port pads asymmetric
  SAME explicitly first, so an input gradient counts the input as it was
  before that padding;
- reductions: one per input element;
- other arithmetic: one per output element;
- views, copies, layout changes, comparisons and selects: free.

``FlopCount`` is the total (a float, what the records bill) and carries its
contraction part, which equals the reference's conv/dot count exactly.

``profile_flops`` is a second counter, for the adaptive cut profile only
(``core.adaptive_cut``): one forward counted as the reference's
``jaxpr_flops`` counts the primitives its forward lowers to
(``repro/core/flops.py:26-87``), so the profile, and so each client's cut,
is the reference's. Where one ATen op stands for several primitives it
counts those primitives: GroupNorm as the reference's ``_gn``
(``repro/models/cnn.py:31-42``), relu6 (``clip``: a max and a min), the
max-pool's ``reduce_window`` (one per input element, before the SAME
padding), and the head's mean (``reduce_sum`` plus a ``div`` per output).
The bill keeps ``count_flops``.
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_FREE = frozenset({
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t", "expand",
    "squeeze", "unsqueeze", "slice", "select", "as_strided", "clone",
    "copy", "copy_", "_to_copy", "detach", "alias", "lift_fresh",
    "lift_fresh_copy", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "fill", "fill_", "zero_",
    "scalar_tensor", "cat", "stack", "split", "split_with_sizes", "unbind",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "isnan",
    "logical_not", "logical_and", "logical_or", "gather", "scatter",
    "index", "index_select", "slice_backward", "select_backward",
    "_local_scalar_dense", "sign", "argmax", "argmin", "clamp", "any", "all",
    "masked_fill", "contiguous",
})
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "logsumexp", "norm", "linalg_vector_norm",
})


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _key(t: torch.Tensor):
    return t.data_ptr(), tuple(t.shape)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


class FlopCount(float):
    """A FLOP total (what the records bill) with its contraction part
    (convolutions and matrix products) as ``.contraction``."""

    def __new__(cls, total: float, contraction: float):
        obj = super().__new__(cls, total)
        obj.contraction = float(contraction)
        return obj


class FlopCounter(TorchDispatchMode):
    """Counts the FLOPs of every ATen op dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.contraction = 0.0
        self.other = 0.0
        # padded tensor (data_ptr, shape) -> (element count before the
        # padding, the tensor itself: held so the key stays unique)
        self._unpadded = {}

    def count(self) -> FlopCount:
        return FlopCount(self.contraction + self.other, self.contraction)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if name == "convolution":
            w = args[1]
            self.contraction += 2.0 * out.numel() * math.prod(w.shape[1:])
        elif name == "convolution_backward":
            grad_out, inp, w = args[0], args[1], args[2]
            groups, mask = args[9], args[10]
            kh_kw = math.prod(w.shape[2:])
            if mask[0]:
                n_in = self._unpadded.get(_key(inp), (inp.numel(),))[0]
                self.contraction += (2.0 * n_in * kh_kw
                                     * (w.shape[0] // groups))
            if mask[1]:
                self.contraction += (2.0 * w.numel() * grad_out.shape[0]
                                     * math.prod(grad_out.shape[2:]))
            if mask[2]:
                self.other += grad_out.numel()
        elif name in ("mm", "bmm"):
            self.contraction += 2.0 * out.numel() * args[0].shape[-1]
        elif name == "addmm":
            self.contraction += 2.0 * out.numel() * args[1].shape[-1]
            self.other += out.numel()
        elif name == "constant_pad_nd":
            self._unpadded[_key(out)] = (args[0].numel(), out)
        elif name in _FREE:
            pass
        elif name in _REDUCTIONS:
            self.other += _numel(args[0])
        else:
            self.other += sum(t.numel() for t in _tensors(out))
        return out


def count_flops(fn, *args) -> FlopCount:
    """FLOPs of running ``fn(*args)`` once (with grad enabled)."""
    with torch.enable_grad(), FlopCounter() as counter:
        fn(*args)
    return counter.count()


_JAXPR_RULES = frozenset({"native_group_norm", "clamp", "constant_pad_nd",
                          "max_pool2d_with_indices", "mean"})


class JaxprRulesCounter(FlopCounter):
    """``FlopCounter`` with the reference's jaxpr rules for the ops whose
    lowering there is several primitives (forward only). Padding is free,
    and a padded tensor is remembered by identity (``data_ptr()`` is 0 on
    the meta device), so a max-pool counts its input before the padding."""

    def __init__(self):
        super().__init__()
        # id of a padded tensor -> (element count before the padding, the
        # tensor itself: held so the id stays unique)
        self._unpadded_ids = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        if name not in _JAXPR_RULES:
            return super().__torch_dispatch__(func, types, args, kwargs)
        out = func(*args, **(kwargs or {}))
        if name == "native_group_norm":
            # _gn over N elements in B x G groups: three reduce_sums over
            # N, sub x2, square, the normalizing mul, scale and bias (9N);
            # three divs, the eps add and the rsqrt per group (5BG); the
            # variance's scalar normalizer (1)
            x, batch, groups = args[0], args[3], args[6]
            self.other += 9.0 * x.numel() + 5.0 * batch * groups + 1.0
        elif name == "clamp":
            self.other += 2.0 * out.numel()          # max, then min
        elif name == "constant_pad_nd":
            self._unpadded_ids[id(out)] = (args[0].numel(), out)
        elif name == "max_pool2d_with_indices":
            self.other += self._unpadded_ids.get(id(args[0]),
                                                 (args[0].numel(),))[0]
        else:                                          # mean
            self.other += args[0].numel() + out.numel()    # reduce_sum, div
        return out


def profile_flops(fn, *args) -> tuple[FlopCount, object]:
    """FLOPs of one forward ``fn(*args)`` (under ``torch.no_grad()``)
    counted by the reference's jaxpr rules (``JaxprRulesCounter``), and
    what ``fn`` returned: the count the adaptive cut profile takes, never
    the bill."""
    with torch.no_grad(), JaxprRulesCounter() as counter:
        out = fn(*args)
    return counter.count(), out
