"""Layers of the CNN backbones and the transformer blocks.

Counterpart of ``repro.models.modules``: conv, linear, GroupNorm and SAME
padding for the CNNs; RMSNorm, LayerNorm, the per-head GroupNorm of the
RWKV time mix, the token embedding (and its tied head), the SwiGLU and GELU
FFNs, rotary embeddings and the initializers for the transformer family.
Initializers draw in f32 from a ``torch.Generator`` on the parameter's own
device, then cast to the parameter's dtype. The
reference is NHWC with HWIO kernels; here tensors are NCHW (kept in
``torch.channels_last`` memory, so an NHWC view is free) and conv kernels
OIHW. Parameter names follow the reference's pytree keys (``w``, ``b``,
``scale``, ``bias``) so ``repro_torch.convert`` maps one onto the other.

Padding is the reference's ``"SAME"``: out = ceil(in / stride), and the
total padding is split ``lo = total // 2``, ``hi = total - lo``. On stride-2
layers that is asymmetric ((0, 1) for a 3x3 kernel), which ``padding=k//2``
would get wrong; ``same_pad`` pads explicitly in that case.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def same_pad_amounts(size: int, k: int, stride: int) -> tuple[int, int]:
    """(lo, hi) padding of one spatial axis under XLA's ``"SAME"``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, k: int, stride: int, *, value: float = 0.0):
    """``(x, symmetric_pad)``: when both axes pad symmetrically, x is
    returned as is with that padding for the layer to apply itself;
    otherwise x comes back padded explicitly (with ``value``) and 0."""
    (hl, hh) = same_pad_amounts(x.shape[-2], k, stride)
    (wl, wh) = same_pad_amounts(x.shape[-1], k, stride)
    if hl == hh and wl == wh:
        return x, (hl, wl)
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


class Conv2d(nn.Module):
    """SAME-padded conv, OIHW weight ``w`` (+ optional bias ``b``);
    he-normal init over fan_in = k*k*cin/groups, as ``conv_init``."""

    def __init__(self, k: int, cin: int, cout: int, *, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.w = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.b = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, generator: torch.Generator):
        fan_in = self.w.shape[1] * self.k * self.k
        with torch.no_grad():
            self.w.normal_(0.0, math.sqrt(2.0 / max(fan_in, 1)),
                           generator=generator)
            if self.b is not None:
                self.b.zero_()

    def forward(self, x):
        x, pad = same_pad(x, self.k, self.stride)
        return F.conv2d(x, self.w, self.b, stride=self.stride, padding=pad,
                        groups=self.groups)


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` stored (in, out) in ``dtype``, as the
    reference stores it, and cast to the input's dtype at use
    (``linear_apply``); lecun-normal init drawn in f32, zero bias."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype)) if bias \
            else None

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.w.copy_(lecun_normal(generator, self.w.shape,
                                      device=self.w.device))
            if self.b is not None:
                self.b.zero_()

    def forward(self, x):
        y = x @ self.w.to(x.dtype)
        return y if self.b is None else y + self.b.to(x.dtype)


def gn_groups(c: int) -> int:
    """The reference's GroupNorm grouping rule (``models/cnn.py:34``)."""
    return c // 8 if c % 8 == 0 else (c // 4 if c % 4 == 0 else 1)


class GroupNorm(nn.Module):
    """Spatial GroupNorm over (C/G, H, W) per group, in f32, eps 1e-5 —
    the batch-stat-free stand-in for BatchNorm of the reference's CNNs."""

    def __init__(self, c: int):
        super().__init__()
        self.groups = gn_groups(c)
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        xf = x.float()
        if torch._C._functorch.is_batchedtensor(xf):
            # under vmap: the CPU kernel asks for a channels-last copy,
            # which vmap refuses; the CUDA kernel takes a contiguous one
            # anyway
            xf = xf.contiguous()
        y = F.group_norm(xf, self.groups, self.scale.float(),
                         self.bias.float(), eps=1e-5)
        return y.to(x.dtype)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``reduce_window(max, SAME)``: pads with -inf, as the reference."""
    x, pad = same_pad(x, k, stride, value=-math.inf)
    return F.max_pool2d(x, k, stride=stride, padding=pad)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


# ---------------------------------------------------------------------------
# initializers (``normal_init``, ``lecun_normal``)
# ---------------------------------------------------------------------------

def normal_init(generator: torch.Generator, shape, *,
                dtype: torch.dtype = torch.float32, stddev: float = 0.02,
                device=None) -> torch.Tensor:
    """N(0, stddev^2) drawn in f32 from ``generator``, cast to ``dtype``."""
    x = torch.empty(tuple(shape), device=device or generator.device)
    return x.normal_(0.0, stddev, generator=generator).to(dtype)


def lecun_normal(generator: torch.Generator, shape, *,
                 dtype: torch.dtype = torch.float32,
                 device=None) -> torch.Tensor:
    """N(0, 1/fan_in) with fan_in = shape[-2] (a 2-D (in, out) weight)."""
    return normal_init(generator, shape, dtype=dtype, device=device,
                       stddev=1.0 / math.sqrt(max(shape[-2], 1)))


# ---------------------------------------------------------------------------
# transformer layers
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """Token embedding ``table`` (V, d) (``embed_init``: N(0, 0.02^2));
    ``forward`` looks tokens up (``embed_apply``), ``logits`` is the tied
    head ``x @ table.T`` in x's dtype (``embed_logits``)."""

    def __init__(self, vocab: int, d: int, *,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d, dtype=dtype))

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.table.copy_(normal_init(generator, self.table.shape,
                                         device=self.table.device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.table[ids.long()]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.table.to(x.dtype).T


class HeadGroupNorm(nn.Module):
    """``groupnorm_apply`` over the last axis: (..., C) split into
    ``groups`` groups of C/groups channels (the RWKV heads), each normalized
    with f32 moments (biased variance, eps 1e-5), then ``* scale + bias`` in
    f32 and cast back to the input's dtype."""

    def __init__(self, c: int, groups: int, *,
                 dtype: torch.dtype = torch.float32, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(c, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c, dtype=dtype))

    def forward(self, x):
        y = F.group_norm(x.float().reshape(-1, x.shape[-1]), self.groups,
                         self.scale.float(), self.bias.float(), eps=self.eps)
        return y.reshape(x.shape).to(x.dtype)


class RMSNorm(nn.Module):
    """``rmsnorm_apply``: computed in f32, cast back to the input's dtype."""

    def __init__(self, d: int, *, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """``layernorm_apply``: computed in f32, cast back to the input's dtype."""

    def __init__(self, d: int, *, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """``jax.nn.gelu(approximate=True)``: the tanh form."""
    return F.gelu(x, approximate="tanh")


class SwiGLU(nn.Module):
    """``swiglu_ffn``: down(silu(gate(x)) * up(x)), no biases."""

    def __init__(self, d: int, d_ff: int, *, dtype: torch.dtype):
        super().__init__()
        self.gate = Linear(d, d_ff, bias=False, dtype=dtype)
        self.up = Linear(d, d_ff, bias=False, dtype=dtype)
        self.down = Linear(d_ff, d, bias=False, dtype=dtype)

    def forward(self, x):
        return self.down(silu(self.gate(x)) * self.up(x))


class GeluFFN(nn.Module):
    """``gelu_ffn``: down(gelu(up(x))), with biases."""

    def __init__(self, d: int, d_ff: int, *, dtype: torch.dtype):
        super().__init__()
        self.up = Linear(d, d_ff, bias=True, dtype=dtype)
        self.down = Linear(d_ff, d, bias=True, dtype=dtype)

    def forward(self, x):
        return self.down(gelu(self.up(x)))


def rope_freqs(head_dim: int, *, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate-half rotary embedding. x (..., T, H, D); positions (..., T)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta=theta, device=x.device)
    ang = positions[..., None].float() * freqs          # (..., T, D/2)
    cos = torch.cos(ang)[..., None, :]                    # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
