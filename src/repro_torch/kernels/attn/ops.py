"""Attention in model layout (B, S, H, D) through the kernel seam.

Counterpart of ``repro.kernels.attn.ops``: GQA KV heads are repeated here,
the heads moved ahead of the sequence ((B, H, S, D), contiguous, as the
kernel takes them), and the result moved back. ``use_kernel`` picks the
flash kernel path (``flash.flash_attention``: the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor) or the O(S^2) oracle.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...models.attention import gqa_repeat
from .flash import flash_attention
from .ref import flash_attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              use_kernel: bool = False) -> torch.Tensor:
    """q (B,S,H,D); k, v (B,S,Kh,D) -> (B,S,H,D)."""
    h = q.shape[2]
    kt = gqa_repeat(k, h // k.shape[2]).transpose(1, 2).contiguous()
    vt = gqa_repeat(v, h // v.shape[2]).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    fn = flash_attention if use_kernel else flash_attention_ref
    return fn(qt, kt, vt, causal=causal, window=window).transpose(1, 2)
