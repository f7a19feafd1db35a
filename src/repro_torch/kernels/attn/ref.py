"""Plain PyTorch oracle of the flash attention kernel (O(S^2), f32).

Counterpart of ``repro.kernels.attn.ref``. ``masked_probs`` is the masked
softmax both this oracle and the kernel's closed-form backward
(``flash.py``) recompute; positions are absolute (query i, key j), also
when Sk != S.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def masked_probs(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                 window: Optional[int]) -> torch.Tensor:
    """(B, H, S, Sk) f32 softmax of q k^T / sqrt(d) with masked scores set to
    ``NEG_INF`` (a fully masked row comes out uniform, as in the reference)."""
    d = q.shape[-1]
    s, sk = q.shape[2], k.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    scores = torch.where(mask, scores, NEG_INF)
    return torch.softmax(scores, dim=-1)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q (B,H,S,D); k,v (B,H,Sk,D) -> (B,H,S,D) in q's dtype."""
    p = masked_probs(q, k, causal=causal, window=window)
    return torch.matmul(p, v.float()).to(q.dtype)
