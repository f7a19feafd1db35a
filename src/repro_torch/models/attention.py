"""Attention in model layout (B, S, H, D): GQA repeat, the chunked
online-softmax path and the O(S^2) oracle.

Counterpart of ``repro.models.attention`` (training/prefill part).
``chunked_causal_attention`` is the spec's default ``attn_impl="xla"``: the
reference's q-block / kv-block online softmax, with the same block choice
(``while s % q_block: q_block //= 2``) and the same clip of the kv span to
the window, as plain PyTorch ops over Python loops. The hand-written
kernel path (``attn_impl="pallas"``) is ``kernels/attn``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def gqa_repeat(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Kh, D) -> (B, S, Kh*n_rep, D), each KV head repeated in place."""
    if n_rep == 1:
        return kv
    b, s, kh, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(
        b, s, kh * n_rep, d)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             window: Optional[int] = None,
                             q_block: int = 512, kv_block: int = 1024,
                             causal: bool = True) -> torch.Tensor:
    """Online-softmax attention. q (B,S,H,D); k,v (B,Sk,Kh,D), RoPE'd.

    With ``window`` set each query attends to keys in (pos-window, pos], and
    the kv blocks a q block visits are clipped to the window."""
    b, s, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    k = gqa_repeat(k, n_rep)
    v = gqa_repeat(v, n_rep)
    scale = 1.0 / math.sqrt(d)

    q_block = min(q_block, s)
    kv_block = min(kv_block, sk)
    while s % q_block:
        q_block //= 2
    while sk % kv_block:
        kv_block //= 2
    nq, nk = s // q_block, sk // kv_block

    qt = q.transpose(1, 2) * scale                    # (B, H, S, D)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)

    if window is not None:
        kv_span = min(nk, int(math.ceil((q_block + window - 1) / kv_block))
                      + 1)
    else:
        kv_span = nk

    blocks = []
    for qi in range(nq):
        qb = qt[:, :, qi * q_block:(qi + 1) * q_block]
        q_pos = qi * q_block + torch.arange(q_block, device=q.device)
        if window is not None:
            lo_pos = max(qi * q_block - (window - 1), 0)
            kv_lo = max(min(lo_pos // kv_block, nk - kv_span), 0)
        else:
            kv_lo = 0
        m = torch.full((b, h, q_block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, q_block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, q_block, d), dtype=torch.float32,
                          device=q.device)
        for j in range(kv_span):
            kj = kv_lo + j
            kb = kt[:, :, kj * kv_block:(kj + 1) * kv_block]
            vb = vt[:, :, kj * kv_block:(kj + 1) * kv_block]
            scores = torch.matmul(qb.float(), kb.float().transpose(-1, -2))
            k_pos = kj * kv_block + torch.arange(kv_block, device=q.device)
            mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(-1))
            p = torch.exp(scores - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(
                p.to(vb.dtype).float(), vb.float())
            m = m_new
        blocks.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(blocks, dim=2).transpose(1, 2)   # (B, S, H, D)


def reference_attention(q, k, v, *, window=None, causal=True):
    """O(S^2) oracle in model layout: the port's one oracle,
    ``kernels.attn.ops.attention`` on its plain path (imported here, since
    that module imports ``gqa_repeat`` from this one)."""
    from ..kernels.attn.ops import attention
    return attention(q, k, v, causal=causal, window=window, use_kernel=False)
