"""Attention in model layout (B, S, H, D): GQA repeat, the q/k/v
projection, the chunked online-softmax path, cached decode and the O(S^2)
oracle.

Counterpart of ``repro.models.attention``.
``chunked_causal_attention`` is the spec's default ``attn_impl="xla"``: the
reference's q-block / kv-block online softmax with the same clip of the kv
span to the window, as plain PyTorch ops over Python loops. Where a length
is not a multiple of its block, the last block is shorter, where the
reference halves the block until it divides the length (its Pallas
kernel pads instead, for the same reason): the same function, summed over
fewer and larger blocks. At whisper's 1500 frames the halving gives blocks
of 4, 140,625 block pairs a layer in a Python loop; here 6. The hand-written
kernel path (``attn_impl="pallas"``) is ``kernels/attn``. The decode
pieces (``decode_attention``, ``update_kv_cache``) are plain PyTorch, as
the reference's are plain jnp outside any Pallas kernel; the cache is
written in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import modules as M

NEG_INF = -1e30


def gqa_repeat(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Kh, D) -> (B, S, Kh*n_rep, D), each KV head repeated in place."""
    if n_rep == 1:
        return kv
    b, s, kh, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(
        b, s, kh * n_rep, d)


def qkv_project(p, x: torch.Tensor, n_heads: int, n_kv_heads: int,
                head_dim: int, positions: torch.Tensor, *,
                rope_theta: float = 10000.0):
    """x (B, S, d) -> q (B, S, H, D), k and v (B, S, Kh, D), q and k
    rotated at ``positions`` (B, S). ``p`` holds the ``wq``/``wk``/``wv``
    linears (an ``AttnLayer``'s ``attn``)."""
    b, s, _ = x.shape
    q = p["wq"](x).reshape(b, s, n_heads, head_dim)
    k = p["wk"](x).reshape(b, s, n_kv_heads, head_dim)
    v = p["wv"](x).reshape(b, s, n_kv_heads, head_dim)
    q = M.apply_rope(q, positions, theta=rope_theta)
    k = M.apply_rope(k, positions, theta=rope_theta)
    return q, k, v


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
    nq, nk = -(-s // q_block), -(-sk // kv_block)   # the last ones ragged

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
        rows = qb.shape[2]
        q_pos = qi * q_block + torch.arange(rows, device=q.device)
        if window is not None:
            lo_pos = max(qi * q_block - (window - 1), 0)
            kv_lo = max(min(lo_pos // kv_block, nk - kv_span), 0)
        else:
            kv_lo = 0
        m = torch.full((b, h, rows), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, rows), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, rows, d), dtype=torch.float32,
                          device=q.device)
        for j in range(kv_span):
            kj = kv_lo + j
            kb = kt[:, :, kj * kv_block:(kj + 1) * kv_block]
            vb = vt[:, :, kj * kv_block:(kj + 1) * kv_block]
            scores = torch.matmul(qb.float(), kb.float().transpose(-1, -2))
            k_pos = kj * kv_block + torch.arange(kb.shape[2], device=q.device)
            mask = torch.ones((rows, kb.shape[2]), dtype=torch.bool,
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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """One new token against a KV cache: q (B, 1, H, D); caches (B, S, Kh,
    D); attends to cache positions < ``cache_len`` (an int or a 0-d
    tensor). The grouped form: each KV head serves its H / Kh query heads
    without a repeated copy of the cache. Scores and the weighted sum
    accumulate in f32 (the reference's ``preferred_element_type``), the
    softmax weights are rounded to the cache's dtype first, and the output
    is in q's dtype."""
    b, _, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    n_rep = h // kh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, 1, kh, n_rep, d) * scale
    scores = torch.einsum("bqgrd,bsgd->bgrqs", qg.float(),
                          k_cache.float())               # (B, Kh, rep, 1, S)
    pos = torch.arange(s, device=q.device)
    scores = torch.where(pos < cache_len, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqs,bsgd->bqgrd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor, pos) -> tuple:
    """Write one token (B, 1, Kh, D) at cache position ``pos`` (an int),
    in the caches' dtype, in place. Returns the two caches."""
    k_cache[:, pos:pos + 1] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + 1] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def reference_attention(q, k, v, *, window=None, causal=True):
    """O(S^2) oracle in model layout: the port's one oracle,
    ``kernels.attn.ops.attention`` on its plain path (imported here, since
    that module imports ``gqa_repeat`` from this one)."""
    from ..kernels.attn.ops import attention
    return attention(q, k, v, causal=causal, window=window, use_kernel=False)
