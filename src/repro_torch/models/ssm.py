"""RWKV-6 ("Finch"): the time mix and the channel mix, in PyTorch.

Counterpart of the RWKV-6 half of ``repro.models.ssm``. Per head (hd =
head size) the time mix runs the recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t        (S: hd x hd)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with the data-dependent decay w_t = exp(-exp(w0 + (x_t A) B)) and
token-shift lerps on the inputs. The recurrence goes through
``kernels.rwkv.ops.wkv`` (the hand-written CUDA kernel on a CUDA tensor),
from the zero state or from a carried one: ``rwkv6_apply(state=...)``
continues a sequence (a chunked prefill) and ``rwkv6_step`` is the decode
step, one token from the state the previous one left. Parameter names are
the reference's pytree keys. Mamba is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv.ops import wkv
from . import modules as M


class RWKV6TimeMix(nn.Module):
    """The parameters of ``rwkv6_init``: the four lerp weights ``mu_*``,
    ``wr``/``wk``/``wv``/``wg``/``wo`` (d, d), the decay base ``w0`` and its
    LoRA ``w_lora_a`` (d, r) / ``w_lora_b`` (r, d), the bonus ``u`` (H, hd)
    and the per-head GroupNorm ``ln_x``."""

    def __init__(self, d_model: int, *, head_size: int = 64, lora_r: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h = d_model // head_size
        self.head_size = head_size

        def vec(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=dtype))

        self.mu_r, self.mu_k, self.mu_v, self.mu_w = (vec(d_model)
                                                      for _ in range(4))
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, M.Linear(d_model, d_model, bias=False,
                                         dtype=dtype))
        self.w0 = vec(d_model)
        self.w_lora_a = vec(d_model, lora_r)
        self.w_lora_b = vec(lora_r, d_model)
        self.u = vec(h, head_size)
        self.ln_x = M.HeadGroupNorm(d_model, h, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator):
        """``rwkv6_init``'s laws: mu ~ N(0, 0.1^2), linears lecun-normal,
        w0 ~ N(0, 0.5^2), the LoRA's A lecun-normal and B zero, u ~
        N(0, 0.3^2), ln_x unit scale and zero bias."""
        def draw(p, fn, **kw):
            p.copy_(fn(generator, p.shape, device=p.device, **kw))

        with torch.no_grad():
            for p in (self.mu_r, self.mu_k, self.mu_v, self.mu_w):
                draw(p, M.normal_init, stddev=0.1)
            for name in ("wr", "wk", "wv", "wg", "wo"):
                getattr(self, name).reset_parameters(generator)
            draw(self.w0, M.normal_init, stddev=0.5)
            draw(self.w_lora_a, M.lecun_normal)
            self.w_lora_b.zero_()
            draw(self.u, M.normal_init, stddev=0.3)
            self.ln_x.scale.fill_(1.0)
            self.ln_x.bias.zero_()


class RWKV6ChannelMix(nn.Module):
    """``rwkv6_ffn_init``: lerp weight ``mu_k``, ``wk`` (d, d_ff), ``wv``
    (d_ff, d) and the receptance ``wr`` (d, d)."""

    def __init__(self, d_model: int, d_ff: int, *,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mu_k = nn.Parameter(torch.empty(d_model, dtype=dtype))
        self.wk = M.Linear(d_model, d_ff, bias=False, dtype=dtype)
        self.wv = M.Linear(d_ff, d_model, bias=False, dtype=dtype)
        self.wr = M.Linear(d_model, d_model, bias=False, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.mu_k.copy_(M.normal_init(generator, self.mu_k.shape,
                                          device=self.mu_k.device,
                                          stddev=0.1))
            for lin in (self.wk, self.wv, self.wr):
                lin.reset_parameters(generator)


def rwkv6_empty_state(batch: int, d_model: int, *, head_size: int = 64,
                      dtype: torch.dtype = torch.float32, device=None) -> dict:
    """The zero recurrent state: ``S`` (B, H, hd, hd) f32 and the token
    shift's ``x_prev`` (B, d) in ``dtype``, which ``rwkv6_apply`` and
    ``rwkv6_step`` take as ``state``."""
    h = d_model // head_size
    return {"S": torch.zeros((batch, h, head_size, head_size),
                             dtype=torch.float32, device=device),
            "x_prev": torch.zeros((batch, d_model), dtype=dtype,
                                  device=device)}


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """x_{t-1} per position of x (B, S, D), ``x_prev`` (B, D) before t=0."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _rwkv6_inner(p: RWKV6TimeMix, x: torch.Tensor, state,
                 head_size: int):
    """x (B, S, D) from ``state`` (``{"S", "x_prev"}``; None: the zero
    state, which the WKV kernel then takes as no S_0 at all). Returns
    (y (B, S, D), new state)."""
    b, s, d = x.shape
    h = d // head_size
    if state is None:
        x_prev, s0 = x.new_zeros((b, d)), None
    else:
        x_prev, s0 = state["x_prev"], state["S"].float().contiguous()
    x_sh = _token_shift(x, x_prev)

    def lerp(mu):
        return x + (x_sh - x) * mu.to(x.dtype)

    r = p.wr(lerp(p.mu_r)).reshape(b, s, h, head_size)
    k = p.wk(lerp(p.mu_k)).reshape(b, s, h, head_size)
    v = p.wv(lerp(p.mu_v)).reshape(b, s, h, head_size)
    g = p.wg(x)
    xw = lerp(p.mu_w)                          # data-dependent decay, in f32
    dd = (xw.float() @ p.w_lora_a.float()) @ p.w_lora_b.float()
    w = torch.exp(-torch.exp(p.w0.float() + dd)).reshape(b, s, h, head_size)

    def heads(a):                              # (B,S,H,hd) -> (B,H,S,hd) f32
        return a.float().transpose(1, 2).contiguous()

    y, S_new = wkv(heads(r), heads(k), heads(v), heads(w), p.u.float(),
                   state=s0, return_state=True)
    y = y.transpose(1, 2).reshape(b, s, d)     # (B,S,D) f32
    y = p.ln_x(y).to(x.dtype) * M.silu(g)      # per-head norm, then the gate
    return p.wo(y), {"S": S_new, "x_prev": x[:, -1, :]}


def rwkv6_apply(p: RWKV6TimeMix, x: torch.Tensor, state=None, *,
                head_size: int = 64):
    """The time mix over a sequence x (B, S, D), from the zero state
    (training, a prefill from scratch) or from a carried ``state``
    (``{"S": (B, H, hd, hd) f32, "x_prev": (B, D)}``, e.g. the last chunk's:
    a chunked prefill). Returns (y, {"S": S_T, "x_prev"}). Differentiable in
    the state too."""
    return _rwkv6_inner(p, x, state, head_size)


def rwkv6_step(p: RWKV6TimeMix, x1: torch.Tensor, state, *,
               head_size: int = 64):
    """One decode step: x1 (B, 1, D) from ``state``, a WKV scan of T = 1
    from S_0 = ``state["S"]``. Returns (y (B, 1, D), new state)."""
    return _rwkv6_inner(p, x1, state, head_size)


def rwkv6_ffn_apply(p: RWKV6ChannelMix, x: torch.Tensor,
                    x_prev: torch.Tensor) -> torch.Tensor:
    """RWKV channel mix: relu(k)^2 value kernel, receptance gate. x (B, S,
    D); x_prev (B, D) the last token of the previous chunk."""
    xk = x + (_token_shift(x, x_prev) - x) * p.mu_k.to(x.dtype)
    k = torch.square(F.relu(p.wk(xk)))
    r = torch.sigmoid(p.wr(xk))
    return r * p.wv(k)
