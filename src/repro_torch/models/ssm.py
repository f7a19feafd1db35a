"""RWKV-6 ("Finch") and Mamba, in PyTorch.

Counterpart of ``repro.models.ssm``. RWKV-6: per head (hd =
head size) the time mix runs the recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t        (S: hd x hd)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with the data-dependent decay w_t = exp(-exp(w0 + (x_t A) B)) and
token-shift lerps on the inputs. The recurrence goes through
``kernels.rwkv.ops.wkv`` (the hand-written CUDA kernel on a CUDA tensor),
from the zero state or from a carried one: ``rwkv6_apply(state=...)``
continues a sequence (a chunked prefill) and ``rwkv6_step`` is the decode
step, one token from the state the previous one left.

Mamba (the ``jamba`` super-block's sequence mixer): a depthwise causal
conv over a carried context of ``conv_width - 1`` rows, the input-dependent
dt, B and C, and the selective scan

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t     (h: d_inner x N)
    y_t = C_t . h_t + D x_t

in f32, a plain loop over time as the reference's ``lax.scan`` is (no
kernel: the reference has none). ``mamba_apply`` runs a sequence from the
empty state or a carried ``{"h", "conv"}``; ``mamba_step`` is the decode
step. Parameter names are the reference's pytree keys.
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


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

class Mamba(nn.Module):
    """``mamba_init``: ``in_proj`` (d, 2 d_inner), the depthwise conv
    ``conv_w`` (conv_width, d_inner) and ``conv_b``, dt's low-rank
    projection ``w_dt_a`` (d_inner, r) / ``w_dt_b`` (r, d_inner) with
    r = max(1, d // 16) and ``dt_bias``, ``w_B`` / ``w_C`` (d_inner, N),
    ``A_log`` (d_inner, N), the skip ``D`` and ``out_proj`` (d_inner, d);
    d_inner = expand * d."""

    def __init__(self, d_model: int, *, expand: int = 2, state_dim: int = 16,
                 conv_width: int = 4, dt_rank: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d_inner = expand * d_model
        dt_rank = dt_rank or max(1, d_model // 16)

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=dtype))

        self.in_proj = M.Linear(d_model, 2 * d_inner, bias=False, dtype=dtype)
        self.conv_w = param(conv_width, d_inner)
        self.conv_b = param(d_inner)
        self.w_dt_a = param(d_inner, dt_rank)
        self.w_dt_b = param(dt_rank, d_inner)
        self.dt_bias = param(d_inner)
        self.w_B = M.Linear(d_inner, state_dim, bias=False, dtype=dtype)
        self.w_C = M.Linear(d_inner, state_dim, bias=False, dtype=dtype)
        self.A_log = param(d_inner, state_dim)
        self.D = param(d_inner)
        self.out_proj = M.Linear(d_inner, d_model, bias=False, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator):
        """``mamba_init``'s laws: the linears and dt's projection
        lecun-normal, conv_w ~ N(0, 0.2^2), dt_bias ~ N(0, 0.1^2), conv_b
        zero, A_log = log(1..N) on every row, D one."""
        def draw(p, fn, **kw):
            p.copy_(fn(generator, p.shape, device=p.device, **kw))

        with torch.no_grad():
            for lin in (self.in_proj, self.w_B, self.w_C, self.out_proj):
                lin.reset_parameters(generator)
            draw(self.conv_w, M.normal_init, stddev=0.2)
            self.conv_b.zero_()
            draw(self.w_dt_a, M.lecun_normal)
            draw(self.w_dt_b, M.lecun_normal)
            draw(self.dt_bias, M.normal_init, stddev=0.1)
            n = self.A_log.shape[1]
            self.A_log.copy_(torch.log(torch.arange(
                1, n + 1, dtype=torch.float32,
                device=self.A_log.device)).expand_as(self.A_log))
            self.D.fill_(1.0)


def mamba_empty_state(batch: int, d_model: int, *, expand: int = 2,
                      state_dim: int = 16, conv_width: int = 4,
                      dtype: torch.dtype = torch.float32, device=None) -> dict:
    """The zero state: ``h`` (B, d_inner, N) f32 and the conv context
    ``conv`` (B, conv_width - 1, d_inner) in ``dtype``."""
    d_inner = expand * d_model
    return {"h": torch.zeros((batch, d_inner, state_dim), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype,
                                device=device)}


def _causal_conv(ctx: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """The depthwise causal conv over ctx (B, S + cw - 1, d_inner): the
    reference's shifted sum, term by term in ctx's dtype (in bf16 each
    product and partial sum rounds, which ``F.conv1d``'s f32 accumulation
    does not)."""
    cw = conv_w.shape[0]
    s = ctx.shape[1] - (cw - 1)
    return sum(ctx[:, i:i + s, :] * conv_w[i].to(ctx.dtype)
               for i in range(cw))


def _dt(p: Mamba, xi: torch.Tensor) -> torch.Tensor:
    """softplus(xi W_a W_b + dt_bias), computed in xi's dtype, then f32."""
    return F.softplus((xi @ p.w_dt_a.to(xi.dtype)) @ p.w_dt_b.to(xi.dtype)
                      + p.dt_bias.to(xi.dtype)).float()


def _mamba_inner(p: Mamba, x: torch.Tensor, state: dict):
    """x (B, S, d) from ``state``. Returns (y (B, S, d), new state).

    The conv is the reference's shifted sum in its order (``F.conv1d``
    accumulates in f32 and drifts from it in bf16); dt is formed in x's
    dtype and then cast to f32; the scan runs in f32. exp(dt A) and
    dt B x are formed for every step at once (the same products, element
    by element, as the reference's step body), so the loop over time is
    one multiply-add a step; y = C . h is read off the stacked states."""
    xi, z = p.in_proj(x).chunk(2, dim=-1)                 # (B, S, d_inner)
    cw = p.conv_w.shape[0]
    ctx = torch.cat([state["conv"].to(xi.dtype), xi], dim=1)
    xi = M.silu(_causal_conv(ctx, p.conv_w) + p.conv_b.to(xi.dtype))
    dt = _dt(p, xi)                                          # (B, S, d_inner)
    Bm = p.w_B(xi).float()                                   # (B, S, N)
    Cm = p.w_C(xi).float()
    A = -torch.exp(p.A_log.float())                          # (d_inner, N)
    xf = xi.float()
    dA = torch.exp(dt[..., None] * A)                        # (B, S, di, N)
    dBx = dt[..., None] * Bm[:, :, None, :] * xf[..., None]
    h = state["h"]
    hs = []
    for dA_t, dBx_t in zip(dA.unbind(1), dBx.unbind(1)):
        h = dA_t * h + dBx_t
        hs.append(h)
    y = torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1), Cm)
    y = y + xf * p.D.float()
    out = p.out_proj(y.to(x.dtype) * M.silu(z))
    new_conv = ctx[:, ctx.shape[1] - (cw - 1):, :] if cw > 1 \
        else state["conv"]
    return out, {"h": h, "conv": new_conv.to(state["conv"].dtype)}


def mamba_apply(p: Mamba, x: torch.Tensor, state=None, *, expand: int = 2,
                state_dim: int = 16, conv_width: int = 4):
    """Mamba over a sequence x (B, S, d), from the empty state in x's dtype
    (training, a prefill) or a carried ``{"h", "conv"}``. Returns (y,
    {"h": h_S, "conv": the last conv_width - 1 inputs})."""
    if state is None:
        state = mamba_empty_state(x.shape[0], x.shape[-1], expand=expand,
                                  state_dim=state_dim, conv_width=conv_width,
                                  dtype=x.dtype, device=x.device)
    return _mamba_inner(p, x, state)


def mamba_step(p: Mamba, x1: torch.Tensor, state: dict):
    """One decode step: x1 (B, 1, d) from ``state``."""
    return _mamba_inner(p, x1, state)
