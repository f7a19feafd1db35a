"""Adaptive split-point selection (the paper's §V future work).

Counterpart of ``repro.core.adaptive_cut``. Given a CNN stage list or a
transformer ``ArchConfig``, every cut point is priced by the client-side
energy of one batch,

    E(cut) = T_client(cut) * P_edge + T_link(cut) * P_radio,

with T_client a FLOP roofline on the A5000 scaled to the edge profile by
Eq. (9), and T_link = L / R (Eq. 8) on the smashed bytes L of that cut
(int8-compressed when the link is). ``min_client_layers`` is the privacy
floor: raw data never leaves the device, so at least that many stages stay
there.

The CNN profile counts each stage's forward with ``core.flops.
profile_flops``, the reference's jaxpr rules, on the meta device: shapes
alone, no arithmetic, so a 224x224 profile costs what a 16x16 one does.
The billing counter (``count_flops``) counts the ATen ops that run, which
differs from the reference's count by the elementwise work of GroupNorm and
relu6, and that difference moves MobileNetV2's cut on a Jetson.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch.func import functional_call

from .energy import HardwareProfile, JETSON_AGX_ORIN, RTX_A5000, scale_time
from .flops import profile_flops
from .link import LinkConfig
from .split import Stage, to_port_layout


@dataclasses.dataclass(frozen=True)
class CutChoice:
    cut_index: int
    client_fraction: float
    client_flops: float
    smashed_bytes: int
    t_client_s: float
    t_link_s: float
    energy_j: float


def stage_profile(stages: Sequence[Stage], x: torch.Tensor
                  ) -> list[tuple[float, torch.Tensor]]:
    """``(forward FLOPs, output)`` of every stage, the activation chained
    through the stages from the NHWC batch ``x``: FLOPs by the reference's
    jaxpr rules, outputs as meta tensors (NCHW, the port's layout)."""
    act = to_port_layout(torch.empty(tuple(x.shape), dtype=x.dtype,
                                     device="meta"))
    out = []
    for stage in stages:
        params = {k: torch.empty_like(v, device="meta")
                  for k, v in stage.named_parameters()}
        flops, act = profile_flops(
            lambda a: functional_call(stage, params, (a,)), act)
        out.append((float(flops), act))
    return out


def profile_cuts_cnn(stages: Sequence[Stage], x: torch.Tensor, *,
                     edge: HardwareProfile = JETSON_AGX_ORIN,
                     link: Optional[LinkConfig] = None,
                     min_client_layers: int = 1,
                     bwd_factor: float = 3.0) -> list[CutChoice]:
    """Energy profile for every admissible cut of a CNN stage list on the
    NHWC batch ``x``: prefix FLOPs are the running sum of the stages'
    forward counts (``stage_profile``), the smashed bytes those of the
    stage output at the cut (the NCHW tensor holds the reference's NHWC
    element count)."""
    link = link or LinkConfig()
    total_depth = sum(s.depth for s in stages)
    cum_flops, smashed_after = [], []
    running = 0.0
    for flops, act in stage_profile(stages, x):
        running += flops
        cum_flops.append(running)
        smashed_after.append(act)
    out = []
    for k in range(min_client_layers, len(stages)):
        fwd = cum_flops[k - 1]
        smashed = smashed_after[k - 1]
        itemsize = smashed.element_size()
        sm_bytes = int(smashed.numel()) * itemsize
        # edge time: fwd + bwd of the prefix, scaled per Eq. 9
        t_src = bwd_factor * fwd / (RTX_A5000.fp32_tflops * 1e12)
        t_client = scale_time(t_src, RTX_A5000, edge)
        t_link = link.transfer_time_s(2 * sm_bytes, itemsize)
        e = t_client * edge.power_w + t_link * link.radio_power_w
        out.append(CutChoice(
            cut_index=k,
            client_fraction=sum(s.depth for s in stages[:k]) / total_depth,
            client_flops=fwd, smashed_bytes=sm_bytes,
            t_client_s=t_client, t_link_s=t_link, energy_j=e))
    return out


def select_cut(choices: Sequence[CutChoice], *,
               max_link_s: Optional[float] = None) -> CutChoice:
    """Minimum-energy cut, optionally under a per-step link deadline (the
    UAV hover window of Algorithm 2); with no cut inside the deadline, the
    cut of the fastest link."""
    admissible = [c for c in choices
                  if max_link_s is None or c.t_link_s <= max_link_s]
    if not admissible:
        return min(choices, key=lambda c: c.t_link_s)
    return min(admissible, key=lambda c: c.energy_j)


def profile_cuts_transformer(cfg, *, batch: int, seq: int,
                             edge: HardwareProfile = JETSON_AGX_ORIN,
                             link: Optional[LinkConfig] = None,
                             bwd_factor: float = 3.0) -> list[CutChoice]:
    """Analytic cut profile of a transformer ``ArchConfig``: the client's
    layers are alike, so a layer's forward is 2 * params_layer * tokens
    (MoE: the active experts), and the smashed tensor is always (batch,
    seq, d_model)."""
    link = link or LinkConfig()
    tokens = batch * seq
    d = cfg.d_model
    if cfg.ssm_kind == "rwkv6":
        layer_params = 5 * d * d + 2 * d * cfg.d_ff + d * d
    else:
        layer_params = (d * cfg.n_heads * cfg.hd
                        + 2 * d * cfg.n_kv_heads * cfg.hd
                        + cfg.n_heads * cfg.hd * d)
        if cfg.n_experts:
            layer_params += cfg.top_k * 3 * d * (cfg.moe_d_ff or cfg.d_ff)
        else:
            layer_params += 3 * d * cfg.d_ff
    sm_bytes = tokens * d * (2 if cfg.dtype == "bfloat16" else 4)
    out = []
    n = cfg.n_enc_layers if cfg.enc_dec else cfg.n_layers
    for k in range(1, n):
        fwd = 2.0 * k * layer_params * tokens
        t_src = bwd_factor * fwd / (RTX_A5000.fp32_tflops * 1e12)
        t_client = scale_time(t_src, RTX_A5000, edge)
        t_link = link.transfer_time_s(2 * sm_bytes, 2)
        e = t_client * edge.power_w + t_link * link.radio_power_w
        out.append(CutChoice(cut_index=k, client_fraction=k / n,
                             client_flops=fwd, smashed_bytes=sm_bytes,
                             t_client_s=t_client, t_link_s=t_link,
                             energy_j=e))
    return out
