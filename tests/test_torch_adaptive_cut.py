"""The port's adaptive cut profile (``core/adaptive_cut.py``, the profile
counter of ``core/flops.py`` and ``fleet/hetero``'s cut assignment) against
the reference.

- The profile counter (``profile_flops``, on the meta device) equals the
  reference's ``jaxpr_flops`` exactly, stage by stage, on all four CNNs at
  batch 2-8 (tinycnn at 16 px, the others at 32 px), and on single
  conv-GroupNorm layers whose channels fall in each of the reference's
  three grouping rules.
- Every ``CutChoice`` of ``profile_cuts_cnn`` (tinycnn, MobileNetV2) over
  edges (Jetson, MCU) x links (fp32, int8, 1 Mb/s) x ``min_client_layers``
  (1, 2): index, smashed bytes and client FLOPs exactly, times and energy
  within 1e-12 relative; ``select_cut`` under deadlines None, 10 ms, 1 ms
  picks the reference's cut.
- The witness: MobileNetV2 on a Jetson, fp32 link, no deadline picks cut 2,
  the reference's, at 32 px batch 8 and at 224 px batch 16, where the
  billing counter's counts (0.79-0.98 of the reference's a stage) pick 3.
- The card's cuts: MobileNetV2 at 224 px, batch 16, edges (Jetson, MCU)
  over 4 clients, int8, the mission's 20 s deadline: [2, 1, 2, 1], in both
  packages.
- ``profile_cuts_transformer`` on a tiny ``ArchConfig``, SmolLM-135M and
  rwkv6-7b; ``bucket_by_cut`` on the reference's case.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import reference_params

from repro import configs as ref_configs
from repro.configs.base import ArchConfig as RefArchConfig
from repro.core.adaptive_cut import profile_cuts_cnn as ref_profile_cuts_cnn
from repro.core.adaptive_cut import \
    profile_cuts_transformer as ref_profile_cuts_transformer
from repro.core.adaptive_cut import select_cut as ref_select_cut
from repro.core.energy import HardwareProfile as RefHardwareProfile
from repro.core.energy import JETSON_AGX_ORIN as REF_JETSON
from repro.core.flops import jaxpr_flops
from repro.core.link import LinkConfig as RefLinkConfig
from repro.fleet.hetero import assign_cuts_cnn as ref_assign_cuts_cnn
from repro.fleet.hetero import bucket_by_cut as ref_bucket_by_cut
from repro.models import cnn as ref_cnn
from repro_torch import configs
from repro_torch.api.runtime import mission_max_link_s
from repro_torch.configs.base import ArchConfig
from repro_torch.core import adaptive_cut
from repro_torch.core.adaptive_cut import (profile_cuts_cnn,
                                           profile_cuts_transformer,
                                           select_cut, stage_profile)
from repro_torch.core.energy import HardwareProfile, JETSON_AGX_ORIN
from repro_torch.core.flops import count_flops, profile_flops
from repro_torch.core.link import LinkConfig
from repro_torch.fleet.hetero import assign_cuts_cnn, bucket_by_cut
from repro_torch.models.cnn import CNN_BUILDERS, ConvGN

# the microcontroller-class profile of the reference's tests
# (tests/test_api.py:47-48)
MCU_FIELDS = dict(fp32_tflops=0.02, mem_bw_gbs=2.0, tensor_tflops=0.04,
                  cpu_passmark=400.0, power_w=2.0)
MCU = HardwareProfile("mcu-class", **MCU_FIELDS)
REF_MCU = RefHardwareProfile("mcu-class", **MCU_FIELDS)
EDGES = {"jetson": (JETSON_AGX_ORIN, REF_JETSON), "mcu": (MCU, REF_MCU)}
LINKS = {"fp32": dict(), "int8": dict(compress="int8"),
         "1mbps": dict(rate_bps=1e6)}
DEADLINES = (None, 10e-3, 1e-3)
EXACT = ("cut_index", "smashed_bytes", "client_flops")
CLOSE = ("client_fraction", "t_client_s", "t_link_s", "energy_j")


def _ref_stage_flops(name, size, batch):
    stages = ref_cnn.CNN_BUILDERS[name](12)
    params = reference_params(name)[1]
    act = jax.ShapeDtypeStruct((batch, size, size, 3), jnp.float32)
    out = []
    for s, p in zip(stages, params):
        out.append(jaxpr_flops(s.apply, p, act))
        act = jax.eval_shape(s.apply, p, act)
    return out


@pytest.mark.parametrize("name,size,batch", [
    ("tinycnn", 16, 4), ("mobilenetv2", 32, 8), ("resnet18", 32, 2),
    ("googlenet", 32, 2)])
def test_stage_counts_equal_jaxpr_flops_exactly(name, size, batch):
    want = _ref_stage_flops(name, size, batch)
    got = stage_profile(CNN_BUILDERS[name](12),
                        torch.empty(batch, size, size, 3, device="meta"))
    assert [f for f, _ in got] == want
    # each stage's output: the reference's NHWC shape, NCHW here
    stages = ref_cnn.CNN_BUILDERS[name](12)
    act = jax.ShapeDtypeStruct((batch, size, size, 3), jnp.float32)
    for s, p, (_, out) in zip(stages, reference_params(name)[1], got):
        act = jax.eval_shape(s.apply, p, act)
        nhwc = out.permute(0, 2, 3, 1) if out.dim() == 4 else out
        assert tuple(nhwc.shape) == act.shape


@pytest.mark.parametrize("cout", [16, 12, 3])
@pytest.mark.parametrize("act", ["relu", "relu6", None])
def test_conv_gn_layer_counts_equal_jaxpr_flops(cout, act):
    """The three GroupNorm grouping rules (C/8, C/4, one group), after a
    stride-2 conv whose SAME padding is asymmetric, with each activation."""
    layer = ConvGN(3, 5, cout, stride=2, act=act)
    x = torch.zeros(2, 5, 7, 9)
    got, _ = profile_flops(layer, x)
    p = ref_cnn._conv_gn_relu_init(jax.random.PRNGKey(0), 3, 5, cout)

    def ref(p, x):
        y = ref_cnn._conv_gn_relu(p, x, stride=2, relu=act == "relu")
        return ref_cnn._relu6(y) if act == "relu6" else y

    assert float(got) == jaxpr_flops(ref, p, jnp.zeros((2, 7, 9, 5)))


def _assert_choices(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in EXACT:
            assert getattr(g, f) == getattr(w, f), f
        for f in CLOSE:
            assert getattr(g, f) == pytest.approx(getattr(w, f), rel=1e-12)


@pytest.mark.parametrize("link", list(LINKS))
@pytest.mark.parametrize("edge", list(EDGES))
@pytest.mark.parametrize("name,size,batch", [("tinycnn", 16, 4),
                                             ("mobilenetv2", 32, 8)])
def test_cut_choices_match_reference(name, size, batch, edge, link):
    port_edge, ref_edge = EDGES[edge]
    ref_stages, params = reference_params(name)
    x = jax.ShapeDtypeStruct((batch, size, size, 3), jnp.float32)
    for mcl in (1, 2):
        want = ref_profile_cuts_cnn(ref_stages, params, x, edge=ref_edge,
                                    link=RefLinkConfig(**LINKS[link]),
                                    min_client_layers=mcl)
        got = profile_cuts_cnn(CNN_BUILDERS[name](12),
                               torch.empty(batch, size, size, 3),
                               edge=port_edge, link=LinkConfig(**LINKS[link]),
                               min_client_layers=mcl)
        _assert_choices(got, want)
        for deadline in DEADLINES:
            assert (select_cut(got, max_link_s=deadline).cut_index
                    == ref_select_cut(want, max_link_s=deadline).cut_index)


@pytest.mark.parametrize("size,batch", [(32, 8), (224, 16)])
def test_mobilenetv2_jetson_fp32_picks_the_references_cut(size, batch,
                                                          monkeypatch):
    """The case the billing counter gets wrong: with its counts (0.79-0.98
    of the reference's a stage, the elementwise work of GroupNorm and
    relu6 left out) the Jetson's minimum-energy cut is 3, with the
    reference's it is 2."""
    ref_stages, params = reference_params("mobilenetv2")
    want = ref_select_cut(ref_profile_cuts_cnn(
        ref_stages, params,
        jax.ShapeDtypeStruct((batch, size, size, 3), jnp.float32),
        edge=REF_JETSON)).cut_index

    def port_cut():
        return select_cut(profile_cuts_cnn(
            CNN_BUILDERS["mobilenetv2"](12),
            torch.empty(batch, size, size, 3, device="meta"),
            edge=JETSON_AGX_ORIN)).cut_index

    assert port_cut() == want == 2

    def billing_counts(fn, *args):
        out = []
        return count_flops(lambda *a: out.append(fn(*a)), *args), out[0]

    monkeypatch.setattr(adaptive_cut, "profile_flops", billing_counts)
    assert port_cut() == 3


def test_card_cuts_of_the_hetero_phase():
    """``chip_smoke.py``'s ``[hetero]`` phase: MobileNetV2 at 224 px, batch
    16, edges (Jetson, MCU) cycled over 4 clients, an int8 link at 100
    Mb/s, the UAV mission's per-step deadline (30 + 10) / 2 = 20 s."""
    deadline = mission_max_link_s(30.0, 10.0, 2)
    assert deadline == 20.0
    ref_stages, params = reference_params("mobilenetv2")
    want = ref_assign_cuts_cnn(
        ref_stages, params,
        jax.ShapeDtypeStruct((16, 224, 224, 3), jnp.float32),
        edges=[REF_JETSON, REF_MCU] * 2,
        links=[RefLinkConfig(compress="int8")] * 4, max_link_s=deadline)
    got = assign_cuts_cnn(
        CNN_BUILDERS["mobilenetv2"](12),
        torch.empty(16, 224, 224, 3, device="meta"),
        edges=[JETSON_AGX_ORIN, MCU] * 2,
        links=[LinkConfig(compress="int8")] * 4, max_link_s=deadline)
    assert got == want == [2, 1, 2, 1]


TINY_ARCH = dict(name="tiny-attn", family="dense", n_layers=4, d_model=16,
                 n_heads=2, n_kv_heads=2, d_ff=32, vocab=64, dtype="float32")


@pytest.mark.parametrize("arch", ["tiny", "smollm_135m", "rwkv6_7b",
                                  "deepseek_moe_16b"])
def test_transformer_profile_matches_reference(arch):
    if arch == "tiny":
        cfg, ref_cfg = ArchConfig(**TINY_ARCH), RefArchConfig(**TINY_ARCH)
    else:
        cfg, ref_cfg = getattr(configs, arch), getattr(ref_configs, arch)
    for edge, ref_edge in EDGES.values():
        for link in LINKS.values():
            got = profile_cuts_transformer(cfg, batch=4, seq=64, edge=edge,
                                           link=LinkConfig(**link))
            want = ref_profile_cuts_transformer(
                ref_cfg, batch=4, seq=64, edge=ref_edge,
                link=RefLinkConfig(**link))
            _assert_choices(got, want)
            assert [dataclasses.astuple(c) for c in got] == \
                [dataclasses.astuple(c) for c in want]


def test_bucket_by_cut_is_the_references_partition():
    cuts = [2, 1, 2, 1, 1, 3, 2, 1]
    got = bucket_by_cut(cuts)
    want = ref_bucket_by_cut(cuts)
    assert [(b.cut_index, b.client_ids) for b in got] == \
        [(b.cut_index, b.client_ids) for b in want]
    assert [b.cut_index for b in got] == [1, 2, 3]
    seen = [cid for b in got for cid in b.client_ids]
    assert sorted(seen) == list(range(len(cuts)))
    for b in got:
        assert all(cuts[cid] == b.cut_index for cid in b.client_ids)


def test_assign_cuts_shares_a_profile_and_checks_lengths():
    """Identical (hardware, link) profiles get one cut; per-client links
    must match the edges in length (the reference's message)."""
    stages = CNN_BUILDERS["tinycnn"](12)
    x = torch.empty(4, 16, 16, 3, device="meta")
    cuts = assign_cuts_cnn(stages, x, edges=[JETSON_AGX_ORIN, MCU] * 2)
    assert cuts[0] == cuts[2] and cuts[1] == cuts[3]
    assert all(1 <= k <= len(stages) - 1 for k in cuts)
    with pytest.raises(ValueError, match="same length"):
        assign_cuts_cnn(stages, x, edges=[MCU] * 2, links=[LinkConfig()])
