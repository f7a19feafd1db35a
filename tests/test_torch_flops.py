"""The port's FLOP counter (``repro_torch.core.flops``) against the reference.

Gates, at batch 8, on tinycnn at 16x16 and MobileNetV2 at 32x32 at the 0.25
cut, and on the paper's other two backbones, ResNet-18 and GoogLeNet, at
32x32 at all four of its splits (SL_75_25, SL_40_60, SL_25_75, SL_15_85):

- contractions: the counter's conv/matmul part of the client step, the
  server step and the full-model FL step equals, exactly, the reference's
  analytic count of ``dot_general``/``conv_general_dilated`` over the very
  step functions it bills (``repro.api.runtime.count_*`` with ``flops_of``
  swapped for the restricted jaxpr walk);
- totals, at the 0.25 cut: the port's total over the reference's XLA
  ``flops_of`` is pinned at the ratio measured when this test was written —
  a record of how far the two bills stand apart, not a pass band. XLA-CPU
  counts MobileNetV2 at 4-5x its contractions, which no PyTorch count
  reproduces. For ResNet-18 and GoogLeNet it counts *below* their
  contractions (ResNet-18's server step at ~0.47x, GoogLeNet's at ~0.68x
  at the 0.15 cut, batch 8): the reference's energy bill of these two
  backbones misses part of their convolutions, and the port's total, which
  counts every one, stands above it. The records' billing arithmetic
  (energies scale by exactly this ratio) is checked in
  ``test_torch_plan.py`` and ``test_torch_paper_*.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import (jax_contraction_flops, port_stages,
                                reference_params)

import repro.api.runtime as ref_runtime
from repro.core.split import cut_index_for_fraction
from repro_torch.api.runtime import count_fl_step_flops, count_sl_step_flops
from repro_torch.core.flops import FlopCounter, count_flops

# the paper's splits SL_{a,b}: the client's share a
PAPER_FRACTIONS = (0.75, 0.40, 0.25, 0.15)
CASES = ([pytest.param("tinycnn", 16, 0.25, id="tinycnn-16"),
          pytest.param("mobilenetv2", 32, 0.25, id="mobilenetv2-32")]
         + [pytest.param(name, 32, f, id=f"{name}-32-{f}")
            for name in ("resnet18", "googlenet") for f in PAPER_FRACTIONS])
TOTAL_CASES = [("tinycnn", 16), ("mobilenetv2", 32), ("resnet18", 32),
               ("googlenet", 32)]

# port total / reference XLA flops_of, measured at these shapes
# (client, server, full-model FL step)
TOTAL_RATIOS = {
    "tinycnn": (0.716993, 1.994969, 1.444006),
    "mobilenetv2": (0.205844, 0.237900, 0.227036),
    "resnet18": (1.131950, 2.458304, 1.857707),
    "googlenet": (1.188569, 1.572323, 1.329917),
}


def _setup(name, size, fraction=0.25):
    ref_stages, params = reference_params(name)
    x = np.random.RandomState(0).uniform(0, 1, (8, size, size, 3)).astype(
        np.float32)
    y = np.arange(8) % 12
    k = cut_index_for_fraction(ref_stages, fraction)
    stages = port_stages(name, params)
    port = (torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
    ref = (jnp.asarray(x), jnp.asarray(y))
    return ref_stages, params, stages, k, ref, port


def _ref_counts(ref_stages, params, k, ref):
    c, s, _ = ref_runtime.count_sl_step_flops(
        ref_stages[:k], params[:k], ref_stages[k:], params[k:], *ref)
    f = ref_runtime.count_fl_step_flops(ref_stages, params, *ref)
    return c, s, f


def _port_counts(stages, k, port):
    c, s, smashed = count_sl_step_flops(stages[:k], stages[k:], *port)
    return c, s, count_fl_step_flops(stages, *port), smashed


@pytest.mark.parametrize("name,size,fraction", CASES)
def test_contractions_equal_reference_exactly(name, size, fraction,
                                              monkeypatch):
    ref_stages, params, stages, k, ref, port = _setup(name, size, fraction)
    monkeypatch.setattr(ref_runtime, "flops_of", jax_contraction_flops)
    want = _ref_counts(ref_stages, params, k, ref)
    got = _port_counts(stages, k, port)[:3]
    assert [g.contraction for g in got] == list(want)


@pytest.mark.parametrize("name,size", TOTAL_CASES)
def test_total_over_xla_count_is_the_recorded_ratio(name, size):
    ref_stages, params, stages, k, ref, port = _setup(name, size)
    want = _ref_counts(ref_stages, params, k, ref)
    got = _port_counts(stages, k, port)[:3]
    ratios = tuple(float(g) / w for g, w in zip(got, want))
    assert ratios == pytest.approx(TOTAL_RATIOS[name], abs=1e-6)
    assert all(float(g) > g.contraction > 0 for g in got)


def test_smashed_spec_is_the_nhwc_cut():
    _, _, stages, k, _, port = _setup("mobilenetv2", 32)
    smashed = _port_counts(stages, k, port)[3]
    assert smashed.shape == (8, 4, 4, 32) and smashed.itemsize == 4
    assert stages[k - 1].name == "ir2_0"


def test_counter_rules_on_single_ops():
    x = torch.randn(2, 3, 8, 8)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    with FlopCounter() as fc:
        y = torch.nn.functional.conv2d(x, w, padding=1)
    assert fc.contraction == 2 * y.numel() * 27 and fc.other == 0
    a, b = torch.randn(4, 6), torch.randn(6, 5)
    assert count_flops(lambda: a @ b).contraction == 2 * 20 * 6
    total = count_flops(lambda: a.sum())
    assert float(total) == a.numel() and total.contraction == 0
    assert float(count_flops(lambda: torch.relu(a))) == a.numel()
    assert float(count_flops(lambda: a.permute(1, 0).reshape(-1))) == 0


# the split LM (smollm_135m.reduced(), cut 1 of 2, batch 4 x 64 tokens):
# port total / reference XLA flops_of per attention path (client, server)
LM_TOTAL_RATIOS = {"xla": (0.997348, 0.997415), "ref": (0.996897, 0.997043)}


@pytest.mark.parametrize("impl", list(LM_TOTAL_RATIOS))
def test_lm_split_step_flops_against_reference(impl, monkeypatch):
    """Contractions equal the reference's dot_general count exactly; the
    totals stand at the recorded ratio to XLA's count."""
    import jax
    from repro.configs import smollm_135m as ref_smollm
    from repro.fleet.hetero import lm_split_program as ref_lm_split_program
    from repro_torch.api.runtime import count_split_step_flops
    from repro_torch.configs import smollm_135m
    from repro_torch.convert import lm_from_reference
    from repro_torch.fleet.hetero import lm_modules, lm_split_step

    cfg, ref_cfg, k = smollm_135m.reduced(), ref_smollm.reduced(), 1
    prog = ref_lm_split_program(ref_cfg, jax.random.PRNGKey(0), k,
                                attn_impl=impl)
    rng = np.random.RandomState(0)
    bx, by = (rng.randint(0, cfg.vocab, (4, 64)).astype(np.int32)
              for _ in range(2))
    ref_args = (prog.step, prog.params_c0, prog.params_s0, jnp.asarray(bx),
                jnp.asarray(by))
    want = ref_runtime.count_split_step_flops(*ref_args)[:2]
    monkeypatch.setattr(ref_runtime, "flops_of", jax_contraction_flops)
    want_contraction = ref_runtime.count_split_step_flops(*ref_args)[:2]

    client, server = lm_modules(cfg, k)
    sd_c, sd_s = lm_from_reference(*jax.tree_util.tree_map(
        np.asarray, (prog.params_c0, prog.params_s0)), cfg)
    client.load_state_dict(sd_c, assign=True)
    server.load_state_dict(sd_s, assign=True)
    step, _ = lm_split_step(cfg, attn_impl=impl)
    c, s, smashed = count_split_step_flops(
        step, client, server, torch.tensor(bx).long(),
        torch.tensor(by).long())
    assert smashed.shape == (4, 64, cfg.d_model) and smashed.itemsize == 4
    assert [c.contraction, s.contraction] == list(want_contraction)
    ratios = (float(c) / want[0], float(s) / want[1])
    assert ratios == pytest.approx(LM_TOTAL_RATIOS[impl], abs=1e-6)
