"""The port's FLOP counter (``repro_torch.core.flops``) against the reference.

Gates, at batch 8 and the 0.25 cut, on tinycnn at 16x16 and MobileNetV2 at
32x32:

- contractions: the counter's conv/matmul part equals, exactly, the
  reference's analytic count of ``dot_general``/``conv_general_dilated``
  over the very step functions it bills (``repro.api.runtime.count_*`` with
  ``flops_of`` swapped for the restricted jaxpr walk);
- totals: the port's total over the reference's XLA ``flops_of`` is pinned
  at the ratio measured when this test was written — a record of how far
  the two bills stand apart, not a pass band (XLA-CPU counts MobileNetV2 at
  4-5x its contractions, which no PyTorch count reproduces). The records'
  billing arithmetic (energies scale by exactly this ratio) is checked in
  ``test_torch_plan.py``.
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

CASES = [("tinycnn", 16), ("mobilenetv2", 32)]

# port total / reference XLA flops_of, measured at these shapes
# (client, server, full-model FL step)
TOTAL_RATIOS = {
    "tinycnn": (0.716993, 1.994969, 1.444006),
    "mobilenetv2": (0.205844, 0.237900, 0.227036),
}


def _setup(name, size):
    ref_stages, params = reference_params(name)
    x = np.random.RandomState(0).uniform(0, 1, (8, size, size, 3)).astype(
        np.float32)
    y = np.arange(8) % 12
    k = cut_index_for_fraction(ref_stages, 0.25)
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


@pytest.mark.parametrize("name,size", CASES)
def test_contractions_equal_reference_exactly(name, size, monkeypatch):
    ref_stages, params, stages, k, ref, port = _setup(name, size)
    monkeypatch.setattr(ref_runtime, "flops_of", jax_contraction_flops)
    want = _ref_counts(ref_stages, params, k, ref)
    got = _port_counts(stages, k, port)[:3]
    assert [g.contraction for g in got] == list(want)


@pytest.mark.parametrize("name,size", CASES)
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
