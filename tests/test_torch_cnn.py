"""The port's four backbones against the reference's, on the same params.

Logits at batch 2 and 32x32 from ``convert.from_reference(params)`` must
match ``repro.core.split.apply_stages`` within 1e-4 (f32; the two
frameworks sum convolutions in different orders), and so must the smashed
tensor at the 0.25 cut. The JAX side is jitted: on these stage lists XLA's
compile is quicker than op-by-op eager dispatch.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_harness import port_stages, reference_params

from repro.core.split import apply_stages as ref_apply
from repro.core.split import cut_index_for_fraction as ref_cut
from repro_torch.convert import from_reference
from repro_torch.core.split import (apply_stages, cut_index_for_fraction,
                                    to_port_layout)
from repro_torch.models.modules import same_pad_amounts

BACKBONES = ["tinycnn", "resnet18", "googlenet", "mobilenetv2"]


@pytest.mark.parametrize("name", BACKBONES)
def test_logits_and_smashed_match_reference(name):
    ref_stages, params = reference_params(name, seed=11)
    x = np.random.RandomState(1).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    k = ref_cut(ref_stages, 0.25)
    want_logits, want_sm = jax.jit(lambda p, xx: (
        ref_apply(ref_stages, p, xx),
        ref_apply(ref_stages[:k], p[:k], xx)))(params, x)

    stages = port_stages(name, params)
    assert cut_index_for_fraction(stages, 0.25) == k
    with torch.no_grad():
        xt = to_port_layout(torch.from_numpy(x))
        sm = apply_stages(stages[:k], xt)
        logits = apply_stages(stages[k:], sm)
    assert sm.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(sm.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_sm), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("size,k,stride,want", [
    (16, 3, 2, (0, 1)), (32, 7, 2, (2, 3)), (15, 3, 2, (1, 1)),
    (8, 3, 1, (1, 1)), (8, 1, 2, (0, 0)), (7, 5, 1, (2, 2))])
def test_same_padding_is_xlas(size, k, stride, want):
    assert same_pad_amounts(size, k, stride) == want
    lo, hi = want
    out = -(-size // stride)
    assert (size + lo + hi - k) // stride + 1 == out


def test_from_reference_rejects_another_model():
    _, params = reference_params("tinycnn")
    with pytest.raises(ValueError):
        from_reference(params, "mobilenetv2")
