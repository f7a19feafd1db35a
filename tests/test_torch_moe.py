"""The port's MoE FFN and Mamba mixer against the reference, on the CPU.

- ``moe_apply`` against the reference's at (E, k) in {(4, 1), (4, 2),
  (8, 6)}, with and without shared experts, at a capacity that drops
  nothing and at capacity_factor 0.5, where picks are dropped and only
  the reference's slot order (a cumsum over the picks flattened
  token-major) drops the same ones: outputs and ``aux`` to 1e-4 in f32,
  and on four of those cases (``GRAD_CASES``) every gradient (the
  router's, the shared experts', x's) against ``jax.value_and_grad``;
  ``_moe_apply_grouped`` at ``n_groups=2`` and ``moe_ref``, the same way;
  one bf16 case at the port's bf16 rule
  (``tests/test_torch_rwkv.py``'s ``_close``: one bf16 rounding of the
  output's largest magnitude, twice over);
- the dispatch table's drops, slots and padding rows, by hand;
- ``mamba_apply`` against the reference's in f32 and bf16, from the empty
  state and from a carried ``{h, conv}``; ``mamba_step`` chained equals
  ``mamba_apply`` (1e-5, ``tests/test_models.py``'s own); every gradient,
  the carried state's included, against ``jax.grad`` (1e-4);
- the modules' leaves: ``router.w`` f32 beside bf16 experts, the expert
  stacks drawn in their own dtype.

The MoE's weights are drawn by numpy at ``moe_init``'s traced structure
(its eager init costs seconds a case), Mamba's are ``mamba_init``'s own;
both are carried across by ``convert.module_from_reference``, and so are
the reference's gradients. Inputs come from numpy seeds.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.moe import _moe_apply_grouped as ref_moe_grouped
from repro.models.moe import moe_apply as ref_moe_apply
from repro.models.moe import moe_init as ref_moe_init
from repro.models.moe import moe_ref as ref_moe_ref
from repro.models.ssm import mamba_apply as ref_mamba_apply
from repro.models.ssm import mamba_init as ref_mamba_init
from repro_torch.convert import module_from_reference
from repro_torch.models.moe import (MoE, _experts, _moe_apply_grouped,
                                    _router, capacity_of, dispatch_table,
                                    moe_apply, moe_ref)
from repro_torch.models.ssm import (Mamba, _causal_conv, _dt, mamba_apply,
                                    mamba_empty_state, mamba_step)

TOL = 1e-4
D, FF, B, S = 16, 32, 2, 32     # T = 64 tokens: 0.5 drops for every (E, k)
AUX_COEF = 0.1                 # weights aux in the gradient checks' loss


def _torch_dtype(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _j(a: np.ndarray, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _t(a: np.ndarray, dtype):
    """The same values as ``_j(a, dtype)``: rounded by jax, then carried."""
    return torch.from_numpy(np.array(_j(a, dtype).astype(jnp.float32))).to(
        _torch_dtype(dtype))


def _close(got: torch.Tensor, want, dtype, err_msg="", bf16_bits=7):
    """f32: 1e-4. bf16: within one bf16 rounding (2^-8 relative) of the
    output's largest magnitude, twice over (``test_torch_rwkv._close``:
    2^-``bf16_bits``, 2^-7)."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=0, err_msg=err_msg,
                                   atol=2.0 ** -bf16_bits * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _moe_pair(e, k, shared, dtype="float32", seed=0):
    """A tree of ``moe_init``'s structure (traced, not run) with leaves
    drawn by numpy at its scales (N(0, 1/fan_in)), and the port's ``MoE``
    holding the same values."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: ref_moe_init(
        jax.random.PRNGKey(0), D, e, FF, k, n_shared=2 if shared else 0,
        dtype=jnp.dtype(dtype)))
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(
            rng.standard_normal(a.shape) / np.sqrt(a.shape[-2])).astype(
                a.dtype)), shapes)
    with torch.device("meta"):
        module = MoE(D, e, FF, k, n_shared=2 if shared else 0,
                     dtype=_torch_dtype(dtype))
    return tree, module_from_reference(tree, module)


def _x(shape, seed=1):
    return (0.5 * np.random.RandomState(seed).standard_normal(shape)).astype(
        np.float32)


def _moe_case(ref_fn, port_fn, e, k, shared, grads=True):
    """``ref_fn(p, x)`` and ``port_fn(module, x)`` -> (y, aux): values and
    aux to 1e-4, and with ``grads`` the gradients of sum(y gy) + AUX_COEF
    aux with respect to every leaf and x."""
    tree, module = _moe_pair(e, k, shared)
    x = _x((B, S, D))
    gy = np.random.RandomState(2).standard_normal(x.shape).astype(np.float32)
    p = jax.tree_util.tree_map(jnp.asarray, tree)

    def loss(p, xx):
        y, aux = ref_fn(p, xx)
        return jnp.sum(y * gy) + AUX_COEF * aux, (y, aux)

    if grads:
        (_, (want_y, want_aux)), (want_gp, want_gx) = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
                p, jnp.asarray(x))
    else:
        want_y, want_aux = jax.jit(ref_fn)(p, jnp.asarray(x))
    module.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_(grads)
    y, aux = port_fn(module, xt)
    assert y.dtype == torch.float32 and aux.shape == ()
    _close(y, want_y, "float32", "y")
    np.testing.assert_allclose(float(aux.detach()), float(want_aux),
                               atol=TOL, rtol=TOL)
    if grads:
        ((y * torch.from_numpy(gy)).sum() + AUX_COEF * aux).backward()
        _grads_close(module, want_gp)
        _close(xt.grad, want_gx, "float32", "x")


def _grads_close(module, want_tree):
    """Every leaf's gradient against the reference's, carried across as the
    weights are (the shared experts' stack unstacked), to 1e-4."""
    want = module_from_reference(
        jax.tree_util.tree_map(np.asarray, want_tree),
        copy.deepcopy(module).to("meta")).state_dict()
    assert sorted(want) == sorted(n for n, _ in module.named_parameters())
    for name, g in want.items():
        _close(module.get_parameter(name).grad, g.numpy(), "float32", name)


EK = [(4, 1), (4, 2), (8, 6)]
# the sweep's cases whose gradients are checked too (each one compiles
# the reference's gradient): both capacities, both kinds of layer, k > 1
GRAD_CASES = {(4, 1, False, "no_drop"), (4, 2, True, 0.5),
              (8, 6, False, 0.5), (8, 6, True, "no_drop")}


@pytest.mark.parametrize("capacity_factor", ["no_drop", 0.5])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("e,k", EK)
def test_moe_apply_and_gradients_match_reference(e, k, shared,
                                                 capacity_factor):
    cf = float(e) if capacity_factor == "no_drop" else capacity_factor
    _moe_case(lambda p, x: ref_moe_apply(p, x, top_k=k, capacity_factor=cf),
              lambda m, x: moe_apply(m, x, top_k=k, capacity_factor=cf),
              e, k, shared,
              grads=(e, k, shared, capacity_factor) in GRAD_CASES)
    # the case is what it says: the reference's own table drops picks at
    # 0.5 (the slot-order trap binds) and none at the no-drop capacity
    tree, module = _moe_pair(e, k, shared)
    with torch.no_grad():
        xf = torch.from_numpy(_x((B, S, D))).reshape(-1, D)
        top_p, top_i, _ = _router(module, xf, k)
        cap = capacity_of(B * S, k, e, cf)
        table, _ = dispatch_table(top_p, top_i, e, cap)
    kept = int((table < B * S).sum())
    if capacity_factor == "no_drop":
        assert kept == B * S * k
    else:
        assert 0 < kept < B * S * k


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
def test_grouped_dispatch_matches_reference(capacity_factor):
    """``n_groups=2``: two tables of capacity ceil(T/2 k factor / E), the
    router over all T tokens."""
    kw = dict(top_k=2, capacity_factor=capacity_factor, min_capacity=4,
              n_groups=2)
    _moe_case(lambda p, x: ref_moe_grouped(p, x, **kw),
              lambda m, x: _moe_apply_grouped(m, x, **kw), 4, 2, True)
    # moe_apply(n_groups=2) takes the grouped path
    _moe_case(lambda p, x: ref_moe_apply(p, x, **kw),
              lambda m, x: moe_apply(m, x, **kw), 4, 2, False, grads=False)


@pytest.mark.parametrize("e,k,shared", [(4, 2, True), (8, 6, False)])
def test_moe_ref_matches_reference(e, k, shared):
    _moe_case(lambda p, x: ref_moe_ref(p, x, top_k=k),
              lambda m, x: moe_ref(m, x, top_k=k), e, k, shared,
              grads=shared)


def test_moe_apply_without_drops_equals_the_dense_oracle():
    """The reference's ``test_moe_matches_dense_oracle`` on the port: at
    capacity E nothing drops, and the dispatch equals ``moe_ref``."""
    _, module = _moe_pair(8, 6, True)
    x = torch.from_numpy(_x((B, S, D), seed=5))
    with torch.no_grad():
        y, aux = moe_apply(module, x, top_k=6, capacity_factor=8.0)
        yr, auxr = moe_ref(module, x, top_k=6)
    torch.testing.assert_close(y, yr, atol=TOL, rtol=TOL)
    assert float(aux) == float(auxr)


def test_moe_bf16_matches_reference():
    """bf16 experts and x (the router stays f32): output at the port's bf16
    rule, aux to 1e-4 (the router computes in f32 on x.float())."""
    tree, module = _moe_pair(8, 2, True, "bfloat16")
    assert module.router.w.dtype == torch.float32
    assert module.w_gate.dtype == module.shared[0].gate.w.dtype == \
        torch.bfloat16
    x = _x((B, S, D), seed=3)
    want_y, want_aux = jax.jit(lambda p, xx: ref_moe_apply(p, xx, top_k=2))(
        jax.tree_util.tree_map(jnp.asarray, tree), _j(x, "bfloat16"))
    with torch.no_grad():
        y, aux = moe_apply(module, _t(x, "bfloat16"), top_k=2)
        # the experts run in x's dtype (the weights cast to it)
        slots = _t(x, "bfloat16").reshape(1, -1, D).expand(8, -1, -1)
        assert _experts(module, slots).dtype == torch.bfloat16
    assert y.dtype == torch.bfloat16
    _close(y, want_y, "bfloat16")
    np.testing.assert_allclose(float(aux), float(want_aux), atol=TOL,
                               rtol=TOL)


def test_dispatch_table_slots_drops_and_padding():
    """3 tokens x 2 picks over 2 experts, capacity 2, picks token-major:
    expert 0 gets token 0 (slot 0), token 1 (slot 1); token 2's pick of 0
    is dropped; expert 1 gets token 0 and token 2, and its table has no
    empty slot; an empty slot points at row T = 3 with gate 0."""
    top_i = torch.tensor([[0, 1], [0, 1], [1, 0]])
    top_p = torch.tensor([[0.6, 0.4], [0.7, 0.3], [0.8, 0.2]])
    table, gate = dispatch_table(top_p, top_i, 2, 2)
    assert table.tolist() == [[0, 1], [0, 1]]
    torch.testing.assert_close(gate, torch.tensor([[0.6, 0.7], [0.4, 0.3]]))
    table, gate = dispatch_table(top_p, top_i, 2, 4)
    assert table.tolist() == [[0, 1, 2, 3], [0, 1, 2, 3]]
    assert gate[:, 3].tolist() == [0.0, 0.0]
    assert capacity_of(3, 2, 2, 1.25) == 4 == capacity_of(1, 1, 64, 1.25)
    assert capacity_of(4096, 6, 64, 1.25) == 480


def _dispatch_table_in_place(top_p, top_i, n_experts, capacity):
    """``dispatch_table`` as it was written before its scatters went out of
    place: the same indices and values written into the tensors."""
    t, k = top_i.shape
    flat_e = top_i.reshape(-1)
    pos_in_e = torch.cumsum(torch.nn.functional.one_hot(flat_e, n_experts),
                            dim=0) - 1
    slot = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = slot < capacity
    token_src = torch.arange(t).repeat_interleave(k)
    safe_e = torch.where(keep, flat_e, 0)
    safe_s = torch.where(keep, slot, capacity)
    table = torch.full((n_experts, capacity + 1), t, dtype=torch.int64)
    table[safe_e, safe_s] = torch.where(keep, token_src, t)
    gate = torch.zeros((n_experts, capacity + 1), dtype=torch.float32)
    gate[safe_e, safe_s] = torch.where(keep, top_p.reshape(-1).float(), 0.0)
    return table[:, :capacity], gate[:, :capacity]


@pytest.mark.parametrize("t,e,k,factor", [(64, 4, 1, 0.5), (64, 4, 2, 0.5),
                                          (64, 8, 6, 0.5), (37, 8, 2, 1.25),
                                          (200, 16, 4, 0.25)])
def test_dispatch_table_and_combine_equal_the_in_place_writes(t, e, k,
                                                              factor):
    """The out-of-place scatters give the in-place writes' bits, on random
    routings where picks drop (skewed logits crowd a few experts), and the
    out-of-place ``index_add`` combine equals ``index_add_``."""
    from repro_torch.models.moe import _combine
    rng = np.random.default_rng(t * 100 + e * 10 + k)
    logits = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32)
                              * 3.0 + np.linspace(2.0, 0.0, e,
                                                  dtype=np.float32))
    top_p, top_i = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    cap = capacity_of(t, k, e, factor)
    table, gate = dispatch_table(top_p, top_i, e, cap)
    want_table, want_gate = _dispatch_table_in_place(top_p, top_i, e, cap)
    assert int((want_gate > 0).sum()) < t * k      # some picks dropped
    assert torch.equal(table, want_table)
    assert torch.equal(gate, want_gate)
    y_e = torch.from_numpy(rng.standard_normal((e, cap, 8)).astype(
        np.float32))
    want = torch.zeros((t + 1, 8))
    want.index_add_(0, table.reshape(-1),
                    (y_e * gate[..., None]).reshape(-1, 8))
    assert torch.equal(_combine(y_e, table, gate, t), want[:t])


def test_moe_init_draws_experts_in_their_dtype():
    module = MoE(64, 4, 32, 2, n_shared=1, dtype=torch.bfloat16)
    module.reset_parameters(torch.Generator().manual_seed(0))
    assert module.router.w.dtype == torch.float32
    for w in (module.w_gate, module.w_up, module.w_down):
        assert w.dtype == torch.bfloat16
        std = float(w.detach().float().std())
        assert abs(std * np.sqrt(w.shape[-2]) - 1.0) < 0.05, std
    x = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(1))
    y, aux = moe_apply(module, x.bfloat16(), top_k=2)
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    assert aux.dtype == torch.float32


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

MD, EXPAND, N, CW, T = 32, 2, 16, 4, 12


@functools.lru_cache(maxsize=None)
def _mamba_pair(dtype, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: ref_mamba_init(key, MD, expand=EXPAND, state_dim=N,
                                   conv_width=CW, dtype=jnp.dtype(dtype)))(
            jax.random.PRNGKey(seed)))
    with torch.device("meta"):
        module = Mamba(MD, expand=EXPAND, state_dim=N, conv_width=CW,
                       dtype=_torch_dtype(dtype))
    return tree, module_from_reference(tree, module)


def _carried_state(dtype, seed=4):
    rng = np.random.RandomState(seed)
    h = (0.5 * rng.standard_normal((B, EXPAND * MD, N))).astype(np.float32)
    conv = (0.3 * rng.standard_normal((B, CW - 1, EXPAND * MD))).astype(
        np.float32)
    return ({"h": jnp.asarray(h), "conv": _j(conv, dtype)},
            {"h": torch.from_numpy(h), "conv": _t(conv, dtype)})


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_matches_reference(dtype, carried):
    tree, module = _mamba_pair(dtype)
    x = (0.3 * np.random.RandomState(3).standard_normal((B, T, MD))).astype(
        np.float32)
    ref_state, state = _carried_state(dtype) if carried else (None, None)
    want_y, want_st = jax.jit(lambda p, xx, st: ref_mamba_apply(
        p, xx, st, expand=EXPAND, state_dim=N, conv_width=CW))(
            jax.tree_util.tree_map(jnp.asarray, tree), _j(x, dtype),
            ref_state)
    with torch.no_grad():
        y, st = mamba_apply(module, _t(x, dtype), state, expand=EXPAND,
                            state_dim=N, conv_width=CW)
    assert y.dtype == _torch_dtype(dtype) and st["h"].dtype == torch.float32
    assert st["conv"].dtype == _torch_dtype(dtype)
    # bf16: the mixer rounds to bf16 at a dozen places (in_proj, the conv's
    # products and sums, silu, dt's two projections, softplus, B, C, the
    # output's cast and gate, out_proj) where XLA's fusions keep some in
    # f32, and its f32 state h sums dt B x over the steps, three factors
    # each of which may be one rounding apart: 2^-6 of the largest
    # magnitude, twice the one-rounding rule
    for name, got, want in (("y", y, want_y), ("h", st["h"], want_st["h"]),
                            ("conv", st["conv"], want_st["conv"])):
        _close(got, want, dtype, name, bf16_bits=6)


def test_mamba_conv_and_dt_round_as_the_reference():
    """bf16: the conv is the reference's shifted sum, each product and
    partial sum rounded to bf16 as jax rounds them op by op (bit for bit;
    ``F.conv1d``, accumulating in f32, is not), and dt is formed in bf16,
    so its f32 values are bf16 values."""
    tree, module = _mamba_pair("bfloat16")
    rng = np.random.RandomState(9)
    ctx = rng.standard_normal((B, T + CW - 1, EXPAND * MD)).astype(np.float32)
    w = jnp.asarray(tree["conv_w"])
    cj = _j(ctx, "bfloat16")
    want = sum(cj[:, i:i + T, :] * w[i].astype(cj.dtype) for i in range(CW))
    with torch.no_grad():
        got = _causal_conv(_t(ctx, "bfloat16"), module.conv_w)
        conv1d = torch.nn.functional.conv1d(
            _t(ctx, "bfloat16").transpose(1, 2),
            module.conv_w.T.flip(-1)[:, None, :], groups=EXPAND * MD)
        dt = _dt(module, got)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert not torch.equal(conv1d.transpose(1, 2), got)
    assert dt.dtype == torch.float32
    assert torch.equal(dt.bfloat16().float(), dt)


@pytest.mark.parametrize("carried", [False, True])
def test_mamba_step_chain_equals_apply(carried):
    _, module = _mamba_pair("float32")
    x = torch.from_numpy((0.3 * np.random.RandomState(6).standard_normal(
        (B, T, MD))).astype(np.float32))
    state = (_carried_state("float32")[1] if carried else
             mamba_empty_state(B, MD, expand=EXPAND, state_dim=N,
                               conv_width=CW))
    with torch.no_grad():
        full, full_st = mamba_apply(module, x, state, expand=EXPAND,
                                    state_dim=N, conv_width=CW)
        st, ys = state, []
        for t in range(T):
            y, st = mamba_step(module, x[:, t:t + 1], st)
            ys.append(y)
        xi = module.in_proj(x)[..., :EXPAND * MD]
    torch.testing.assert_close(torch.cat(ys, dim=1), full, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(st["h"], full_st["h"], atol=1e-5, rtol=1e-5)
    assert torch.equal(st["conv"], full_st["conv"])
    # the new context is the last conv_width - 1 inputs of the conv
    assert torch.equal(full_st["conv"], xi[:, -(CW - 1):])


def test_mamba_gradients_match_reference():
    """From a carried state, the loss sum(G_y y) + sum(G_h h_T): the
    gradients of every leaf, of x and of the state (h and conv) against
    ``jax.grad`` of the reference's ``mamba_apply``, to 1e-4."""
    tree, module = _mamba_pair("float32")
    rng = np.random.RandomState(8)
    x = (0.3 * rng.standard_normal((B, T, MD))).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gh = rng.standard_normal((B, EXPAND * MD, N)).astype(np.float32)
    ref_state, state = _carried_state("float32")

    def loss(p, xx, st):
        y, new = ref_mamba_apply(p, xx, st, expand=EXPAND, state_dim=N,
                                 conv_width=CW)
        return jnp.sum(y * gy) + jnp.sum(new["h"] * gh)

    want_gp, want_gx, want_gs = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), ref_state)
    module.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    state = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    y, new = mamba_apply(module, xt, state, expand=EXPAND, state_dim=N,
                         conv_width=CW)
    ((y * torch.from_numpy(gy)).sum()
     + (new["h"] * torch.from_numpy(gh)).sum()).backward()
    assert len(list(module.parameters())) == 11
    _grads_close(module, want_gp)
    _close(xt.grad, want_gx, "float32", "x")
    _close(state["h"].grad, want_gs["h"], "float32", "h_0")
    _close(state["conv"].grad, want_gs["conv"], "float32", "conv_0")
