"""The port's fleet engines (``fleet/engine.py``, ``client_axis="vmap"``) against the reference.

tinycnn at 16x16, 3 clients, 2 local steps, batch 4, from the reference's
parameters (``test_torch_harness.reference_params``), inputs made with numpy:

- the vmap rules of the two custom Functions on the fleet path: the int8
  link boundary under ``torch.func.vmap`` bit-equal to a per-client loop
  (NaN rows included) and its ``vmap(grad)`` the identity; flash attention
  (its plain version, on the CPU) within 1e-6 of a per-client loop, in the
  forward and in the three gradients;
- the masked FedAvg pair against ``repro.core.fedavg``, an all-masked mask
  included, and the stacked functional AdamW against ``init_stacked`` plus
  ``jax.vmap(opt.update)`` over steps with a mask between them, so that the
  rows' step counters differ;
- ``make_fleet_sl_round`` against the reference's
  ``make_fleet_sl_round(client_axis="vmap")`` over the stacked and shared
  client tiers, mean and sum server reduction, no mask, a mask and an
  all-masked mask, the int8 link on the two-op and fused paths: losses,
  both tiers' parameters and optimizer states (step counters exactly)
  within ``FLEET_EQUIV_ATOL``; ``make_fleet_fl_round`` likewise;
- record parity of ``sl/vmap`` and ``fl/vmap`` tinycnn plans with dropout
  and an int8 link, and of a reduced SmolLM ``sl/vmap`` plan, through both
  ``compile_experiment``s (``assert_records_match``; ``active_clients`` and
  ``engine`` equal in every round).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.func import grad, vmap

from test_torch_harness import assert_records_match, reference_params

import repro.api as R
from repro.api.runtime import stack_replicas as ref_stack_replicas
from repro.configs import smollm_135m as ref_smollm
from repro.core.fedavg import fedavg_mean_masked as ref_fedavg_mean_masked
from repro.core.fedavg import fedavg_stack_masked as ref_fedavg_stack_masked
from repro.core.link import LinkConfig as RefLinkConfig
from repro.core.split import SplitStep as RefSplitStep
from repro.core.split import apply_stages as ref_apply_stages
from repro.fleet.engine import FLEET_EQUIV_ATOL as REF_FLEET_EQUIV_ATOL
from repro.fleet.engine import make_fleet_fl_round as ref_fleet_fl_round
from repro.fleet.engine import make_fleet_sl_round as ref_fleet_sl_round
from repro.fleet.link import FleetLink as RefFleetLink
from repro.models.cnn import cross_entropy_loss as ref_cross_entropy
from repro.optim import adamw as ref_adamw
from repro.optim import init_stacked as ref_init_stacked
import repro_torch.api as T
from repro_torch.api.plan import FL_SERVER_AGG_S
from repro_torch.configs import smollm_135m
from repro_torch.convert import from_reference, lm_from_reference
from repro_torch.core.fedavg import fedavg_mean_masked, fedavg_stack_masked
from repro_torch.core.link import LinkConfig
from repro_torch.core.split import SplitStep, make_split_loss, to_port_layout
from repro_torch.fleet.engine import (FLEET_EQUIV_ATOL, fleet_state,
                                      make_fleet_fl_round,
                                      make_fleet_sl_round)
from repro_torch.fleet.link import FleetLink
from repro_torch.kernels.attn.flash import flash_attention
from repro_torch.kernels.quant.ops import make_link_compress
from repro_torch.models.cnn import CNN_BUILDERS, cross_entropy_loss
from repro_torch.optim import FunctionalAdamW, OptState

C, S, B = 3, 2, 4          # clients, local steps, batch
K = 1                      # tinycnn cut: stem on the client, smashed (B, 8, 8, 8)
LR = 1e-2
MASKS = {"no-mask": None,
         "mask": np.array([1, 0, 1], np.float32),
         "all-masked": np.zeros(C, np.float32)}


def test_the_tolerance_is_the_references():
    assert FLEET_EQUIV_ATOL == REF_FLEET_EQUIV_ATOL == 1e-3


# ---------------------------------------------------------------------------
# the vmap rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["xla", "fused"])
def test_int8_boundary_vmap_rule(kernel):
    """Rows are independent: the vmapped boundary equals the per-client
    loop bit for bit (NaN, inf and zero rows included), and its gradient
    under ``vmap(grad)`` is the identity (straight-through)."""
    compress = make_link_compress(kernel=kernel)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(
        (rng.standard_normal((C, 2, 5, 8)) * 10).astype(np.float32))
    x[1, 0, 2, 3] = float("nan")
    x[2, 1, 0, 0] = float("inf")
    x[0, 1, 4] = 0.0
    got = vmap(compress)(x)
    want = torch.stack([compress(x[c]) for c in range(C)])
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))
    # the client axis in the middle of the physical tensor
    got_mid = vmap(compress, in_dims=1, out_dims=1)(x.transpose(0, 1))
    assert torch.equal(got_mid.transpose(0, 1).nan_to_num(0.0),
                       want.nan_to_num(0.0))
    w = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    xs = torch.from_numpy(rng.standard_normal((C, 2, 5, 8)).astype(
        np.float32))
    g = vmap(grad(lambda t: (compress(t) * w).sum()))(xs)
    assert torch.equal(g, w.expand_as(xs))


@pytest.mark.parametrize("case", ["causal", "window", "unbatched-kv",
                                  "not-causal"])
def test_flash_vmap_rule(case):
    """The client axis folds into B: the vmapped flash attention (its plain
    version on the CPU) equals the per-client loop within 1e-6, forward and
    gradients."""
    causal = case != "not-causal"
    window = 5 if case == "window" else None
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((C, 2, 3, 12, 16))
                                .astype(np.float32)) for _ in range(3))
    kv_dim = None if case == "unbatched-kv" else 0
    if kv_dim is None:
        k, v = k[0], v[0]

    def f(a, b, c):
        return flash_attention(a, b, c, causal=causal, window=window)

    def kv(t, i):
        return t if kv_dim is None else t[i]

    got = vmap(f, in_dims=(0, kv_dim, kv_dim))(q, k, v)
    want = torch.stack([f(q[i], kv(k, i), kv(v, i)) for i in range(C)])
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)

    def loss(a, b, c):
        o = f(a, b, c)
        return (o * torch.cos(o)).sum()

    g = vmap(grad(loss, argnums=(0, 1, 2)),
             in_dims=(0, kv_dim, kv_dim))(q, k, v)
    for i in range(C):
        leaves = [t.clone().requires_grad_(True)
                  for t in (q[i], kv(k, i), kv(v, i))]
        loss(*leaves).backward()
        for got_g, leaf in zip(g, leaves):
            torch.testing.assert_close(got_g[i], leaf.grad, atol=1e-6,
                                       rtol=0)


# ---------------------------------------------------------------------------
# masked FedAvg and the stacked AdamW
# ---------------------------------------------------------------------------

def _stack_np(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.standard_normal((C, 4, 3)).astype(np.float32),
            "b": rng.standard_normal((C, 3)).astype(np.float32)}


@pytest.mark.parametrize("mask", ["mask", "all-masked", "all-active"])
def test_masked_fedavg_matches_reference(mask):
    m = MASKS.get(mask, np.ones(C, np.float32))
    stack = _stack_np(2)
    fallback = {k: v[0] * 3.0 for k, v in stack.items()}
    port = {k: torch.from_numpy(v) for k, v in stack.items()}
    got_s = fedavg_stack_masked(port, torch.from_numpy(m))
    got_m = fedavg_mean_masked(port, torch.from_numpy(m),
                               {k: torch.from_numpy(v)
                                for k, v in fallback.items()})
    want_s = ref_fedavg_stack_masked(stack, jnp.asarray(m))
    want_m = ref_fedavg_mean_masked(stack, jnp.asarray(m), fallback)
    for k in stack:
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]),
                                   atol=1e-7, rtol=0)
        np.testing.assert_allclose(got_m[k].numpy(), np.asarray(want_m[k]),
                                   atol=1e-7, rtol=0)
    if mask == "all-masked":
        for k in stack:
            assert torch.equal(got_s[k], port[k])
            np.testing.assert_array_equal(got_m[k].numpy(), fallback[k])


def test_stacked_adamw_matches_reference():
    """``init_stacked`` + ``update`` against the reference's
    ``init_stacked`` + ``jax.vmap(opt.update)``: a step, a masked step (row
    1 keeps its params and state, its step counter included), a step; the
    rows' counters end at 3, 2, 3 and each row takes its own bias
    correction."""
    params = {k: v[0] for k, v in _stack_np(3).items()}
    mask = np.array([1, 0, 1], np.float32)
    opt, ref = FunctionalAdamW(LR), ref_adamw(LR)
    p = {k: torch.from_numpy(v)[None].expand((C,) + v.shape).clone()
         for k, v in params.items()}
    st = opt.init_stacked({k: torch.from_numpy(v) for k, v in params.items()},
                          C)
    rp = ref_stack_replicas(params, C)
    rst = ref_init_stacked(ref, params, C)
    ref_update = jax.jit(jax.vmap(ref.update))
    for i, masked in enumerate((False, True, False)):
        g = _stack_np(10 + i)
        new_p, new_st = opt.update({k: torch.from_numpy(v)
                                    for k, v in g.items()}, st, p)
        up, new_rst = ref_update(g, rst, rp)
        new_rp = jax.tree_util.tree_map(lambda a, u: a + u, rp, up)
        if masked:
            keep = torch.from_numpy(mask)

            def sel_t(n, o):
                return torch.where(keep.reshape((C,) + (1,) * (n.dim() - 1))
                                   > 0, n, o)

            def sel_j(n, o):
                w = mask.reshape((C,) + (1,) * (n.ndim - 1))
                return jnp.where(w > 0, n, o)
            new_p = {k: sel_t(v, p[k]) for k, v in new_p.items()}
            new_st = OptState(step=sel_t(new_st.step, st.step),
                              mu={k: sel_t(v, st.mu[k])
                                  for k, v in new_st.mu.items()},
                              nu={k: sel_t(v, st.nu[k])
                                  for k, v in new_st.nu.items()})
            new_rp = jax.tree_util.tree_map(sel_j, new_rp, rp)
            new_rst = jax.tree_util.tree_map(sel_j, new_rst, rst)
        p, st, rp, rst = new_p, new_st, new_rp, new_rst
        np.testing.assert_array_equal(st.step.numpy(), np.asarray(rst.step))
        for k in params:
            for got, want in ((p[k], rp[k]), (st.mu[k], rst.mu[k]),
                              (st.nu[k], rst.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=1e-7, rtol=1e-6)
    assert st.step.tolist() == [3, 2, 3]
    assert st.step.dtype == torch.int32


# ---------------------------------------------------------------------------
# the engines against the reference's vmap engines
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup():
    stages, params = reference_params("tinycnn")
    rng = np.random.RandomState(1)
    bx = rng.uniform(0, 1, (C, S, B, 16, 16, 3)).astype(np.float32)
    by = rng.randint(0, 12, (C, S, B))
    return stages, params, bx, by


def _flat(tree, prefix=""):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", v


def _tier(trees, stacked: bool) -> dict:
    """Reference per-stage trees (numpy or jax; leaves optionally stacked
    on a leading client axis) -> the port's dict keyed as
    ``nn.Sequential(*stages)``: conv kernels HWIO -> OIHW."""
    out = {}
    for i, tree in enumerate(trees):
        for key, a in _flat(tree):
            a = np.asarray(a, np.float32)
            if a.ndim == 4 + stacked:
                lead = list(range(a.ndim - 4))
                a = a.transpose(*lead, a.ndim - 1, a.ndim - 2, a.ndim - 4,
                                a.ndim - 3)
            out[f"{i}.body.{key}"] = torch.from_numpy(np.array(a))
    return out


def _assert_tier(got: dict, want_trees, stacked: bool):
    want = _tier(want_trees, stacked)
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, atol=FLEET_EQUIV_ATOL, rtol=0,
                                   msg=k)


def _assert_state(got: OptState, want, stacked: bool):
    np.testing.assert_array_equal(got.step.numpy(), np.asarray(want.step))
    _assert_tier(got.mu, want.mu, stacked)
    _assert_tier(got.nu, want.nu, stacked)


@functools.lru_cache(maxsize=None)
def _ref_sl_round(tier, reduce, kernel, masked):
    stages, _, _, _ = _setup()
    cs, ss = stages[:K], stages[K:]
    link = RefFleetLink(config=RefLinkConfig(compress="int8"),
                        use_pallas=kernel == "fused", interpret=True)
    step = RefSplitStep(
        client_fwd=lambda pc, x: ref_apply_stages(cs, pc, x),
        server_loss=lambda ps, sm, y: (
            ref_cross_entropy(ref_apply_stages(ss, ps, sm), y), {}),
        link_constraint=link.boundary())
    opt_c, opt_s = ref_adamw(LR), ref_adamw(LR)
    return opt_c, opt_s, jax.jit(ref_fleet_sl_round(
        step, opt_c, opt_s, local_rounds=S, server_reduce=reduce,
        client_dropout=masked, client_tier=tier))


@pytest.mark.parametrize("kernel", ["xla", "fused"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("reduce", ["mean", "sum"])
@pytest.mark.parametrize("tier", ["stacked", "shared"])
def test_fleet_sl_round_matches_reference(tier, reduce, mask, kernel):
    stages, params, bx, by = _setup()
    m = MASKS[mask]
    shared = tier == "shared"
    opt_c, opt_s, ref_round = _ref_sl_round(tier, reduce, kernel,
                                            m is not None)
    cp0, sp0 = params[:K], params[K:]
    ref_state = ((cp0 if shared else ref_stack_replicas(cp0, C)), sp0,
                 (opt_c.init(cp0) if shared
                  else ref_init_stacked(opt_c, cp0, C)), opt_s.init(sp0))
    args = ref_state + ({"inputs": jnp.asarray(bx),
                         "targets": jnp.asarray(by)},)
    if m is not None:
        args += (jnp.asarray(m),)
    want = ref_round(*args)

    port = CNN_BUILDERS["tinycnn"](12)
    for st in port:
        st.to(memory_format=torch.channels_last)
    client, server = nn.Sequential(*port[:K]), nn.Sequential(*port[K:])
    step = SplitStep(
        client_fwd=lambda c, x: c(to_port_layout(x)),
        server_loss=lambda s_, sm, y: (cross_entropy_loss(s_(sm), y), {}),
        link_constraint=FleetLink(config=LinkConfig(compress="int8"),
                                  kernel=kernel).boundary("nchw"))
    popt_c, popt_s = FunctionalAdamW(LR), FunctionalAdamW(LR)
    round_fn = make_fleet_sl_round(
        make_split_loss(step, client, server), popt_c, popt_s,
        local_rounds=S, server_reduce=reduce, client_dropout=m is not None,
        client_tier=tier)
    state = fleet_state(_tier(cp0, False), _tier(sp0, False), popt_c,
                        popt_s, C, client_tier=tier)
    pargs = state + ({"inputs": torch.from_numpy(bx),
                      "targets": torch.from_numpy(by).long()},)
    if m is not None:
        pargs += (torch.from_numpy(m),)
    got = round_fn(*pargs)

    assert got[4].shape == (S, C)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               atol=FLEET_EQUIV_ATOL, rtol=0)
    _assert_tier(got[0], want[0], stacked=not shared)
    _assert_tier(got[1], want[1], stacked=False)
    _assert_state(got[2], want[2], stacked=not shared)
    _assert_state(got[3], want[3], stacked=False)
    if mask == "all-masked":        # a no-op on all state
        assert int(got[3].step) == 0
        for k, v in _tier(cp0 if shared else ref_stack_replicas(cp0, C),
                          not shared).items():
            assert torch.equal(got[0][k], v)


@pytest.mark.parametrize("mask", list(MASKS))
def test_fleet_fl_round_matches_reference(mask):
    stages, params, bx, by = _setup()
    m = MASKS[mask]

    def ref_grad_fn(p, batch):
        xx, yy = batch
        return jax.value_and_grad(lambda q: ref_cross_entropy(
            ref_apply_stages(stages, q, xx), yy))(p)

    ref_round = jax.jit(ref_fleet_fl_round(ref_grad_fn, ref_adamw(LR),
                                           client_dropout=m is not None))
    args = (params, (jnp.asarray(bx), jnp.asarray(by)))
    want_p, want_l = ref_round(*(args + ((jnp.asarray(m),)
                                         if m is not None else ())))

    model = nn.Sequential(*CNN_BUILDERS["tinycnn"](12))

    def loss_fn(p, batch):
        xx, yy = batch
        return cross_entropy_loss(
            torch.func.functional_call(model, p, (to_port_layout(xx),)), yy)

    round_fn = make_fleet_fl_round(loss_fn, FunctionalAdamW(LR),
                                   client_dropout=m is not None)
    pargs = (_tier(params, False), (torch.from_numpy(bx),
                                     torch.from_numpy(by).long()))
    got_p, got_l = round_fn(*(pargs + ((torch.from_numpy(m),)
                                       if m is not None else ())))
    assert got_l.shape == (C, S)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               atol=FLEET_EQUIV_ATOL, rtol=0)
    _assert_tier(got_p, want_p, stacked=False)
    if mask == "all-masked":        # the incoming global params
        for k, v in _tier(params, False).items():
            assert torch.equal(got_p[k], v)


@pytest.mark.parametrize("option", [dict(server_reduce="max"),
                                    dict(client_tier="sharded")])
def test_sl_round_refuses_unknown_options(option):
    opt = FunctionalAdamW(LR)
    with pytest.raises(ValueError):
        make_fleet_sl_round(lambda *a: None, opt, opt, local_rounds=1,
                            **option)


# ---------------------------------------------------------------------------
# record parity through compile_experiment
# ---------------------------------------------------------------------------

N_TRAIN, N_TEST = 96, 24


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, size=(N_TRAIN, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, 12, size=(N_TRAIN,))
    return x, y, x[:N_TEST], y[:N_TEST]


def _cnn_spec(api, kind, reduce):
    return api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(kind="arrays", image_size=16),
        clients=api.ClientSpec(num_clients=C, dropout_rate=0.34),
        cut_policy=api.CutPolicy(fraction=0.4),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind=kind, client_axis="vmap",
                              link_kernel="fused", server_reduce=reduce),
        mission=api.MissionSpec(), global_rounds=3, local_steps=S,
        batch_size=B)


def _assert_fleet_records(ref_recs, port_recs, **kw):
    assert_records_match(ref_recs, port_recs, **kw)
    assert ([r.active_clients for r in port_recs]
            == [r.active_clients for r in ref_recs])
    assert [r.engine for r in port_recs] == [r.engine for r in ref_recs]


@pytest.mark.parametrize("case", ["sl-mean", "sl-sum", "fl"])
def test_vmap_plan_records_match_reference(case):
    """Dropout 0.34 over 3 clients: the masks drop 1 and 2 clients in the
    first two rounds (seed 0), so the loss, the bills and the evaluation
    (the row-mean prefix) all run over a subset."""
    kind, reduce = (case.split("-") + ["mean"])[:2]
    data = _data()
    ref_plan = R.compile_experiment(_cnn_spec(R, kind, reduce), data=data)
    port_plan = T.compile_experiment(_cnn_spec(T, kind, reduce), data=data,
                                     device="cpu")
    port_plan.params0 = from_reference(
        jax.tree_util.tree_map(np.asarray, ref_plan.params0), "tinycnn")
    _, ref_recs = ref_plan.run()
    _, port_recs = port_plan.run()
    assert port_plan.engine_label == f"{kind}/vmap"
    assert [r.active_clients for r in port_recs] == [2, 1, 3]
    if kind == "fl":
        pair = (ref_plan.flops["full"], 0.0), (port_plan.flops["full"], 0.0)
    else:
        k = port_plan.cut_of_client[0]
        pair = ref_plan.flops[k][:2], port_plan.flops[k][:2]
    _assert_fleet_records(
        ref_recs, port_recs, ref_flops_pair=pair[0], port_flops_pair=pair[1],
        server_base_s=FL_SERVER_AGG_S if kind == "fl" else 0.0,
        n_test=N_TEST)


def _lm_spec(api, arch, impl, dropout, reduce):
    return api.ExperimentSpec(
        model=api.ModelSpec(family="transformer", arch=arch,
                            attn_impl=impl),
        data=api.DataSpec(kind="tokens", partition="iid", seq_len=16,
                          n_train=32, n_test=4),
        clients=api.ClientSpec(num_clients=C, dropout_rate=dropout),
        cut_policy=api.CutPolicy(fraction=0.4),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(client_axis="vmap", link_kernel="fused",
                              server_reduce=reduce),
        global_rounds=2, local_steps=S, batch_size=B)


@pytest.mark.parametrize("case", ["pallas-dropout-mean", "ref-sum"])
def test_lm_vmap_plan_records_match_reference(case):
    """A reduced SmolLM split at 0.4 on ``sl/vmap``, int8 on the fused
    path, attention on the flash path (its plain version here; the
    reference's Pallas kernel in interpret mode) or the O(S^2) oracle."""
    impl, *rest = case.split("-")
    dropout = 0.34 if "dropout" in rest else 0.0
    reduce = rest[-1]
    ref_plan = R.compile_experiment(
        _lm_spec(R, ref_smollm.reduced(), impl, dropout, reduce))
    data = (ref_plan.x_train, ref_plan.y_train, ref_plan.x_test,
            ref_plan.y_test)
    cfg = smollm_135m.reduced()
    port_plan = T.compile_experiment(_lm_spec(T, cfg, impl, dropout, reduce),
                                     data=data, device="cpu")
    port_plan.params0 = lm_from_reference(
        *jax.tree_util.tree_map(np.asarray, ref_plan.params0), cfg)
    _, ref_recs = ref_plan.run()
    _, port_recs = port_plan.run()
    k = port_plan.cut_of_client[0]
    assert port_plan.engine_label == "sl/vmap"
    _assert_fleet_records(
        ref_recs, port_recs, ref_flops_pair=ref_plan.flops[k][:2],
        port_flops_pair=port_plan.flops[k][:2], server_base_s=0.0,
        n_test=4 * 16)
