"""Split step, round builders, cut placement and optimizers vs the reference.

tinycnn at 16x16: one ``SplitStep`` (fp32 and int8-fused link) gives the
reference's loss and client/server gradients within 1e-5 atol / 1e-4 rtol;
one sequential SL round and one FL round give its losses and parameters
within 1e-4 (the reference's scan-vs-host-loop bound); AdamW and SGD updates
equal ``repro.optim`` within 1e-7 over 3 steps.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import port_stages, reference_params

from repro.core.fedavg import fedavg as ref_fedavg
from repro.core.fedavg import fedavg_mean as ref_fedavg_mean
from repro.core.fedavg import fedavg_stack as ref_fedavg_stack
from repro.core.link import LinkConfig as RefLinkConfig
from repro.core.split import SplitStep as RefSplitStep
from repro.core.split import apply_stages as ref_apply
from repro.core.split import cut_index_for_fraction as ref_cut
from repro.core.split import make_fl_round as ref_fl_round
from repro.core.split import make_multi_client_round as ref_sl_round
from repro.fleet.link import FleetLink as RefFleetLink
from repro.models.cnn import CNN_BUILDERS as REF_BUILDERS
from repro.models.cnn import cross_entropy_loss as ref_ce
from repro.optim import adamw as ref_adamw
from repro.optim import init_stacked
from repro.optim.optimizers import apply_updates
from repro.optim.optimizers import sgd as ref_sgd
from repro_torch.convert import from_reference
from repro_torch.core import fedavg
from repro_torch.core.link import LinkConfig
from repro_torch.core.split import (SplitStep, cut_index_for_fraction,
                                    make_fl_round, make_multi_client_round,
                                    partition_stages, to_port_layout)
from repro_torch.fleet.link import FleetLink
from repro_torch.models.cnn import CNN_BUILDERS, cross_entropy_loss
from repro_torch.optim import AdamW, SGD, adamw

TOL = dict(atol=1e-5, rtol=1e-4)


def _batch(n, seed=0, size=16):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    y = rng.randint(0, 12, size=(n,)).astype(np.int32)
    return x, y


def _ref_step(stages, k, link):
    cs, ss = stages[:k], stages[k:]
    return RefSplitStep(
        client_fwd=lambda pc, xx: ref_apply(cs, pc, xx),
        server_loss=lambda ps, sm, yy: (ref_ce(ref_apply(ss, ps, sm), yy), {}),
        link_constraint=link)


def _port_step(link):
    return SplitStep(
        client_fwd=lambda c, xx: c(to_port_layout(xx)),
        server_loss=lambda s, sm, yy: (cross_entropy_loss(s(sm), yy), {}),
        link_constraint=link)


def _grads_of(module):
    return [{k: p.grad for k, p in st.body.named_parameters()}
            for st in module]


def _assert_params_close(port_list, ref_tree, name, **tol):
    """Port per-stage dicts vs reference per-stage pytrees (converted)."""
    want = from_reference(jax.tree_util.tree_map(np.asarray, ref_tree), name)
    assert len(port_list) == len(want)
    for got_d, want_d in zip(port_list, want):
        assert got_d.keys() == want_d.keys()
        for key in want_d:
            np.testing.assert_allclose(got_d[key].detach().numpy(),
                                       want_d[key].numpy(), err_msg=key,
                                       **tol)


@pytest.mark.parametrize("link", ["fp32", "int8-fused"])
def test_split_step_loss_and_grads_match(link):
    ref_stages, params = reference_params("tinycnn", seed=2)
    k = ref_cut(ref_stages, 0.4)
    ref_link = (RefFleetLink(config=RefLinkConfig(compress="int8"),
                             use_pallas=True).boundary()
                if link != "fp32" else None)
    port_link = (FleetLink(config=LinkConfig(compress="int8"),
                           kernel="fused").boundary()
                 if link != "fp32" else None)
    x, y = _batch(4)
    loss_r, _, g_c, g_s = jax.jit(_ref_step(ref_stages, k, ref_link).grads)(
        params[:k], params[k:], {"inputs": x, "targets": y})

    stages = port_stages("tinycnn", params)
    client = torch.nn.Sequential(*stages[:k])
    server = torch.nn.Sequential(*stages[k:])
    loss, aux = _port_step(port_link).grads(
        client, server, {"inputs": torch.from_numpy(x),
                         "targets": torch.from_numpy(y.astype(np.int64))})
    assert aux["smashed_elems"] == 4 * 4 * 4 * 16
    np.testing.assert_allclose(float(loss), float(loss_r), **TOL)
    _assert_params_close(_grads_of(client) + _grads_of(server),
                         list(g_c) + list(g_s), "tinycnn", **TOL)


@pytest.mark.parametrize("fraction", [0.15, 0.25, 0.4, 0.75])
@pytest.mark.parametrize("name", ["tinycnn", "resnet18", "googlenet",
                                  "mobilenetv2"])
def test_cut_index_equals_reference(name, fraction):
    ref_stages = REF_BUILDERS[name](12)
    stages = CNN_BUILDERS[name](12)
    assert [s.name for s in stages] == [s.name for s in ref_stages]
    assert [s.depth for s in stages] == [s.depth for s in ref_stages]
    assert (cut_index_for_fraction(stages, fraction)
            == ref_cut(ref_stages, fraction))
    client, server, k = partition_stages(stages, fraction)
    assert k == ref_cut(ref_stages, fraction)
    assert client + server == stages and len(client) == k


def test_sequential_sl_round_matches_reference():
    """One Algorithm 3 round, 3 clients x 2 local steps, shared server."""
    ref_stages, params = reference_params("tinycnn", seed=4)
    k, n, steps = 1, 3, 2
    x, y = _batch(n * steps * 4, seed=5)
    bx, by = x.reshape(n, steps, 4, 16, 16, 3), y.reshape(n, steps, 4)
    opt = ref_adamw(1e-3)
    round_fn = jax.jit(ref_sl_round(_ref_step(ref_stages, k, None), opt, opt,
                                    local_rounds=steps))
    stack = jax.tree_util.tree_map(
        lambda v: jnp.broadcast_to(v[None], (n,) + v.shape), params[:k])
    cs, sp, _, _, losses_r = round_fn(stack, params[k:],
                                      init_stacked(opt, params[:k], n),
                                      opt.init(params[k:]),
                                      {"inputs": bx, "targets": by})

    stages = port_stages("tinycnn", params)
    clients = [copy.deepcopy(torch.nn.Sequential(*stages[:k]))
               for _ in range(n)]
    server = torch.nn.Sequential(*stages[k:])
    make = adamw(1e-3)
    losses = make_multi_client_round(_port_step(None), local_rounds=steps)(
        clients, server, [make(c.parameters()) for c in clients],
        make(server.parameters()),
        {"inputs": torch.from_numpy(bx),
         "targets": torch.from_numpy(by.astype(np.int64))})
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_r),
                               atol=1e-4)
    client0 = jax.tree_util.tree_map(lambda v: v[0], cs)
    _assert_params_close(
        [{k_: p for k_, p in st.body.named_parameters()}
         for st in list(clients[0]) + list(server)],
        list(client0) + list(sp), "tinycnn", atol=1e-4)


def test_fl_round_matches_reference():
    ref_stages, params = reference_params("tinycnn", seed=6)
    n, steps = 3, 2
    x, y = _batch(n * steps * 4, seed=7)
    bx, by = x.reshape(n, steps, 4, 16, 16, 3), y.reshape(n, steps, 4)

    def grad_fn(p, batch):
        return jax.value_and_grad(
            lambda q: ref_ce(ref_apply(ref_stages, q, batch[0]), batch[1]))(p)
    new_r, losses_r = jax.jit(ref_fl_round(grad_fn, ref_adamw(1e-3)))(
        params, (bx, by))

    model = torch.nn.Sequential(*port_stages("tinycnn", params))
    losses = make_fl_round(
        lambda m, xx, yy: cross_entropy_loss(m(to_port_layout(xx)), yy),
        adamw(1e-3))(model, (torch.from_numpy(bx),
                             torch.from_numpy(by.astype(np.int64))))
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_r),
                               atol=1e-4)
    _assert_params_close(
        [dict(st.body.named_parameters()) for st in model], new_r,
        "tinycnn", atol=1e-4)


def _opt_trajectory(ref_opt, port_cls, **kw):
    rng = np.random.RandomState(3)
    p0 = {"a": rng.standard_normal((5, 4)).astype(np.float32),
          "b": rng.standard_normal((7,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    state = ref_opt.init(ref_p)
    port_p = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    opt = port_cls(list(port_p.values()), **kw)
    for g in grads:
        up, state = ref_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, ref_p)
        ref_p = apply_updates(ref_p, up)
        for k, p in port_p.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in p0:
            np.testing.assert_allclose(port_p[k].detach().numpy(),
                                       np.asarray(ref_p[k]), atol=1e-7,
                                       rtol=0)


def test_adamw_matches_reference_over_three_steps():
    _opt_trajectory(ref_adamw(1e-2), AdamW, lr=1e-2)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_matches_reference_over_three_steps(nesterov):
    _opt_trajectory(ref_sgd(1e-2, nesterov=nesterov), SGD, lr=1e-2,
                    nesterov=nesterov)


def test_fedavg_matches_reference():
    rng = np.random.RandomState(8)
    clients = [{"w": rng.standard_normal((3, 2)).astype(np.float32)}
               for _ in range(4)]
    weights = [1.0, 2.0, 3.0, 4.0]
    want = ref_fedavg([{k: jnp.asarray(v) for k, v in c.items()}
                              for c in clients], weights)
    got = fedavg.fedavg([{k: torch.from_numpy(v) for k, v in c.items()}
                         for c in clients], weights)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               atol=1e-7)
    stacked = np.stack([c["w"] for c in clients])
    np.testing.assert_allclose(
        fedavg.fedavg_mean({"w": torch.from_numpy(stacked)})["w"].numpy(),
        np.asarray(ref_fedavg_mean({"w": stacked})["w"]), atol=1e-7)
    np.testing.assert_allclose(
        fedavg.fedavg_stack({"w": torch.from_numpy(stacked)})["w"].numpy(),
        np.asarray(ref_fedavg_stack({"w": stacked})["w"]), atol=1e-7)
    mods = [torch.nn.Linear(2, 3) for _ in range(3)]
    mean_w = torch.stack([m.weight.detach() for m in mods]).mean(0)
    fedavg.fedavg_modules_(mods)
    for m in mods:
        assert torch.equal(m.weight.detach(), mean_w)
