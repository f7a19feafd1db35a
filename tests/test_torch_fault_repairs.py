"""Two repairs to the fleet round (ROADMAP queue 3, faults J and I).

J. AdamW's f32 scalars (b1, b2, lr) are made on the device once, and
   ``AdamW``'s step count is written there by a fill, so a step copies
   nothing from the host (on the card: no synchronizing copy). Pinned here:
   params, moments and updates bit-equal to the former arithmetic, which
   built ``torch.tensor(..., device=)`` scalars every step, over 3 steps,
   for ``AdamW.step`` (two parameter groups, one of them skipping a step)
   and for the stacked ``FunctionalAdamW.update`` (per-row counters).

I. The taps' second backward (``fleet/engine._losses_and_grads``) takes
   the clients' identity cotangents one at a time (``vmap(...,
   chunk_size=1)``), so its peak grows by one client's gradients. Pinned
   here against the unchunked ``vmap`` on a tinycnn split step with an
   int8 link and a mask: each client's rows of the shared (server) leaves
   are bit-equal; its rows of the stacked (client) leaves, which only a
   masked round asks for, are equal within 1e-7 but not bit-equal (the
   batched convolution's weight gradient sums in another order for a batch
   of one cotangent than for four).
"""
import numpy as np
import pytest
import torch
from torch.func import vmap

from repro_torch.core.link import LinkConfig
from repro_torch.core.split import (SplitStep, init_stages, make_split_loss,
                                    to_port_layout)
from repro_torch.fleet import engine as fleet_engine
from repro_torch.fleet.link import FleetLink
from repro_torch.models.cnn import CNN_BUILDERS, cross_entropy_loss
from repro_torch.optim import AdamW, FunctionalAdamW, OptState


def _former_scalars(b1, b2, lr, t, device):
    """The former per-step scalars: ``torch.tensor`` of each, every step."""
    f32 = dict(dtype=torch.float32, device=device)
    tf = t.float() if torch.is_tensor(t) else torch.tensor(float(t), **f32)
    return (1 - torch.tensor(b1, **f32) ** tf,
            1 - torch.tensor(b2, **f32) ** tf, torch.tensor(lr, **f32))


def _former_leaf(p, g, mu, nu, b1c, b2c, lr, *, b1, b2, eps, wd):
    g = g.float()
    m = b1 * mu + (1 - b1) * g
    v = b2 * nu + (1 - b2) * g * g
    delta = (m / b1c) / (torch.sqrt(v / b2c) + eps) + wd * p.float()
    return m, v, (-lr * delta).to(p.dtype)


def test_adamw_step_is_bit_equal_to_the_former_scalars():
    rng = np.random.RandomState(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2)}
    init = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}
    params = {k: torch.nn.Parameter(v.clone()) for k, v in init.items()}
    opt = AdamW([{"params": [params["a"], params["b"]]},
                 {"params": [params["c"]], "lr": 3e-3}], lr=1e-2)
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    want = {k: v.clone() for k, v in init.items()}
    mu = {k: torch.zeros_like(v) for k, v in init.items()}
    nu = {k: torch.zeros_like(v) for k, v in init.items()}
    counts = {"a": 0, "b": 0, "c": 0}
    for step in range(3):
        grads = {k: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)) for k, s in shapes.items()}
        # step 1: group 1 has no gradient (its count still advances)
        live = {k for k in shapes if not (step == 1 and k == "c")}
        ups = []
        for k, p in params.items():
            p.grad = grads[k].clone() if k in live else None
        opt.step(updates=ups)
        for k in shapes:
            counts[k] += 1
            if k not in live:
                continue
            lr = 3e-3 if k == "c" else 1e-2
            b1c, b2c, lr_t = _former_scalars(0.9, 0.999, lr, counts[k],
                                             want[k].device)
            mu[k], nu[k], up = _former_leaf(want[k], grads[k], mu[k], nu[k],
                                            b1c, b2c, lr_t, **hp)
            want[k] = want[k] + up
        for k in shapes:
            assert torch.equal(params[k].detach(), want[k]), (step, k)
            if k in live:
                assert torch.equal(opt.state[params[k]]["mu"], mu[k])
                assert torch.equal(opt.state[params[k]]["nu"], nu[k])
        assert len(ups) == len(live)
    # the scalars were made once for each group and device
    assert len(opt._scalars) == 2


def test_stacked_functional_adamw_is_bit_equal_to_the_former_scalars():
    rng = np.random.RandomState(1)
    n = 3
    p = {"w": torch.from_numpy(rng.standard_normal((n, 4, 2)).astype(
        np.float32))}
    opt = FunctionalAdamW(1e-2)
    st = opt.init_stacked({"w": p["w"][0]}, n)
    st = OptState(step=torch.tensor([0, 2, 1], dtype=torch.int32),
                  mu=st.mu, nu=st.nu)
    want_p, want_mu, want_nu = p["w"].clone(), st.mu["w"], st.nu["w"]
    steps = st.step
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    for _ in range(3):
        g = {"w": torch.from_numpy(rng.standard_normal((n, 4, 2)).astype(
            np.float32))}
        ups = {}
        p, st = opt.update(g, st, p, updates=ups)
        steps = steps + 1
        b1c, b2c, lr = _former_scalars(0.9, 0.999, 1e-2, steps, "cpu")
        shape = (n, 1, 1)
        want_mu, want_nu, up = _former_leaf(
            want_p, g["w"], want_mu, want_nu, b1c.reshape(shape),
            b2c.reshape(shape), lr, **hp)
        want_p = want_p + up
        assert torch.equal(p["w"], want_p)
        assert torch.equal(st.mu["w"], want_mu)
        assert torch.equal(st.nu["w"], want_nu)
        assert torch.equal(ups["w"], up)
    assert st.step.tolist() == [3, 5, 4]
    assert len(opt._scalars) == 1


def test_a_changed_lr_takes_new_scalars():
    param = torch.nn.Parameter(torch.ones(3))
    opt = AdamW([param], lr=1e-2)
    param.grad = torch.ones(3)
    opt.step()
    opt.param_groups[0]["lr"] = 0.0
    before = param.detach().clone()
    param.grad = torch.ones(3)
    opt.step()
    # lr 0: only the weight decay's product with 0, no move
    assert torch.equal(param.detach(), before)
    assert len(opt._scalars) == 2


# ---------------------------------------------------------------------------
# fault I: the identity cotangents a client at a time
# ---------------------------------------------------------------------------

def _split_loss():
    stages = CNN_BUILDERS["tinycnn"](12)
    init_stages(torch.Generator().manual_seed(0), stages)
    client = torch.nn.Sequential(*stages[:1])
    server = torch.nn.Sequential(*stages[1:])
    step = SplitStep(
        client_fwd=lambda c, x: c(to_port_layout(x)),
        server_loss=lambda s_, sm, y: (cross_entropy_loss(s_(sm), y), {}),
        link_constraint=FleetLink(config=LinkConfig(compress="int8"),
                                  kernel="fused").boundary("nchw"))
    return make_split_loss(step, client, server), client, server


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cotangents_give_the_unchunked_rows(masked, monkeypatch):
    loss, client, server = _split_loss()
    n = 4
    pc = {k: v.detach()[None].expand((n,) + v.shape).clone()
          for k, v in client.state_dict().items()}
    ps = {k: v.detach().clone() for k, v in server.state_dict().items()}
    rng = np.random.RandomState(0)
    batch = {"inputs": torch.from_numpy(
        rng.uniform(0, 1, (n, 4, 16, 16, 3)).astype(np.float32)),
        "targets": torch.from_numpy(rng.randint(0, 12, (n, 4)))}
    per_client = vmap(loss, in_dims=(0, None, 0))
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0]) if masked else None
    rows = {0: True, 1: False} if masked else {1: False}

    def run():
        return fleet_engine._losses_and_grads(per_client, (pc, ps), batch,
                                              mask, rows=rows)

    got = run()
    real = fleet_engine.vmap
    monkeypatch.setattr(fleet_engine, "vmap", lambda f, **kw: real(
        f, **{k: v for k, v in kw.items() if k != "chunk_size"}))
    want = run()
    assert torch.equal(got[0], want[0])
    for i, tier in enumerate(got[2]):            # the training gradients
        for k in tier:
            assert torch.equal(tier[k], want[2][i][k])
    for k, v in got[3][1].items():               # shared leaves: bit-equal
        assert v.shape == (n,) + ps[k].shape
        assert torch.equal(v, want[3][1][k]), k
    if masked:                                   # stacked leaves: 1e-7
        for k, v in got[3][0].items():
            assert v.shape == pc[k].shape
            torch.testing.assert_close(v, want[3][0][k], atol=1e-7, rtol=0)
