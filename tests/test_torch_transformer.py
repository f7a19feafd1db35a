"""The split language model of the port against the reference.

- ``models/transformer.group_apply`` over a stack of ``smollm_135m.reduced()``
  layers, with the reference's params carried over by
  ``convert.lm_from_reference`` (xla and pallas attention), 1e-5;
- ``fleet/hetero.lm_split_program``: ``client_fwd``, ``server_loss`` and one
  joint backward (every client and server gradient), 1e-5 / 1e-4;
- one split step with bf16 block params (SmolLM's storage type): loss,
  bf16 gradients and the AdamW update, to one bf16 rounding;
- ``Plan`` record parity on a tiny LM spec on ``sl/scan``, fp32 and
  int8-fused links, ``attn_impl`` in {xla, ref, pallas}: loss within 1e-3,
  link bytes exactly, energies by the port/reference FLOP ratio to 1e-6
  (``assert_records_match``);
- the port's token stream law, the stack cut and the conversion's checks;
- the chunked server loss the engines train on (``chunked_lm_loss``): its
  loss and the gradients of h and the head against autograd through the
  plain loss in f32 within 1e-6, at chunk sizes that divide the token
  count and that do not; no tensor larger than one chunk's logits; under
  ``torch.func.vmap`` over 3 clients with a shared head, each client's
  loss and gradient as a per-client loop, the head's gradient the
  weighted sum of theirs; the split step on it against the plain one, and
  the same contraction FLOPs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import assert_records_match

import repro.api as R
from repro.configs import smollm_135m as ref_smollm
from repro.configs.base import ArchConfig as RefArch
from repro.core.split import merge_stack
from repro.core.split import stack_cut_index as ref_stack_cut_index
from repro.fleet.hetero import lm_split_program as ref_lm_split_program
from repro.models.transformer import GroupSpec as RefGroupSpec
from repro.models.transformer import group_apply as ref_group_apply
from repro.optim import adamw as ref_adamw
import repro_torch.api as T
from repro_torch.configs import smollm_135m
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_from_reference
from repro_torch.core.split import stack_cut_index
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.fleet.hetero import (chunked_lm_loss, lm_loss, lm_modules,
                                     lm_split_program, lm_split_step)
from repro_torch.models.transformer import GroupSpec, group_apply
from repro_torch.optim import AdamW

B, S = 2, 24


def _cfg(dtype="float32"):
    cfg = dataclasses.replace(smollm_135m.reduced(), dtype=dtype)
    ref = dataclasses.replace(ref_smollm.reduced(), dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    return cfg, ref


def _reference_program(ref_cfg, k, seed=0):
    """The reference's split LM and its params as numpy, norm scales moved
    off 1 so that they count."""
    prog = ref_lm_split_program(ref_cfg, jax.random.PRNGKey(seed), k)
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (a.astype(np.float32)
                    + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(
        perturb, (prog.params_c0, prog.params_s0))
    return prog, params


def _port_modules(cfg, params, k):
    client, server = lm_modules(cfg, k)
    sd_c, sd_s = lm_from_reference(*params, cfg)
    client.load_state_dict(sd_c, assign=True)
    server.load_state_dict(sd_s, assign=True)
    return client, server


def _tokens(vocab, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, size=(B, S)).astype(np.int32),
            rng.randint(0, vocab, size=(B, S)).astype(np.int32))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_group_apply_matches_reference(impl):
    cfg, ref_cfg = _cfg()
    _, (pc, ps) = _reference_program(ref_cfg, 1)
    client, server = _port_modules(cfg, (pc, ps), 1)
    stacked = merge_stack(pc["blocks"], ps["blocks"])
    x = np.random.RandomState(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, _ = ref_group_apply(
        ref_cfg, RefGroupSpec("attn", cfg.n_layers, 0), stacked, x,
        jnp.zeros(()), positions=pos, window=None,
        attn_impl="pallas" if impl == "pallas" else "xla")
    layers = list(client.blocks) + list(server.blocks)
    got, _ = group_apply(cfg, GroupSpec("attn", cfg.n_layers, 0), layers,
                         torch.tensor(x), 0.0,
                         positions=torch.tensor(np.array(pos)).long(),
                         window=None, attn_impl=impl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_group_kinds_outside_the_slice_are_refused():
    """Every kind of the reference's plan is ported (``enc`` and ``xdec``
    included); a kind outside it is refused."""
    from repro_torch.models.transformer import group_modules
    cfg, _ = _cfg()
    g = GroupSpec("conv", 1, 0)
    with pytest.raises(ValueError, match="unknown layer group kind"):
        group_apply(cfg, g, [], torch.zeros(1, 1, cfg.d_model), 0.0,
                    positions=None, window=None)
    with pytest.raises(ValueError, match="unknown layer group kind"):
        group_modules(cfg, g)


def _ref_loss_and_grads(prog, params, tokens, targets):
    pc, ps = jax.tree_util.tree_map(jnp.asarray, params)

    def loss(pc_, ps_):
        sm = prog.step.client_fwd(pc_, tokens)
        return prog.step.server_loss(ps_, sm, targets)[0]

    return jax.value_and_grad(loss, argnums=(0, 1))(pc, ps)


def _flat_ref_grads(g_c, g_s, cfg):
    """Reference gradients as the port's flat state-dict keys."""
    return lm_from_reference(jax.tree_util.tree_map(np.asarray, g_c),
                             jax.tree_util.tree_map(np.asarray, g_s), cfg)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_lm_split_program_step_matches_reference(impl):
    cfg, ref_cfg = _cfg()
    k = 1
    ref_prog, params = _reference_program(ref_cfg, k)
    tokens, targets = _tokens(cfg.vocab)
    smashed_ref = ref_prog.step.client_fwd(
        jax.tree_util.tree_map(jnp.asarray, params[0]), tokens)
    ref_loss, (g_c, g_s) = _ref_loss_and_grads(ref_prog, params, tokens,
                                               targets)

    client, server = _port_modules(cfg, params, k)
    step, server_logits = lm_split_step(cfg, attn_impl=impl)
    tt, yt = torch.tensor(tokens).long(), torch.tensor(targets).long()
    smashed = step.client_fwd(client, tt)
    np.testing.assert_allclose(smashed.detach().numpy(),
                               np.asarray(smashed_ref), atol=1e-5)
    loss, aux = step.grads(client, server, {"inputs": tt, "targets": yt})
    assert aux["smashed_elems"] == B * S * cfg.d_model
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-5)
    want = _flat_ref_grads(g_c, g_s, cfg)
    for module, w in zip((client, server), want):
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), w[name].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=name)
    logits = server_logits(server, smashed)
    assert logits.shape == (B, S, cfg.vocab)


def test_bf16_block_params_split_step_and_adamw():
    """SmolLM stores its blocks in bf16: the weights are cast to the f32
    residual stream at use, so their gradients come back in bf16, and
    AdamW keeps f32 moments and adds a bf16 update, as the reference."""
    cfg, ref_cfg = _cfg("bfloat16")
    k = 1
    ref_prog, params = _reference_program(ref_cfg, k)
    tokens, targets = _tokens(cfg.vocab)
    ref_loss, (g_c, g_s) = _ref_loss_and_grads(ref_prog, params, tokens,
                                               targets)
    client, server = _port_modules(cfg, params, k)
    assert client.blocks[0].attn["wq"].w.dtype == torch.bfloat16
    assert client.embed.dtype == torch.float32
    step, _ = lm_split_step(cfg)
    loss, _ = step.grads(client, server,
                         {"inputs": torch.tensor(tokens).long(),
                          "targets": torch.tensor(targets).long()})
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-5)
    want = _flat_ref_grads(g_c, g_s, cfg)
    for name, p in server.named_parameters():
        w = want[1][name]
        assert p.grad.dtype == w.dtype == p.dtype, name
        # one bf16 rounding of an f32 gradient that differs in the last bits
        np.testing.assert_allclose(p.grad.float().numpy(), w.float().numpy(),
                                   rtol=2 ** -7, atol=1e-6, err_msg=name)

    # one AdamW step on the server tier, from the same gradient
    opt = ref_adamw(1e-3)
    ps = jax.tree_util.tree_map(jnp.asarray, params[1])
    upd, _ = opt.update(g_s, opt.init(ps), ps)
    new_ps = jax.tree_util.tree_map(lambda p, u: p + u, ps, upd)
    want_p = lm_from_reference(
        jax.tree_util.tree_map(np.asarray, params[0]),
        jax.tree_util.tree_map(np.asarray, new_ps), cfg)[1]
    for name, p in server.named_parameters():
        p.grad = want[1][name].clone()
    AdamW(server.parameters(), 1e-3).step()
    for name, p in server.named_parameters():
        assert p.dtype == want_p[name].dtype
        # f32 (the head): the optimizer's arithmetic, 1e-7 as in
        # test_torch_split; bf16: at most one rounding of the update apart
        tol = dict(atol=1e-7, rtol=0) if p.dtype == torch.float32 \
            else dict(atol=1e-7, rtol=2 ** -8)
        torch.testing.assert_close(p.detach().float(),
                                   want_p[name].float(), msg=name, **tol)


N_TEST = 4
TINY = dict(name="tinylm", family="dense", n_layers=3, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, dtype="float32")


def _lm_spec(api, arch_cls, impl, compress, link_kernel):
    return api.ExperimentSpec(
        model=api.ModelSpec(family="transformer", name="tinylm",
                            arch=arch_cls(**TINY), attn_impl=impl),
        data=api.DataSpec(kind="tokens", partition="iid", seq_len=16,
                          n_train=32, n_test=N_TEST),
        clients=api.ClientSpec(num_clients=2),
        cut_policy=api.CutPolicy(fraction=0.4),
        link_policy=api.LinkPolicy(compress=compress),
        engine=api.EngineSpec(link_kernel=link_kernel),
        global_rounds=2, local_steps=2, batch_size=4)


@pytest.mark.parametrize("link", ["fp32", "int8-fused"])
@pytest.mark.parametrize("impl", ["xla", "ref", "pallas"])
def test_lm_record_streams_match_reference(impl, link):
    compress, lk = ("none", "xla") if link == "fp32" else ("int8", "fused")
    ref_plan = R.compile_experiment(_lm_spec(R, RefArch, impl, compress, lk))
    data = (ref_plan.x_train, ref_plan.y_train, ref_plan.x_test,
            ref_plan.y_test)
    port_plan = T.compile_experiment(
        _lm_spec(T, ArchConfig, impl, compress, lk), data=data,
        device="cpu")
    assert port_plan.cut_of_client == ref_plan.cut_of_client == [2, 2]
    port_plan.params0 = lm_from_reference(
        *jax.tree_util.tree_map(np.asarray, ref_plan.params0),
        ArchConfig(**TINY))
    _, ref_recs = ref_plan.run()
    _, port_recs = port_plan.run()
    k = port_plan.cut_of_client[0]
    assert port_plan.flops[k][2].shape == (4, 16, 32)
    assert_records_match(
        ref_recs, port_recs, ref_flops_pair=ref_plan.flops[k][:2],
        port_flops_pair=port_plan.flops[k][:2], server_base_s=0.0,
        n_test=N_TEST * 16)


def test_pallas_plan_bills_the_ref_plans_flops():
    """The kernel's work is invisible to the dispatch-level counter; the
    "pallas" plan is billed through the plain attention, as "ref"."""
    plans = [T.compile_experiment(_lm_spec(T, ArchConfig, impl, "none",
                                           "xla"), device="cpu")
             for impl in ("pallas", "ref")]
    k = plans[0].cut_of_client[0]
    assert plans[0].flops[k][:2] == plans[1].flops[k][:2]


def test_port_token_stream():
    a = synthetic_tokens(np.random.default_rng(0), 64, 257, 1000)
    b = synthetic_tokens(np.random.default_rng(0), 64, 257, 1000)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (64, 257) and a.dtype == np.int32
    assert a.min() >= 0 and a.max() < 1000
    # half the tokens copy the one 16 back (plus chance agreements)
    copies = float((a[:, 16:] == a[:, :-16]).mean())
    assert 0.45 < copies < 0.7
    # Zipf-like ranks: rank 0 is the most frequent token
    assert np.bincount(a.ravel()).argmax() == 0


def test_plan_makes_its_own_token_data():
    plan = T.compile_experiment(_lm_spec(T, ArchConfig, "xla", "none",
                                         "xla"), device="cpu")
    assert plan.x_train.shape == plan.y_train.shape == (32, 16)
    np.testing.assert_array_equal(plan.x_train[:, 1:], plan.y_train[:, :-1])
    assert plan.x_test.shape == (N_TEST, 16)


@pytest.mark.parametrize("n_layers", [2, 3, 30])
def test_stack_cut_index_matches_reference(n_layers):
    for fraction in (0.0, 0.1, 0.25, 0.4, 0.5, 0.99, 1.0):
        assert (stack_cut_index(n_layers, fraction)
                == ref_stack_cut_index(n_layers, fraction))
    assert stack_cut_index(30, 0.25) == 8      # SmolLM-135M: 8 client blocks


def test_lm_from_reference_checks_keys_and_shapes():
    cfg, ref_cfg = _cfg()
    _, (pc, ps) = _reference_program(ref_cfg, 1)
    sd_c, sd_s = lm_from_reference(pc, ps, cfg)
    assert sd_c["blocks.0.attn.wq.w"].shape == (cfg.d_model,
                                                cfg.n_heads * cfg.hd)
    assert "head" in sd_s and f"blocks.{cfg.n_layers - 2}.ffn.down.w" in sd_s
    with pytest.raises(ValueError, match="do not match"):
        lm_from_reference(pc, ps, dataclasses.replace(cfg, d_ff=8))
    with pytest.raises(ValueError, match="cut"):
        lm_split_program(cfg, torch.Generator(), cfg.n_layers)


# ---------------------------------------------------------------------------
# the chunked server loss
# ---------------------------------------------------------------------------

N_TOK, D, V = 2 * 37, 48, 300


def _loss_inputs(seed=0, clients=None):
    rng = np.random.RandomState(seed)
    lead = () if clients is None else (clients,)
    h = torch.tensor(rng.standard_normal(lead + (2, 37, D)),
                     dtype=torch.float32, requires_grad=True)
    head = torch.tensor(0.2 * rng.standard_normal((D, V)),
                        dtype=torch.float32, requires_grad=True)
    t = torch.tensor(rng.randint(0, V, size=lead + (2, 37)))
    return h, head, t


@pytest.mark.parametrize("chunk", [1, 7, 37, N_TOK, 1000])
def test_chunked_loss_matches_plain_loss(chunk):
    """Chunks of 7 and 1 do not divide 74 tokens; 1000 is one chunk."""
    h, head, t = _loss_inputs()
    got = chunked_lm_loss(h, head, t, chunk=chunk)
    g_got = torch.autograd.grad(got, [h, head])
    want = lm_loss(h @ head, t)
    g_want = torch.autograd.grad(want, [h, head])
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_chunked_loss_holds_one_chunk_of_logits():
    """Forward and backward, no tensor the loss makes is larger than one
    chunk of logits (7 x 300), where the plain loss makes (74, 300)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    self.most = max(self.most, o.numel())
            return out

    h, head, t = _loss_inputs()
    for fn, bound in ((lambda: chunked_lm_loss(h, head, t, chunk=7),
                       max(7 * V, D * V)),
                      (lambda: lm_loss(h @ head, t), N_TOK * V)):
        with Largest() as mode:
            torch.autograd.grad(fn(), [h, head])
        assert mode.most == bound


def test_chunked_loss_skips_the_gradient_work_without_grad():
    h, head, t = _loss_inputs()
    want = float(lm_loss(h @ head, t))
    with torch.no_grad():
        got = chunked_lm_loss(h, head, t, chunk=7)
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), want, atol=1e-6, rtol=0)
    got = chunked_lm_loss(h.detach(), head.detach(), t, chunk=7)
    assert not got.requires_grad


def test_chunked_loss_vmap_with_a_shared_head():
    """The fleet engines' form: a vmapped forward over 3 clients (head
    shared, ``in_dims`` None), one backward of the weighted sum. Each
    client's loss and h gradient equal a per-client loop's; the head's
    gradient the weighted sum of the clients', weights (0, 1, 1). A
    vmapped head gives each index its own head's loss."""
    h, head, t = _loss_inputs(clients=3)
    w = torch.tensor([0.0, 1.0, 1.0])
    losses = torch.func.vmap(
        lambda hh, hd, tt: chunked_lm_loss(hh, hd, tt, chunk=7),
        in_dims=(0, None, 0))(h, head, t)
    g_h, g_head = torch.autograd.grad((losses * w).sum(), [h, head])
    assert losses.shape == (3,)
    want_head = torch.zeros_like(head)
    for c in range(3):
        hc = h[c].detach().requires_grad_()
        want = lm_loss(hc @ head, t[c])
        gw_h, gw_head = torch.autograd.grad(want, [hc, head])
        np.testing.assert_allclose(float(losses[c]), float(want), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(g_h[c].numpy(), (w[c] * gw_h).numpy(),
                                   atol=1e-6, rtol=0)
        want_head += w[c] * gw_head
    np.testing.assert_allclose(g_head.numpy(), want_head.numpy(), atol=1e-6,
                               rtol=0)
    # a head of each client's own (the form a Monte-Carlo seed axis gives
    # the server's head): each loss on its own head
    heads = head.detach() * torch.tensor([1.0, 0.5, 2.0]).reshape(3, 1, 1)
    losses = torch.func.vmap(
        lambda hh, hd, tt: chunked_lm_loss(hh, hd, tt, chunk=7))(
            h.detach(), heads, t)
    for c in range(3):
        np.testing.assert_allclose(float(losses[c]),
                                   float(lm_loss(h[c].detach() @ heads[c],
                                                 t[c])),
                                   atol=1e-6, rtol=0)


def test_split_step_on_the_chunked_loss():
    """The split step the engines train (``chunked_loss=True``) against
    the plain one: loss and every gradient, and equal contraction FLOPs
    (the bill counts the plain step)."""
    from repro_torch.api.runtime import count_split_step_flops
    cfg, ref_cfg = _cfg()
    k = 1
    _, params = _reference_program(ref_cfg, k)
    tokens, targets = _tokens(cfg.vocab)
    batch = {"inputs": torch.tensor(tokens).long(),
             "targets": torch.tensor(targets).long()}
    out = []
    for chunked in (False, True):
        client, server = _port_modules(cfg, params, k)
        step, _ = lm_split_step(cfg, chunked_loss=chunked)
        loss, _ = step.grads(client, server, batch)
        grads = {f"{tier}.{name}": p.grad.clone()
                 for tier, m in (("c", client), ("s", server))
                 for name, p in m.named_parameters()}
        c, s, _ = count_split_step_flops(step, client, server,
                                         batch["inputs"], batch["targets"])
        out.append((float(loss), grads, (c.contraction, s.contraction)))
    (l0, g0, f0), (l1, g1, f1) = out
    np.testing.assert_allclose(l1, l0, atol=1e-6, rtol=0)
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)
    assert f1 == f0
