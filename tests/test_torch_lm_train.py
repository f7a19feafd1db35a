"""The port's whole-model path and trainer against the reference.

- ``build_groups``, ``_split_at`` and ``default_cut_layer`` equal the
  reference's for all ten configs (the group plan is pure Python);
- ``model_forward`` and ``lm_loss`` of ``rwkv6_7b.reduced()`` and
  ``smollm_135m.reduced()`` with the reference's weights
  (``convert.model_from_reference``): logits and loss to 1e-4, every
  gradient to 1e-4 (f32; the RWKV stack's head size is 256 there, so its
  WKV runs the plain version on the CPU);
- a cut preserves the function (the port's ``tests/test_split.py:135``);
- one ``launch.train`` step (``clip_by_global_norm(1.0)`` + AdamW) against
  the reference trainer's ``train_step`` on the same tokens; the clip and
  AdamW on bf16 leaves against the reference's;
- the trainer's loop on the CPU, and what it refuses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.core.split import merge_stack
from repro.models.transformer import _split_at as ref_split_at
from repro.models.transformer import build_groups as ref_build_groups
from repro.models.transformer import default_cut_layer as ref_default_cut
from repro.models.transformer import lm_loss as ref_lm_loss
from repro.models.transformer import model_forward as ref_model_forward
from repro.models.transformer import model_init as ref_model_init
from repro.optim import adamw as ref_adamw
from repro.optim import apply_updates as ref_apply_updates
from repro.optim import clip_by_global_norm as ref_clip
import repro_torch.configs as configs
from repro_torch.convert import model_from_reference
from repro_torch.core.energy import RTX_A5000
from repro_torch.launch.train import main, train, train_step
from repro_torch.models.transformer import (_split_at, build_groups,
                                            default_cut_layer, lm_loss,
                                            model_forward, model_init,
                                            vocab_padded)
from repro_torch.optim import AdamW, clip_by_global_norm

B, S = 2, 16
ARCHS = ("rwkv6-7b", "smollm-135m")
TOL = 1e-4


def _groups_as_tuples(groups):
    return [(g.kind, g.count, g.layer_offset, g.moe, g.tier) for g in groups]


@pytest.mark.parametrize("name", list(configs.ARCHS))
def test_group_plan_and_cut_equal_the_reference(name):
    cfg, ref = configs.ARCHS[name], ref_configs.ARCHS[name]
    for c, r in ((cfg, ref), (cfg.reduced(), ref.reduced())):
        assert _groups_as_tuples(build_groups(c)) == \
            _groups_as_tuples(ref_build_groups(r))
        n = c.n_enc_layers if c.enc_dec else c.n_layers
        for frac in (0.0, 0.15, 0.25, 0.5, 0.75, 1.0):
            assert default_cut_layer(c, frac) == ref_default_cut(r, frac)
        for cut in range(0, n + 2):
            assert _groups_as_tuples(build_groups(c, cut_layer=cut)) == \
                _groups_as_tuples(ref_build_groups(r, cut_layer=cut)), cut
            assert _groups_as_tuples(_split_at(build_groups(c), cut, c)) == \
                _groups_as_tuples(ref_split_at(ref_build_groups(r), cut, r))
    assert vocab_padded(cfg) % 16 == 0 and vocab_padded(cfg) >= cfg.vocab


def _pair(name):
    cfg = configs.ARCHS[name].reduced()
    ref = ref_configs.ARCHS[name].reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    return cfg, ref


def _reference_params(ref, cut, seed=0):
    """The reference's ``model_init`` tree as numpy, the LoRA's B (zero at
    init) and the norm scales moved off their init so that they count."""
    params = ref_model_init(ref, jax.random.PRNGKey(seed), cut_layer=cut)
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a)
        key = jax.tree_util.keystr(path)
        if any(s in key for s in ("w_lora_b", "scale")):
            return (a.astype(np.float32)
                    + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


def _batch(vocab, seed=1):
    tokens = np.random.RandomState(seed).randint(
        0, vocab, size=(B, S)).astype(np.int32)
    return ({"tokens": tokens, "labels": tokens},
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(tokens)})


@pytest.mark.parametrize("name", ARCHS)
def test_model_forward_loss_and_gradients_match_reference(name):
    cfg, ref = _pair(name)
    cut = ref_default_cut(ref, 0.5)
    params = _reference_params(ref, cut)
    model = model_from_reference(params, cfg, cut)
    rb, tb = _batch(cfg.vocab)
    # each reference result is read back before the port's counterpart runs
    want_logits = np.asarray(ref_model_forward(ref, params, rb,
                                               cut_layer=cut)[0])
    got_logits, aux = model_forward(cfg, model, tb, cut_layer=cut)
    assert got_logits.shape == (B, S, vocab_padded(cfg))
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               want_logits, atol=TOL, rtol=TOL)
    assert float(aux) == 0.0

    (want_loss, want_m), want_g = jax.block_until_ready(jax.value_and_grad(
        lambda p: ref_lm_loss(ref, p, rb, cut_layer=cut),
        has_aux=True)(params))
    loss, metrics = lm_loss(cfg, model, tb, cut_layer=cut)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), atol=TOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(want_m["ce"]),
                               atol=TOL)
    want_sd = model_from_reference(
        jax.tree_util.tree_map(np.asarray, want_g), cfg, cut).state_dict()
    for key, want in want_sd.items():
        got = model.get_parameter(key).grad
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=key)


@pytest.mark.parametrize("name", ARCHS)
def test_cut_preserves_the_function(name):
    """Evaluating the cut model equals evaluating the same weights with the
    cut stacks merged back into one group (``tests/test_split.py:135``)."""
    cfg, ref = _pair(name)
    cut = default_cut_layer(cfg, 0.5)
    params = jax.tree_util.tree_map(
        np.asarray, ref_model_init(ref, jax.random.PRNGKey(0),
                                   cut_layer=cut))
    merged = dict(params, groups=[merge_stack(*params["groups"])])
    cut_model = model_from_reference(params, cfg, cut)
    whole = model_from_reference(merged, cfg)
    assert [g.tier for g in cut_model.specs] == ["client", "server"]
    _, tb = _batch(cfg.vocab, seed=2)
    got, _ = model_forward(cfg, cut_model, tb, cut_layer=cut)
    want, _ = model_forward(cfg, whole, tb)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="built for groups"):
        model_forward(cfg, cut_model, tb)


def test_train_step_matches_the_reference_trainer():
    """The reference trainer's ``train_step`` (``launch/train.py:59-65``) and
    the port's on the same params and tokens: loss, gnorm (1e-4) and every
    parameter after the clipped AdamW step. Adam's first update is
    lr * g / (|g| + eps): where |g| is well above eps = 1e-8 (>= 1e-6) it is
    lr * sign(g) and the parameters agree to 1e-6; where |g| is near eps, a
    last-bit difference in g (or its sign, at g ~ 0) moves the update
    anywhere within +-lr, so there they agree to 2 lr."""
    cfg, ref = _pair("rwkv6-7b")
    cut = ref_default_cut(ref, 0.15)
    lr = 3e-4
    params = _reference_params(ref, cut, seed=3)
    model = model_from_reference(params, cfg, cut)
    rb, tb = _batch(cfg.vocab, seed=4)

    opt = ref_adamw(lr, weight_decay=0.01)
    (ref_loss, _), grads = jax.value_and_grad(
        lambda p: ref_lm_loss(ref, p, rb, cut_layer=cut), has_aux=True)(params)
    grads, ref_gnorm = ref_clip(grads, 1.0)
    updates, _ = opt.update(grads, opt.init(params), params)
    ref_new = jax.block_until_ready(ref_apply_updates(params, updates))

    loss, gnorm = train_step(cfg, model, AdamW(model.parameters(), lr,
                                               weight_decay=0.01), tb,
                             cut_layer=cut)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=TOL)
    np.testing.assert_allclose(float(gnorm), float(ref_gnorm), rtol=TOL)
    want = model_from_reference(jax.tree_util.tree_map(np.asarray, ref_new),
                                cfg, cut).state_dict()
    ref_g = model_from_reference(jax.tree_util.tree_map(np.asarray, grads),
                                 cfg, cut).state_dict()
    for key, w in want.items():
        diff = np.abs(model.get_parameter(key).detach().numpy() - w.numpy())
        clear = np.abs(ref_g[key].numpy()) >= 1e-6
        assert diff[clear].max(initial=0.0) <= 1e-6, key
        assert diff.max() <= 2 * lr, key
        assert clear.mean() > 0.9, key      # the strong check covers most


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_and_adamw_on_bf16_leaves_match_reference(max_norm):
    """bf16 leaves: the clip sums squares in f32 and casts back, AdamW keeps
    f32 moments and adds a bf16 update; two steps, to one bf16 rounding."""
    rng = np.random.RandomState(7)
    shapes = [(8, 16), (16,), (3, 4, 5)]
    p_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    g_np = [[2.0 * rng.standard_normal(s).astype(np.float32) for s in shapes]
            for _ in range(2)]
    ref_p = [jnp.asarray(p).astype(jnp.bfloat16) for p in p_np]
    params = [torch.nn.Parameter(torch.from_numpy(
        np.array(p.astype(jnp.float32))).to(torch.bfloat16)) for p in ref_p]
    opt, ref_opt = AdamW(params, 1e-2, weight_decay=0.01), \
        ref_adamw(1e-2, weight_decay=0.01)
    state = ref_opt.init(ref_p)
    for step_g in g_np:
        ref_g = [jnp.asarray(g).astype(jnp.bfloat16) for g in step_g]
        ref_g, ref_norm = ref_clip(ref_g, max_norm)
        updates, state = ref_opt.update(ref_g, state, ref_p)
        ref_p = ref_apply_updates(ref_p, updates)
        for p, g in zip(params, step_g):
            p.grad = torch.from_numpy(g).to(torch.bfloat16)
        norm = clip_by_global_norm([p.grad for p in params], max_norm)
        np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
        for p, g in zip(params, ref_g):
            assert p.grad.dtype == torch.bfloat16
            np.testing.assert_allclose(p.grad.float().numpy(),
                                       np.asarray(g.astype(jnp.float32)),
                                       rtol=2 ** -8, atol=1e-6)
        opt.step()
    for p, r in zip(params, ref_p):
        assert p.dtype == torch.bfloat16
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   rtol=2 ** -8, atol=1e-6)


def test_model_from_reference_checks_keys_and_shapes():
    cfg, ref = _pair("rwkv6-7b")
    params = jax.tree_util.tree_map(
        np.asarray, ref_model_init(ref, jax.random.PRNGKey(0), cut_layer=1))
    model = model_from_reference(params, cfg, 1)
    assert model.head is None                      # tied: logits from embed
    assert model.groups[0][0].mix.u.shape == (1, 256)
    with pytest.raises(ValueError, match="do not match"):
        model_from_reference(params, cfg)          # uncut: one group
    bad = dict(params, embed={"table": params["embed"]["table"][:, :8]})
    with pytest.raises(ValueError, match="do not match"):
        model_from_reference(bad, cfg, 1)


def test_model_init_draws_on_the_generator_and_ties_the_head():
    cfg = dataclasses.replace(configs.smollm_135m.reduced(),
                              tie_embeddings=False, dtype="bfloat16")
    a = model_init(cfg, torch.Generator().manual_seed(0), cut_layer=1)
    b = model_init(cfg, torch.Generator().manual_seed(0), cut_layer=1)
    assert a.head is not None and a.head.w.dtype == torch.bfloat16
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert [g.tier for g in a.specs] == ["client", "server"]


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "whisper-tiny",
                                  "pixtral-12b", "deepseek-moe-16b"])
def test_kinds_outside_the_slice_are_refused(name):
    cfg = configs.ARCHS[name].reduced()
    with pytest.raises(NotImplementedError, match="item 17"):
        model_init(cfg, torch.Generator().manual_seed(0))


def test_trainer_runs_on_the_cpu_and_learns(capsys):
    cfg = dataclasses.replace(configs.rwkv6_7b.reduced(), head_dim=64)
    kw = dict(steps=4, batch=2, seq=16, lr=3e-3, log_every=1,
              hardware=RTX_A5000, device="cpu")
    losses = train(cfg, generator=torch.Generator().manual_seed(0), **kw)
    again = train(cfg, generator=torch.Generator().manual_seed(0), **kw)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses == again                        # seeded: repeatable
    assert losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "[train] arch=rwkv6-7b layers=2 cut=1" in out
    assert "[train] done: final loss" in out and "rtx_a5000" in out


def test_trainer_refuses_what_it_does_not_run():
    cfg = configs.smollm_135m.reduced()
    with pytest.raises(ValueError, match="hardware"):
        train(cfg, steps=1, device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        main(["--arch", "smollm-135m", "--reduced", "--ckpt", "/nowhere"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])
