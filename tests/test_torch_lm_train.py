"""The port's whole-model path and trainer against the reference.

- ``build_groups``, ``_split_at`` and ``default_cut_layer`` equal the
  reference's for all ten configs (the group plan is pure Python);
- ``model_forward`` and ``lm_loss`` of ``rwkv6_7b.reduced()``,
  ``smollm_135m.reduced()``, ``deepseek_moe_16b.reduced()``,
  ``arctic_480b.reduced()`` and ``jamba_1_5_large_398b.reduced()`` with
  the reference's weights (``convert.model_from_reference``; the MoE and
  hybrid trees drawn by numpy at ``model_init``'s structure,
  ``test_torch_harness.drawn_model_params``): logits,
  loss and the routers' aux to 1e-4, every gradient to 1e-4 (f32; the
  RWKV stack's head size is 256 there, so its WKV runs the plain version
  on the CPU); deepseek through the grouped dispatch (``moe_groups=2``);
- a cut preserves the function (the port's ``tests/test_split.py:135``);
- a bf16 MoE tree keeps its dtypes (``router.w`` f32);
- one ``launch.train`` step (``clip_by_global_norm(1.0)`` + AdamW) against
  the reference trainer's ``train_step`` on the same tokens; the clip and
  AdamW on bf16 leaves against the reference's;
- the trainer's loop on the CPU (the MoE and hybrid families too), and
  what it refuses.
"""
import dataclasses
import functools

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
from repro.models.transformer import model_init as ref_model_init
from repro.optim import adamw as ref_adamw
from repro.optim import apply_updates as ref_apply_updates
from repro.optim import clip_by_global_norm as ref_clip
import repro_torch.configs as configs
from repro_torch.checkpoint import checkpoint_meta
from repro_torch.convert import model_from_reference
from repro_torch.core.energy import RTX_A5000
from repro_torch.launch.train import main, train, train_step
from repro_torch.models.transformer import (_split_at, build_groups,
                                            default_cut_layer, lm_loss,
                                            model_forward, model_init,
                                            vocab_padded)
from repro_torch.optim import AdamW, clip_by_global_norm
from test_torch_harness import (drawn_model_params,
                                reference_loss_and_logits)

B, S = 2, 16
ARCHS = ("rwkv6-7b", "smollm-135m", "deepseek-moe-16b", "arctic-480b",
         "jamba-1.5-large-398b")
# held uncut by the gradient test: a cut splits jamba's two super-blocks
# into two groups, which the reference traces and compiles apart (about
# 20 s more); what a cut does is held by test_cut_preserves_the_function
UNCUT = ("jamba-1.5-large-398b",)
# the gradient test's deepseek case takes lm_loss's grouped dispatch
# (moe_groups=2: two capacity tables of T/2 tokens a layer)
MOE_GROUPS = {"deepseek-moe-16b": 2}
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


@functools.lru_cache(maxsize=None)
def _reference_params(name, cut, seed=0):
    """The reference's ``model_init`` tree of ``name``'s reduced config as
    numpy, the LoRA's B (zero at init) and the norm scales moved off their
    init so that they count; for the MoE and hybrid configs, whose eager
    init costs seconds, ``test_torch_harness.drawn_model_params``. Shared
    by the cases of a process (the port's model copies it)."""
    ref = ref_configs.ARCHS[name].reduced()
    if ref.n_experts or ref.ssm_kind == "mamba":
        return drawn_model_params(ref, cut, seed)
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
def test_model_forward_loss_and_gradients_match_reference(name, monkeypatch):
    cfg, ref = _pair(name)
    cut = None if name in UNCUT else ref_default_cut(ref, 0.5)
    groups = MOE_GROUPS.get(name, 1)
    params = _reference_params(name, cut)
    model = model_from_reference(params, cfg, cut)
    rb, tb = _batch(cfg.vocab)
    kw = dict(cut_layer=cut, moe_groups=groups)
    # read back before the port runs
    (want_loss, (want_m, want_logits)), want_g = reference_loss_and_logits(
        ref, params, rb, monkeypatch, **kw)
    got_logits, aux = model_forward(cfg, model, tb, **kw)
    assert got_logits.shape == (B, S, vocab_padded(cfg))
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(want_logits), atol=TOL, rtol=TOL)
    # the MoE routers' summed auxiliary loss; 0 without an MoE FFN
    assert (float(aux.detach()) == 0.0) == (cfg.n_experts == 0)
    if groups > 1:          # the grouped tables drop other picks than one
        with torch.no_grad():
            one, _ = model_forward(cfg, model, tb, cut_layer=cut)
        assert float((one - got_logits).abs().max()) > 1e-3

    np.testing.assert_allclose(float(aux.detach()), float(want_m["aux"]),
                               atol=TOL, rtol=TOL)
    loss, metrics = lm_loss(cfg, model, tb, **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), atol=TOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(want_m["ce"]),
                               atol=TOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(want_m["aux"]),
                               atol=TOL, rtol=TOL)
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
    cfg, _ = _pair(name)
    cut = default_cut_layer(cfg, 0.5)
    cut_specs = build_groups(cfg, cut_layer=cut)
    params = _reference_params(name, cut)
    # the cut groups merged back into the groups of the uncut plan (for
    # deepseek the cut falls on its dense/MoE boundary: nothing to merge)
    merged_groups, gi = [], 0
    for whole_g in build_groups(cfg):
        parts, covered = [], 0
        while covered < whole_g.count:
            parts.append(params["groups"][gi])
            covered += cut_specs[gi].count
            gi += 1
        merged_groups.append(parts[0] if len(parts) == 1
                             else merge_stack(*parts))
    merged = dict(params, groups=merged_groups)
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
    params = _reference_params("rwkv6-7b", cut, seed=3)
    model = model_from_reference(params, cfg, cut)
    rb, tb = _batch(cfg.vocab, seed=4)

    opt = ref_adamw(lr, weight_decay=0.01)
    (ref_loss, _), grads = jax.value_and_grad(
        lambda p: ref_lm_loss(ref, p, rb, cut_layer=cut), has_aux=True)(params)
    grads, ref_gnorm = ref_clip(grads, 1.0)
    updates, _ = opt.update(grads, opt.init(params), params)
    ref_new = jax.block_until_ready(ref_apply_updates(params, updates))

    loss, gnorm, _ = train_step(cfg, model, AdamW(model.parameters(), lr,
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


@pytest.mark.parametrize("name", ["deepseek-moe-16b",
                                  "jamba-1.5-large-398b"])
def test_model_from_reference_keeps_the_moe_dtypes(name):
    """A bf16 config's tree (its structure traced by ``jax.eval_shape``):
    the expert stacks and the shared experts stay bf16, ``router.w`` f32,
    the shared experts' stack is unstacked, and a wrong shared-expert
    shape is refused."""
    cfg = dataclasses.replace(configs.ARCHS[name].reduced(),
                              dtype="bfloat16")
    ref = dataclasses.replace(ref_configs.ARCHS[name].reduced(),
                              dtype="bfloat16")
    shapes = jax.eval_shape(lambda: ref_model_init(
        ref, jax.random.PRNGKey(0), cut_layer=1 if cfg.n_shared_experts
        else None))
    params = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                    shapes)
    cut = 1 if cfg.n_shared_experts else None
    model = model_from_reference(params, cfg, cut)
    sd = model.state_dict()
    routers = [k for k in sd if k.endswith("router.w")]
    experts = [k for k in sd if k.endswith(("w_gate", "w_up", "w_down"))]
    assert routers and experts
    assert all(sd[k].dtype == torch.float32 for k in routers)
    assert all(sd[k].dtype == torch.bfloat16 for k in experts)
    if cfg.n_shared_experts:
        assert sd["groups.1.0.moe.shared.1.down.w"].dtype == torch.bfloat16
        moe = params["groups"][1]["moe"]
        bad = dict(params, groups=[params["groups"][0], dict(
            params["groups"][1], moe=dict(moe, shared=dict(
                moe["shared"], up={"w": moe["shared"]["up"]["w"][:, :1]})))])
        with pytest.raises(ValueError, match="do not match"):
            model_from_reference(bad, cfg, cut)


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


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "arctic-480b",
                                  "jamba-1.5-large-398b"])
def test_trainer_runs_the_moe_and_hybrid_families(name, capsys):
    """``launch.train`` on the reduced MoE and hybrid configs: finite
    losses, the routers' aux on the log line; the MoE leaves in their
    dtypes under a bf16 config (``router.w`` f32)."""
    cfg = configs.ARCHS[name].reduced()
    losses = train(cfg, steps=2, batch=2, seq=16, lr=3e-3, log_every=1,
                   hardware=RTX_A5000, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "aux" in capsys.readouterr().out
    model = model_init(dataclasses.replace(cfg, dtype="bfloat16"),
                       torch.Generator().manual_seed(0))
    moes = [m for m in model.modules() if type(m).__name__ == "MoE"]
    assert moes and all(m.router.w.dtype == torch.float32
                        and m.w_down.dtype == torch.bfloat16 for m in moes)


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


def test_trainer_refuses_what_it_does_not_run(tmp_path):
    cfg = configs.smollm_135m.reduced()
    with pytest.raises(ValueError, match="hardware"):
        train(cfg, steps=1, device="cpu")
    # --ckpt writes the reference's checkpoint (it was refused before)
    ckpt = str(tmp_path / "smollm.msgpack")
    losses = main(["--arch", "smollm-135m", "--reduced", "--steps", "1",
                   "--batch", "2", "--seq", "8", "--ckpt", ckpt],
                  device="cpu", hardware=RTX_A5000)
    assert checkpoint_meta(ckpt) == {"arch": cfg.name, "steps": 1,
                                     "loss": losses[-1]}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])
