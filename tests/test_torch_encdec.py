"""The encoder-decoder groups and the modality frontends of the port against
the reference: whisper-tiny and pixtral-12b.

- ``model_forward``, ``lm_loss`` and every gradient of
  ``whisper_tiny.reduced()`` (``enc`` and ``xdec`` groups, the audio
  frames plus the sinusoidal table, ``enc_norm``), uncut and cut inside the
  encoder, and of ``pixtral_12b.reduced()`` (patch embeddings prepended,
  their logits skipped by the loss), with the reference's weights
  (``test_torch_harness.drawn_model_params`` through
  ``convert.model_from_reference``), to ``TOL``;
- whisper's decode: ``decode_state_init`` leaf by leaf, teacher-forced
  ``model_decode_step`` from a state whose cross K/V the reference's
  example fills (every step's logits and the final state to ``TOL``), the
  stacked steps equal to the port's own ``model_forward``, and
  ``launch.serve.transcribe`` against the sequence of reference calls of
  ``examples/whisper_serve.py`` (tokens equal);
- a narrow head dim of 160 (pixtral's; d 320, 2 / 1 heads) through
  ``kernels.attn.ops.attention`` against the reference's Pallas kernel in
  interpret mode, forward 2e-5 and gradients 2e-4 (the reference's
  tolerances), and the flash wrapper's checks at the head dims the kernel
  now takes;
- ``Plan`` record parity of split-LM plans: the hd-160 variant with
  ``attn_impl="pallas"`` and the reduced whisper-tiny (the decoder's width
  and norms, the reference's ``lm_split_program``);
- the trainer's batch (``launch.train.step_batch``) and loop on both
  reduced configs on the CPU.

``TOL`` is ``test_torch_lm_train``'s and ``test_torch_decode``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
import repro.configs as ref_configs
from repro.configs.base import ArchConfig as RefArch
from repro.kernels.attn.ops import attention as ref_ops_attention
from repro.models import modules as ref_nn
from repro.models.transformer import _norm_apply as ref_norm_apply
from repro.models.transformer import build_groups as ref_build_groups
from repro.models.transformer import decode_state_init as ref_state_init
from repro.models.transformer import group_apply as ref_group_apply
from repro.models.transformer import model_init as ref_model_init
from repro.models.transformer import model_decode_step as ref_decode_step
import repro_torch.api as T
import repro_torch.configs as configs
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import (decode_state_from_reference,
                                 lm_from_reference, model_from_reference)
from repro_torch.core.energy import RTX_A5000
from repro_torch.kernels.attn import flash as flash_mod
from repro_torch.kernels.attn.ops import attention
from repro_torch.launch.serve import transcribe
from repro_torch.launch.train import step_batch, train
from repro_torch.models.transformer import (_embed_inputs, decode_state_init,
                                            default_cut_layer, group_apply,
                                            lm_loss, model_decode_step,
                                            model_forward, vocab_padded)
from test_torch_harness import (assert_records_match, drawn_model_params,
                                reference_loss_and_logits)

TOL = 1e-4
B, S = 2, 16


def _pair(name):
    cfg = configs.ARCHS[name].reduced()
    ref = ref_configs.ARCHS[name].reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    return cfg, ref


def _batch(cfg, seed=1):
    """Tokens (B, S) and the frontend's stand-ins, numpy-seeded:
    ``frames`` (B, enc_seq_len, d) for whisper, ``patch_embeds`` (B, Np, d)
    for pixtral. Returns (reference batch, port batch)."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab, size=(B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patch_embed":
        batch["patch_embeds"] = (0.5 * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return batch, {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name,cut", [("whisper-tiny", None),
                                      ("whisper-tiny", 1),
                                      ("pixtral-12b", 1)])
def test_forward_loss_and_gradients_match_reference(name, cut, monkeypatch):
    """whisper cut at 1 splits its 2 encoder layers into two ``enc`` groups
    (client and server); pixtral's cut is between its 2 decoder layers."""
    cfg, ref = _pair(name)
    params = drawn_model_params(ref, cut)
    model = model_from_reference(params, cfg, cut)
    if cfg.enc_dec:
        kinds = [g.kind for g in model.specs]
        assert kinds == (["enc", "xdec"] if cut is None
                         else ["enc", "enc", "xdec"])
        assert model.enc_norm is not None
    rb, tb = _batch(cfg)
    (want_loss, (want_m, want_logits)), want_g = reference_loss_and_logits(
        ref, params, rb, monkeypatch, cut_layer=cut)
    logits, _ = model_forward(cfg, model, tb, cut_layer=cut)
    n_front = cfg.frontend_tokens if cfg.frontend == "patch_embed" else 0
    assert logits.shape == (B, n_front + S, vocab_padded(cfg))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=TOL, rtol=TOL)
    loss, metrics = lm_loss(cfg, model, tb, cut_layer=cut)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), atol=TOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(want_m["ce"]),
                               atol=TOL)
    if n_front:      # the loss reads the text positions only
        text = logits[:, n_front:].detach().float()
        logp = torch.log_softmax(text, dim=-1)[:, :-1]
        ce = -torch.gather(logp, -1, tb["labels"][:, 1:, None].long()).mean()
        np.testing.assert_allclose(float(ce), float(metrics["ce"]),
                                   atol=1e-6)
    want_sd = model_from_reference(
        jax.tree_util.tree_map(np.asarray, want_g), cfg, cut).state_dict()
    for key, want in want_sd.items():
        got = model.get_parameter(key).grad
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=key)


def test_model_from_reference_keeps_the_encdec_tree():
    """A bf16 whisper tree (its structure traced): ``enc_norm``, each
    ``xdec`` layer's ``lnx`` and ``xattn`` (no biases) in bf16; an ``enc``
    layer has no cross-attention; a tree without ``enc_norm`` is refused."""
    cfg = dataclasses.replace(configs.whisper_tiny.reduced(), dtype="bfloat16")
    ref = dataclasses.replace(ref_configs.whisper_tiny.reduced(),
                              dtype="bfloat16")
    shapes = jax.eval_shape(lambda: ref_model_init(ref, jax.random.PRNGKey(0),
                                                   cut_layer=1))
    params = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                    shapes)
    sd = model_from_reference(params, cfg, 1).state_dict()
    assert sd["enc_norm.scale"].dtype == torch.bfloat16
    assert sd["groups.2.1.xattn.wk.w"].shape == (cfg.d_model, cfg.d_model)
    assert sd["groups.2.0.lnx.bias"].dtype == torch.bfloat16
    assert not any(k.startswith("groups.2.0.xattn.") and k.endswith(".b")
                   for k in sd)
    assert not any(k.startswith(("groups.0.", "groups.1."))
                   and k.split(".")[3] in ("lnx", "xattn") for k in sd)
    with pytest.raises(ValueError, match="do not match"):
        model_from_reference({k: v for k, v in params.items()
                              if k != "enc_norm"}, cfg, 1)


def test_decode_state_init_matches_reference():
    cfg, ref = _pair("whisper-tiny")
    cut = default_cut_layer(cfg, 0.15)
    for kv_dtype in ("param", "int8"):
        want = jax.eval_shape(lambda: ref_state_init(
            ref, 3, 12, cut_layer=cut, kv_dtype=kv_dtype))
        got = decode_state_init(cfg, 3, 12, cut_layer=cut, kv_dtype=kv_dtype)
        assert [sorted(g) for g in got] == [sorted(w) for w in want] == [
            [], [], ["ck", "cv", "k", "v"]]
        for g, w in zip(got, want):
            for key in w:
                assert tuple(g[key].shape) == w[key].shape, key
                assert str(g[key].dtype).split(".")[-1] == \
                    w[key].dtype.name, key
                assert not g[key].any()
    assert got[2]["ck"].shape == (cfg.n_layers, 3, cfg.enc_seq_len,
                                  cfg.n_kv_heads, cfg.hd)


def _xdec_kv(ref_cfg, params, enc_out, groups):
    """The example's fill (``examples/whisper_serve.py:45-56``): each xdec
    layer's ``wk``/``wv`` of the encoder's output, (count, B, Senc, Kh,
    hd), per group index."""
    out = {}
    b, senc = enc_out.shape[0], enc_out.shape[1]
    for gi, g in enumerate(groups):
        if g.kind != "xdec":
            continue

        def fill(xp):
            k = ref_nn.linear_apply(xp["wk"], enc_out)
            v = ref_nn.linear_apply(xp["wv"], enc_out)
            return (k.reshape(b, senc, ref_cfg.n_kv_heads, ref_cfg.hd),
                    v.reshape(b, senc, ref_cfg.n_kv_heads, ref_cfg.hd))
        out[gi] = jax.vmap(fill)(params["groups"][gi]["xattn"])
    return out


def test_decode_steps_match_reference_and_forward():
    """Cut at the serve's default (inside the encoder). The cross K/V are
    filled from ``enc_norm`` of the port's encoder over the batch's frames
    (the sinusoidal table included, as in ``model_forward``), in both
    states; 8 teacher-forced steps: every step's logits and the final
    state against the reference's to ``TOL``, and the stacked logits
    against the port's ``model_forward`` on the same batch to ``TOL``."""
    cfg, ref = _pair("whisper-tiny")
    cut = default_cut_layer(cfg, 0.15)
    params = drawn_model_params(ref, cut, seed=3)
    model = model_from_reference(params, cfg, cut)
    _, tb = _batch(cfg, seed=4)
    steps = 8
    tokens = tb["tokens"][:, :steps]
    with torch.no_grad():
        _, _, enc_x = _embed_inputs(cfg, model, tb)
        for g, layers in zip(model.specs, model.groups):
            if g.kind == "enc":
                enc_x, _ = group_apply(cfg, g, layers, enc_x, 0.0,
                                       positions=None, window=None)
        enc_out = model.enc_norm(enc_x).numpy()
    groups = ref_build_groups(ref, cut_layer=cut)
    ref_state = ref_state_init(ref, B, steps, cut_layer=cut)
    for gi, (ck, cv) in _xdec_kv(ref, params, enc_out, groups).items():
        ref_state[gi] = dict(ref_state[gi], ck=ck, cv=cv)
    state = decode_state_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_state))
    step = jax.jit(lambda p, s, t, pos: ref_decode_step(
        ref, p, s, t, pos, cut_layer=cut))
    outs = []
    with torch.no_grad():
        for t in range(steps):
            want, ref_state = step(params, ref_state,
                                   jnp.asarray(tokens[:, t:t + 1].numpy()),
                                   jnp.asarray(t, jnp.int32))
            got, state = model_decode_step(cfg, model, state,
                                           tokens[:, t:t + 1], t,
                                           cut_layer=cut)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL, rtol=TOL, err_msg=str(t))
            outs.append(got)
        full, _ = model_forward(cfg, model, dict(tb, tokens=tokens),
                                cut_layer=cut)
    want_state = decode_state_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_state))
    for g, w in zip(state, want_state):
        assert sorted(g) == sorted(w)
        for key in w:
            torch.testing.assert_close(g[key], w[key], atol=TOL, rtol=TOL,
                                       msg=key)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, atol=TOL,
                               rtol=TOL)


def test_transcribe_matches_the_reference_example():
    """``examples/whisper_serve.py``'s calls, written out with the
    reference's functions on the same weights and frames (0.02 x a numpy
    normal draw), batch 2, 12 tokens: the tokens equal ``transcribe``'s."""
    cfg, ref = _pair("whisper-tiny")
    params = drawn_model_params(ref, None, seed=5)
    model = model_from_reference(params, cfg)
    b, gen = 2, 12
    frames = (0.02 * np.random.RandomState(6).standard_normal(
        (b, ref.enc_seq_len, ref.d_model))).astype(np.float32)
    groups = ref_build_groups(ref)
    enc_x, aux = jnp.asarray(frames), jnp.zeros((), jnp.float32)
    epos = jnp.broadcast_to(jnp.arange(ref.enc_seq_len, dtype=jnp.int32),
                            (b, ref.enc_seq_len))
    for g, gp in zip(groups, params["groups"]):
        if g.kind == "enc":
            enc_x, aux = ref_group_apply(ref, g, gp, enc_x, aux,
                                         positions=epos, window=None)
    enc_out = ref_norm_apply(ref, params["enc_norm"], enc_x)
    state = ref_state_init(ref, b, gen + 1)
    for gi, (ck, cv) in _xdec_kv(ref, params, enc_out, groups).items():
        state[gi]["ck"], state[gi]["cv"] = ck, cv
    step = jax.jit(lambda p, s, t, pos: ref_decode_step(ref, p, s, t, pos))
    tok, want = jnp.zeros((b, 1), jnp.int32), []
    for t in range(gen):
        logits, state = step(params, state, tok, jnp.asarray(t, jnp.int32))
        tok = jnp.argmax(logits[:, -1, :ref.vocab], -1)[:, None].astype(
            jnp.int32)
        want.append(tok)
    got = transcribe(cfg, model, torch.from_numpy(frames), gen)
    assert got.dtype == torch.int64 and got.shape == (b, gen)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(want, 1)))
    assert len(set(got.flatten().tolist())) > 1      # not one token over
    with pytest.raises(ValueError, match="enc_seq_len"):
        transcribe(cfg, model, torch.zeros(b, 3, cfg.d_model), gen)
    pix = configs.pixtral_12b.reduced()
    with pytest.raises(ValueError, match="enc-dec"):
        transcribe(pix, model, torch.from_numpy(frames), gen)


# a narrow config at pixtral's head dim: d 320, 2 query heads over 1 KV head
HD160 = dict(name="hd160", family="vlm", n_layers=3, d_model=320, n_heads=2,
             n_kv_heads=1, head_dim=160, d_ff=64, vocab=64,
             rope_theta=1_000_000.0, dtype="float32")


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 33)])
def test_head_dim_160_attention_matches_the_pallas_kernel(causal, window):
    """S 100 over the kernel seam: the port's flash path (its plain version
    on the CPU, its closed-form gradient) against the reference's Pallas
    kernel in interpret mode, GQA 2 / 1."""
    rng = np.random.RandomState(7)
    q = rng.standard_normal((2, 100, 2, 160)).astype(np.float32)
    k, v = (rng.standard_normal((2, 100, 1, 160)).astype(np.float32)
            for _ in range(2))

    def ref_loss(q_, k_, v_):
        o = ref_ops_attention(q_, k_, v_, causal=causal, window=window,
                              use_pallas=True, interpret=True)
        return (o * jnp.cos(o)).sum(), o

    (_, want), want_g = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = attention(*leaves, causal=causal, window=window, use_kernel=True)
    (got * torch.cos(got)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    for leaf, g in zip(leaves, want_g):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   atol=2e-4)


def test_flash_wrapper_takes_head_dims_up_to_256():
    """The wrapper's checks (run before a launch on the card) on CPU
    tensors: every multiple of 16 from 16 to 256 passes, 272 and 40 are
    refused. (The grid's length limit is the launcher's own, checked at
    the tile each dtype and head dim launches with: a card test.)"""
    for d in range(16, 257, 16):
        x = torch.zeros(1, 2, 8, d)
        flash_mod._check(x, x, x, None)
    for d in (40, 272):
        x = torch.zeros(1, 2, 8, d)
        with pytest.raises(ValueError, match="head dim"):
            flash_mod._check(x, x, x, None)
    assert flash_mod.MAX_HEAD_DIM == 256


def _lm_spec(api, arch, impl):
    return api.ExperimentSpec(
        model=api.ModelSpec(family="transformer", name=arch.name, arch=arch,
                            attn_impl=impl),
        data=api.DataSpec(kind="tokens", partition="iid", seq_len=16,
                          n_train=16, n_test=2),
        clients=api.ClientSpec(num_clients=2),
        cut_policy=api.CutPolicy(fraction=0.4),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(link_kernel="fused"),
        global_rounds=1, local_steps=2, batch_size=4)


@pytest.mark.parametrize("arch,impl", [("hd160", "pallas"),
                                       ("whisper-tiny", "xla")])
def test_split_lm_plan_records_match_reference(arch, impl):
    """The split-LM plan (``sl/scan``, int8 link on the fused kernel) of the
    hd-160 variant on the flash kernel's path (the reference's Pallas kernel
    in interpret mode) and of the reduced whisper-tiny, whose plan the port
    no longer refuses: records within ``assert_records_match``'s
    tolerances."""
    if arch == "hd160":
        cfg, ref = ArchConfig(**HD160), RefArch(**HD160)
    else:
        cfg, ref = _pair(arch)
    ref_plan = R.compile_experiment(_lm_spec(R, ref, impl))
    data = (ref_plan.x_train, ref_plan.y_train, ref_plan.x_test,
            ref_plan.y_test)
    port_plan = T.compile_experiment(_lm_spec(T, cfg, impl), data=data,
                                     device="cpu")
    k = port_plan.cut_of_client[0]
    assert port_plan.cut_of_client == ref_plan.cut_of_client
    port_plan.params0 = lm_from_reference(
        *jax.tree_util.tree_map(np.asarray, ref_plan.params0), cfg)
    _, ref_recs = ref_plan.run()
    _, port_recs = port_plan.run()
    assert port_plan.flops[k][2].shape == (4, 16, cfg.d_model)
    assert_records_match(
        ref_recs, port_recs, ref_flops_pair=ref_plan.flops[k][:2],
        port_flops_pair=port_plan.flops[k][:2], server_base_s=0.0,
        n_test=2 * 16)


@pytest.mark.parametrize("name", ["whisper-tiny", "pixtral-12b"])
def test_trainer_runs_the_frontends(name, capsys):
    """``step_batch``: the frontend's stand-ins at their shapes, 0.02 x a
    normal draw from the step's generator after the tokens, repeatable;
    then two steps of ``launch.train`` on the CPU, finite losses."""
    cfg = configs.ARCHS[name].reduced()
    a = step_batch(cfg, np.random.default_rng([0, 1]), 2, 8, "cpu")
    b = step_batch(cfg, np.random.default_rng([0, 1]), 2, 8, "cpu")
    extra = "frames" if cfg.enc_dec else "patch_embeds"
    n = cfg.enc_seq_len if cfg.enc_dec else cfg.frontend_tokens
    assert sorted(a) == sorted(["tokens", "labels", extra])
    assert a[extra].shape == (2, n, cfg.d_model)
    assert a[extra].dtype == torch.float32
    assert 0.01 < float(a[extra].std()) < 0.03
    assert all(torch.equal(a[key], b[key]) for key in a)
    losses = train(cfg, steps=2, batch=2, seq=8, lr=3e-3, log_every=1,
                   hardware=RTX_A5000, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert f"[train] arch={cfg.name}" in capsys.readouterr().out
