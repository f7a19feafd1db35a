"""The port's serving path against the reference: cached decode attention,
the decode state, the one-token decode step and the greedy serve loop.

- ``decode_attention`` (grouped, no repeated KV) and ``update_kv_cache``
  against the reference's, f32 to 1e-6 and bf16 to one bf16 rounding;
- ``decode_state_init`` against the reference's, leaf by leaf (keys,
  shapes, dtypes, bytes) for each group kind the port decodes, plain and
  int8 KV, with and without a sliding window;
- ``model_decode_step`` teacher-forced with the reference's weights
  (``convert.model_from_reference``), split at the serve's default cut:
  every step's logits against the reference's ``model_decode_step`` at
  1e-4 (f32) and the final state against its state
  (``convert.decode_state_from_reference``), and the stacked logits
  against the port's own ``model_forward`` at the reference's criteria
  (1e-4, ``tests/test_models.py:163``; int8 KV: relative max error < 0.05,
  ``tests/test_perf_options.py:37``), on SmolLM (GQA), Qwen1.5 (qkv bias),
  H2O-Danube with more steps than its window of 32 (the ring slot wraps),
  RWKV-6 (head size 256: the WKV kernel's plain version from a carried
  state on the CPU) and SmolLM with an int8 KV cache;
- ``launch.serve.generate`` against the reference serve's loop
  (``repro/launch/serve.py:53-66``) on the reference's prompts: tokens
  equal, every step's logits within 1e-4; and ``serve`` on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.data.synthetic import synthetic_tokens as ref_synthetic_tokens
from repro.models.attention import decode_attention as ref_decode_attention
from repro.models.attention import update_kv_cache as ref_update_kv_cache
from repro.models.transformer import decode_state_init as ref_state_init
from repro.models.transformer import model_decode_step as ref_decode_step
from repro.models.transformer import model_init as ref_model_init
import repro_torch.configs as configs
from repro_torch.convert import (decode_state_from_reference,
                                 model_from_reference)
from repro_torch.launch.serve import generate, serve
from repro_torch.models.attention import decode_attention, update_kv_cache
from repro_torch.models.transformer import (decode_state_init,
                                            default_cut_layer,
                                            model_decode_step, model_forward)

TOL = 1e-4
CLIENT_FRACTION = 0.15           # the reference serve's default


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a) -> np.ndarray:
    return a.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_and_cache_write_match_reference(dtype):
    """GQA 4 query heads over 2 KV heads, a cache of 9 positions of which
    the first 6 are live; one token written at position 6."""
    rng = np.random.RandomState(0)
    b, s, h, kh, d = 2, 9, 4, 2, 16
    q, k_new, v_new = (rng.standard_normal(shape).astype(np.float32)
                       for shape in ((b, 1, h, d), (b, 1, kh, d),
                                     (b, 1, kh, d)))
    kc, vc = (rng.standard_normal((b, s, kh, d)).astype(np.float32)
              for _ in range(2))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def j(a):
        return jnp.asarray(a).astype(jdt)

    def t(a):
        return torch.from_numpy(a).to(tdt)

    want_k, want_v = ref_update_kv_cache(j(kc), j(vc), j(k_new), j(v_new), 6)
    got_k, got_v = update_kv_cache(t(kc), t(vc), t(k_new), t(v_new), 6)
    assert got_k.dtype == tdt
    np.testing.assert_array_equal(_t(got_k), _np(want_k))
    np.testing.assert_array_equal(_t(got_v), _np(want_v))
    want = ref_decode_attention(j(q), want_k, want_v, 7)
    got = decode_attention(t(q), got_k, got_v, 7)
    assert got.shape == (b, 1, h, d) and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_t(got), _np(want), atol=1e-6, rtol=1e-6)
    else:
        np.testing.assert_allclose(_t(got), _np(want), rtol=0,
                                   atol=2 ** -7 * np.abs(_np(want)).max())
    # positions >= cache_len do not count: garbage there changes nothing
    got_k[:, 7:] = 1e4
    torch.testing.assert_close(decode_attention(t(q), got_k, got_v, 7), got,
                               atol=0, rtol=0)


@pytest.mark.parametrize("arch,kv_dtype,max_len", [
    ("smollm-135m", "param", 12), ("smollm-135m", "int8", 12),
    ("h2o-danube-1.8b", "param", 40), ("rwkv6-7b", "param", 12)])
def test_decode_state_init_matches_reference(arch, kv_dtype, max_len):
    ref_cfg = ref_configs.ARCHS[arch].reduced()
    cfg = configs.ARCHS[arch].reduced()
    cut = default_cut_layer(cfg, CLIENT_FRACTION)
    want = jax.eval_shape(lambda: ref_state_init(
        ref_cfg, 3, max_len, cut_layer=cut, kv_dtype=kv_dtype))
    got = decode_state_init(cfg, 3, max_len, cut_layer=cut,
                            kv_dtype=kv_dtype)
    assert len(got) == len(want) == 2          # client and server groups
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert tuple(g[key].shape) == w[key].shape, key
            assert str(g[key].dtype).split(".")[-1] == w[key].dtype.name, key
            assert not g[key].any()
    nbytes = sum(a.numel() * a.element_size() for g in got for a in g.values())
    assert nbytes == sum(a.size * a.dtype.itemsize
                         for g in want for a in g.values())
    if arch == "h2o-danube-1.8b":              # the ring: the window of 32
        assert got[0]["k"].shape[2] == cfg.swa_window == 32 < max_len


def _reference_and_port(arch, seed=0):
    ref_cfg = ref_configs.ARCHS[arch].reduced()
    cfg = configs.ARCHS[arch].reduced()
    cut = default_cut_layer(cfg, CLIENT_FRACTION)
    params = jax.tree_util.tree_map(
        np.asarray, ref_model_init(ref_cfg, jax.random.PRNGKey(seed),
                                   cut_layer=cut))
    return ref_cfg, cfg, cut, params, model_from_reference(params, cfg, cut)


@pytest.mark.parametrize("arch,kv_dtype,steps", [
    ("smollm-135m", "param", 10), ("qwen1.5-32b", "param", 10),
    ("h2o-danube-1.8b", "param", 40), ("rwkv6-7b", "param", 10),
    ("smollm-135m", "int8", 10)])
def test_decode_step_teacher_forced_matches_reference_and_forward(
        arch, kv_dtype, steps):
    ref_cfg, cfg, cut, params, model = _reference_and_port(arch)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, (2, steps))
    step = jax.jit(lambda p, s, t, pos: ref_decode_step(
        ref_cfg, p, s, t, pos, cut_layer=cut))
    ref_state = ref_state_init(ref_cfg, 2, steps, cut_layer=cut,
                               kv_dtype=kv_dtype)
    state = decode_state_init(cfg, 2, steps, cut_layer=cut,
                              kv_dtype=kv_dtype)
    tok = torch.from_numpy(tokens)
    outs = []
    with torch.no_grad():
        for t in range(steps):
            want, ref_state = step(params, ref_state,
                                   jnp.asarray(tokens[:, t:t + 1]),
                                   jnp.asarray(t, jnp.int32))
            got, state = model_decode_step(cfg, model, state,
                                           tok[:, t:t + 1], t, cut_layer=cut)
            assert not got.requires_grad
            np.testing.assert_allclose(_t(got), _np(want), atol=TOL,
                                       rtol=TOL, err_msg=f"step {t}")
            outs.append(got)
        full, _ = model_forward(cfg, model, {"tokens": tok}, cut_layer=cut)
    want_state = decode_state_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_state))
    for g, w in zip(state, want_state):
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            if w[key].dtype == torch.int8:     # codes: a tie may round apart
                assert (g[key].int() - w[key].int()).abs().max() <= 1, key
            else:
                torch.testing.assert_close(g[key], w[key], atol=TOL,
                                           rtol=TOL, msg=key)
    dec = torch.cat(outs, dim=1)
    if kv_dtype == "int8":
        rel = float((dec - full).abs().max() / full.abs().max())
        assert rel < 0.05, rel
    else:
        torch.testing.assert_close(dec, full, atol=TOL, rtol=TOL)


def test_chunked_rwkv_prefill_equals_one_pass():
    """The carried state continues a sequence: the time mix over 24 tokens
    equals 10 tokens, then 14 from the state those left, then the decode
    step for a 25th token from the state the 24 left equals the last
    output of a 25-token pass."""
    from repro_torch.models.ssm import rwkv6_apply, rwkv6_step
    _, cfg, _, _, model = _reference_and_port("rwkv6-7b", seed=2)
    mix = model.groups[0][0].mix
    x = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (2, 25, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        whole, st = rwkv6_apply(mix, x[:, :24], head_size=cfg.hd)
        a, st_a = rwkv6_apply(mix, x[:, :10], head_size=cfg.hd)
        b, st_b = rwkv6_apply(mix, x[:, 10:24], st_a, head_size=cfg.hd)
        last, _ = rwkv6_step(mix, x[:, 24:], st, head_size=cfg.hd)
        full, _ = rwkv6_apply(mix, x, head_size=cfg.hd)
    torch.testing.assert_close(torch.cat([a, b], dim=1), whole, atol=TOL,
                               rtol=TOL)
    torch.testing.assert_close(st_b["S"], st["S"], atol=TOL, rtol=TOL)
    torch.testing.assert_close(last, full[:, 24:], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-7b"])
def test_generate_matches_the_reference_serve_loop(arch):
    """The reference serve's loop, written out with its own jitted step, on
    its own prompts (``synthetic_tokens`` from PRNGKey(0)), batch 2,
    prompt 6, 5 generated tokens."""
    ref_cfg, cfg, cut, params, model = _reference_and_port(arch)
    b, plen, gen = 2, 6, 5
    prompts = ref_synthetic_tokens(jax.random.PRNGKey(0), b, plen,
                                   ref_cfg.vocab)
    step = jax.jit(lambda p, s, t, pos: ref_decode_step(
        ref_cfg, p, s, t, pos, cut_layer=cut))
    state = ref_state_init(ref_cfg, b, plen + gen, cut_layer=cut)
    logits, kept, toks = None, [], []
    for t in range(plen):
        logits, state = step(params, state, prompts[:, t:t + 1],
                             jnp.asarray(t, jnp.int32))
        kept.append(logits)
    for t in range(plen, plen + gen):
        nxt = jnp.argmax(logits[:, -1, :ref_cfg.vocab], axis=-1).astype(
            jnp.int32)
        toks.append(nxt)
        logits, state = step(params, state, nxt[:, None],
                             jnp.asarray(t, jnp.int32))
        kept.append(logits)
    got, got_logits = generate(cfg, model,
                               torch.from_numpy(np.array(prompts)).long(),
                               gen, cut_layer=cut, keep_logits=True)
    assert got.dtype == torch.int64 and got.shape == (b, gen)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.stack(toks, axis=1)))
    np.testing.assert_allclose(_t(got_logits),
                               _np(jnp.concatenate(kept, axis=1)),
                               atol=TOL, rtol=TOL)


def test_serve_on_the_cpu_prints_the_reference_lines(capsys):
    cfg = configs.smollm_135m.reduced()
    out, dt = serve(cfg, batch=2, prompt_len=4, gen=3, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 3) and dt > 0
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve]")]
    assert len(lines) == 2 and "tok/s incl. prefill" in lines[0]
    with pytest.raises(SystemExit):
        serve(configs.whisper_tiny.reduced(), device="cpu")
