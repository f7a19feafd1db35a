"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``).

Other test modules import this one (``from test_torch_harness import ...``,
as they import ``_hypothesis_compat``); its own tests below pin the
helpers. Inputs and parameters are made with numpy from a seed and handed
to both packages: the JAX reference (``repro``) and the port
(``repro_torch``). The reference runs on the CPU. Tests that need the
card are in ``test_torch_cuda.py``, which imports no jax.
"""
import dataclasses
import functools
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import flops as ref_flops
from repro.core.split import init_stages as ref_init_stages
from repro.models.cnn import CNN_BUILDERS as REF_BUILDERS
from repro_torch.convert import from_reference
from repro_torch.models.cnn import CNN_BUILDERS as PORT_BUILDERS

if os.environ.get("PYTEST_XDIST_WORKER"):
    # several workers share the machine's cores
    torch.set_num_threads(2)

RECORD_LINK_FIELDS = ("link_time_s", "link_energy_j")


def reference_params(name: str, seed: int = 0, num_classes: int = 12):
    """(reference stages, numpy params) of a reference backbone. The
    params take the reference's tree structure (from ``eval_shape`` of its
    initializer) and are drawn with numpy: weights at fan-in scale, and
    non-trivial GroupNorm scales and biases so every term is exercised."""
    stages = REF_BUILDERS[name](num_classes)
    shapes = jax.eval_shape(
        lambda: ref_init_stages(jax.random.PRNGKey(0), stages))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        key = jax.tree_util.keystr(path)
        if len(s.shape) >= 2:
            fan_in = math.prod(s.shape[:-1])
            return (rng.standard_normal(s.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if key.endswith("['scale']") else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return stages, jax.tree_util.tree_map_with_path(draw, shapes)


def port_stages(name: str, params_np, num_classes: int = 12):
    """The port's stages of ``name`` loaded with the reference's params."""
    stages = PORT_BUILDERS[name](num_classes)
    for stage, p in zip(stages, from_reference(params_np, name)):
        stage.body.load_state_dict(p)
        stage.to(memory_format=torch.channels_last)
    return stages


def _contractions(jaxpr) -> float:
    total = 0.0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            total += ref_flops._dot_general_flops(eqn)
        elif name == "conv_general_dilated":
            total += ref_flops._conv_flops(eqn)
        elif name == "scan":
            total += (float(eqn.params.get("length", 1))
                      * _contractions(eqn.params["jaxpr"].jaxpr))
        else:
            for sub, reps in ref_flops._subjaxprs(eqn.params):
                total += reps * _contractions(getattr(sub, "jaxpr", sub))
    return total


def jax_contraction_flops(fn, *args) -> float:
    """The reference's analytic jaxpr walk restricted to ``dot_general`` and
    ``conv_general_dilated`` (2 * out * K each): the contraction FLOPs of
    ``fn(*args)``."""
    return _contractions(jax.make_jaxpr(fn)(*args).jaxpr)


def _billing_ratios(ref_flops_pair, port_flops_pair, ref_consts, active):
    """Port/reference ratios of (client time, client energy, server time)
    for one record. One pair each: the client and the server FLOP ratios.
    Per-client pairs (clients at different cuts): each field's ratio is
    the mean of the active clients' FLOP ratios weighted by their
    reference step constants ``ref_consts = (t_client, p_edge,
    t_server)``, since each client is billed at its own cut."""
    if ref_consts is None:
        (ref_c, ref_s), (port_c, port_s) = ref_flops_pair, port_flops_pair
        return port_c / ref_c, port_c / ref_c, (port_s / ref_s if ref_s
                                                else None)
    t, p_edge, t_srv = (np.asarray(a, np.float64)[active] for a in ref_consts)
    rc = np.asarray([port_flops_pair[c][0] / ref_flops_pair[c][0]
                     for c in active])
    rs = np.asarray([port_flops_pair[c][1] / ref_flops_pair[c][1]
                     for c in active])
    return ((rc * t).sum() / t.sum(),
            (rc * t * p_edge).sum() / (t * p_edge).sum(),
            (rs * t_srv).sum() / t_srv.sum())


def assert_records_match(ref_recs, port_recs, *, ref_flops_pair,
                         port_flops_pair, server_base_s, n_test,
                         loss_atol=1e-3, ref_consts=None, active=None,
                         link_rel=1e-9):
    """Record-stream parity: loss within ``loss_atol``, accuracy within one
    test sample (or NaN in both), link bytes and cohort ids exact, link time/energy within
    ``link_rel`` relative (1e-9; a scenario's channel rates are float32
    arithmetic, each package's own, and hold to 1e-6),
    the rest by the billing arithmetic: every client field scales by the
    client FLOP ratio and every server field (less ``server_base_s``) by
    the server FLOP ratio, within 1e-6.

    With clients at different cuts, ``ref_flops_pair`` and
    ``port_flops_pair`` are per-client lists of (client, server) FLOP
    pairs (each client's cut's), ``ref_consts`` the reference plan's
    per-client ``(t_client, p_edge, t_server)`` step constants, and
    ``active`` a list a record of its active client ids (default: every
    client): each field then scales by the weighted ratio of
    ``_billing_ratios``."""
    assert len(ref_recs) == len(port_recs)
    for i, (r, p) in enumerate(zip(ref_recs, port_recs)):
        assert p.round == r.round and p.engine == r.engine
        assert abs(p.loss - r.loss) <= loss_atol, (p.loss, r.loss)
        if not (math.isnan(p.accuracy) and math.isnan(r.accuracy)):
            # both NaN: neither round evaluated (a Monte-Carlo sweep's)
            assert abs(p.accuracy - r.accuracy) <= 1.0 / n_test + 1e-12
        assert p.link_bytes == r.link_bytes
        assert tuple(p.cohort_pids) == tuple(r.cohort_pids)
        for f in RECORD_LINK_FIELDS:
            assert getattr(p, f) == pytest.approx(getattr(r, f),
                                                  rel=link_rel)
        assert p.active_clients == r.active_clients
        assert p.uav_energy_j == r.uav_energy_j
        ids = None
        if ref_consts is not None:
            ids = (np.arange(len(ref_consts[0])) if active is None
                   else np.asarray(active[i]))
            assert len(ids) == r.active_clients
        r_time, r_energy, r_server = _billing_ratios(
            ref_flops_pair, port_flops_pair, ref_consts, ids)
        for f, ratio in (("client_time_s", r_time),
                         ("client_energy_j", r_energy)):
            assert getattr(p, f) / getattr(r, f) == pytest.approx(
                ratio, rel=1e-6)
        if r_server is not None:
            for f, base in (("server_time_s", server_base_s),
                            ("server_energy_j", server_base_s * 230.0)):
                assert (getattr(p, f) - base) / (getattr(r, f) - base) == \
                    pytest.approx(r_server, rel=1e-6)
        else:
            assert p.server_time_s == pytest.approx(r.server_time_s,
                                                    rel=1e-12)
            assert p.server_energy_j == pytest.approx(r.server_energy_j,
                                                      rel=1e-12)


def plan_flops_pair(plan):
    """(client, server) FLOPs a plan bills a step at: the full model's and 0
    on FL, the first client's cut's on SL."""
    if plan.spec.engine.kind == "fl":
        return plan.flops["full"], 0.0
    c, s, _ = plan.flops[plan.cut_of_client[0]]
    return c, s


PAPER_N_TRAIN, PAPER_N_TEST = 96, 24


def paper_plans_both(model: str, kind: str, *, fraction: float = 0.25,
                     compress: bool = False, image_size: int = 32):
    """One ``paper_spec`` (2 clients, 1 round, 1 local step, batch 4) through
    both packages' ``compile_experiment`` on the same numpy arrays (seed 0,
    12 classes), the port on the CPU with the reference plan's ``params0``
    (through ``convert.from_reference``). Returns (reference plan, port
    plan, reference records, port records)."""
    from repro.api import compile_experiment as ref_compile
    from repro.core.paper_train import PaperTrainConfig as RefConfig
    from repro.core.paper_train import paper_spec as ref_paper_spec
    from repro_torch.api import compile_experiment as port_compile
    from repro_torch.core.paper_train import PaperTrainConfig, paper_spec

    fields = dict(model=model, image_size=image_size, num_clients=2,
                  global_rounds=1, local_steps=1, batch_size=4,
                  client_fraction=fraction, compress_link=compress)
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, (PAPER_N_TRAIN, image_size, image_size, 3)).astype(
        np.float32)
    y = rng.randint(0, 12, size=(PAPER_N_TRAIN,))
    data = (x, y, x[:PAPER_N_TEST], y[:PAPER_N_TEST])
    ref_plan = ref_compile(ref_paper_spec(RefConfig(**fields), kind),
                           data=data)
    port_plan = port_compile(paper_spec(PaperTrainConfig(**fields), kind),
                             data=data, device="cpu")
    port_plan.params0 = from_reference(
        jax.tree_util.tree_map(np.asarray, ref_plan.params0), model)
    _, ref_recs = ref_plan.run()
    _, port_recs = port_plan.run()
    return ref_plan, port_plan, ref_recs, port_recs


def reference_env_draws(env_seed: int, rounds: int, *, mask_n: int = 0,
                        rates_n: int = 0) -> list:
    """The reference's environment draws of ``rounds`` rounds, as the
    port's ``EnvDraws`` (``Plan.env_draws``): per round ``r`` of
    ``keys.round_env_key(PRNGKey(env_seed), r)``, ``mask_n`` uniforms of
    its ``ENV_MASK`` fold (``availability_step``'s draw) and ``rates_n``
    normals and exponentials of the two keys split from its ``ENV_RATES``
    fold (``sample_rates_bps``'s draws)."""
    from repro import keys
    from repro_torch.sim.streams import EnvDraws
    env = jax.random.PRNGKey(env_seed)
    out = []
    for r in range(rounds):
        kr = keys.round_env_key(env, r)
        mask = normal = exponential = None
        if mask_n:
            mask = np.asarray(jax.random.uniform(keys.fold(kr, keys.ENV_MASK),
                                                 (mask_n,)))
        if rates_n:
            k_sh, k_fd = jax.random.split(keys.fold(kr, keys.ENV_RATES))
            normal = np.asarray(jax.random.normal(k_sh, (rates_n,)))
            exponential = np.asarray(jax.random.exponential(k_fd,
                                                            (rates_n,)))
        out.append(EnvDraws(mask=mask, normal=normal,
                            exponential=exponential))
    return out


@functools.lru_cache(maxsize=None)
def drawn_model_params(ref, cut, seed: int = 0):
    """The reference's ``model_init(ref, key, cut_layer=cut)`` tree, traced
    (``jax.eval_shape``), not run, with leaves drawn by numpy at its
    scales: N(0, 1/fan_in) for a matrix or stack, 1 + N(0, 0.1^2) for norm
    scales and Mamba's ``D``, log(1..N) + N(0, 0.1^2) for ``A_log``,
    N(0, 0.1^2) for other vectors; in the leaves' dtypes. The MoE and
    hybrid configs' eager init costs seconds (jamba's ~6 s a process).
    One tree per arguments in a process: callers copy, never write it."""
    from repro.models.transformer import model_init as ref_model_init
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: ref_model_init(
        ref, jax.random.PRNGKey(0), cut_layer=cut))

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        noise = rng.standard_normal(a.shape, dtype=np.float32)
        if "A_log" in key:
            v = np.log(np.arange(1, a.shape[-1] + 1)) + 0.1 * noise
        elif "scale" in key or key.endswith("['D']"):
            v = 1.0 + 0.1 * noise
        elif len(a.shape) >= 2 + ("groups" in key):
            v = noise / np.sqrt(a.shape[-2])
        else:
            v = 0.1 * noise
        return np.asarray(v, np.float32).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def reference_loss_and_logits(ref, params, batch, monkeypatch, **kw):
    """The reference's ``lm_loss`` value and gradient, jitted, and the
    logits its ``model_forward`` made on the way, from one trace: the
    forward is wrapped (for the calling test only, through its
    ``monkeypatch``) to hand its logits out as the loss's aux, where tracing
    the model again for them would double the case's time. Returns ((loss,
    (metrics, logits)), grads)."""
    import repro.models.transformer as ref_transformer
    forward, seen = ref_transformer.model_forward, []

    def recording(*args, **kwargs):
        out = forward(*args, **kwargs)
        seen.append(out[0])
        return out

    monkeypatch.setattr(ref_transformer, "model_forward", recording)

    def loss(p):
        value, metrics = ref_transformer.lm_loss(ref, p, batch, **kw)
        return value, (metrics, seen.pop())

    return jax.block_until_ready(
        jax.jit(jax.value_and_grad(loss, has_aux=True))(params))


# ---------------------------------------------------------------------------
# tests of the helpers
# ---------------------------------------------------------------------------

def test_drawn_model_params_follow_the_reference_tree():
    from repro.configs import deepseek_moe_16b
    from repro.models.transformer import model_init as ref_model_init
    ref = dataclasses.replace(deepseek_moe_16b.reduced(), dtype="bfloat16")
    params = drawn_model_params(ref, 1, seed=2)
    want = jax.eval_shape(lambda: ref_model_init(ref, jax.random.PRNGKey(0),
                                                 cut_layer=1))
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(want))
    for a, s in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == s.shape and a.dtype == s.dtype
    router = params["groups"][1]["moe"]["router"]["w"]
    assert router.dtype == np.float32
    assert abs(float(router.std()) * math.sqrt(router.shape[-2]) - 1) < 0.2
    again = drawn_model_params(ref, 1, seed=2)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_reference_params_follow_the_reference_tree():
    stages, params = reference_params("tinycnn", seed=3)
    want = jax.eval_shape(lambda: ref_init_stages(jax.random.PRNGKey(0),
                                                  stages))
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(want))
    for a, s in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == s.shape and a.dtype == np.float32
    again = reference_params("tinycnn", seed=3)[1]
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_port_stages_carry_the_reference_weights():
    _, params = reference_params("tinycnn")
    stages = port_stages("tinycnn", params)
    w_ref = params[0]["conv"]["w"]                    # HWIO
    w_port = stages[0].body.conv.w.detach().numpy()   # OIHW
    np.testing.assert_array_equal(w_port, w_ref.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(stages[-1].body.w.detach().numpy(),
                                  params[-1]["w"])


def test_contraction_walk_counts_a_matmul_and_a_conv():
    a = np.ones((4, 6), np.float32)
    b = np.ones((6, 5), np.float32)
    assert jax_contraction_flops(lambda x, y: x @ y, a, b) == 2 * 4 * 5 * 6
    x = np.ones((2, 8, 8, 3), np.float32)
    w = np.ones((3, 3, 3, 4), np.float32)
    conv = lambda x, w: jax.lax.conv_general_dilated(  # noqa: E731
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert jax_contraction_flops(conv, x, w) == 2 * (2 * 8 * 8 * 4) * 27


def test_records_match_compares_cohort_ids():
    from repro.api.records import RoundRecord
    rec = RoundRecord(round=0, loss=1.0, accuracy=0.5, link_bytes=8.0,
                      link_time_s=1.0, link_energy_j=2.0, client_time_s=3.0,
                      client_energy_j=4.0, server_time_s=5.0,
                      server_energy_j=6.0, uav_energy_j=0.0,
                      active_clients=2, engine="sl/vmap",
                      cohort_pids=(3, 17))
    kw = dict(ref_flops_pair=(1.0, 1.0), port_flops_pair=(1.0, 1.0),
              server_base_s=0.0, n_test=4)
    assert_records_match([rec], [rec], **kw)
    other = dataclasses.replace(rec, cohort_pids=(3, 18))
    with pytest.raises(AssertionError):
        assert_records_match([rec], [other], **kw)


def test_records_match_bills_each_client_at_its_own_cut():
    """Three clients at two cuts (FLOP ratios 2 and 3 on the client, 5 and
    7 on the server): records billed client by client pass, with every
    client active and with a subset; a bill at one ratio for all does
    not."""
    from repro.api.records import RoundRecord
    t, p_edge, t_srv = (np.array([1.0, 2.0, 4.0]), np.array([40.0, 2.0, 40.0]),
                        np.array([0.5, 0.25, 0.5]))
    ref_pairs = [(10.0, 20.0), (30.0, 40.0), (10.0, 20.0)]
    port_pairs = [(20.0, 100.0), (90.0, 280.0), (20.0, 100.0)]
    rc = np.array([2.0, 3.0, 2.0])
    rs = np.array([5.0, 7.0, 5.0])

    def record(ids, scale_c, scale_s):
        ids = np.asarray(ids)
        return RoundRecord(
            round=0, loss=1.0, accuracy=0.5, link_bytes=8.0,
            link_time_s=1.0, link_energy_j=2.0,
            client_time_s=float((scale_c * t)[ids].sum()),
            client_energy_j=float((scale_c * t * p_edge)[ids].sum()),
            server_time_s=float((scale_s * t_srv)[ids].sum()),
            server_energy_j=float((scale_s * t_srv)[ids].sum()) * 230.0,
            uav_energy_j=0.0, active_clients=len(ids), engine="sl/vmap")

    kw = dict(ref_flops_pair=ref_pairs, port_flops_pair=port_pairs,
              server_base_s=0.0, n_test=4, ref_consts=(t, p_edge, t_srv))
    for ids in ([0, 1, 2], [1, 2]):
        assert_records_match([record(ids, 1.0, 1.0)],
                             [record(ids, rc, rs)], active=[ids], **kw)
    with pytest.raises(AssertionError):
        assert_records_match([record([0, 1, 2], 1.0, 1.0)],
                             [record([0, 1, 2], 2.0, rs)], **kw)
    with pytest.raises(AssertionError):
        assert_records_match([record([1, 2], 1.0, 1.0)],
                             [record([1, 2], rc, rs)], active=[[0, 1]],
                             **kw)


def test_reference_env_draws_are_the_references_streams():
    """The mask uniforms drive the reference's own availability step to
    its mask, and the channel draws give its own rates."""
    import jax.numpy as jnp
    from repro import keys
    from repro.sim import (AvailabilityParams, ChannelParams,
                           availability_step, sample_rates_bps)
    draws = reference_env_draws(5, 2, mask_n=6, rates_n=6)
    assert [d.mask.dtype for d in draws] == [np.float32] * 2
    avail = AvailabilityParams(kind="bernoulli", p_drop=0.5)
    chan = ChannelParams()
    dist = jnp.full((6,), 120.0)
    for r, d in enumerate(draws):
        kr = keys.round_env_key(jax.random.PRNGKey(5), r)
        mask, _ = availability_step(keys.fold(kr, keys.ENV_MASK),
                                    jnp.ones(6), avail)
        np.testing.assert_array_equal(np.asarray(mask),
                                      (d.mask >= 0.5).astype(np.float32))
        want = np.asarray(sample_rates_bps(keys.fold(kr, keys.ENV_RATES),
                                           chan, dist, 1e8))
        snr_db = (chan.tx_power_dbm - (chan.ref_loss_db + 22.0 * np.log10(
            np.float32(120.0))) - chan.noise_dbm - 4.0 * d.normal)
        got = 20e6 * np.log2(1.0 + 10.0 ** (snr_db / 10.0) * d.exponential)
        np.testing.assert_allclose(np.maximum(got, 1e4), want, rtol=1e-5)
