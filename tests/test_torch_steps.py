"""The sharding policy, the step builders and the dry run, held against the
reference (``repro.parallel.sharding``, ``repro.launch.steps``,
``repro.launch.dryrun``).

- ``param_pspecs`` equals the reference's leaf for leaf on every arch
  (reduced) on an abstract 16x16 mesh, for the server tier, the client
  tier and ``client_edp``; ``model_pspecs`` gives each of the port's
  per-layer leaves the same spec without the stacked axes; the rules and
  the divisibility guard of ``tests/test_launch.py`` hold at full size;
- ``effective_window``, ``shape_supported``, ``batch_sds`` and
  ``batch_pspecs``, ``state_pspecs``, every ``BuiltStep.meta`` and the
  body probes' group kinds and counts equal the reference's;
- the built train step is ``launch.train.train_step``'s loss and
  gradients, remat leaves them unchanged, and ``shard_act`` is the
  identity without a policy;
- the dry run, in a process of its own (it starts the fake process group),
  writes its records: a reduced config on a 2x4 fake mesh, its global
  FLOPs equal to a plain meta-device trace's, the same with 3 heads over
  the 4 model ranks (an uneven split DTensor refuses and the dry run
  gathers), a reduced deepseek-moe-16b prefill (the MoE routing table and
  combine, scattered out of place) ``ok`` with its FLOPs equal to the
  plain trace's, and whisper x long_500k skipped with the reference's
  reason;
- SmolLM-135M x decode_32k at its published widths, cut to 2 layers,
  ends ``ok`` on both production meshes with equal global FLOPs and no
  more argument bytes on rank 0 of the 2x16x16 mesh, and on a 2x2x2
  fake mesh a strided view of batch and heads is gathered apart
  (``ReshardOnRefusal``'s ``gather_strided``), so that the next op is
  priced without the graph-based planner's search.

No test starts a process group in the pytest process.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as ref_configs
from repro.launch import steps as ref_steps
from repro.launch.mesh import abstract_mesh as ref_abstract_mesh
from repro.launch.mesh import make_host_mesh
from repro.models.transformer import decode_state_init as ref_state_init
from repro.models.transformer import model_init as ref_model_init
from repro.parallel.sharding import param_pspecs as ref_param_pspecs
import repro_torch.configs as configs
from repro_torch.checkpoint.ckpt import tree_flatten_with_paths
from repro_torch.convert import model_to_reference, reference_path
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.train import train_step
from repro_torch.models.transformer import (Model, build_groups,
                                            decode_state_init,
                                            default_cut_layer, lm_loss,
                                            model_init)
from repro_torch.optim import AdamW, OptState
from repro_torch.parallel.sharding import (P, ShardingPolicy, model_pspecs,
                                           param_pspecs, set_policy,
                                           shard_act)

ROOT = os.path.join(os.path.dirname(__file__), "..")
NAMES = list(configs.ARCHS)
MESH = abstract_mesh((16, 16), ("data", "model"))
REF_MESH = ref_abstract_mesh((16, 16), ("data", "model"))


def _ref_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _port_specs(tree) -> dict:
    return {k: tuple(v) for k, v in tree_flatten_with_paths(
        tree, is_leaf=lambda s: isinstance(s, P)).items()}


def _meta_model(cfg, cut):
    with torch.device("meta"):
        return Model(cfg, build_groups(cfg, cut_layer=cut))


def _pair(name, full=False):
    cfg, ref = configs.ARCHS[name], ref_configs.ARCHS[name]
    return (cfg, ref) if full else (cfg.reduced(), ref.reduced())


@pytest.mark.parametrize("name", NAMES)
def test_param_pspecs_equal_the_reference(name):
    cfg, ref = _pair(name)
    cut = default_cut_layer(cfg, 0.25)
    ref_tree = jax.eval_shape(lambda: ref_model_init(
        ref, jax.random.PRNGKey(0), cut_layer=cut))
    model = _meta_model(cfg, cut)
    port_tree = model_to_reference(model, cfg)
    for tier in ("server", "client", "client_edp"):
        for tier_fn in (None, steps.tier_fn_for(cfg, cut, client_name=tier)):
            want = _ref_specs(ref_param_pspecs(
                ref_tree, REF_MESH, tier=tier,
                tier_fn=None if tier_fn is None else
                ref_steps.tier_fn_for(ref, cut, client_name=tier)))
            got = _port_specs(param_pspecs(port_tree, MESH, tier=tier,
                                           tier_fn=tier_fn))
            assert got == want, (tier, tier_fn)
            # the port's per-layer leaves: the same specs, stacked axes off
            per_layer = model_pspecs(model, MESH, tier=tier, tier_fn=tier_fn)
            for port_name, spec in per_layer.items():
                path, idx = reference_path(port_name)
                assert tuple(spec) == want["/".join(path)][len(idx):], \
                    port_name


def test_param_pspecs_rules_at_full_size():
    """The cases of ``tests/test_launch.py``, on the port's own trees."""
    cfg = configs.ARCHS["yi-9b"]
    specs = param_pspecs(model_to_reference(_meta_model(cfg, None), cfg),
                         MESH)
    assert specs["embed"]["table"] == P("model", "data")
    g0 = specs["groups"][0]
    assert g0["attn"]["wq"]["w"] == P(None, "data", "model")
    assert g0["attn"]["wo"]["w"] == P(None, "model", "data")
    assert g0["ffn"]["gate"]["w"] == P(None, "data", "model")
    assert g0["ffn"]["down"]["w"] == P(None, "model", "data")
    assert g0["ln1"]["scale"] == P()
    cut = default_cut_layer(cfg, 0.25)
    specs = param_pspecs(model_to_reference(_meta_model(cfg, cut), cfg),
                         MESH, tier_fn=steps.tier_fn_for(cfg, cut))
    for spec in tree_flatten_with_paths(
            specs["groups"][0], is_leaf=lambda s: isinstance(s, P)).values():
        assert "model" not in [a for a in spec if a]
    assert specs["groups"][1]["attn"]["wq"]["w"] == P(None, "data", "model")
    cfg = configs.ARCHS["whisper-tiny"]       # vocab padded to 51872
    specs = param_pspecs(model_to_reference(_meta_model(cfg, None), cfg),
                         MESH)
    assert specs["embed"]["table"] == P("model", "data")
    cfg = configs.ARCHS["deepseek-moe-16b"]
    specs = param_pspecs(model_to_reference(_meta_model(cfg, None), cfg),
                         MESH)
    assert specs["groups"][1]["moe"]["w_gate"] == P(None, "model", "data",
                                                    None)
    assert specs["groups"][1]["moe"]["w_down"] == P(None, "model", "data",
                                                    None)


def _ref_mesh_stub(shape, axes):
    """What the reference's spec helpers read of a mesh: its axis names and
    its devices array's shape."""
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _sds_tuple(x):
    return (tuple(x.shape), str(x.dtype).replace("torch.", ""))


@pytest.mark.parametrize("name", NAMES)
def test_shapes_windows_and_batch_and_state_specs_equal_the_reference(name):
    cfg, ref = _pair(name, full=True)
    for shape_name, shape in configs.INPUT_SHAPES.items():
        ref_shape = ref_configs.INPUT_SHAPES[shape_name]
        assert steps.effective_window(cfg, shape) == \
            ref_steps.effective_window(ref, ref_shape)
        assert steps.shape_supported(cfg, shape) == \
            ref_steps.shape_supported(ref, ref_shape)
        for labels in (False, True):
            got = {k: _sds_tuple(v) for k, v in steps.batch_sds(
                cfg, shape, with_labels=labels).items()}
            want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                    ref_steps.batch_sds(ref, ref_shape,
                                        with_labels=labels).items()}
            assert got == want
            for mesh_shape, axes in (((16, 16), ("data", "model")),
                                     ((2, 16, 16), ("pod", "data", "model")),
                                     ((3, 1), ("data", "model"))):
                got = {k: tuple(v) for k, v in steps.batch_pspecs(
                    cfg, shape, abstract_mesh(mesh_shape, axes),
                    with_labels=labels).items()}
                want = {k: tuple(v) for k, v in ref_steps.batch_pspecs(
                    ref, ref_shape, _ref_mesh_stub(mesh_shape, axes),
                    with_labels=labels).items()}
                assert got == want
    small, ref_small = _pair(name)
    cut = default_cut_layer(small, 0.25)
    for kv in ("param", "int8"):
        state = decode_state_init(small, 32, 64, cut_layer=cut, kv_dtype=kv,
                                  device="meta")
        ref_state = jax.eval_shape(lambda: ref_state_init(
            ref_small, 32, 64, cut_layer=cut, kv_dtype=kv))
        for mesh_shape in ((16, 16), (2, 4), (1, 1)):
            got = _port_specs(steps.state_pspecs(
                state, abstract_mesh(mesh_shape, ("data", "model"))))
            want = _ref_specs(ref_steps.state_pspecs(
                ref_state, _ref_mesh_stub(mesh_shape, ("data", "model"))))
            assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_built_step_meta_and_body_probes_equal_the_reference(name):
    cfg, ref = _pair(name)
    mesh, ref_mesh = abstract_mesh((1, 1), ("data", "model")), \
        make_host_mesh()
    for shape_name in configs.INPUT_SHAPES:
        shape = configs.INPUT_SHAPES[shape_name]
        if not steps.shape_supported(cfg, shape)[0]:
            with pytest.raises(ValueError, match="whisper"):
                steps.build_step(cfg, shape_name, mesh)
            continue
        built = steps.build_step(cfg, shape_name, mesh)
        want = ref_steps.build_step(ref, shape_name, ref_mesh)
        assert built.meta == want.meta and built.name == want.name
        probes = steps.build_body_probes(cfg, shape, mesh)
        ref_probes = ref_steps.build_body_probes(
            ref, ref_configs.INPUT_SHAPES[shape_name], ref_mesh)
        assert [(p.group_index, p.kind, p.count) for p in probes] == \
            [(p.group_index, p.kind, p.count) for p in ref_probes]
    opts = steps.PerfOptions(seq_parallel_server=True, kv_dtype="int8")
    ref_opts = ref_steps.PerfOptions(seq_parallel_server=True,
                                     kv_dtype="int8")
    assert opts.tiers == ref_opts.tiers == ("server",)
    built = steps.build_step(cfg, "decode_32k", mesh, opts=opts)
    want = ref_steps.build_step(ref, "decode_32k", ref_mesh, opts=ref_opts)
    assert built.meta == want.meta and built.name == want.name
    # no buffer donation in PyTorch: the dry run refuses the flag
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", name, "--shape", "decode_32k", "--donate"])


@pytest.mark.parametrize("name", ["rwkv6-7b", "smollm-135m",
                                  "deepseek-moe-16b"])
def test_built_train_step_is_the_trainers(name):
    """Loss and gradients of the built step (remat on) equal
    ``train_step``'s (remat off) before its clip, bit for bit on the CPU;
    the update is FunctionalAdamW's, no clip."""
    cfg = configs.ARCHS[name].reduced()
    shape = configs.InputShape("mini", 16, 2, "train")
    built = steps.build_train_step(cfg, shape,
                                   abstract_mesh((1, 1), ("data", "model")))
    cut = built.meta["cut_layer"]
    model = model_init(cfg, torch.Generator().manual_seed(0), cut_layer=cut)
    tokens = torch.randint(0, cfg.vocab, (2, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens}
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    assert {k: (tuple(v.shape), v.dtype) for k, v in params.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in built.args_sds[0].items()}
    state = OptState(step=torch.zeros((), dtype=torch.int32),
                     mu={k: torch.zeros_like(v, dtype=torch.float32)
                         for k, v in params.items()},
                     nu={k: torch.zeros_like(v, dtype=torch.float32)
                         for k, v in params.items()})
    grads = {}
    new_params, new_state, metrics = built.fn(params, state, batch,
                                              grads_out=grads)
    want = []
    loss, _, _ = train_step(cfg, model, AdamW(model.parameters(), 1e-4),
                            batch, cut_layer=cut, grads_out=want)
    assert torch.equal(metrics["loss"], loss)
    for (key, _), g in zip(model.named_parameters(), want):
        assert torch.equal(grads[key], g), key
    assert int(new_state.step) == 1
    assert not any(torch.equal(new_params[k], params[k]) for k in params)


@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-1.5-large-398b",
                                  "whisper-tiny"])
def test_remat_leaves_loss_and_gradients(name):
    cfg = configs.ARCHS[name].reduced()
    cut = default_cut_layer(cfg, 0.25)
    model = model_init(cfg, torch.Generator().manual_seed(0), cut_layer=cut)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=g)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.enc_dec:
        batch["frames"] = 0.02 * torch.randn(2, cfg.enc_seq_len, cfg.d_model,
                                             generator=g)
    out = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss, _ = lm_loss(cfg, model, batch, cut_layer=cut, remat=remat)
        loss.backward()
        out.append((loss.detach(), [p.grad.clone()
                                    for p in model.parameters()]))
    np.testing.assert_allclose(float(out[1][0]), float(out[0][0]), atol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   atol=1e-6)


def test_shard_act_is_the_identity_on_plain_tensors():
    x = torch.randn(2, 3, 4)
    assert shard_act(x, ("dp", None, None)) is x
    policy = ShardingPolicy(abstract_mesh((2, 16, 16),
                                          ("pod", "data", "model")))
    with set_policy(policy):
        assert shard_act(x, ("dp", "tp", None)) is x
    assert policy.resolve(("dp", "tp", "fsdp", None)) == \
        P(("pod", "data"), "model", "data", None)
    assert ShardingPolicy(MESH).resolve(("dp", None)) == P("data", None)


DRYRUN = textwrap.dedent("""
    import dataclasses, json, sys, tempfile
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import abstract_mesh, fake_mesh
    cfg = dataclasses.replace(ARCHS["smollm-135m"].reduced(), vocab=512,
                              d_model=256, d_ff=512)
    shape = InputShape("mini", 64, 8, "train")
    out = tempfile.mkdtemp()
    rec = dryrun.run_one("smollm-135m", shape, cfg=cfg, outdir=out,
                         mesh=fake_mesh((2, 4), ("data", "model")))
    # the same step on plain meta tensors, no mesh
    built = steps.build_train_step(
        cfg, shape, abstract_mesh((1, 1), ("data", "model")),
        attn_impl=dryrun.ATTN_IMPL)
    with FlopCounterMode(display=False) as flops:
        built.fn(*built.args_sds)
    # 3 heads over the 4 model ranks: DTensor refuses the uneven split of
    # the projections' outputs, which ReshardOnRefusal gathers
    uneven = dataclasses.replace(cfg, n_heads=3, n_kv_heads=1, head_dim=64)
    pre = InputShape("mini", 64, 8, "prefill")
    rec3 = dryrun.run_one("smollm-135m", pre, cfg=uneven, outdir=out,
                          tag="uneven", mesh=fake_mesh((2, 4),
                                                       ("data", "model")))
    built = steps.build_prefill_step(
        uneven, pre, abstract_mesh((1, 1), ("data", "model")),
        attn_impl=dryrun.ATTN_IMPL)
    with FlopCounterMode(display=False) as flops3:
        built.fn(*built.args_sds)
    skip = dryrun.run_one("whisper-tiny", "long_500k", outdir=out)
    # a MoE stack: its routing table and combine are scattered out of
    # place, which DTensor takes
    moe = ARCHS["deepseek-moe-16b"].reduced()
    rec_moe = dryrun.run_one("deepseek-moe-16b", pre, cfg=moe, outdir=out,
                             mesh=fake_mesh((2, 4), ("data", "model")))
    built = steps.build_prefill_step(
        moe, pre, abstract_mesh((1, 1), ("data", "model")),
        attn_impl=dryrun.ATTN_IMPL)
    with FlopCounterMode(display=False) as flops_moe:
        built.fn(*built.args_sds)
    print(json.dumps({"rec": rec, "plain": flops.get_total_flops(),
                      "rec3": rec3, "plain3": flops3.get_total_flops(),
                      "skip": skip, "moe": rec_moe,
                      "plain_moe": flops_moe.get_total_flops()}))
""")


def test_dryrun_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", DRYRUN], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    rec = got["rec"]
    assert rec["status"] == "ok", rec.get("error")
    assert {"arch", "shape", "mesh", "tag", "status", "meta", "trace_s",
            "flops_global", "flops_corrected", "collectives",
            "argument_bytes_rank0", "output_bytes_rank0", "fits",
            "bodies", "loops", "peak_bytes_rank0_estimate",
            "temp_bytes_rank0_estimate"} <= set(rec)
    assert rec["mesh"] == "2x4" and rec["meta"]["kind"] == "train"
    assert rec["flops_corrected"] == rec["flops_global"] > 0
    assert abs(rec["flops_global"] - got["plain"]) <= 0.01 * got["plain"]
    assert set(rec["collectives"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "total_bytes"}
    assert rec["collectives"]["total_bytes"] > 0
    assert [(b["kind"], b["count"]) for b in rec["bodies"]] == [
        ("attn", 1), ("attn", 1)]
    assert rec["fits"]["arguments_fit"]
    assert {"resharded", "collectives_resharded", "rules_added"} <= set(rec)
    rec3 = got["rec3"]
    assert rec3["status"] == "ok", rec3.get("error")
    assert rec3["flops_global"] == got["plain3"] > 0
    # the uneven split's views were retried on their gathered inputs, and
    # those gathers are counted apart from DTensor's own
    assert any(r.get("gather_changed") for r in rec3["resharded"].values())
    assert rec3["collectives_resharded"]["total_bytes"] > 0
    skip = got["skip"]
    ref_ok, ref_why = ref_steps.shape_supported(
        ref_configs.ARCHS["whisper-tiny"],
        ref_configs.INPUT_SHAPES["long_500k"])
    assert not ref_ok
    assert skip["status"] == "skipped" and skip["reason"] == ref_why
    moe = got["moe"]
    assert moe["status"] == "ok", moe.get("error")
    assert moe["flops_global"] == got["plain_moe"] > 0


LOOPS = textwrap.dedent("""
    import dataclasses, json, sys, tempfile, time
    import torch
    from repro_torch.checkpoint.ckpt import (tree_flatten_with_paths,
                                             tree_unflatten_like)
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import abstract_mesh, fake_mesh
    # one fake group for the 2x2, the 1x1 and the production meshes
    small = fake_mesh((2, 2), ("data", "model"), world=512)
    one = fake_mesh((1, 1), ("data", "model"))
    out = tempfile.mkdtemp()
    trace = dryrun._trace

    def run(arch, shape, cfg, mesh, scale):
        dryrun._trace = lambda fn, args: trace(fn, args, scale_loops=scale)
        try:
            return dryrun.run_one(arch, shape, cfg=cfg, outdir=out,
                                  mesh=mesh, tag=f"scaled{int(scale)}")
        finally:
            dryrun._trace = trace

    part = sys.argv[1]
    # the long recurrences at 32 tokens: scaled and unrolled
    loops = {}
    for arch, layers in (("rwkv6-7b", 2), ("jamba-1.5-large-398b", 8)):
        if part != "loops":
            break
        cfg = dataclasses.replace(ARCHS[arch].reduced(), n_layers=layers)
        for kind in ("train", "prefill"):
            shape = InputShape("mini", 32, 4, kind)
            loops[f"{arch} {kind}"] = [run(arch, shape, cfg, small, s)
                                       for s in (True, False)]
    # the bytes estimate of a prefill step: meta shards on a 1x1 mesh
    # (unrolled and scaled) and real CPU tensors
    est = {}
    for arch in ("smollm-135m", "rwkv6-7b", "jamba-1.5-large-398b"):
        if part != "est":
            break
        cfg = dataclasses.replace(ARCHS[arch].reduced(), vocab=512)
        if arch.startswith("jamba"):
            cfg = dataclasses.replace(cfg, n_layers=8)
        shape = InputShape("mini", 16, 2, "prefill")
        # unrolled, scaled, and unrolled again: the propagator's caches
        # are warm by the third trace, which must count the same bytes
        recs = [run(arch, shape, cfg, one, s) for s in (False, True, False)]
        built = steps.build_prefill_step(
            cfg, shape, abstract_mesh((1, 1), ("data", "model")),
            attn_impl=dryrun.ATTN_IMPL)
        g = torch.Generator().manual_seed(0)
        real = {k: ((0.02 * torch.randn(tuple(a.shape), generator=g))
                    if a.dtype.is_floating_point else
                    torch.randint(0, 8, tuple(a.shape), generator=g)
                    ).to(a.dtype)
                for k, a in tree_flatten_with_paths(built.args_sds).items()}
        estimate = dryrun.BytesEstimate()
        with estimate:
            built.fn(*tree_unflatten_like(built.args_sds, real))
        est[arch] = [r["temp_bytes_rank0_estimate"] for r in recs] + [
            estimate.peak]
    # rwkv6-7b x train_4k on the production mesh, 2 of its 32 layers
    full, t0 = None, time.time()
    if part == "est":
        full = dryrun.run_one(
            "rwkv6-7b", "train_4k", outdir=out, tag="2layers",
            cfg=dataclasses.replace(ARCHS["rwkv6-7b"], n_layers=2))
    print(json.dumps({"loops": loops, "est": est, "full": full,
                      "full_s": time.time() - t0}))
""")


@pytest.fixture(scope="module")
def scaled_loops():
    """The two halves of ``LOOPS``, each in a process of its own, side by
    side: the loops' comparisons, and the estimates with rwkv6-7b x
    train_4k."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", LOOPS, part], env=env,
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for part in ("loops", "est")]
    halves = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            halves.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    loops, est = halves
    return dict(est, loops=loops["loops"])


@pytest.mark.parametrize("case", ["rwkv6-7b train", "rwkv6-7b prefill",
                                  "jamba-1.5-large-398b train",
                                  "jamba-1.5-large-398b prefill"])
def test_scaled_loops_count_as_the_unrolled_loops(scaled_loops, case):
    """The WKV scan and Mamba's scan (in the train step their backward
    loops too), traced one settled step and
    scaled, count the FLOPs and collective bytes of the same trace with
    every step unrolled, at 32 tokens on a 2x2 fake mesh; the record's
    ``loops`` name each site."""
    scaled, unrolled = scaled_loops["loops"][case]
    assert scaled["status"] == unrolled["status"] == "ok", (
        scaled.get("error"), unrolled.get("error"))
    assert scaled["flops_global"] == unrolled["flops_global"] > 0
    for key in ("collectives", "collectives_resharded"):
        assert scaled[key] == unrolled[key], key
    assert unrolled["loops"] == []
    sites = {r["site"] for r in scaled["loops"]}
    want = ({"rwkv6_scan_ref"} if case.startswith("rwkv")
            else {"mamba_inner"})
    if case == "rwkv6-7b train":
        want.add("rwkv6_scan_bwd_ref")
    elif case.endswith("train"):
        want.add("mamba_inner_bwd")
    assert sites == want
    assert all(r["steps"] in (32, 2) and r["calls"] > 0
               for r in scaled["loops"])


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-7b",
                                  "jamba-1.5-large-398b"])
def test_bytes_estimate_of_meta_shards_is_the_cpu_tensors(scaled_loops,
                                                          arch):
    """The per-rank bytes estimate of a prefill step on meta shards of a
    1x1 fake mesh equals the estimate of the same step run on real CPU
    tensors, byte for byte, with the loops unrolled; scaled, within 5%
    (a scaled loop's traced steps and its repeats live at other times than
    the plain loop's list). A second unrolled trace in the same process,
    on DTensor's warm sharding caches, counts the same bytes: the
    propagation's own tensors are left out on a cache miss."""
    unrolled, scaled, again, cpu = scaled_loops["est"][arch]
    assert unrolled == cpu > 0
    assert again == unrolled
    assert abs(scaled - unrolled) <= 0.05 * unrolled


def test_rwkv_train_4k_ends_ok_with_its_loops(scaled_loops):
    """rwkv6-7b x train_4k on the 16x16 fake mesh, cut to 2 of its 32
    layers: ``ok`` in seconds, its WKV forward scaled over 4,096 steps (a
    layer's forward, and again in the backward's remat) and its backward
    over 256 segments of 16, each record carrying the per-rank bytes
    estimate and its verdict."""
    full = scaled_loops["full"]
    assert full["status"] == "ok", full.get("error")
    assert scaled_loops["full_s"] < 120
    loops = {(r["site"], r["steps"]): r for r in full["loops"]}
    assert set(loops) == {("rwkv6_scan_ref", 4096),
                          ("rwkv6_scan_bwd_ref", 256)}
    assert loops[("rwkv6_scan_ref", 4096)]["flops_step"] > 0
    peak = full["peak_bytes_rank0_estimate"]
    assert peak == (full["argument_bytes_rank0"]
                    + full["temp_bytes_rank0_estimate"])
    assert full["temp_bytes_rank0_estimate"] > 0
    assert full["fits"]["peak_fits_estimate"] == (
        peak <= full["fits"]["card_bytes"])


@pytest.mark.parametrize("case", ["skipped", "timeout"])
def test_dryrun_sweep_runs_each_combination_in_its_own_process(tmp_path,
                                                               case):
    """More than one combination (here both meshes) is a sweep: each in a
    process of its own, its output kept beside its record, then the
    status table. A skipped shape ends the sweep 0 with its records; a
    process past ``--timeout`` is killed, its row ``not done``, and the
    sweep exits 1."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    arch, shape, more = (("whisper-tiny", "long_500k", []) if case ==
                         "skipped" else ("smollm-135m", "decode_32k",
                                         ["--timeout", "0.5"]))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--both-meshes", "--outdir", str(tmp_path),
         "--jobs", "2", *more], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    rows = [ln for ln in out.stdout.splitlines()
            if ln.startswith(f"| {arch} |")]
    assert [ln.split(" | ")[2] for ln in rows] == ["pod16x16", "pod2x16x16"]
    logs = sorted(p.name for p in tmp_path.glob("*.log"))
    assert logs == [f"{arch}__{shape}__pod16x16.log",
                    f"{arch}__{shape}__pod2x16x16.log"]
    if case == "skipped":
        assert out.returncode == 0, out.stderr[-3000:]
        assert all(ln.split(" | ")[3].startswith("skipped: ") for ln in rows)
        assert len(list(tmp_path.glob("*.json"))) == 2
        assert "done ok=0 err=0 skip=2 not_done=0" in out.stdout
    else:
        assert out.returncode == 1
        assert all(ln.split(" | ")[3].startswith("not done") for ln in rows)
        assert "not_done=2" in out.stdout


NO_RULE = textwrap.dedent("""
    import dataclasses, json, sys, tempfile
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    # a torch with no sharding rule for the group norm (as 2.11 has none)
    prop = DTensor._op_dispatcher.sharding_propagator
    for table in ("op_to_rules", "op_strategy_funcs",
                  "op_single_dim_strategy_funcs"):
        getattr(prop, table, {}).pop(torch.ops.aten.native_group_norm.default,
                                     None)
    cfg = dataclasses.replace(ARCHS["rwkv6-7b"].reduced(), vocab=512)
    shape = InputShape("mini", 32, 4, "decode")
    mesh = fake_mesh((2, 2), ("data", "model"))
    out = tempfile.mkdtemp()
    # without the rule the dry run adds: the combination is an error
    may_lack = dryrun._MAY_LACK_A_RULE
    dryrun._MAY_LACK_A_RULE = ()
    err = dryrun.run_one("rwkv6-7b", shape, cfg=cfg, outdir=out, mesh=mesh,
                         tag="norule")
    dryrun._MAY_LACK_A_RULE = may_lack
    ok = dryrun.run_one("rwkv6-7b", shape, cfg=cfg, outdir=out, mesh=mesh)
    print(json.dumps({"err": err, "ok": ok}))
""")


def test_dryrun_records_an_op_without_a_rule():
    """An op DTensor has no rule for ends the combination ``error``; the
    group norm, which some torch versions give none, runs on the
    replicating rule the dry run adds, and the record names and counts
    it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", NO_RULE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    err, ok = got["err"], got["ok"]
    assert err["status"] == "error"
    assert "native_group_norm" in err["error"], err["error"]
    assert ok["status"] == "ok", ok.get("error")
    assert "aten.native_group_norm.default" in ok["rules_added"]
    assert ok["resharded"]["aten.native_group_norm.default"][
        "rule_added"] > 0


MULTI_POD = textwrap.dedent("""
    import dataclasses, json, tempfile
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    # SmolLM-135M at its published widths, 2 of its 30 layers, on both
    # production meshes (one 512-rank fake group for the two)
    cfg = dataclasses.replace(ARCHS["smollm-135m"], n_layers=2)
    out = tempfile.mkdtemp()
    recs = [dryrun.run_one("smollm-135m", "decode_32k", cfg=cfg, outdir=out,
                           multi_pod=mp) for mp in (False, True)]
    print(json.dumps(recs))
""")


def test_dryrun_multi_pod_ends_with_the_single_pod_invariants():
    """SmolLM-135M x decode_32k, cut to 2 layers, ends ``ok`` on the
    2x16x16 mesh as on the 16x16 one: the step's arithmetic does not
    depend on the mesh (equal global FLOPs), and rank 0 holds no more
    argument bytes on the larger mesh. There the heads' merge with the
    batch is a strided view, which the dry run gathers apart; left
    strided, the decode step's next matmul alone took minutes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", MULTI_POD], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    one, two = json.loads(out.stdout.strip().splitlines()[-1])
    assert (one["mesh"], two["mesh"]) == ("pod16x16", "pod2x16x16")
    assert one["status"] == two["status"] == "ok", (one.get("error"),
                                                    two.get("error"))
    assert two["flops_global"] == one["flops_global"] > 0
    assert two["argument_bytes_rank0"] <= one["argument_bytes_rank0"]
    assert not any(r.get("gather_strided") for r in one["resharded"].values())
    assert any(r.get("gather_strided") for r in two["resharded"].values())


STRIDED_VIEW = textwrap.dedent("""
    import json
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor._redistribute import \\
        DTensorRedistributePlanner
    from torch.distributed.tensor.placement_types import _StridedShard
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    mesh = fake_mesh((2, 2, 2), ("pod", "data", "model"))

    def dt(shape, placements):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                 placements)

    # (batch 4, heads 2, 3), heads split over 'pod' and batch over
    # 'data', merged as a batched matmul merges them
    x = dt((4, 2, 3), [Shard(1), Shard(0), Replicate()])
    strided = x.view(8, 3)
    # batch 2 over 'pod', one row a rank, heads over 'data': a split
    # factor of 1
    one = dt((2, 2, 3), [Shard(0), Shard(1), Replicate()])
    strided_one = one.view(4, 3)
    counter = dryrun.CollectiveCounter()
    reshard = dryrun.ReshardOnRefusal(counter)
    with counter, reshard:
        y = x.view(8, 3)
        # the batch outer on both axes: a plain merge, let through
        outer = dt((4, 2, 3), [Shard(0), Shard(0), Replicate()]).view(8, 3)
    gathered = counter.record_added()
    with counter, reshard:
        y_one = one.view(4, 3)
        # on two mesh dims DTensor's layout is kept
        flat = distribute_tensor(
            torch.empty((4, 2, 3), device="meta"),
            fake_mesh((2, 2), ("data", "model")), [Shard(1), Shard(0)])
        kept = flat.view(8, 3)

    searches = []

    def search(self, *args, **kwargs):
        searches.append(1)
        raise RuntimeError("searched")

    # a graph-based planner's search is noted and fails the op that prices
    # with it
    DTensorRedistributePlanner.generate_graph_based_transform_infos = search
    w = dt((3, 5), [Replicate()] * 3)
    searched = []
    for v in (strided, y):
        searches.clear()
        try:
            torch.mm(v, w)
        except RuntimeError:
            pass
        searched.append(bool(searches))
    print(json.dumps({
        "strided": [isinstance(p, _StridedShard) for p in strided.placements],
        "y": [str(p) for p in y.placements], "shape": list(y.shape),
        "local": list(y.to_local().shape),
        "outer": [str(p) for p in outer.placements],
        "one": [str(p) for p in strided_one.placements],
        "y_one": [str(p) for p in y_one.placements],
        "kept": [str(p) for p in kept.placements],
        "locals_one": [list(strided_one.to_local().shape),
                       list(y_one.to_local().shape)],
        "retries": reshard.retries, "gathered": gathered,
        "added": counter.record_added(), "ops": counter.record(),
        "searched": searched}))
""")


def _local_shard(t, placements, sizes, coord):
    """Rank ``coord``'s shard of ``t``, the placements applied left to
    right, as DTensor lays a tensor out."""
    for size, at, p in zip(sizes, coord, placements):
        t = p._split_tensor(t, size, with_padding=False)[0][at]
    return t


def test_a_strided_view_is_gathered_apart():
    """On a 2x2x2 fake mesh, a view merging batch (split over 'data') with
    heads (split over 'pod') comes out of DTensor with a ``_StridedShard``
    on 'pod' of split factor 4; under ``ReshardOnRefusal`` it runs again
    on its input with the 'pod' shard gathered: the merged dim split over
    'data' alone, the gather counted apart (``gather_strided``, one
    all-gather of rank 0's gathered shard, 2 x 2 x 3 f32), DTensor's own
    collectives none. The next matmul prices the strided layout with the
    graph-based planner's search, and the plain one without it. A merge
    whose outer dim holds every shard is let through, and one whose
    strided split has a split factor of 1 (the batch one row a rank) is
    named a ``Shard``, which lays it out alike on every rank, and moves
    nothing (``strided_as_shard``). On a 2x2 mesh the strided view is
    kept as DTensor made it."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", STRIDED_VIEW], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["strided"] == [True, False, False]
    assert got["y"] == ["R", "S(0)", "R"]
    assert (got["shape"], got["local"]) == ([8, 3], [4, 3])
    assert got["outer"] == ["S(0)", "S(0)", "R"]
    assert got["retries"] == {"aten.view.default": {
        "gather_strided": 1, "strided_as_shard": 1}}
    assert got["gathered"]["all-gather"] == {"count": 1,
                                             "bytes": 2 * 2 * 3 * 4}
    assert got["added"]["total_bytes"] == 48
    assert got["ops"]["total_bytes"] == 0
    assert got["searched"] == [True, False]
    assert got["one"] == ["S(0)", "_S(0, 1)", "R"]
    assert got["y_one"] == ["S(0)", "S(0)", "R"]
    assert got["locals_one"] == [[1, 3], [1, 3]]
    assert got["kept"] == ["_S(0, 4)", "S(0)"]
    t = torch.arange(4 * 3).reshape(4, 3)
    for sf, same in ((1, True), (2, False)):
        strided = [Shard(0), _StridedShard(0, split_factor=sf), Shard(1)]
        plain = [Shard(0), Shard(0), Shard(1)]
        assert same == all(
            torch.equal(_local_shard(t, strided, (2, 2, 2), c),
                        _local_shard(t, plain, (2, 2, 2), c))
            for c in np.ndindex(2, 2, 2))
