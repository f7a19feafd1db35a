"""Checkpoints, the model's way back to the reference's tree, the trainer's
``--ckpt`` and the learning-rate schedules, held against
the reference (``repro.checkpoint``, ``repro.optim``).

- the same tree saved by both packages gives the same bytes, and each
  package restores the other's file (bf16 included);
- ``convert.model_to_reference`` inverts ``model_from_reference`` on the
  reference's ``model_init`` tree of three families;
- a CPU ``train(..., ckpt=)`` file read by the reference into its
  ``model_init`` tree gives its ``model_forward`` the port's logits;
- the schedules equal the reference's step by step (f32 cos: 1e-6
  relative), and a scheduled ``AdamW``/``FunctionalAdamW`` the
  reference's ``adamw(schedule)`` over 3 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.checkpoint.ckpt import restore_checkpoint as ref_restore
from repro.checkpoint.ckpt import save_checkpoint as ref_save
from repro.models.transformer import model_forward as ref_model_forward
from repro.models.transformer import model_init as ref_model_init
from repro.optim import adamw as ref_adamw
from repro.optim import apply_updates as ref_apply_updates
from repro.optim.optimizers import constant_schedule as ref_constant
from repro.optim.optimizers import cosine_schedule as ref_cosine
from repro.optim.optimizers import warmup_cosine as ref_warmup_cosine
import repro_torch.configs as configs
from repro_torch.checkpoint import (checkpoint_meta, restore_checkpoint,
                                    save_checkpoint, tree_flatten_with_paths)
from repro_torch.checkpoint import msgpack as port_msgpack
from repro_torch.checkpoint.ckpt import Stacked
from repro_torch.convert import model_from_reference, model_to_reference
from repro_torch.core.energy import RTX_A5000
from repro_torch.launch.train import train
from repro_torch.models.transformer import (Model, build_groups,
                                            default_cut_layer, model_forward)
from repro_torch.optim import (AdamW, FunctionalAdamW, OptState, adamw,
                               constant_schedule, cosine_schedule,
                               warmup_cosine)
from test_torch_harness import drawn_model_params

TOL = 1e-4      # the trainer tests' (test_torch_lm_train.py)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((3, 4)).astype(np.float32),
        "bf": rng.standard_normal((2, 5)).astype(ml_dtypes.bfloat16),
        "layers": [
            {"codes": rng.integers(-127, 128, (7,)).astype(np.int8),
             "count": np.asarray(5, np.int32)},
            {"ids": np.arange(6, dtype=np.int32).reshape(2, 3),
             "nested": {"z": rng.standard_normal((1, 2, 3)).astype(
                 np.float32)}},
        ],
        "scalar": np.asarray(2.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    """A leaf (torch or numpy, bf16 included) as comparable numpy bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


META = {"arch": "tiny", "steps": 3, "loss": 1.25, "tags": ["a", 7],
        "none": None, "ok": True}


def test_codec_matches_msgpack_headers():
    for v in (None, True, 0, 127, 128, 2 ** 16, 2 ** 32, 2 ** 63, -1, -33,
              -2 ** 15 - 1, -2 ** 63, 0.1, "", "x" * 31, "x" * 32,
              "é" * 200, b"", b"y" * 256, b"y" * 70_000, list(range(16)),
              {str(i): i for i in range(16)}, META):
        assert port_msgpack.packb(v) == msgpack.packb(v, use_bin_type=True)


@pytest.mark.parametrize("as_torch", [False, True])
def test_checkpoint_bytes_equal_the_reference(tmp_path, as_torch):
    tree = _tree()
    ref_save(str(tmp_path / "ref.msgpack"), tree, meta=META)
    port_tree = jax.tree_util.tree_map(_to_torch, tree) if as_torch else tree
    save_checkpoint(str(tmp_path / "port.msgpack"), port_tree, meta=META)
    ref_bytes = (tmp_path / "ref.msgpack").read_bytes()
    assert (tmp_path / "port.msgpack").read_bytes() == ref_bytes
    assert not (tmp_path / "port.msgpack.tmp").exists()
    assert checkpoint_meta(str(tmp_path / "ref.msgpack")) == META
    assert list(tree_flatten_with_paths(tree)) == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_each_package_restores_the_others_file(tmp_path):
    tree = _tree(1)
    ref_path, port_path = str(tmp_path / "r.msgpack"), str(tmp_path / "p")
    ref_save(ref_path, tree, meta=META)
    save_checkpoint(port_path, jax.tree_util.tree_map(_to_torch, tree))
    got = restore_checkpoint(ref_path, tree)
    back = ref_restore(port_path, tree)
    for key, want in tree_flatten_with_paths(tree).items():
        for have in (tree_flatten_with_paths(got)[key],
                     np.asarray(tree_flatten_with_paths(back)[key])):
            np.testing.assert_array_equal(_bits(have), _bits(want),
                                          err_msg=key)
    assert got["bf"].dtype == torch.bfloat16 and got["w"].device.type == "cpu"
    assert isinstance(got["layers"], list) and got["scalar"].shape == ()
    # a meta `like` gives the shapes; `shardings` places each leaf
    like = jax.tree_util.tree_map(
        lambda a: torch.empty(np.shape(a), device="meta"), tree)
    placed = restore_checkpoint(ref_path, like, shardings=jax.tree_util.
                                tree_map(lambda a: torch.device("cpu"), tree))
    assert placed["w"].device.type == "cpu"


def test_missing_leaf_and_shape_errors_match_the_reference(tmp_path):
    path = str(tmp_path / "c.msgpack")
    save_checkpoint(path, {"a": np.zeros(3, np.float32)})
    for like, err in (({"a": np.zeros(3), "b": np.zeros(1)}, KeyError),
                      ({"a": np.zeros(4)}, ValueError)):
        with pytest.raises(err) as ref_e:
            ref_restore(path, like)
        with pytest.raises(err) as port_e:
            restore_checkpoint(path, like)
        assert str(port_e.value) == str(ref_e.value)


def test_a_stacked_leaf_is_written_as_its_stack(tmp_path):
    """A ``Stacked`` leaf (nested rows, bf16) writes the bytes of the
    stacked tensor; rows of another shape are refused."""
    rng = np.random.default_rng(3)
    rows = [[torch.from_numpy(rng.standard_normal((2, 3)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2)] for _ in range(3)]
    lazy = {"w": Stacked([Stacked(r) for r in rows]), "b": torch.arange(4)}
    whole = {"w": torch.stack([torch.stack(r) for r in rows]),
             "b": torch.arange(4)}
    save_checkpoint(str(tmp_path / "lazy"), lazy, meta={"n": 1})
    save_checkpoint(str(tmp_path / "whole"), whole, meta={"n": 1})
    assert (tmp_path / "lazy").read_bytes() == (tmp_path / "whole").read_bytes()
    assert lazy["w"].shape == whole["w"].shape
    assert torch.equal(lazy["w"].stack(), whole["w"])
    with pytest.raises(ValueError, match="rows differ"):
        Stacked([torch.zeros(2), torch.zeros(3)])


@pytest.mark.parametrize("name", ["smollm-135m", "rwkv6-7b",
                                  "deepseek-moe-16b"])
def test_model_to_reference_inverts_model_from_reference(name):
    ref = ref_configs.ARCHS[name].reduced()
    cfg = configs.ARCHS[name].reduced()
    cut = default_cut_layer(cfg, 0.5)
    params = drawn_model_params(ref, cut)
    tree = model_to_reference(model_from_reference(params, cfg, cut), cfg)
    want = tree_flatten_with_paths(params)
    # the stacked leaves come as their rows, stacked only here
    have = {k: v.stack() if isinstance(v, Stacked) else v
            for k, v in tree_flatten_with_paths(tree).items()}
    assert all(isinstance(v, Stacked) for v in tree_flatten_with_paths(
        tree["groups"]).values())
    assert list(have) == list(want)
    for key, a in want.items():
        np.testing.assert_array_equal(_bits(have[key]), _bits(a),
                                      err_msg=key)
    # a meta model gives the `like` tree: shapes and dtypes, no weights
    with torch.device("meta"):
        meta = Model(cfg, build_groups(cfg, cut_layer=cut))
    like = tree_flatten_with_paths(model_to_reference(meta, cfg))
    assert {k: (tuple(v.shape), v.is_meta) for k, v in like.items()} == {
        k: (tuple(np.shape(a)), True) for k, a in want.items()}


def test_trainer_checkpoint_reads_into_the_reference(tmp_path):
    cfg = configs.smollm_135m.reduced()
    ref = ref_configs.smollm_135m.reduced()
    path = str(tmp_path / "trained.msgpack")
    trained = []
    losses = train(cfg, steps=2, batch=2, seq=16, lr=3e-3, log_every=1,
                   device="cpu", hardware=RTX_A5000, ckpt=path,
                   generator=torch.Generator().manual_seed(0),
                   model_out=trained)
    assert checkpoint_meta(path) == {"arch": cfg.name, "steps": 2,
                                     "loss": losses[-1]}
    cut = default_cut_layer(cfg, 0.15)
    like = jax.eval_shape(lambda: ref_model_init(
        ref, jax.random.PRNGKey(0), cut_layer=cut))
    ref_params = ref_restore(path, like)
    # the reference writes the same tree and meta to the same bytes
    ref_save(str(tmp_path / "again.msgpack"), ref_params,
             meta=checkpoint_meta(path))
    assert (tmp_path / "again.msgpack").read_bytes() == open(
        path, "rb").read()
    tokens = np.random.RandomState(3).randint(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    want, _ = ref_model_forward(ref, ref_params, {"tokens": tokens},
                                cut_layer=cut)
    with torch.device("meta"):
        skeleton = Model(cfg, build_groups(cfg, cut_layer=cut))
    restored = restore_checkpoint(path, model_to_reference(skeleton, cfg))
    model = model_from_reference(restored, cfg, cut)
    with torch.no_grad():
        got, _ = model_forward(cfg, model, {"tokens": torch.from_numpy(
            tokens)}, cut_layer=cut)
        again, _ = model_forward(cfg, trained[0], {"tokens": torch.from_numpy(
            tokens)}, cut_layer=cut)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # the port's restore gives the trained model back, bit for bit
    assert torch.equal(got, again)
    for key, t in trained[0].state_dict().items():
        assert torch.equal(model.state_dict()[key], t), key


SCHEDULES = [
    (lambda: ref_constant(3e-4), lambda: constant_schedule(3e-4)),
    (lambda: ref_cosine(1e-3, 10), lambda: cosine_schedule(1e-3, 10)),
    (lambda: ref_cosine(1e-3, 10, floor=1e-5),
     lambda: cosine_schedule(1e-3, 10, floor=1e-5)),
    (lambda: ref_warmup_cosine(2e-3, 4, 12),
     lambda: warmup_cosine(2e-3, 4, 12)),
    (lambda: ref_warmup_cosine(2e-3, 4, 12, floor=1e-4),
     lambda: warmup_cosine(2e-3, 4, 12, floor=1e-4)),
]


@pytest.mark.parametrize("pair", range(len(SCHEDULES)))
def test_schedules_equal_the_reference(pair):
    ref_fn, port_fn = (f() for f in SCHEDULES[pair])
    steps = np.arange(0, 16, dtype=np.int32)    # across warmup and the end
    want = np.asarray([ref_fn(jnp.asarray(s)) for s in steps])
    got = port_fn(torch.from_numpy(steps.astype(np.float32)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_as_schedule_keeps_a_schedule_and_wraps_a_float():
    """The reference's optimizers take ``_as_schedule(lr)``: a schedule as
    it is, a float as a constant. The port's take a schedule as it is and
    keep a float as a scalar made once on the device, with the values of
    the reference's constant and the bits of ``constant_schedule`` of it."""
    from repro.optim.optimizers import _as_schedule as ref_as_schedule
    sched = warmup_cosine(1e-3, 2, 5)
    assert FunctionalAdamW(sched).lr is sched
    assert adamw(sched)([torch.nn.Parameter(torch.zeros(2))]) \
        .param_groups[0]["lr"] is sched
    step = np.arange(4, dtype=np.int32)
    got = constant_schedule(3e-4)(torch.from_numpy(step.astype(np.float32)))
    want = np.asarray([ref_as_schedule(3e-4)(jnp.asarray(s)) for s in step])
    np.testing.assert_array_equal(got.numpy(), want)
    # a client-stacked state: a float and its constant schedule, same bits
    params, grads = _opt_case(7)
    outs = []
    for lr in (3e-4, constant_schedule(3e-4)):
        opt = FunctionalAdamW(lr, weight_decay=0.01)
        tp = {k: torch.from_numpy(np.stack([v, 2 * v])) for k, v in
              params.items()}
        st = opt.init_stacked({k: torch.from_numpy(v) for k, v in
                               params.items()}, 2)
        for g in grads:
            tp, st = opt.update({k: torch.from_numpy(np.stack([v, -v]))
                                 for k, v in g.items()}, st, tp)
        outs.append(tp)
    for k in params:
        assert torch.equal(outs[0][k], outs[1][k]), k


def _opt_case(seed=5):
    rng = np.random.RandomState(seed)
    shapes = {"a": (8, 16), "b": (16,), "c": (3, 4, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("functional", [False, True])
def test_scheduled_adamw_matches_the_reference(functional):
    params, grads = _opt_case()
    sched, ref_sched = warmup_cosine(1e-2, 2, 6), ref_warmup_cosine(1e-2, 2, 6)
    ref_opt = ref_adamw(ref_sched, weight_decay=0.01)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rst = ref_opt.init(rp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    if functional:
        opt = FunctionalAdamW(sched, weight_decay=0.01)
        st = opt.init(tp)
    else:
        leaves = {k: torch.nn.Parameter(v) for k, v in tp.items()}
        opt = AdamW(leaves.values(), sched, weight_decay=0.01)
    for g in grads:
        up, rst = ref_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 rst, rp)
        rp = ref_apply_updates(rp, up)
        if functional:
            tp, st = opt.update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, st, tp)
        else:
            for k, p in leaves.items():
                p.grad = torch.from_numpy(g[k])
            opt.step()
            tp = {k: p.detach() for k, p in leaves.items()}
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    if functional:
        assert int(st.step) == 3 and isinstance(st, OptState)


def test_a_float_lr_takes_the_former_path():
    """A float lr keeps the made-once device scalar (bit for bit the former
    step); ``constant_schedule`` of it gives the same bits."""
    params, grads = _opt_case(6)
    outs = []
    for lr in (1e-2, constant_schedule(1e-2)):
        leaves = [torch.nn.Parameter(torch.from_numpy(v.copy()))
                  for v in params.values()]
        opt = AdamW(leaves, lr, weight_decay=0.01)
        for g in grads:
            for p, v in zip(leaves, g.values()):
                p.grad = torch.from_numpy(v)
            opt.step()
        outs.append([p.detach().clone() for p in leaves])
        assert ("lr" in next(iter(opt._scalars.values()))) == (
            not callable(lr))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_model_to_reference_refuses_another_config():
    cfg = configs.smollm_135m.reduced()
    with torch.device("meta"):
        model = Model(cfg, build_groups(cfg))
    with pytest.raises(ValueError, match="groups"):
        model_to_reference(model, dataclasses.replace(
            cfg, n_layers=cfg.n_layers + 1))
