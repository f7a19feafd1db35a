"""The ``fedavg_pmean`` family of the port (``repro_torch/core/fedavg.py``)
against the reference's own functions (``repro/core/fedavg.py:96-158``).

The reference's functions run inside a ``shard_map`` body over the mesh's
``data`` axis; here they run under ``jax.vmap(fn, axis_name="data")`` over a
leading rank axis, where ``lax.pmean``/``lax.psum`` reduce over that axis.
The port's run on R gloo ranks spawned by ``launch.mesh.run_ranks``
(``torch_rank_cases.pmean_cases``), each on its own rows of the same
seeded numpy stack. Masks include a fleet with every client masked and a
rank with no active row. Tolerance 1e-6. The 4-rank cases run in
``test_torch_shard_map.py``'s one 4-rank spawn, checked by
``check_pmean_case`` below. In-process: the single-rank mesh (no group)
and a leading seed axis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_cases
from repro.core.fedavg import (fedavg_mean, fedavg_mean_masked,
                               fedavg_pmean as ref_pmean,
                               fedavg_pmean_masked as ref_pmean_masked,
                               fedavg_pmean_stack as ref_pmean_stack,
                               fedavg_pmean_stack_masked as ref_pmean_stack_masked,
                               fedavg_stack, fedavg_stack_masked)
from repro_torch.core.fedavg import (fedavg_pmean, fedavg_pmean_masked,
                                     fedavg_pmean_stack,
                                     fedavg_pmean_stack_masked)
from repro_torch.launch.mesh import run_ranks

ATOL = 1e-6


def pmean_inputs(n: int, seed: int = 0) -> dict:
    """The cases over ``n`` clients: no mask, a mask, the first half of the
    fleet masked (a rank with no active row when the ranks hold halves or
    less), every client masked."""
    rng = np.random.RandomState(seed)
    x = {"w": rng.standard_normal((n, 4, 3)).astype(np.float32),
         "b": (rng.standard_normal((n, 5)) * 10).astype(np.float32)}
    fallback = {k: v[0] * 3.0 for k, v in x.items()}
    masks = {"plain": None,
             "mask": (np.arange(n) % 3 != 1).astype(np.float32),
             "idle-rank": (np.arange(n) >= n // 2).astype(np.float32),
             "all-masked": np.zeros(n, np.float32)}
    return {name: {"x": x, "mask": m, "fallback": fallback}
            for name, m in masks.items()}


def reference_pmean(case: dict, ranks: int) -> dict:
    """The reference's four functions on ``ranks`` shards of the stack,
    under ``jax.vmap(..., axis_name="data")``: the dropped-axis means (one
    a rank) and the stacked results back in (n, ...) rows."""
    x = {k: jnp.asarray(v.reshape((ranks, -1) + v.shape[1:]))
         for k, v in case["x"].items()}

    def rows(tree):
        return {k: np.asarray(v).reshape((-1,) + v.shape[2:])
                for k, v in tree.items()}

    out = {"pmean": jax.vmap(lambda a: ref_pmean(a, "data"),
                             axis_name="data")(x),
           "pmean_stack": rows(jax.vmap(lambda a: ref_pmean_stack(a, "data"),
                                        axis_name="data")(x))}
    if case["mask"] is not None:
        m = jnp.asarray(case["mask"].reshape(ranks, -1))
        fb = case["fallback"]
        out["pmean_masked"] = jax.vmap(
            lambda a, w: ref_pmean_masked(a, w, fb, "data"),
            axis_name="data")(x, m)
        out["pmean_stack_masked"] = rows(jax.vmap(
            lambda a, w: ref_pmean_stack_masked(a, w, "data"),
            axis_name="data")(x, m))
    return out


def check_pmean_case(got: dict, case: dict, ranks: int):
    """The port's results of one case (``pmean_cases``) within ``ATOL`` of
    the reference's; the dropped-axis means equal on every rank."""
    want = reference_pmean(case, ranks)
    assert set(got) == set(want)
    for fn, w in want.items():
        for k in case["x"]:
            if fn.startswith("pmean_stack"):
                np.testing.assert_allclose(got[fn][k], w[k], atol=ATOL,
                                           rtol=0, err_msg=f"{fn} {k}")
            else:
                assert len(got[fn]) == ranks
                for r in range(ranks):
                    np.testing.assert_allclose(
                        got[fn][r][k], np.asarray(w[k][r]), atol=ATOL, rtol=0,
                        err_msg=f"{fn} {k} rank {r}")
                    np.testing.assert_array_equal(got[fn][r][k],
                                                  got[fn][0][k])
    if case["mask"] is not None and not case["mask"].any():
        # an all-masked fleet keeps the fallback and its stale rows
        for k, v in case["x"].items():
            np.testing.assert_array_equal(got["pmean_stack_masked"][k], v)
            np.testing.assert_array_equal(got["pmean_masked"][0][k],
                                          case["fallback"][k])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(torch_rank_cases.pmean_cases, 2,
                     str(tmp_path_factory.mktemp("pmean")),
                     args=(pmean_inputs(4),))


@pytest.mark.parametrize("case", ["plain", "mask", "idle-rank",
                                  "all-masked"])
def test_pmean_family_matches_reference_on_two_ranks(two_ranks, case):
    check_pmean_case(two_ranks[case], pmean_inputs(4)[case], 2)


@pytest.mark.parametrize("case", ["plain", "mask", "idle-rank",
                                  "all-masked"])
def test_single_rank_mesh_is_the_host_fedavg(case):
    """``group=None`` (the single-rank mesh): each collective is the
    identity, and the four functions are the reference's host forms (and
    its pmean forms over one rank)."""
    c = pmean_inputs(6, seed=1)[case]
    x = {k: torch.from_numpy(v) for k, v in c["x"].items()}
    got = {"pmean": fedavg_pmean(x, None),
           "pmean_stack": fedavg_pmean_stack(x, None)}
    want = {"pmean": fedavg_mean(c["x"]), "pmean_stack": fedavg_stack(c["x"])}
    if c["mask"] is not None:
        m = torch.from_numpy(c["mask"])
        fb = {k: torch.from_numpy(v) for k, v in c["fallback"].items()}
        got["pmean_masked"] = fedavg_pmean_masked(x, m, fb, None)
        got["pmean_stack_masked"] = fedavg_pmean_stack_masked(x, m, None)
        want["pmean_masked"] = fedavg_mean_masked(c["x"], c["mask"],
                                                  c["fallback"])
        want["pmean_stack_masked"] = fedavg_stack_masked(c["x"], c["mask"])
    one_rank = reference_pmean(c, 1)
    for fn in want:
        for k in x:
            np.testing.assert_allclose(got[fn][k].numpy(),
                                       np.asarray(want[fn][k]), atol=ATOL,
                                       rtol=0)
            w1 = np.asarray(one_rank[fn][k])
            np.testing.assert_allclose(
                got[fn][k].numpy(), w1 if fn.startswith("pmean_stack")
                else w1[0], atol=ATOL, rtol=0)


def test_seed_axis_is_one_fedavg_a_seed():
    """``lead=1`` (a Monte-Carlo seed axis before the clients, the mask
    (seeds, clients)): seed by seed the same as without it."""
    rng = np.random.RandomState(2)
    x = {"w": torch.from_numpy(rng.standard_normal((3, 4, 2, 5)).astype(
        np.float32))}
    m = torch.tensor([[1., 0., 1., 1.], [0., 0., 0., 0.], [0., 1., 0., 0.]])
    fb = {"w": torch.from_numpy(rng.standard_normal((3, 2, 5)).astype(
        np.float32))}
    seeds = {"pmean": fedavg_pmean(x, None, lead=1),
             "pmean_stack": fedavg_pmean_stack(x, None, lead=1),
             "pmean_masked": fedavg_pmean_masked(x, m, fb, None, lead=1),
             "pmean_stack_masked": fedavg_pmean_stack_masked(x, m, None,
                                                             lead=1)}
    for s in range(3):
        xs, fs = {"w": x["w"][s]}, {"w": fb["w"][s]}
        one = {"pmean": fedavg_pmean(xs, None),
               "pmean_stack": fedavg_pmean_stack(xs, None),
               "pmean_masked": fedavg_pmean_masked(xs, m[s], fs, None),
               "pmean_stack_masked": fedavg_pmean_stack_masked(xs, m[s],
                                                               None)}
        for fn, v in one.items():
            torch.testing.assert_close(seeds[fn]["w"][s], v["w"], atol=ATOL,
                                       rtol=0)
    # seed 1 has no active client: its fallback and its stale rows
    assert torch.equal(seeds["pmean_masked"]["w"][1], fb["w"][1])
    assert torch.equal(seeds["pmean_stack_masked"]["w"][1], x["w"][1])
