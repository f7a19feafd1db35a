"""``repro_torch.analyze`` (the counterpart of ``repro.analyze``) on the CPU.

- Every AST rule fires on a minimal hazard at its exact line and stays
  silent on the idiomatic twin, rule by rule as ``tests/test_analyze.py``
  does; the escape hatch suppresses only with a reason. The rules both
  packages share (``raw-timer``, ``bare-except``, ``unhoisted-const``,
  ``label-link``, ``bad-suppression``) also run through the reference's
  ``repro.analyze.lint_source`` on the same snippets (``unhoisted-const``'s
  with ``jnp`` in the reference's and ``torch`` in the port's) and give the
  same rule ids at the same lines. ``src/repro_torch`` lints clean.
- The runtime audit flags each seeded hazard (an ``.item()`` in a forward
  and in a backward, a data-shaped op, a float64 tensor, a kernel seam's
  Function run once too often, a collective on a foreign group, a stream
  slot registered twice) and passes its clean twin; hetero-bucketed plans
  are refused.
- The whole variant matrix (22 entries) audits clean on the CPU, and its
  ``shard_map`` entries again on two spawned gloo ranks, where their
  collectives run on the plan's group.
- The Monte-Carlo audit runs the sweep's own builder: one int8 call a
  local step for all seeds and clients, as the sweep runs it.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analyze import lint_source as ref_lint_source
from repro_torch.analyze import (RULES, audit_all, audit_call, audit_keys,
                                 audit_mc_round, audit_plan, audit_round,
                                 expected_calls, lint_paths, lint_source)
from repro_torch.analyze.variants import METRICS_TWINS, _tiny_spec
from repro_torch.api import (ClientSpec, CutPolicy, LinkPolicy,
                             compile_experiment)
from repro_torch.core.energy import JETSON_AGX_ORIN, HardwareProfile
from repro_torch.kernels.quant.ops import make_link_compress
from repro_torch.launch.mesh import run_ranks
from repro_torch.sim import run_monte_carlo, streams

import torch_rank_cases as RC

ROOT = Path(__file__).resolve().parents[1]
MCU = HardwareProfile("mcu-class", fp32_tflops=0.02, mem_bw_gbs=2.0,
                      tensor_tflops=0.04, cpu_passmark=400.0, power_w=2.0)
MATRIX = ("fl/scan", "fl/vmap", "fl/vmap+metrics", "fl/shard_map",
          "sl/scan", "sl/scan+metrics", "sl/vmap", "sl/vmap+metrics",
          "sl/shard_map", "sl/shard_map+metrics", "fl/vmap+dropout",
          "sl/vmap+dropout", "fl/vmap+population", "sl/vmap+population",
          "sl/vmap+population+metrics", "sl/vmap+lm_pallas",
          "sl/scan+lm_pallas", "sl/vmap+link_fused",
          "sl/vmap+link_fused+metrics", "mc/fl/vmap+scenario",
          "mc/sl/vmap+population", "mc/sl/vmap+population+metrics")


def _rules_at(findings):
    return [(f.rule, int(f.where.rsplit(":", 1)[1])) for f in findings]


# ---------------------------------------------------------------------------
# AST lint: one hazard and one clean twin a rule
# ---------------------------------------------------------------------------

# (port snippet, reference snippet) pairs of the shared rules: hazards
SHARED_HAZARDS = {
    "raw-timer": ("import time\nt0 = time.perf_counter()\n",) * 2,
    "raw-timer-no-reason": (
        "import time\nt0 = time.time()  # repro: ignore[raw-timer]\n",) * 2,
    "raw-timer-unknown-rule": (
        "import time\n"
        "t0 = time.time()  # repro: ignore[not-a-rule] -- because\n",) * 2,
    "bare-except": ("try:\n    x = 1\nexcept:\n    pass\n",) * 2,
    "unhoisted-const": tuple(
        f"import {mod}\n"
        "def f(n):\n"
        "    out = []\n"
        "    for i in range(n):\n"
        f"        out.append({ns}.ones((4, 4)) * i)\n"
        "    return out\n"
        for mod, ns in (("torch", "torch"), ("jax.numpy as jnp", "jnp"))),
    "label-link": (
        "from repro.core.split import SplitStep\n"
        "step = SplitStep(\n"
        "    client_fwd=lambda pc, xx, yy: fwd(pc, xx, yy),\n"
        "    server_loss=loss_fn)\n",) * 2,
}
SHARED_CLEAN = {
    "raw-timer": ("import time\n"
                  "t0 = time.time()  "
                  "# repro: ignore[raw-timer] -- progress stamp only\n",) * 2,
    "bare-except": ("try:\n    x = 1\nexcept ValueError:\n    pass\n",) * 2,
    # a def inside the loop is not executed per iteration
    "unhoisted-const": tuple(
        f"import {mod}\n"
        "def f(n):\n"
        "    fns = []\n"
        "    for i in range(n):\n"
        "        def g(x):\n"
        f"            return x + {ns}.ones((4, 4))\n"
        "        fns.append(g)\n"
        "    return fns, [" + f"{ns}.zeros(n) for _ in range(n)]\n"
        for mod, ns in (("torch", "torch"), ("jax.numpy as jnp", "jnp"))),
    "label-link": (
        "from repro.core.split import SplitStep\n"
        "step = SplitStep(\n"
        "    client_fwd=lambda pc, xx: fwd(pc, xx),\n"
        "    server_loss=lambda ps, sm, yy: loss(ps, sm, yy))\n",) * 2,
}


@pytest.mark.parametrize("case", sorted(SHARED_HAZARDS))
def test_shared_rules_flag_what_the_reference_flags(case):
    port_src, ref_src = SHARED_HAZARDS[case]
    got = sorted(_rules_at(lint_source(port_src)))
    assert got, case
    assert got == sorted(_rules_at(ref_lint_source(ref_src)))
    want = {"raw-timer": [("raw-timer", 2)],
            "raw-timer-no-reason": [("bad-suppression", 2), ("raw-timer", 2)],
            "raw-timer-unknown-rule": [("bad-suppression", 2),
                                       ("raw-timer", 2)],
            "bare-except": [("bare-except", 3)],
            "unhoisted-const": [("unhoisted-const", 5)],
            "label-link": [("label-link", 3)]}[case]
    assert got == want


@pytest.mark.parametrize("case", sorted(SHARED_CLEAN))
def test_shared_rules_pass_the_clean_twins(case):
    port_src, ref_src = SHARED_CLEAN[case]
    assert lint_source(port_src) == []
    assert ref_lint_source(ref_src) == []


def test_label_link_names_the_label():
    found = lint_source(SHARED_HAZARDS["label-link"][0])
    assert "'yy'" in found[0].message


def test_traced_branch_on_a_vmapped_parameter():
    bad = (
        "import torch\n"
        "def f(x):\n"
        "    if x:\n"
        "        return x\n"
        "    def inner(z):\n"
        "        while x > z:\n"
        "            z = z + 1\n"
        "        return z\n"
        "    return inner(x)\n"
        "g = torch.func.vmap(f)\n")
    # the inner function closes over x and is batched too: both names
    assert _rules_at(lint_source(bad)) == [("traced-branch", 3),
                                           ("traced-branch", 6),
                                           ("traced-branch", 6)]
    decorated = (
        "import torch\n"
        "@torch.vmap\n"
        "def body(c):\n"
        "    while c:\n"
        "        c = c - 1\n"
        "    return c\n")
    assert _rules_at(lint_source(decorated)) == [("traced-branch", 4)]
    # `is None` tests are static; a function vmap never sees may branch
    ok = (
        "import torch\n"
        "def f(x, bias=None):\n"
        "    if bias is None:\n"
        "        return x\n"
        "    return x + bias\n"
        "def h(y):\n"
        "    if y:\n"
        "        return 1\n"
        "g = torch.func.vmap(f)\n")
    assert lint_source(ok) == []


def test_host_sync_in_round_bodies_and_vmapped_functions():
    bad = (
        "import torch\n"
        "def make_sl_round(step):\n"
        "    def global_round(batch):\n"
        "        loss = step(batch)\n"
        "        print(loss.item(), loss.tolist())\n"
        "        return loss.cpu().numpy()\n"
        "    return global_round\n"
        "def f(x):\n"
        "    return float(x) + int(x)\n"
        "g = torch.vmap(f)\n")
    assert _rules_at(lint_source(bad)) == [
        ("host-sync", 5), ("host-sync", 5), ("host-sync", 6),
        ("host-sync", 6), ("host-sync", 9), ("host-sync", 9)]
    # the factory's own body runs once, at build time; a host function and
    # a float of a closure's attribute read no tensor a call
    ok = (
        "import torch\n"
        "def make_sl_round(step, lr):\n"
        "    scale = torch.tensor(lr).item()\n"
        "    def global_round(batch):\n"
        "        return step(batch) * float(step.lr)\n"
        "    return global_round\n"
        "def report(losses):\n"
        "    return losses.cpu().numpy(), float(losses)\n")
    assert lint_source(ok) == []
    suppressed = ("def make_x_step():\n"
                  "    def step(t):\n"
                  "        return t.item()  # repro: ignore[host-sync] -- "
                  "the step returns a host number by contract\n"
                  "    return step\n")
    assert lint_source(suppressed) == []


def test_rules_and_the_not_ported_ones():
    from repro.analyze import RULES as REF_RULES
    from repro_torch.analyze import NOT_PORTED
    assert set(RULES) == (set(REF_RULES) - set(NOT_PORTED)) | {"host-sync"}
    assert set(NOT_PORTED) == {"key-reuse", "magic-fold"}


def test_port_source_tree_lints_clean():
    import repro_torch
    src = Path(next(iter(repro_torch.__path__))).resolve()
    report = lint_paths([src], repo_root=src.parent.parent)
    assert report.ok, "\n".join(str(f) for f in report.findings)
    assert len(report.checked) > 70


def _lint_cli():
    spec = importlib.util.spec_from_file_location(
        "repro_torch_lint", ROOT / "tools" / "repro_torch_lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_exits_zero_on_a_clean_run_and_one_on_a_finding(tmp_path,
                                                             capsys):
    cli = _lint_cli()
    out = tmp_path / "lint.json"
    assert cli.main(["--ast", "--audit", "--variant", "fl/scan", "--no-mc",
                     "--device", "cpu", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "[audit] fl/scan: round[" in text and "0 finding(s)" in text
    assert '"ok": true' in out.read_text()
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nt0 = time.time()\n")
    assert cli.main(["--ast", "--paths", str(bad), "-q"]) == 1
    with pytest.raises(SystemExit):
        cli.main([])


# ---------------------------------------------------------------------------
# the runtime audit: one seeded hazard a check
# ---------------------------------------------------------------------------

class _SyncInBackward(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return x * 2.0

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g * float(g.sum())


def _rules(rep):
    return [f.rule for f in rep.findings]


def test_audit_flags_host_syncs_in_forward_and_backward():
    t = torch.arange(4.0)
    _, rep = audit_call(lambda: t.sum().item(), where="item")
    assert _rules(rep) == ["audit-host-sync"]
    assert "_local_scalar_dense" in rep.findings[0].message
    _, rep = audit_call(lambda: torch.nonzero(t > 1), where="nonzero")
    assert _rules(rep) == ["audit-host-sync"]
    x = torch.ones(3, requires_grad=True)
    _, rep = audit_call(lambda: _SyncInBackward.apply(x).sum().backward(),
                        where="backward")
    assert _rules(rep) == ["audit-host-sync"]
    out, rep = audit_call(lambda: (t * 2).sum(), where="clean")
    assert rep.findings == [] and float(out) == 12.0


def test_audit_flags_float64_tensors():
    _, rep = audit_call(lambda: torch.ones(2) * torch.ones(
        2, dtype=torch.float64), where="f64")
    assert set(_rules(rep)) == {"audit-f64"} and len(rep.f64) == 2
    _, rep = audit_call(lambda: torch.ones(2) * 2.0, where="f32")
    assert rep.findings == []


def test_audit_counts_each_kernel_seams_calls():
    compress = make_link_compress(kernel="fused")
    x = torch.randn(4, 8)
    want = {"_StraightThroughInt8": 1, "_FlashAttention": 0, "_WKV": 0}
    _, rep = audit_call(lambda: compress(compress(x)), where="twice",
                        expected_calls=want)
    assert _rules(rep) == ["audit-launches"]
    assert "2 calls" in rep.findings[0].message
    _, rep = audit_call(lambda: compress(x), where="once",
                        expected_calls=want)
    assert rep.findings == [] and rep.calls == want
    # the CPU tensor took the plain version: no kernel launched
    assert rep.launches["quant_dequant_int8"] == 0


def test_audit_keys_proves_the_loaded_registry():
    assert audit_keys().ok
    slot = streams.KeySlot("env", "bypass", streams.ENV_MASK.value)
    streams._REGISTRY[("env", "bypass")] = slot
    try:
        report = audit_keys()
    finally:
        del streams._REGISTRY[("env", "bypass")]
    assert [f.rule for f in report.findings] == ["audit-fold-slot"]
    assert "registered twice" in report.findings[0].message
    assert audit_keys().ok


def test_audit_rejects_hetero_plans():
    spec = dataclasses.replace(
        _tiny_spec("sl", "vmap"),
        clients=ClientSpec(num_clients=4,
                           edge_profiles=(JETSON_AGX_ORIN, MCU)),
        cut_policy=CutPolicy(mode="adaptive"),
        link_policy=LinkPolicy(compress="int8", rate_bps=1e6))
    plan = compile_experiment(spec, device="cpu")
    assert len(set(plan.cut_of_client)) == 2
    for audit in (audit_plan, audit_mc_round):
        with pytest.raises(ValueError, match="no single"):
            audit(plan)


# ---------------------------------------------------------------------------
# the variant matrix audits clean
# ---------------------------------------------------------------------------

def test_whole_variant_matrix_audits_clean_on_the_cpu():
    seen = []

    def entry(name, report):
        seen.append(name)
        assert report.ok, (name, [str(f) for f in report.findings])

    report = audit_all(device="cpu", on_entry=entry)
    assert tuple(seen) == MATRIX
    assert len(MATRIX) == 22 and sum(
        n.endswith("+metrics") for n in MATRIX) == len(METRICS_TWINS)
    assert report.ok
    # the registry, 22 raw rounds and the 3 Monte-Carlo rounds
    assert len(report.checked) == 1 + 22 + 3
    # the kernels' Functions ran as the engines' design says, e.g. one
    # flash call a layer and a local step for all clients on sl/vmap
    calls = {c.split(": ", 1)[0]: c for c in report.checked}
    assert "'_FlashAttention': 2" in calls["sl/vmap+lm_pallas"]
    assert "'_FlashAttention': 4" in calls["sl/scan+lm_pallas"]
    assert "'_StraightThroughInt8': 1" in calls["sl/vmap+link_fused"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The one 2-rank gloo spawn of ``torch_rank_cases.analyze_shard_map``
    (rank 0's result)."""
    return run_ranks(RC.analyze_shard_map, 2,
                     str(tmp_path_factory.mktemp("analyze")))


def test_shard_map_variants_audit_clean_on_two_ranks(two_ranks):
    out = two_ranks
    assert not out["jax"]
    for rank in out["ranks"]:
        report = rank["report"]
        assert report["ok"], report["findings"]
        assert [c.split(":", 1)[0] for c in report["checked"][1:]] == [
            "fl/shard_map", "sl/shard_map", "sl/shard_map+metrics"]
        # the rounds' collectives ran, all on the plan's group
        assert all("on groups ['0']" in c for c in report["checked"][1:])
        assert [r for r, _ in rank["foreign"]] == ["audit-collective-group"]
        assert rank["own"] == [] and len(rank["own_collectives"]) == 1


def test_server_mesh_plan_and_its_sweep_audit_clean_on_two_ranks(two_ranks):
    """An ``sl/vmap`` plan with its server suffix sharded over
    ``server_mesh=(2, 1)`` on 2 gloo ranks: its raw round and its
    Monte-Carlo seed-axis round audit with 0 findings; their collectives
    (the sub-mesh's gathers of the server state) run on the plan's
    groups, which are not its data group alone; one int8 call a local
    step for all clients (and seeds)."""
    out = two_ranks
    assert not out["jax"]
    for rank in out["ranks"]:
        sm = rank["server_mesh"]
        assert sm["mesh"] == {"data": 1, "fsdp": 2, "tp": 1}
        for name, report in sm["reports"].items():
            assert report["ok"], (name, report["findings"])
        for name in ("plan", "mc"):
            assert sm["groups"][name], name
            assert set(sm["groups"][name]) - {sm["data_group"]}, name
            assert sm["calls"][name]["_StraightThroughInt8"] == 2


def test_mc_audit_runs_the_sweeps_builder():
    """The audited seed-axis round is the sweep's: an int8 fused link
    calls the boundary once a local step for all seeds and clients, in the
    audit and in ``run_monte_carlo``'s execution (warm-up round
    included)."""
    from repro_torch.analyze.audit import counting_calls, kernel_functions
    spec = dataclasses.replace(_tiny_spec("sl", "vmap", compress="int8",
                                          link_kernel="fused",
                                          dropout=0.25), local_steps=2)
    plan = compile_experiment(spec, device="cpu")
    rep = audit_mc_round(plan, num_seeds=3)
    assert rep.findings == [], [str(f) for f in rep.findings]
    assert rep.calls["_StraightThroughInt8"] == 2 == expected_calls(
        plan)["_StraightThroughInt8"]
    with counting_calls(kernel_functions()) as calls:
        res = run_monte_carlo(plan, 3, rounds=2)
    assert res.stacks["loss"].shape == (3, 2)
    assert calls["_StraightThroughInt8"] == 2 * (1 + 2)
    assert np.isfinite(res.stacks["loss"]).all()
    # the raw round of the same plan: one call a local step for all clients
    assert audit_round(plan).calls["_StraightThroughInt8"] == 2


@pytest.mark.parametrize("kind,pop", [("sl", None), ("fl", None),
                                      ("fl", 6)])
def test_mc_audit_of_the_scan_engines_is_clean(kind, pop):
    """The Monte-Carlo round of a scan engine audits clean and calls the
    kernel seams as its raw round does, whatever the seed count: on
    ``sl/scan`` (the seeds' shared round) the fused int8 boundary once a
    client step, on ``fl/scan`` none (shared, or the seed axis under a
    population)."""
    from repro_torch.analyze.audit import counting_calls, kernel_functions
    spec = dataclasses.replace(
        _tiny_spec(kind, "scan", pop=pop, compress="int8",
                   link_kernel="fused" if kind == "sl" else "xla"),
        local_steps=2)
    plan = compile_experiment(spec, device="cpu")
    rep = audit_mc_round(plan, num_seeds=3)
    assert rep.findings == [], [str(f) for f in rep.findings]
    want = 2 * 2 if kind == "sl" else 0          # clients x local steps
    assert rep.calls["_StraightThroughInt8"] == want == expected_calls(
        plan)["_StraightThroughInt8"]
    assert audit_round(plan).calls["_StraightThroughInt8"] == want
    with counting_calls(kernel_functions()) as calls:
        res = run_monte_carlo(plan, 3, rounds=2)
    assert calls["_StraightThroughInt8"] == want * (1 + 2)
    assert np.isfinite(res.stacks["loss"]).all()
