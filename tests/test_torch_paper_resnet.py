"""ResNet-18 through the paper's specs: both packages' record streams.

``paper_spec`` at 32x32 (2 clients, 1 round, 1 local step, batch 4) for
SL_15_85 with the int8 link and for FL, run through the reference's and
the port's ``compile_experiment`` on the same arrays and initial params
(``test_torch_harness.paper_plans_both``). The records agree as
``assert_records_match`` states: loss within 1e-3, accuracy within one
test sample, link bytes exactly, energies and times by the billing ratio
(the port bills from its own FLOP count, held in ``test_torch_flops.py``).
Each reference plan is compiled and run once for the module.
"""
import pytest

from test_torch_harness import (PAPER_N_TEST, assert_records_match,
                                paper_plans_both, plan_flops_pair)

from repro_torch.api.plan import FL_SERVER_AGG_S

CASES = {
    "sl_15_85-int8": dict(kind="sl", fraction=0.15, compress=True),
    "fl": dict(kind="fl"),
}


@pytest.fixture(scope="module")
def runs():
    return {}


def _run(runs, case):
    if case not in runs:
        runs[case] = paper_plans_both("resnet18", **CASES[case])
    return runs[case]


@pytest.mark.parametrize("case", list(CASES))
def test_records_match_reference(runs, case):
    ref_plan, port_plan, ref_recs, port_recs = _run(runs, case)
    assert len(port_recs) == 1
    assert_records_match(
        ref_recs, port_recs, ref_flops_pair=plan_flops_pair(ref_plan),
        port_flops_pair=plan_flops_pair(port_plan),
        server_base_s=FL_SERVER_AGG_S if CASES[case]["kind"] == "fl" else 0.0,
        n_test=PAPER_N_TEST)
    if CASES[case].get("compress"):
        assert port_recs[0].link_bytes > 0
    else:
        assert port_recs[0].link_bytes == 0


@pytest.mark.parametrize("case", list(CASES))
def test_cuts_and_budget_match_reference(runs, case):
    ref_plan, port_plan, _, _ = _run(runs, case)
    assert port_plan.cut_of_client == ref_plan.cut_of_client
    assert port_plan.rounds_budget == ref_plan.rounds_budget
    if CASES[case]["kind"] == "sl":
        assert port_plan.cut_of_client == [2, 2]
