"""GoogLeNet through the paper's SL_40_60 spec: both packages' records.

``paper_spec`` at 32x32 (2 clients, 1 round, 1 local step, batch 4) for
SL_40_60 with the int8 link, run through the reference's and the port's
``compile_experiment`` on the same arrays and initial params
(``test_torch_harness.paper_plans_both``), held by ``assert_records_match``
(loss within 1e-3, accuracy within one test sample, link bytes exactly,
energies and times by the billing ratio). The reference plan is compiled
and run once for the module.
"""
import pytest

from test_torch_harness import (PAPER_N_TEST, assert_records_match,
                                paper_plans_both, plan_flops_pair)


@pytest.fixture(scope="module")
def run():
    return paper_plans_both("googlenet", "sl", fraction=0.40, compress=True)


def test_records_match_reference(run):
    ref_plan, port_plan, ref_recs, port_recs = run
    assert len(port_recs) == 1 and port_recs[0].link_bytes > 0
    assert_records_match(
        ref_recs, port_recs, ref_flops_pair=plan_flops_pair(ref_plan),
        port_flops_pair=plan_flops_pair(port_plan), server_base_s=0.0,
        n_test=PAPER_N_TEST)


def test_cuts_and_budget_match_reference(run):
    ref_plan, port_plan, _, _ = run
    assert port_plan.cut_of_client == ref_plan.cut_of_client == [4, 4]
    assert port_plan.rounds_budget == ref_plan.rounds_budget
