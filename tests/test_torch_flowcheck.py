"""The port's flowcheck against the JAX package's: the planner's output
verifies clean, every seeded bad fixture fires the same diagnostics (rule
ids, severities, locations, op indices, messages) as the reference's
fixture, the 64-case corpus and its delta leg verify with zero findings, and
the port's ``prepare`` rejects a malformed flow before running it."""
import dataclasses

import pytest

from repro.analysis import corpus as corpus_ref
from repro.analysis import fixtures as fixtures_ref
from repro.analysis import flowcheck as fc_ref
from repro.core import engine as eng_ref
from repro.core.cost import GraphStats as GS_ref
from repro.core.dataflow import translate as tr_ref
from repro.core.optimizer import optimal_plan as plan_ref
from repro.core.query import PAPER_QUERIES as Q_REF
from repro.serve import graph_service as svc_ref
from repro_torch.analysis import clean_tree_flowcheck
from repro_torch.analysis import corpus as corpus_pt
from repro_torch.analysis import fixtures as fixtures_pt
from repro_torch.analysis.diagnostics import Diagnostic, FlowcheckError, errors
from repro_torch.analysis.flowcheck import check_flow, check_plan, check_query, verify_flow
from repro_torch.core.cost import GraphStats
from repro_torch.core.dataflow import Dataflow, OpDesc, merge_flows, translate
from repro_torch.core.engine import EngineConfig, HugeEngine, QueueSlotPool, flow_queue_cells
from repro_torch.core.faults import FaultPlan
from repro_torch.core.optimizer import optimal_plan
from repro_torch.core.query import PAPER_QUERIES, QueryGraph, triangle
from repro_torch.graph import powerlaw_graph
from repro_torch.serve import graph_service as svc_pt

STATS = GraphStats.synthetic(1 << 10, 6.0)


@pytest.fixture(scope="module")
def graph():
    return powerlaw_graph(256, 5.0, seed=3, device="cpu")


def as_tuples(diags):
    return [dataclasses.astuple(d) for d in diags]


# ---------------------------------------------------------------------------
# clean inputs verify clean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", ["q1", "q2", "q5", "q8"])
@pytest.mark.parametrize("space", ["huge", "seed", "bigjoin"])
def test_planner_output_verifies(qname, space):
    plan = optimal_plan(PAPER_QUERIES[qname], STATS, 8, space)
    assert check_plan(plan) == []
    flow = translate(plan)
    assert check_flow(flow) == []
    # priced against the default service pool, as the reference prices it
    assert check_flow(flow, cfg=EngineConfig(), d_pad=64,
                      max_cells=svc_pt.ServiceConfig().total_queue_cells) == []
    ref = tr_ref(plan_ref(Q_REF[qname], GS_ref.synthetic(1 << 10, 6.0), 8, space))
    assert as_tuples(fc_ref.check_flow(ref, cfg=eng_ref.EngineConfig(), d_pad=64)) == []


def test_merged_flow_verifies():
    flows = [translate(optimal_plan(PAPER_QUERIES[q], STATS, 8, "huge"))
             for q in ("q1", "q2")]
    merged, _ = merge_flows(flows)
    assert errors(check_flow(merged)) == []


def test_engine_preflight_accepts_good_query(graph):
    eng = HugeEngine(graph, EngineConfig(num_machines=4, batch_size=256), device="cpu")
    assert eng.run(triangle()).count > 0


# ---------------------------------------------------------------------------
# seeded bad fixtures fire what the reference's fire
# ---------------------------------------------------------------------------

def test_fixture_set_is_the_references_minus_the_source_lint():
    assert set(fixtures_pt.FIXTURES) == set(fixtures_ref.FIXTURES) - {"bad-kernel-source"}


@pytest.mark.parametrize("name", sorted(fixtures_pt.FIXTURES))
def test_fixture_fires_the_references_rules(name):
    diags, expected = fixtures_pt.run_fixture(name)
    diags_ref, expected_ref = fixtures_ref.run_fixture(name)
    assert expected == expected_ref
    fired = {d.rule for d in diags}
    for rule in expected:
        assert rule in fired, f"{name}: {rule} missing from {sorted(fired)}"
    assert all(isinstance(d, Diagnostic) for d in diags)
    # rule ids, messages, severities, where, op indices and hints, in order
    assert as_tuples(diags) == as_tuples(diags_ref)
    assert [d.key() for d in diags] == [d.key() for d in diags_ref]
    assert [d.format() for d in diags] == [d.format() for d in diags_ref]


def test_query_checks():
    assert {d.rule for d in check_query(QueryGraph.from_edges([(0, 1), (2, 3)]))} \
        == {"query-disconnected"}
    empty = dataclasses.replace(triangle(), edges=frozenset())
    assert "query-empty" in {d.rule for d in check_query(empty)}


def test_verify_flow_error_carries_diagnostics():
    with pytest.raises(FlowcheckError) as ei:
        verify_flow(fixtures_pt.dangling_sink_flow())
    assert any(d.rule == "orphan-op" for d in ei.value.diagnostics)
    assert "orphan-op" in str(ei.value)


def test_sinkless_flow_rejected():
    flow = Dataflow(ops=[OpDesc(kind="scan", schema=(0, 1), scan_edge=(0, 1))],
                    query_name="sinkless")
    assert "no-sink" in {d.rule for d in check_flow(flow)}


@pytest.mark.parametrize("bad", ["bad_join_key_flow", "pull_join_flow",
                                 "disconnected_extend_flow"])
def test_engine_prepare_rejects_bad_flow(graph, bad):
    eng = HugeEngine(graph, EngineConfig(num_machines=4), device="cpu")
    flow = getattr(fixtures_pt, bad)()
    with pytest.raises(FlowcheckError) as ei:
        eng.prepare(flow)
    assert {d.rule for d in ei.value.diagnostics} == \
        {d.rule for d in errors(check_flow(flow))}
    with pytest.raises(FlowcheckError):
        eng.run(flow)  # nothing runs either


def test_engine_prepare_prices_queues(graph):
    """Sessions allocate what the pre-flight priced; an armed fault plan with
    recovery on doubles the retry slack, and a budget that only the plain
    pricing fits is blamed on that slack (rule ``retry-slack``)."""
    flow = translate(optimal_plan(PAPER_QUERIES["q1"], STATS, 8, "huge"))
    for cfg in (EngineConfig(), EngineConfig(faults=FaultPlan.single("shard-loss"))):
        eng = HugeEngine(graph, cfg, device="cpu")
        assert eng.prepare(flow).queue_cells == flow_queue_cells(flow, cfg, eng.d_pad)
    ft = EngineConfig(faults=FaultPlan.single("shard-loss"))
    plain = flow_queue_cells(flow, ft, 128, fault_tolerant=False)
    assert flow_queue_cells(flow, ft, 128) > plain
    assert flow_queue_cells(flow, EngineConfig(faults=ft.faults, recover=False), 128) == plain
    assert [d.rule for d in check_flow(flow, cfg=ft, d_pad=128, max_cells=plain)] == \
        ["retry-slack"]


# ---------------------------------------------------------------------------
# the corpus: every paper query × plan space, and the delta leg
# ---------------------------------------------------------------------------

def test_corpus_verifies_clean_like_the_reference():
    assert corpus_pt.corpus_cases() == corpus_ref.corpus_cases()
    assert len(corpus_pt.corpus_cases()) == 64
    assert clean_tree_flowcheck() == []
    assert corpus_ref.corpus_findings() == []


def test_service_config_and_pool_are_the_references(caplog):
    """The pool the corpus is priced against, the service's defaults and the
    slot pool's over-release error are the reference's."""
    assert dataclasses.asdict(svc_pt.ServiceConfig()) == dataclasses.asdict(svc_ref.ServiceConfig())
    assert dataclasses.asdict(svc_pt.TenantBudget()) == dataclasses.asdict(svc_ref.TenantBudget())
    assert [f.name for f in dataclasses.fields(svc_pt.ServiceConfig)] == \
        [f.name for f in dataclasses.fields(svc_ref.ServiceConfig)]
    assert [f.name for f in dataclasses.fields(svc_pt.TenantBudget)] == \
        [f.name for f in dataclasses.fields(svc_ref.TenantBudget)]
    errs = []
    for pool in (QueueSlotPool(1000), eng_ref.QueueSlotPool(1000)):
        assert pool.try_lease(100) and not pool.try_lease(901) and pool.free_cells() == 900
        with pytest.raises(RuntimeError, match="over-release") as ei:
            pool.release(250)
        assert pool.leased_cells == 0  # clamped, not negative
        errs.append(str(ei.value))
    assert errs[0] == errs[1] == ("queue-slot pool released 250 cells but only 100 "
                                  "were leased (over-release of 150)")
    assert "150 excess" in caplog.text
