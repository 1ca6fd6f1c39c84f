"""Planner of the PyTorch port against the JAX package: the same plan tree
and the same operator list for every corpus case (8 paper queries × 8 plan
spaces), and the same degree moments from the same graph."""
import dataclasses

import numpy as np
import pytest

from repro.analysis.corpus import corpus_cases
from repro.core import cost as cost_ref
from repro.core import dataflow as df_ref
from repro.core import optimizer as opt_ref
from repro.core import query as q_ref
from repro.graph import generators as gen_ref
from repro_torch.core import cost as cost_pt
from repro_torch.core import dataflow as df_pt
from repro_torch.core import optimizer as opt_pt
from repro_torch.core import query as q_pt
from repro_torch.graph import storage as st_pt


def assert_same_flow(flow_ref, flow_pt):
    assert flow_pt.query_name == flow_ref.query_name
    assert len(flow_pt.ops) == len(flow_ref.ops)
    for op_r, op_p in zip(flow_ref.ops, flow_pt.ops):
        port = dataclasses.asdict(op_p)
        assert port == {f: getattr(op_r, f) for f in port}
        # the fields the port leaves to the streaming slice stay at their
        # defaults in every flow ``translate`` emits
        assert op_r.scan_epoch == "full" and op_r.ext_epochs == ()
        assert op_p.label() == op_r.label()
    assert flow_pt.describe() == flow_ref.describe()


@pytest.mark.parametrize("qname,space", corpus_cases())
def test_corpus_plans_and_dataflows_identical(qname, space):
    stats_r = cost_ref.GraphStats.synthetic(1 << 11, 6.0)
    stats_p = cost_pt.GraphStats.synthetic(1 << 11, 6.0)
    assert dataclasses.asdict(stats_p) == dataclasses.asdict(stats_r)
    plan_r = opt_ref.optimal_plan(q_ref.PAPER_QUERIES[qname], stats_r, 8, space)
    plan_p = opt_pt.optimal_plan(q_pt.PAPER_QUERIES[qname], stats_p, 8, space)
    assert plan_p.describe() == plan_r.describe()
    assert plan_p.est_cost == plan_r.est_cost
    assert plan_p.symmetry_conditions == plan_r.symmetry_conditions
    assert_same_flow(df_ref.translate(plan_r), df_pt.translate(plan_p))


def test_graph_stats_moments_identical():
    ref = gen_ref.powerlaw_graph(512, 6.0, seed=0)
    pt = st_pt.from_numpy(np.asarray(ref.offsets), np.asarray(ref.nbrs),
                          np.asarray(ref.padded.adj), np.asarray(ref.padded.deg),
                          device="cpu")
    s_r = cost_ref.GraphStats.from_graph(ref)
    s_p = cost_pt.GraphStats.from_graph(pt)
    assert s_p.degree_moments == s_r.degree_moments  # exact float equality
    assert (s_p.num_vertices, s_p.num_directed_edges, s_p.max_degree) == \
        (s_r.num_vertices, s_r.num_directed_edges, s_r.max_degree)


@pytest.mark.parametrize("space", ["huge", "seed", "rads"])
def test_plans_from_graph_stats_identical(space):
    ref = gen_ref.powerlaw_graph(512, 6.0, seed=0)
    pt = st_pt.from_numpy(np.asarray(ref.offsets), np.asarray(ref.nbrs),
                          np.asarray(ref.padded.adj), np.asarray(ref.padded.deg),
                          device="cpu")
    s_r, s_p = cost_ref.GraphStats.from_graph(ref), cost_pt.GraphStats.from_graph(pt)
    for qname in q_ref.PAPER_QUERIES:
        plan_r = opt_ref.optimal_plan(q_ref.PAPER_QUERIES[qname], s_r, 8, space)
        plan_p = opt_pt.optimal_plan(q_pt.PAPER_QUERIES[qname], s_p, 8, space)
        assert plan_p.describe() == plan_r.describe(), qname
        assert_same_flow(df_ref.translate(plan_r), df_pt.translate(plan_p))


def test_symmetry_breaking_and_automorphisms_identical():
    for qname, qr in q_ref.PAPER_QUERIES.items():
        qp = q_pt.PAPER_QUERIES[qname]
        assert qp.edges == qr.edges and qp.name == qr.name
        assert q_pt.symmetry_break(qp) == q_ref.symmetry_break(qr)
        assert qp.automorphisms() == qr.automorphisms()
