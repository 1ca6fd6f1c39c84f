"""The port's multi-tenant graph service against the JAX package's, on the CPU.

Each scenario of the reference's service tests (``test_graph_service.py``,
the service rows of ``test_chaos.py``, the standing queries of
``test_streaming.py`` and the admission rows of ``test_flowcheck.py``) runs
on both services over the same graph, with the sessions unfused and fused
(the port's fused path runs the kernels' plain versions on the CPU). The
two must agree field by field, with no tolerance: every ``tick()`` dict;
every ticket's status, count, error, attempts, failures, diagnostic rule
ids and every ``EngineStats`` field but the wall times; the service's
``ticks``, ``peak_pool_cells``, ``peak_inflight_rows``, leased cells and
tenant usage. Latency stamps are compared only for being set and in order.
Counts are held to the networkx oracle. Then the port's own departures: a
retired session frees its device buffers without the cycle collector, and
a real ``KernelFault`` propagates out of ``tick`` with the lease returned.
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys
import weakref
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro.analysis import fixtures as fixtures_ref
from repro.core import dataflow as df_ref
from repro.core import engine as eng_ref
from repro.core import faults as faults_ref
from repro.core import query as query_ref
from repro.core import scheduler as sched_ref
from repro.graph import generators as gen_ref
from repro.graph import storage as st_ref
from repro.graph.oracle import count_instances
from repro.serve import graph_service as svc_ref
from repro_torch.analysis import fixtures as fixtures_pt
from repro_torch.core import dataflow as df_pt
from repro_torch.core import engine as eng_pt
from repro_torch.core import faults as faults_pt
from repro_torch.core import operators as ops_pt
from repro_torch.core import query as query_pt
from repro_torch.core import scheduler as sched_pt
from repro_torch.graph import generators as gen_pt
from repro_torch.graph import storage as st_pt
from repro_torch.serve import graph_service as svc_pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@dataclasses.dataclass(frozen=True)
class Pkg:
    """One package's service API, so a scenario is written once for both."""

    name: str
    svc: object
    eng: object
    faults: object
    df: object
    query: object
    sched: object
    gen: object
    storage: object
    fixtures: object
    dev: tuple  # keyword arguments that put an entry point on the CPU

    def graph(self, n, deg, seed):
        return _graph(self.name, n, deg, seed)

    def build_graph(self, edges, n):
        return self.storage.build_graph(edges, n, **dict(self.dev))

    def service(self, graph, cfg=None, engine_cfg=None, tenants=None):
        return record(self.svc.GraphService(graph, cfg, engine_cfg, tenants, **dict(self.dev)))

    def restore(self, graph, snap, cfg=None):
        return record(self.svc.GraphService.restore(graph, snap, cfg, **dict(self.dev)))

    def engine(self, graph, cfg=None):
        return self.eng.HugeEngine(graph, cfg, **dict(self.dev))

    def ecfg(self, fused, **kw):
        return self.eng.EngineConfig(fused=fused, **kw)

    def scfg(self, **kw):
        base = dict(queue_capacity=1 << 10, join_buffer_capacity=1 << 12,
                    tick_steps=16, max_active=4)
        base.update(kw)
        return self.svc.ServiceConfig(**base)

    def request(self, tenant, query, **kw):
        return self.svc.GraphQueryRequest(tenant=tenant, query=query, **kw)

    def plan(self, kind, op="*", at_step=None):
        return self.faults.FaultPlan.single(kind, op=op, at_step=at_step, seed=0)


REF = Pkg("ref", svc_ref, eng_ref, faults_ref, df_ref, query_ref, sched_ref, gen_ref,
          st_ref, fixtures_ref, ())
PT = Pkg("pt", svc_pt, eng_pt, faults_pt, df_pt, query_pt, sched_pt, gen_pt,
         st_pt, fixtures_pt, (("device", "cpu"),))


@lru_cache(maxsize=None)
def _graph(name, n, deg, seed):
    if name == "ref":
        return gen_ref.powerlaw_graph(n, deg, seed=seed)
    return gen_pt.powerlaw_graph(n, deg, seed=seed, device="cpu")


@lru_cache(maxsize=None)
def oracle(n, deg, seed, qname):
    q = query_ref.triangle() if qname == "triangle" else query_ref.PAPER_QUERIES[qname]
    return count_instances(_graph("ref", n, deg, seed), list(q.edges))


G = (256, 5.0, 3)      # the reference's service graph
DENSE = (512, 10.0, 5)  # its budget tests' graph

# EngineStats fields held equal: all but the host-clock times.
STAT_FIELDS = tuple(f.name for f in dataclasses.fields(eng_pt.EngineStats)
                    if f.name not in ("compute_time", "comm_time", "wall_time",
                                      "per_machine_rows"))


def record(svc):
    """Log every ``tick()`` dict of ``svc`` (run_until_idle calls it too)."""
    svc.tick_log = []
    tick = svc.tick

    def logged():
        out = tick()
        svc.tick_log.append(out)
        return out

    svc.tick = logged
    return svc


def ticket_view(t):
    assert t.submitted_at > 0
    if t.admitted_at is not None:
        assert t.submitted_at <= t.admitted_at
    if t.finished_at is not None:
        assert t.submitted_at <= t.finished_at
        assert t.latency_s >= (t.queue_wait_s or 0) >= 0
    return {
        "id": t.id, "tenant": t.request.tenant, "status": t.status, "count": t.count,
        "error": t.error, "attempts": t.attempts, "failures": list(t.failures),
        "rules": [d.rule for d in t.diagnostics], "queue_cells": t.queue_cells,
        "not_before_tick": t.not_before_tick,
        "admitted": t.admitted_at is not None, "finished": t.finished_at is not None,
        "stats": None if t.stats is None else {f: getattr(t.stats, f) for f in STAT_FIELDS},
    }


def observe(svc, tickets=()):
    tenants = sorted({t.request.tenant for t in tickets}
                     | set(svc._tenant_inflight) | set(svc._tenant_cells))
    return {
        "ticks_out": list(svc.tick_log),
        "tickets": [ticket_view(t) for t in tickets],
        "ticks": svc.ticks, "peak_pool_cells": svc.peak_pool_cells,
        "peak_inflight_rows": svc.peak_inflight_rows,
        "leased_cells": svc.pool.leased_cells,
        "usage": {t: svc.tenant_usage(t) for t in tenants},
        "active": len(svc.active), "queued": len(svc.admission),
    }


def assert_same(scenario, fused):
    """Run ``scenario`` on both packages; their observations must be equal."""
    got = {p.name: scenario(p, fused) for p in (REF, PT)}
    assert got["pt"] == got["ref"]
    return got["pt"]


# ---------------------------------------------------------------------------
# Scenarios (each mirrors one reference test, with its assertions)
# ---------------------------------------------------------------------------

def admission_queue_rejects_at_capacity(P, fused):
    svc = P.service(P.graph(*G), P.scfg(admission_queue_len=2), P.ecfg(fused))
    t1 = svc.submit(P.request("a", "q1"))
    t2 = svc.submit(P.request("b", "q1"))
    t3 = svc.submit(P.request("c", "q1"))
    assert t1.status == t2.status == "queued"
    assert t3.status == "rejected" and "admission queue full" in t3.error
    svc.run_until_idle()
    assert t1.status == t2.status == "done" and t1.count == oracle(*G, "q1")
    assert t3.status == "rejected"
    return observe(svc, [t1, t2, t3])


def tenant_inflight_cap_rejects(P, fused):
    svc = P.service(P.graph(*G), P.scfg(), P.ecfg(fused),
                    tenants={"a": P.svc.TenantBudget(max_inflight=1)})
    t1 = svc.submit(P.request("a", "q1"))
    t2 = svc.submit(P.request("a", "q2"))
    other = svc.submit(P.request("b", "q2"))
    assert t1.status == "queued" and other.status == "queued"
    assert t2.status == "rejected" and "max_inflight" in t2.error
    svc.run_until_idle()
    assert t1.status == other.status == "done" and other.count == oracle(*G, "q2")
    t4 = svc.submit(P.request("a", "q1"))
    assert t4.status == "queued"
    svc.run_until_idle()
    assert t4.status == "done" and t4.count == t1.count == oracle(*G, "q1")
    return observe(svc, [t1, t2, other, t4])


def unknown_query_rejected(P, fused):
    svc = P.service(P.graph(*G), P.scfg(), P.ecfg(fused))
    t = svc.submit(P.request("a", "not-a-query"))
    assert t.status == "rejected" and "unknown query" in t.error
    return observe(svc, [t])


def oversized_query_rejected(P, fused):
    svc = P.service(P.graph(*G), P.scfg(total_queue_cells=1000), P.ecfg(fused))
    t = svc.submit(P.request("a", "q1"))
    assert t.status == "queued"
    svc.tick()
    assert t.status == "rejected" and "service pool" in t.error
    return observe(svc, [t])


def q1_cells(P, cfg, fused):
    eng = P.engine(P.graph(*G), P.ecfg(fused))
    flow = eng.to_flow(P.query.PAPER_QUERIES["q1"])
    return P.eng.flow_queue_cells(flow, eng.cfg, eng.d_pad, cfg.queue_capacity,
                                  cfg.join_buffer_capacity)


def pool_fits_one_query_at_a_time(P, fused):
    cells = q1_cells(P, P.scfg(), fused)
    svc = P.service(P.graph(*G), P.scfg(total_queue_cells=int(cells * 1.5)), P.ecfg(fused))
    t1 = svc.submit(P.request("a", "q1"))
    t2 = svc.submit(P.request("b", "q1"))
    svc.tick()
    assert t1.status == "running" and t2.status == "queued"
    assert svc.pool.leased_cells == cells
    svc.run_until_idle()
    assert t1.status == t2.status == "done" and t2.count == oracle(*G, "q1")
    assert t2.admitted_at >= t1.finished_at
    assert svc.pool.leased_cells == 0
    assert svc.tenant_usage("a") == svc.tenant_usage("b") == {"inflight": 0, "queue_cells": 0}
    return observe(svc, [t1, t2]), cells


def tenant_cell_cap_serialises_that_tenant_only(P, fused):
    cells = q1_cells(P, P.scfg(), fused)
    svc = P.service(P.graph(*G), P.scfg(), P.ecfg(fused),
                    tenants={"a": P.svc.TenantBudget(max_queue_cells=int(cells * 1.5))})
    a1 = svc.submit(P.request("a", "q1"))
    a2 = svc.submit(P.request("a", "q1"))
    b1 = svc.submit(P.request("b", "q1"))
    svc.tick()
    assert (a1.status, a2.status, b1.status) == ("running", "queued", "running")
    svc.run_until_idle()
    assert a1.status == a2.status == b1.status == "done"
    assert a1.count == a2.count == b1.count == oracle(*G, "q1")
    return observe(svc, [a1, a2, b1])


def budget_cfg(P):
    return P.scfg(queue_capacity=256, tick_steps=2)


def match_budget_stops_query_early(P, fused):
    total = oracle(*DENSE, "triangle")
    assert total > 500
    svc = P.service(P.graph(*DENSE), budget_cfg(P), P.ecfg(fused))
    t = svc.submit(P.request("a", P.query.triangle(), match_budget=10))
    svc.run_until_idle()
    assert t.status == "budget_exceeded" and 10 <= t.count < total
    assert svc.pool.leased_cells == 0
    return observe(svc, [t])


def tenant_default_match_budget_applies(P, fused):
    total = oracle(*DENSE, "triangle")
    svc = P.service(P.graph(*DENSE), budget_cfg(P), P.ecfg(fused),
                    tenants={"capped": P.svc.TenantBudget(max_matches=10)})
    t = svc.submit(P.request("capped", P.query.triangle()))
    u = svc.submit(P.request("free", P.query.triangle()))
    svc.run_until_idle()
    assert t.status == "budget_exceeded" and t.count < total
    assert u.status == "done" and u.count == total
    return observe(svc, [t, u])


def three_tenant_mixed_queries_match_oracle(P, fused):
    svc = P.service(P.graph(*G), P.scfg(tick_steps=1, max_active=3), P.ecfg(fused))
    mix = [("alice", "q1"), ("bob", "q2"), ("carol", "q3")]
    tickets = [svc.submit(P.request(t, q)) for t, q in mix]
    svc.tick()
    assert all(t.status == "running" for t in tickets)
    svc.run_until_idle()
    for ticket, (_, qname) in zip(tickets, mix):
        isolated = P.engine(P.graph(*G), P.ecfg(fused)).run(P.query.PAPER_QUERIES[qname]).count
        assert ticket.status == "done"
        assert ticket.count == isolated == oracle(*G, qname)
        assert ticket.latency_s > 0 and ticket.stats.batches > 0
    return observe(svc, tickets)


def latency_is_per_request_not_per_service(P, fused):
    svc = P.service(P.graph(*G), P.scfg(max_active=1), P.ecfg(fused))
    t1 = svc.submit(P.request("a", "q1"))
    t2 = svc.submit(P.request("b", "q1"))
    svc.run_until_idle()
    assert t2.queue_wait_s >= (t1.finished_at - t2.submitted_at) - 1e-6
    assert t2.latency_s >= t2.queue_wait_s
    return observe(svc, [t1, t2])


def chaos_engine_cfg(P, fused, **kw):
    return P.ecfg(fused, batch_size=128, queue_capacity=1 << 14,
                  join_buffer_capacity=1 << 16, **kw)


def lease_oom_is_transient(P, fused):
    svc = P.service(P.graph(*G), P.scfg(faults=P.plan("lease-oom", op="admit", at_step=0)),
                    chaos_engine_cfg(P, fused))
    t = svc.submit(P.request("a", "q1"))
    svc.run_until_idle()
    assert t.status == "done" and t.count == oracle(*G, "q1")
    assert any("lease-oom" in f for f in t.failures)
    assert svc.pool.leased_cells == 0
    return observe(svc, [t])


def crash_releases_lease_and_inflight(P, fused):
    ecfg = chaos_engine_cfg(P, fused, faults=P.plan("queue-overflow", op="scan", at_step=1))
    svc = P.service(P.graph(*G), P.scfg(max_retries=0), ecfg)
    t = svc.submit(P.request("a", "q1"))
    svc.run_until_idle()
    assert t.status == "failed" and "queue-overflow" in t.error and t.failures
    assert svc.pool.leased_cells == 0
    assert svc.tenant_usage("a") == {"inflight": 0, "queue_cells": 0}
    assert not svc.active and not svc.admission
    return observe(svc, [t])


def retries_with_backoff_and_succeeds(P, fused):
    ecfg = chaos_engine_cfg(P, fused, faults=P.plan("queue-overflow", op="scan", at_step=1))
    svc = P.service(P.graph(*G), P.scfg(max_retries=2, retry_backoff_ticks=1), ecfg)
    t = svc.submit(P.request("a", "q1"))
    svc.run_until_idle()
    assert t.status == "done" and t.count == oracle(*G, "q1")
    assert t.attempts == 2 and len(t.failures) == 1
    assert svc.pool.leased_cells == 0
    return observe(svc, [t])


def checkpoint_degrades_in_place(P, fused):
    ecfg = chaos_engine_cfg(P, fused, faults=P.plan("queue-overflow", op="ext", at_step=6))
    svc = P.service(P.graph(*G), P.scfg(checkpoint_every_ticks=1, tick_steps=4), ecfg)
    t = svc.submit(P.request("a", "q1"))
    svc.run_until_idle()
    assert t.status == "done" and t.count == oracle(*G, "q1")
    assert t.attempts == 1 and t.stats.pressure_events >= 1
    assert svc.pool.leased_cells == 0
    return observe(svc, [t])


def deadline_times_out(P, fused):
    svc = P.service(P.graph(*G), P.scfg(), chaos_engine_cfg(P, fused))
    t = svc.submit(P.request("a", "q1", deadline_s=0.0))
    svc.run_until_idle()
    assert t.status == "timed_out" and t.error
    assert svc.pool.leased_cells == 0 and svc.tenant_usage("a")["inflight"] == 0
    return observe(svc, [t])


def snapshot_restore_resumes_running_and_standing(P, fused):
    g = P.graph(*G)
    svc = P.service(g, P.scfg(checkpoint_every_ticks=1, tick_steps=4), chaos_engine_cfg(P, fused))
    sq = svc.register_standing("s", "q2")
    sq.total_count = 41
    t0 = svc.submit(P.request("a", "q1"))
    for _ in range(6):
        svc.tick()
    assert svc.active
    snap = svc.snapshot()
    assert snap["running"] and snap["standing"]
    svc2 = P.restore(g, snap, P.scfg(checkpoint_every_ticks=1))
    assert svc2.standing[0].total_count == 41
    svc2.run_until_idle()
    assert svc2.pool.leased_cells == 0
    svc3 = P.service(g, P.scfg(), chaos_engine_cfg(P, fused))
    req, flow, sess_snap = snap["running"][0]
    t = svc3.resume(req, flow, sess_snap)
    svc3.run_until_idle()
    assert t.status == "done" and t.count == oracle(*G, "q1")
    return (observe(svc, [t0]), observe(svc2), observe(svc3, [t]),
            [(a, q.name, b, n) for a, q, b, n in snap["standing"]], len(snap["running"]))


def standing_queries_see_deltas(P, fused):
    n = 150
    rng = np.random.default_rng(9)
    und = set()
    while len(und) < 600:
        a, b = rng.integers(0, n, 2)
        if a != b:
            und.add((min(a, b), max(a, b)))
    und = np.array(sorted(und))
    rng.shuffle(und)
    base, stream = und[:480], und[480:]
    g0 = P.build_graph(base, n)
    svc = P.service(g0, P.svc.ServiceConfig(), P.ecfg(fused, batch_size=128))
    sq1 = svc.register_standing("alice", "q1")
    sq2 = svc.register_standing("bob", "q2")
    t = svc.submit(P.request("carol", "q1"))
    svc.run_until_idle()
    assert t.status == "done"
    totals = [0, 0]
    outs = []
    for chunk in np.array_split(stream, 3):
        out = svc.apply_batch(P.storage.GraphUpdateBatch(chunk))
        assert out["new_edges"] == chunk.shape[0]
        totals[0] += out["deltas"][sq1.id]
        totals[1] += out["deltas"][sq2.id]
        outs.append((out["new_edges"], out["touched_vertices"], out["deltas"],
                     [ticket_view(x) for x in out["tickets"]]))
    cfg = P.ecfg(fused, batch_size=128)
    g_ref0, g_refn = st_ref.build_graph(base, n), st_ref.build_graph(und, n)
    for qname, total in (("q1", totals[0]), ("q2", totals[1])):
        q = P.query.PAPER_QUERIES[qname]
        before = P.engine(g0, cfg).run(q).count
        after = P.engine(svc.engine.graph, cfg).run(q).count
        assert total == after - before
        edges = list(query_ref.PAPER_QUERIES[qname].edges)
        assert total == count_instances(g_refn, edges) - count_instances(g_ref0, edges)
    assert sq1.total_count == totals[0] and sq2.total_count == totals[1]
    assert len(sq1.history) == 3
    assert svc.unregister_standing(sq2)
    out = svc.apply_batch(P.storage.GraphUpdateBatch(und[:2]))
    assert out["new_edges"] == 0 and out["deltas"] == {sq1.id: 0}
    return observe(svc, [t]), outs, totals


def flowcheck_svc(P, fused):
    return P.service(P.graph(*G), P.scfg(), P.ecfg(fused))


def rejects_malformed_dataflow_at_admission(P, fused):
    svc = flowcheck_svc(P, fused)
    t = svc.submit(P.request("adv", P.fixtures.bad_join_key_flow()))
    assert t.status == "queued"
    svc.tick()
    assert t.status == "rejected" and "flowcheck" in t.error
    assert any(d.rule == "join-key-incompatible" for d in t.diagnostics)
    assert svc.pool.leased_cells == 0 and svc.tenant_usage("adv")["inflight"] == 0
    assert not svc.active
    return observe(svc, [t])


def rejects_disconnected_plan_at_admission(P, fused):
    svc = flowcheck_svc(P, fused)
    t = svc.submit(P.request("adv", P.fixtures.disconnected_plan()))
    svc.tick()
    assert t.status == "rejected"
    assert any(d.rule == "subquery-disconnected" for d in t.diagnostics)
    assert svc.pool.leased_cells == 0
    return observe(svc, [t])


def still_serves_good_tenants_after_rejection(P, fused):
    svc = flowcheck_svc(P, fused)
    bad = svc.submit(P.request("adv", P.fixtures.pull_join_flow()))
    good = svc.submit(P.request("ok", "q1"))
    svc.run_until_idle()
    assert bad.status == "rejected"
    assert any(d.rule == "comm-illegal" for d in bad.diagnostics)
    assert good.status == "done" and good.count == oracle(*G, "q1")
    assert svc.pool.leased_cells == 0
    return observe(svc, [bad, good])


SCENARIOS = [
    admission_queue_rejects_at_capacity,
    tenant_inflight_cap_rejects,
    unknown_query_rejected,
    oversized_query_rejected,
    pool_fits_one_query_at_a_time,
    tenant_cell_cap_serialises_that_tenant_only,
    match_budget_stops_query_early,
    tenant_default_match_budget_applies,
    three_tenant_mixed_queries_match_oracle,
    latency_is_per_request_not_per_service,
    lease_oom_is_transient,
    crash_releases_lease_and_inflight,
    retries_with_backoff_and_succeeds,
    checkpoint_degrades_in_place,
    deadline_times_out,
    snapshot_restore_resumes_running_and_standing,
    standing_queries_see_deltas,
    rejects_malformed_dataflow_at_admission,
    rejects_disconnected_plan_at_admission,
    still_serves_good_tenants_after_rejection,
]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_service_equals_reference(scenario, fused):
    assert_same(scenario, fused)


# ---------------------------------------------------------------------------
# The scenarios that need no service: the tick primitive, flow merging, the pool
# ---------------------------------------------------------------------------

class _TickOp:
    def __init__(self, n):
        self.label = "op"
        self.inbox = n
        self.runs = 0

    def has_input(self):
        return self.inbox > 0

    def output_free(self):
        return 1 << 30

    def required_slack(self):
        return 1

    def run_one(self):
        self.inbox -= 1
        self.runs += 1


def test_scheduler_max_steps_budget_and_resume():
    for P in (REF, PT):
        op = _TickOp(10)
        st = P.sched.AdaptiveScheduler([op]).run(max_steps=3)
        assert st.steps == 3 and not st.completed and op.inbox == 7
        st2 = P.sched.AdaptiveScheduler([op]).run()
        assert st2.completed and op.inbox == 0 and op.runs == 10


def test_merge_flows_reindexes_and_keeps_sinks():
    got = {}
    for P in (REF, PT):
        eng = P.engine(P.graph(*G))
        f1 = eng.to_flow(P.query.PAPER_QUERIES["q1"])
        f2 = eng.to_flow(P.query.PAPER_QUERIES["q3"])
        merged, tenant_of_op = P.df.merge_flows([f1, f2])
        assert merged.sink_indices() == (len(f1.ops) - 1, len(merged.ops) - 1)
        assert tenant_of_op == tuple([0] * len(f1.ops) + [1] * len(f2.ops))
        off = len(f1.ops)
        for i, op in enumerate(merged.ops[off:]):
            assert op.inputs == tuple(j + off for j in f2.ops[i].inputs)
        cells = P.eng.flow_queue_cells(merged, eng.cfg, eng.d_pad)
        assert cells == (P.eng.flow_queue_cells(f1, eng.cfg, eng.d_pad)
                         + P.eng.flow_queue_cells(f2, eng.cfg, eng.d_pad))
        got[P.name] = (merged.describe(), tenant_of_op, cells)
    assert got["pt"] == got["ref"]


def test_queue_slot_pool_over_release_is_an_error():
    for P in (REF, PT):
        pool = P.eng.QueueSlotPool(1000)
        assert pool.try_lease(100)
        with pytest.raises(RuntimeError, match="over-release"):
            pool.release(200)
        assert pool.leased_cells == 0


# ---------------------------------------------------------------------------
# Departures: retired sessions free their buffers; a real KernelFault propagates
# ---------------------------------------------------------------------------

def _retire(P, how):
    """One q1 request that finishes, is cancelled mid-run, or fails without
    retry (an injected queue-overflow at its second scan batch)."""
    faults = P.plan("queue-overflow", op="scan", at_step=1) if how == "fail" else None
    svc = P.service(P.graph(*G), P.scfg(tick_steps=2, max_retries=0),
                    chaos_engine_cfg(P, False, faults=faults))
    t = svc.submit(P.request("a", "q1"))
    if how == "cancel":
        svc.tick()
        assert t.status == "running"
        assert svc.cancel(t)
    else:
        svc.run_until_idle()
    assert t.status == {"finish": "done", "cancel": "cancelled", "fail": "failed"}[how]
    return observe(svc, [t])


@pytest.mark.parametrize("how", ["finish", "cancel", "fail"])
def test_retired_session_frees_its_buffers_without_gc(monkeypatch, how):
    made = []

    class Watched(eng_pt.EngineSession):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append([weakref.ref(self)]
                        + [weakref.ref(q.buf) for q in self.queues.values()])

    monkeypatch.setattr(svc_pt, "EngineSession", Watched)
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        got = _retire(PT, how)
        assert made and all(len(refs) > 1 for refs in made)
        alive = [r for refs in made for r in refs if r() is not None]
        assert not alive, f"{len(alive)} session objects or queue buffers outlived retirement"
    finally:
        if was_enabled:
            gc.enable()
    assert got == _retire(REF, how)


def test_real_kernel_fault_propagates_with_the_lease_returned(monkeypatch):
    """A kernel that fails to launch is not a ticket outcome: ``tick``
    re-raises its ``KernelFault`` after returning the session's lease, slot
    and tenant accounting; the other tenants' sessions run on."""
    real = ops_pt.fused_extend_batch
    calls = []

    def broken_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise faults_pt.KernelFault("fused_extend failed to launch")
        return real(*args, **kwargs)

    monkeypatch.setattr(ops_pt, "fused_extend_batch", broken_once)
    svc = PT.service(PT.graph(*G), PT.scfg(tick_steps=4), PT.ecfg(True))
    t1 = svc.submit(PT.request("a", "q1"))
    t2 = svc.submit(PT.request("b", "q2"))
    with pytest.raises(faults_pt.KernelFault, match="failed to launch") as ei:
        svc.tick()
    assert not ei.value.recoverable
    victim, other = (t1, t2) if t1.queue_cells == 0 else (t2, t1)
    assert victim.status == "running" and victim.queue_cells == 0
    assert "failed to launch" in victim.error and victim.failures == []
    assert [a.ticket for a in svc.active] == [other]
    assert svc.pool.leased_cells == other.queue_cells
    assert svc.tenant_usage(victim.request.tenant) == {"inflight": 0, "queue_cells": 0}
    svc.run_until_idle()
    assert other.status == "done" and other.count == oracle(*G, other.request.query)
    assert svc.pool.leased_cells == 0


# ---------------------------------------------------------------------------
# Entry points on the CPU
# ---------------------------------------------------------------------------

def _run(args):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          cwd=ROOT, timeout=300,
                          env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})


def test_serve_graph_cli_on_cpu():
    proc = _run(["repro_torch.launch.serve", "graph", "--vertices", "256", "--tenants", "2",
                 "--requests", "1", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if "->" in ln]
    assert len(lines) == 2
    for ln, q in zip(lines, ("q1", "q2")):
        assert "-> done" in ln
        assert f"count={oracle(256, 6.0, 7, q)} " in ln
    assert "p50" in proc.stdout and "matches/s" in proc.stdout


def test_service_load_smoke_on_cpu(tmp_path):
    out = tmp_path / "BENCH_torch_service.json"
    proc = _run(["repro_torch.launch.service_load", "--smoke", "--device", "cpu",
                 "--out", str(out)])
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.read_text())
    assert doc["bench"] == "torch_service" and len(doc["entries"]) == 1
    e = doc["entries"][0]
    assert e["case"] == "T2xR1_v256" and e["matches"] == 3040 and e["requests"] == 2
    assert e["device"] == "cpu" and "power_limit" in e and e["fused"] is False
    assert e["peak_pool_cells"] == 533504 and e["ticks"] == 2  # BENCH_service.json's


def test_graph_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    from repro_torch.launch import serve, service_load

    g = gen_pt.powerlaw_graph(64, 4.0, seed=0, device="cpu")
    for call in (lambda: svc_pt.GraphService(g),
                 lambda: serve.main(["graph", "--vertices", "64"]),
                 lambda: service_load.main(["--smoke"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
