"""The PyTorch port's engine end to end on the CPU, against the networkx
oracle's counts and the JAX engine's statistics, on
powerlaw_graph(512, 6.0, seed=0) (both packages build it identically)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as eng_ref
from repro.core.query import PAPER_QUERIES as Q_REF
from repro.graph import generators as gen_ref
from repro_torch.core import engine as eng_pt
from repro_torch.core.query import PAPER_QUERIES as Q_PT
from repro_torch.graph import generators as gen_pt
from repro_torch.kernels.intersect import ops as ik


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is faster, and test
    workers that share the cores do not oversubscribe them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# networkx oracle counts on powerlaw_graph(512, 6.0, seed=0)
# (repro.graph.oracle.count_instances; the graph tests hold the port's
# oracle equal to it)
ORACLE = {"q1": 4361, "q2": 2551, "q3": 84}


@pytest.fixture(scope="module")
def g_pt():
    return gen_pt.powerlaw_graph(512, 6.0, seed=0, device="cpu")


@pytest.fixture(scope="module")
def g_ref():
    return gen_ref.powerlaw_graph(512, 6.0, seed=0)


STAT_FIELDS = ("count", "pulled_bytes", "pushed_bytes", "cache_hits", "cache_misses",
               "peak_queue_rows", "peak_queue_bytes", "batches", "rows_emitted")

# 2^15 output rows per join probe hold the largest probe of every query run
# below on these graphs (an overflow would raise); the default 2^18 makes each
# probe eight times as much work on the CPU.
JOIN_OUT = 1 << 15


@pytest.mark.parametrize("space", ["huge", "seed", "rads"])
@pytest.mark.parametrize("qname", ["q1", "q2", "q3"])
def test_counts_equal_oracle(g_pt, qname, space):
    cfg = eng_pt.EngineConfig(fused=True, join_out_capacity=JOIN_OUT)
    res = eng_pt.HugeEngine(g_pt, cfg, device="cpu").run(Q_PT[qname], space=space)
    assert res.count == ORACLE[qname]


# JAX engine counts (repro.core.engine, fused=True, space huge) on
# powerlaw_graph(128, 6.0, seed=0); the networkx oracle gives the same.
SMALL_GRAPH_COUNTS = {"q4": 3912, "q5": 12320, "q6": 0, "q7": 222908, "q8": 6106}


@pytest.mark.parametrize("qname", sorted(SMALL_GRAPH_COUNTS))
def test_counts_q4_to_q8_equal_reference(qname):
    """Counts, communication and memory statistics equal the JAX engine's."""
    g = gen_pt.powerlaw_graph(128, 6.0, seed=0, device="cpu")
    cfg = dict(fused=True, join_out_capacity=JOIN_OUT)
    res = eng_pt.HugeEngine(g, eng_pt.EngineConfig(**cfg), device="cpu").run(Q_PT[qname])
    assert res.count == SMALL_GRAPH_COUNTS[qname]
    r_ref = eng_ref.HugeEngine(gen_ref.powerlaw_graph(128, 6.0, seed=0),
                               eng_ref.EngineConfig(**cfg)).run(Q_REF[qname])
    for f in STAT_FIELDS:
        assert getattr(res.stats, f) == getattr(r_ref.stats, f), f
    assert res.schedule.steps == r_ref.schedule.steps


@pytest.mark.parametrize("space", ["huge", "seed", "rads"])
def test_q6_five_cliques_on_ring_of_cliques(space):
    g = gen_pt.ring_of_cliques(4, 6, device="cpu")  # 4 six-cliques: 4 * C(6, 5) = 24
    res = eng_pt.HugeEngine(g, eng_pt.EngineConfig(fused=True), device="cpu").run(
        Q_PT["q6"], space=space)
    assert res.count == 24


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("qname,space", [("q1", "huge"), ("q3", "rads")])
def test_stats_and_matches_equal_reference(g_pt, g_ref, qname, space, fused):
    cfg = dict(fused=fused, materialize=True)
    r_ref = eng_ref.HugeEngine(g_ref, eng_ref.EngineConfig(**cfg)).run(Q_REF[qname], space=space)
    r_pt = eng_pt.HugeEngine(g_pt, eng_pt.EngineConfig(**cfg), device="cpu").run(
        Q_PT[qname], space=space)
    for f in STAT_FIELDS:
        assert getattr(r_pt.stats, f) == getattr(r_ref.stats, f), f
    assert r_pt.schedule.steps == r_ref.schedule.steps
    np.testing.assert_array_equal(r_pt.matches, r_ref.matches)  # same rows, same order


def test_use_intersect_kernel_and_cache_policies(g_pt):
    counts = set()
    for cfg in (eng_pt.EngineConfig(use_intersect_kernel=True),
                eng_pt.EngineConfig(cache_policy="lru"),
                eng_pt.EngineConfig(cache_policy="direct"),
                eng_pt.EngineConfig(cache_capacity=0, fused=True)):
        counts.add(eng_pt.HugeEngine(g_pt, cfg, device="cpu").run(Q_PT["q3"]).count)
    assert counts == {ORACLE["q3"]}


def test_enumerate_query_and_no_kernel_launch_on_cpu(g_pt):
    ik.reset_launches()
    res = eng_pt.enumerate_query(
        g_pt, Q_PT["q2"], eng_pt.EngineConfig(fused=True, join_out_capacity=JOIN_OUT),
        space="rads", device="cpu")
    assert res.count == ORACLE["q2"]
    assert all(n == 0 for n in ik.launches.values())


def test_route_requests_matches_reference():
    rng = np.random.default_rng(0)
    vids = rng.integers(0, 100, 64).astype(np.int32)
    machs = rng.integers(0, 8, 64).astype(np.int32)
    valid = rng.random(64) < 0.7
    r_ref, c_ref = eng_ref.route_requests(jnp.asarray(vids), jnp.asarray(machs),
                                          jnp.asarray(valid), 8, 100, 64)
    r_pt, c_pt = eng_pt.route_requests(torch.from_numpy(vids), torch.from_numpy(machs),
                                       torch.from_numpy(valid), 8, 100, 64)
    np.testing.assert_array_equal(r_pt.numpy(), np.asarray(r_ref))
    np.testing.assert_array_equal(c_pt.numpy(), np.asarray(c_ref))


def test_queue_plan_matches_reference():
    from repro.core.cost import GraphStats as GS_ref
    from repro.core.dataflow import translate as tr_ref
    from repro.core.optimizer import optimal_plan as op_ref
    from repro_torch.core.cost import GraphStats as GS_pt
    from repro_torch.core.dataflow import translate as tr_pt
    from repro_torch.core.optimizer import optimal_plan as op_pt

    for qname, space in (("q2", "seed"), ("q5", "huge"), ("q3", "rads")):
        f_ref = tr_ref(op_ref(Q_REF[qname], GS_ref.synthetic(2048, 6.0), 8, space))
        f_pt = tr_pt(op_pt(Q_PT[qname], GS_pt.synthetic(2048, 6.0), 8, space))
        assert eng_pt._queue_plan(f_pt, eng_pt.EngineConfig(), 256) == \
            eng_ref._queue_plan(f_ref, eng_ref.EngineConfig(), 256)


def test_engine_config_fields_equal_reference_minus_force_kernel():
    """Every field of the reference's config, with its default, except
    ``force_kernel`` (Pallas interpret mode; the port dispatches by device)."""
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    ref = fields(eng_ref.EngineConfig)
    del ref["force_kernel"]
    assert fields(eng_pt.EngineConfig) == ref
    assert {f.name for f in dataclasses.fields(eng_pt.EngineStats)} == \
        {f.name for f in dataclasses.fields(eng_ref.EngineStats)}


@pytest.mark.parametrize("qname,space", [("q1", "huge"), ("q2", "seed")])
def test_per_machine_rows_equal_reference(g_pt, g_ref, qname, space):
    """Under ``track_balance`` the result rows per simulated machine equal
    the JAX engine's; they sum to the count, and like the reference's they
    add up over the runs of one engine."""
    cfg = dict(fused=True, join_out_capacity=JOIN_OUT)
    e_pt = eng_pt.HugeEngine(g_pt, eng_pt.EngineConfig(**cfg), device="cpu",
                             track_balance=True)
    e_ref = eng_ref.HugeEngine(g_ref, eng_ref.EngineConfig(**cfg), track_balance=True)
    for run in (1, 2):
        r_pt = e_pt.run(Q_PT[qname], space=space)
        r_ref = e_ref.run(Q_REF[qname], space=space)
        rows = r_pt.stats.per_machine_rows
        assert rows.dtype == r_ref.stats.per_machine_rows.dtype
        np.testing.assert_array_equal(rows, r_ref.stats.per_machine_rows)
        assert int(rows.sum()) == run * ORACLE[qname]
    untracked = eng_pt.HugeEngine(g_pt, eng_pt.EngineConfig(**cfg), device="cpu").run(
        Q_PT[qname], space=space)
    assert not untracked.stats.per_machine_rows.any()


def test_fault_tolerant_queue_pricing_matches_reference():
    from repro.core.cost import GraphStats as GS_ref
    from repro.core.dataflow import delta_flows as delta_ref, merge_flows as merge_ref
    from repro.core.dataflow import translate as tr_ref
    from repro.core.faults import FaultPlan as FP_ref
    from repro.core.optimizer import optimal_plan as op_ref
    from repro_torch.core.cost import GraphStats as GS_pt
    from repro_torch.core.dataflow import delta_flows as delta_pt, merge_flows as merge_pt
    from repro_torch.core.dataflow import translate as tr_pt
    from repro_torch.core.faults import FaultPlan as FP_pt
    from repro_torch.core.optimizer import optimal_plan as op_pt

    for qname, space in (("q2", "seed"), ("q5", "huge"), ("q1", "starjoin")):
        p_ref = op_ref(Q_REF[qname], GS_ref.synthetic(2048, 6.0), 8, space)
        p_pt = op_pt(Q_PT[qname], GS_pt.synthetic(2048, 6.0), 8, space)
        for f_ref, f_pt in ((tr_ref(p_ref), tr_pt(p_pt)),
                            (merge_ref(delta_ref(p_ref))[0], merge_pt(delta_pt(p_pt))[0])):
            for recover in (True, False):
                c_ref = eng_ref.EngineConfig(faults=FP_ref.single("shard-loss"), recover=recover)
                c_pt = eng_pt.EngineConfig(faults=FP_pt.single("shard-loss"), recover=recover)
                assert eng_pt.fault_tolerant_sizing(c_pt) == eng_ref.fault_tolerant_sizing(c_ref)
                for ft in (None, True, False):
                    assert eng_pt._queue_plan(f_pt, c_pt, 128, fault_tolerant=ft) == \
                        eng_ref._queue_plan(f_ref, c_ref, 128, fault_tolerant=ft)
                    assert eng_pt.flow_queue_cells(f_pt, c_pt, 128, 1 << 10, 1 << 12, ft) == \
                        eng_ref.flow_queue_cells(f_ref, c_ref, 128, 1 << 10, 1 << 12, ft)


def test_hybrid_comm_decisions_equal_reference():
    """The Eq.-3 rule and its MoE and vocab forms on a seeded grid of inputs:
    every field of every decision equal (the same float arithmetic)."""
    import dataclasses as dc

    from repro.core import hybrid_comm as hc_ref
    from repro_torch.core import hybrid_comm as hc_pt

    rng = np.random.default_rng(0)
    modes = set()
    for _ in range(200):
        rows = rng.lognormal(10, 4, 2)
        kw = dict(left_rows=float(rows[0]), right_rows=float(rows[1]),
                  width_left=int(rng.integers(2, 8)), width_right=int(rng.integers(2, 8)),
                  graph_edges=float(rng.lognormal(12, 2)), machines=int(rng.integers(1, 65)))
        a, b = hc_pt.enum_join_mode(**kw), hc_ref.enum_join_mode(**kw)
        assert dc.astuple(a) == dc.astuple(b) and a.ratio == b.ratio
        modes.add(a.mode)
        kw = dict(tokens_per_step=int(rng.integers(1, 1 << 22)), d_model=int(rng.integers(64, 8192)),
                  d_ff=int(rng.integers(64, 32768)), num_experts=int(rng.integers(1, 257)),
                  experts_per_token=int(rng.integers(1, 9)), dp_degree=int(rng.integers(1, 65)),
                  backward=bool(rng.integers(2)))
        assert dc.astuple(hc_pt.moe_dispatch_mode(**kw)) == dc.astuple(hc_ref.moe_dispatch_mode(**kw))
        kw = dict(tokens_per_step=int(rng.integers(1, 1 << 20)), d_model=int(rng.integers(64, 8192)),
                  vocab_size=int(rng.integers(1000, 300000)), tp_degree=int(rng.integers(1, 65)))
        assert dc.astuple(hc_pt.vocab_mode(**kw)) == dc.astuple(hc_ref.vocab_mode(**kw))
    assert modes == {"push", "pull"}  # the grid reaches both sides of the rule


def test_table4_runner_on_cpu(tmp_path, capsys):
    """The table4 runner at a reduced graph: fused and plain counts equal
    (the oracle's), one entry per run, written only where ``--out`` says."""
    import json

    from repro_torch.launch import table4

    out = tmp_path / "BENCH_torch_table4.json"
    entries = table4.main(["--device", "cpu", "--vertices", "512", "--avg-degree", "6",
                           "--seed", "0", "--out", str(out)])
    assert [(e["case"], e["mode"]) for e in entries] == [
        (q, m) for q in ("q1", "q2", "q3") for m in ("unfused", "fused")]
    for e in entries:
        assert e["matches"] == ORACLE[e["case"]] and e["device"] == "cpu"
        assert sum(e["per_machine_rows"]) == e["matches"]
    doc = json.loads(out.read_text())
    assert [e["matches"] for e in doc["entries"]] == [e["matches"] for e in entries]
    assert "table4/q3/fused" in capsys.readouterr().out


def test_queue_overflow_raises_queue_pressure(g_pt):
    from repro_torch.core.faults import QueuePressure

    q = eng_pt.DeviceQueue(4, 2, torch.device("cpu"), label="EXT", query="q")
    q.append(torch.zeros((8, 2), dtype=torch.int32), 3)
    with pytest.raises(QueuePressure) as err:
        q.append(torch.zeros((8, 2), dtype=torch.int32), 2)
    assert err.value.kind == "queue-overflow" and err.value.op == "EXT"


def test_cli_runs_on_cpu(capsys):
    from repro_torch.launch import enumerate as cli

    count = cli.main(["--query", "q3", "--vertices", "512", "--avg-degree", "6",
                      "--seed", "0", "--batch-size", "256", "--device", "cpu"])
    assert count == ORACLE["q3"]
    assert "count=84" in capsys.readouterr().out
