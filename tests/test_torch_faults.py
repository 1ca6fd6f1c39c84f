"""The port's fault injection and recovery ladder against the JAX engine's,
on the CPU: the single-process rows of the reference's chaos matrix, with
counts held to the networkx oracle and every statistic (the recovery
counters included) held equal to the reference's, on the chaos matrix's
graph, powerlaw_graph(256, 5.0, seed=3). (A recovery halves the batch, and
each new batch shape costs the JAX engine a compile: this graph keeps the
matrix inside the suite's time.)"""
import numpy as np
import pytest
import torch

from repro.core import engine as eng_ref
from repro.core import faults as faults_ref
from repro.core.query import PAPER_QUERIES as Q_REF
from repro.graph import generators as gen_ref
from repro_torch.core import engine as eng_pt
from repro_torch.core import faults as faults_pt
from repro_torch.core import operators as ops_pt
from repro_torch.core.query import PAPER_QUERIES as Q_PT
from repro_torch.graph import generators as gen_pt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# networkx oracle counts on powerlaw_graph(256, 5.0, seed=3)
# (repro.graph.oracle.count_instances)
ORACLE = {"q1": 1268, "q2": 819, "q3": 29}
QUERIES = tuple(ORACLE)
# Join probes of 2^15 rows hold every probe below (see test_torch_engine.py).
JOIN_OUT = 1 << 15
STAT_FIELDS = ("count", "pulled_bytes", "pushed_bytes", "cache_hits", "cache_misses",
               "batches", "rows_emitted", "peak_queue_rows", "peak_queue_bytes",
               "join_overflows", "kernel_fallbacks", "pressure_events", "retries",
               "restarts")


@pytest.fixture(scope="module")
def g_pt():
    return gen_pt.powerlaw_graph(256, 5.0, seed=3, device="cpu")


@pytest.fixture(scope="module")
def g_ref():
    return gen_ref.powerlaw_graph(256, 5.0, seed=3)


def cfg_kw(**kw):
    base = dict(batch_size=128, queue_capacity=1 << 14, join_buffer_capacity=1 << 16,
                join_out_capacity=JOIN_OUT)
    base.update(kw)
    return base


def run_both(g_ref, g_pt, qname, space="huge", fault=None, **kw):
    """The same query under the same config and fault plan through both
    engines. Returns ``(ref result, port result, ref plan, port plan)``."""
    fp_ref = fp_pt = None
    if fault is not None:
        fp_ref = faults_ref.FaultPlan.single(*fault)
        fp_pt = faults_pt.FaultPlan.single(*fault)
    r_ref = eng_ref.HugeEngine(g_ref, eng_ref.EngineConfig(**cfg_kw(faults=fp_ref, **kw))).run(
        Q_REF[qname], space=space)
    r_pt = eng_pt.HugeEngine(g_pt, eng_pt.EngineConfig(**cfg_kw(faults=fp_pt, **kw)),
                             device="cpu").run(Q_PT[qname], space=space)
    return r_ref, r_pt, fp_ref, fp_pt


def assert_same_run(r_ref, r_pt):
    for f in STAT_FIELDS:
        assert getattr(r_pt.stats, f) == getattr(r_ref.stats, f), f
    assert r_pt.schedule.steps == r_ref.schedule.steps


# ---------------------------------------------------------------------------
# fault plan determinism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", faults_pt.FAULT_KINDS)
def test_fault_plan_fires_where_the_reference_fires(kind):
    assert faults_pt.FAULT_KINDS == faults_ref.FAULT_KINDS
    for seed in range(6):
        a = faults_pt.FaultPlan.single(kind, seed=seed, times=2)
        b = faults_ref.FaultPlan.single(kind, seed=seed, times=2)
        fires = [a.should_fire(kind, "SCAN(0, 1)") for _ in range(12)]
        assert fires == [b.should_fire(kind, "SCAN(0, 1)") for _ in range(12)]
        assert sum(fires) == 2 and a.fired == b.fired and a.fired_count(kind) == 2
        a.reset()
        assert [a.should_fire(kind, "SCAN(0, 1)") for _ in range(12)] == fires


def test_fault_plan_env_and_validation():
    assert faults_pt.FaultPlan.from_env({}) is None
    fp = faults_pt.FaultPlan.from_env({"REPRO_FAULT_KIND": "shard-loss",
                                       "REPRO_FAULT_SEED": "7",
                                       "REPRO_FAULT_OP": "scan",
                                       "REPRO_FAULT_STEP": "2"})
    assert fp.seed == 7 and fp.specs[0] == faults_pt.FaultSpec("shard-loss", "scan", 2)
    with pytest.raises(ValueError):
        faults_pt.FaultSpec("not-a-kind")
    op_plan = faults_pt.FaultPlan.single("queue-overflow", op="ext", at_step=0)
    assert not op_plan.should_fire("queue-overflow", "SCAN(0, 1)")
    assert op_plan.should_fire("queue-overflow", "EXT(v2|ext=(0,))")  # case-insensitive


# ---------------------------------------------------------------------------
# single-process engine: the recovery ladder, case by case against the JAX engine
# ---------------------------------------------------------------------------

# (fault kind, plan space, fused, the counter the recovery must raise)
LADDER = [
    ("queue-overflow", "huge", False, "pressure_events"),
    ("shard-loss", "huge", False, "restarts"),
    ("kernel-fail", "huge", True, "kernel_fallbacks"),
    ("join-overflow", "starjoin", True, "pressure_events"),
]


@pytest.mark.parametrize("qname", QUERIES)
@pytest.mark.parametrize("kind,space,fused,counter", LADDER, ids=[c[0] for c in LADDER])
def test_engine_recovers_like_the_reference(g_ref, g_pt, qname, kind, space, fused, counter):
    r_ref, r_pt, fp_ref, fp_pt = run_both(g_ref, g_pt, qname, space,
                                          fault=(kind, "*", 1), fused=fused)
    assert fp_pt.fired == fp_ref.fired and fp_pt.fired_count(kind) == 1
    assert r_pt.count == ORACLE[qname]
    assert getattr(r_pt.stats, counter) == 1
    if kind == "kernel-fail":
        assert r_pt.stats.retries == 0  # the plain path takes the batch: no restore
    else:
        assert r_pt.stats.retries == 1
    assert_same_run(r_ref, r_pt)


def test_engine_fault_is_structured_when_recovery_disabled(g_pt):
    fp = faults_pt.FaultPlan.single("queue-overflow", at_step=0)
    eng = eng_pt.HugeEngine(g_pt, eng_pt.EngineConfig(**cfg_kw(faults=fp, recover=False)),
                            device="cpu")
    with pytest.raises(faults_pt.QueuePressure) as ei:
        eng.run(Q_PT["q1"])
    f = ei.value
    assert f.kind == "queue-overflow" and f.recoverable
    assert f.op != "?" and f.query == "square"  # attributable


def test_engine_ladder_exhaustion_escalates(g_pt):
    # The fault re-fires on every attempt and the batch floor is the starting
    # batch, so the first halving must escalate structurally.
    fp = faults_pt.FaultPlan.single("queue-overflow", at_step=0, times=100)
    eng = eng_pt.HugeEngine(g_pt, eng_pt.EngineConfig(**cfg_kw(
        batch_size=64, min_batch_size=64, faults=fp, recover=True)), device="cpu")
    with pytest.raises(faults_pt.EnumerationFault) as ei:
        eng.run(Q_PT["q1"])
    assert "recovery ladder exhausted" in str(ei.value)
    assert not ei.value.recoverable


def test_max_retries_bounds_the_ladder(g_pt):
    fp = faults_pt.FaultPlan.single("shard-loss", at_step=0, times=100)
    eng = eng_pt.HugeEngine(g_pt, eng_pt.EngineConfig(**cfg_kw(faults=fp, max_retries=2)),
                            device="cpu")
    with pytest.raises(faults_pt.ShardLoss):
        eng.run(Q_PT["q1"])
    assert fp.fired_count("shard-loss") == 3  # the first run and two retries


def test_organic_queue_overflow_is_recoverable_pressure():
    q = eng_pt.DeviceQueue(capacity=100, width=2, device=torch.device("cpu"),
                           label="EXT(v2)", query="q1")
    with pytest.raises(faults_pt.QueuePressure) as ei:
        q.append(torch.zeros((128, 2), dtype=torch.int32), 128)
    f = ei.value
    assert f.kind == "queue-overflow" and f.recoverable
    assert f.op == "EXT(v2)" and f.query == "q1"


def test_real_kernel_fault_propagates(g_pt, monkeypatch):
    """Only an injected kernel-fail takes the plain path: a kernel that
    fails to build or launch raises through the engine, uncounted."""
    def broken(*args, **kwargs):
        raise faults_pt.KernelFault("fused_extend failed to launch")

    monkeypatch.setattr(ops_pt, "fused_extend_batch", broken)
    fp = faults_pt.FaultPlan.single("queue-overflow", at_step=100)  # recovery armed
    eng = eng_pt.HugeEngine(g_pt, eng_pt.EngineConfig(**cfg_kw(fused=True, faults=fp)),
                            device="cpu")
    with pytest.raises(faults_pt.KernelFault, match="failed to launch") as ei:
        eng.run(Q_PT["q1"])
    assert not ei.value.recoverable
    assert eng.stats.kernel_fallbacks == 0 and eng.stats.retries == 0


# ---------------------------------------------------------------------------
# checkpoint / resume (exactly once)
# ---------------------------------------------------------------------------

def test_snapshot_restore_resumes_exactly_once(g_ref, g_pt):
    def resumed(eng_mod, g, q, **dev):
        eng = eng_mod.HugeEngine(g, eng_mod.EngineConfig(**cfg_kw(materialize=True)), **dev)
        sess = eng.prepare(q)
        sess.tick(6)
        snap = sess.snapshot()
        mid = snap["stats"].batches
        sess.tick(8)  # work after the checkpoint is thrown away by the restore
        back = eng_mod.EngineSession.restore(eng, sess.flow, snap)
        assert back.stats.batches == mid and not back.done()
        back.run()
        return back.result()

    r_pt = resumed(eng_pt, g_pt, Q_PT["q2"], device="cpu")
    r_ref = resumed(eng_ref, g_ref, Q_REF["q2"])
    assert r_pt.count == ORACLE["q2"]
    assert_same_run(r_ref, r_pt)
    np.testing.assert_array_equal(r_pt.matches, r_ref.matches)


def test_periodic_checkpoints_bound_replay(g_ref, g_pt):
    r_ref, r_pt, _, fp_pt = run_both(g_ref, g_pt, "q1", fault=("queue-overflow", "ext", 10),
                                     checkpoint_every_steps=2, materialize=True)
    assert fp_pt.fired_count("queue-overflow") == 1
    assert r_pt.count == ORACLE["q1"] and r_pt.stats.pressure_events == 1
    assert_same_run(r_ref, r_pt)
    np.testing.assert_array_equal(r_pt.matches, r_ref.matches)
