"""Finished runs free their device queues without the cycle collector.

``HugeEngine.run``, ``run_delta`` and ``enumerate_query`` close the session
they drove once its result is read, and ``drive`` closes a session it
restores from; ``DistributedEngine``'s passes hold no reference cycle. With
``gc`` disabled, weak references to every session (or distributed runtime)
and every queue tensor of a run must be dead once the call returns, while
the result, its stats and its matches stay valid.
"""
import gc
import weakref

import numpy as np
import pytest

from repro_torch.core import distributed as dist_pt
from repro_torch.core import engine as eng_pt
from repro_torch.core.faults import FaultPlan
from repro_torch.core.query import PAPER_QUERIES, triangle
from repro_torch.graph import GraphUpdateBatch, powerlaw_graph
from repro_torch.graph.oracle import count_instances

# powerlaw_graph(256, 5.0, seed=3): q1 1268, q2 819, q3 29.
G = (256, 5.0, 3)


@pytest.fixture
def no_gc():
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


@pytest.fixture
def watched(monkeypatch):
    """Weak references to every session the engine builds and to its queue
    tensors, taken when it is built and again when its result is read."""
    refs = []

    class Watched(eng_pt.EngineSession):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            refs.append(weakref.ref(self))
            refs.extend(weakref.ref(q.buf) for q in self.queues.values())

        def result(self):
            refs.extend(weakref.ref(q.buf) for q in self.queues.values())
            return super().result()

    monkeypatch.setattr(eng_pt, "EngineSession", Watched)
    return refs


def _alive(refs):
    return [r for r in refs if r() is not None]


@pytest.mark.parametrize("fused", [False, True])
def test_enumerate_query_leaves_no_session_or_queue(no_gc, watched, fused):
    g = powerlaw_graph(*G[:2], seed=G[2], device="cpu")
    counts = []
    for qname in ("q1", "q2", "q3", "q1"):
        res = eng_pt.enumerate_query(g, PAPER_QUERIES[qname],
                                     eng_pt.EngineConfig(fused=fused, materialize=True),
                                     device="cpu")
        counts.append(res.count)
        assert res.matches.shape == (res.count, PAPER_QUERIES[qname].num_vertices)
        assert res.stats.count == res.count and res.schedule.steps > 0
    assert len(watched) > 4
    alive = _alive(watched)
    assert not alive, f"{len(alive)} sessions or queue tensors outlived their runs"
    assert counts == [1268, 819, 29, 1268]


def test_engine_runs_and_recovery_leave_no_session_or_queue(no_gc, watched):
    """One engine, several runs, one of them recovering from a fault: the
    engine stays, every session and queue goes (the one restored from too)."""
    g = powerlaw_graph(*G[:2], seed=G[2], device="cpu")
    eng = eng_pt.HugeEngine(g, eng_pt.EngineConfig(), device="cpu", track_balance=True)
    assert eng.run(PAPER_QUERIES["q3"]).count == 29
    fp = FaultPlan.single("queue-overflow", at_step=1)
    faulted = eng_pt.HugeEngine(g, eng_pt.EngineConfig(faults=fp), device="cpu")
    res = faulted.run(PAPER_QUERIES["q1"])
    assert res.count == 1268 and res.stats.retries == 1 and fp.fired_count("queue-overflow") == 1
    assert eng.run(PAPER_QUERIES["q2"]).count == 29 + 819  # an engine's stats accumulate
    assert int(eng.stats.per_machine_rows.sum()) == 29 + 819
    alive = _alive(watched)
    assert not alive, f"{len(alive)} sessions or queue tensors outlived their runs"


def test_unrecoverable_fault_leaves_no_session_or_queue(no_gc, watched):
    g = powerlaw_graph(*G[:2], seed=G[2], device="cpu")
    eng = eng_pt.HugeEngine(g, eng_pt.EngineConfig(
        faults=FaultPlan.single("queue-overflow", at_step=1), recover=False), device="cpu")
    with pytest.raises(eng_pt.QueuePressure):
        eng.run(PAPER_QUERIES["q1"])
    assert watched and not _alive(watched)


def test_run_delta_leaves_no_session_or_queue(no_gc, watched):
    g = powerlaw_graph(*G[:2], seed=G[2], device="cpu")
    eng = eng_pt.HugeEngine(g, eng_pt.EngineConfig(materialize=True), device="cpu")
    rng = np.random.default_rng(0)
    edges = []
    for _ in range(3):
        batch = rng.integers(0, G[0], size=(8, 2))
        batch = batch[batch[:, 0] != batch[:, 1]]
        edges.append(batch)
        eng.apply_updates(GraphUpdateBatch(batch))
        for q in (triangle(), PAPER_QUERIES["q2"]):
            res = eng.run_delta(q)
            assert res.matches is None or res.matches.shape[0] == res.count
    total = eng.run(triangle()).count
    base = count_instances(powerlaw_graph(*G[:2], seed=G[2], device="cpu"), list(triangle().edges))
    assert total >= base
    alive = _alive(watched)
    assert len(watched) > 6 and not alive, f"{len(alive)} outlived their runs"


def test_distributed_run_leaves_no_runtime_or_queue(no_gc, monkeypatch):
    """One gloo rank in this process: after ``run``, ``run_concurrent`` and
    ``run_delta``, and a run that restarts after a fault, no runtime,
    distributed queue or queue tensor of theirs is alive, though the engines
    are."""
    refs = []
    build = dist_pt.DistributedEngine._build_runtimes

    def watched_build(self, *args, **kwargs):
        runtimes = build(self, *args, **kwargs)
        for rt in runtimes:
            refs.append(weakref.ref(rt))
            for q in vars(rt).values():
                if isinstance(q, dist_pt._DQueue):
                    refs.extend((weakref.ref(q), weakref.ref(q.buf)))
        return runtimes

    monkeypatch.setattr(dist_pt.DistributedEngine, "_build_runtimes", watched_build)
    g = powerlaw_graph(*G[:2], seed=G[2], device="cpu")
    with dist_pt.process_group("gloo", "cpu") as comm:
        eng = dist_pt.DistributedEngine(g, comm, dist_pt.DistConfig(batch_size=128))
        count, stats = eng.run(PAPER_QUERIES["q1"], space="seed")
        assert count == 1268 and stats["joins"] >= 1
        counts, _ = eng.run_concurrent([PAPER_QUERIES["q3"], PAPER_QUERIES["q2"]])
        assert counts == [29, 819] and len(eng._last_labels) > 4
        eng.apply_updates(GraphUpdateBatch(np.array([[0, 5], [5, 9], [0, 9]])))
        delta, _ = eng.run_delta(triangle())
        assert delta >= 1
        fp = FaultPlan.single("queue-overflow", at_step=1)
        faulted = dist_pt.DistributedEngine(g, comm, dist_pt.DistConfig(batch_size=128, faults=fp))
        count, stats = faulted.run(PAPER_QUERIES["q1"])
        assert count == 1268 and stats["retries"] == 1 and fp.fired_count("queue-overflow") == 1
        alive = _alive(refs)
        assert len(refs) > 10 and not alive, f"{len(alive)} runtimes or queues outlived their runs"
        del eng, faulted
