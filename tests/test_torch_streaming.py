"""The port's streaming path against the JAX package's, on the CPU: edge-insert
batches applied to the storage (CSR splice, padded rows written on the
device, ``d_pad`` grown by lanes), the delta-join decomposition, and
``run_delta`` counts, statistics and materialised rows, held to the oracle's
count differences and to the reference's ``run_delta`` batch by batch."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataflow as df_ref
from repro.core import engine as eng_ref
from repro.core.cost import GraphStats as GS_ref
from repro.core.optimizer import optimal_plan as plan_ref
from repro.core.query import PAPER_QUERIES as Q_REF
from repro.graph import storage as st_ref
from repro_torch.analysis.flowcheck import verify_flow
from repro_torch.core import dataflow as df_pt
from repro_torch.core import engine as eng_pt
from repro_torch.core.cost import GraphStats as GS_pt
from repro_torch.core.optimizer import optimal_plan as plan_pt
from repro_torch.core.query import PAPER_QUERIES as Q_PT
from repro_torch.graph import generators as gen_pt
from repro_torch.graph import storage as st_pt
from repro_torch.graph.oracle import count_instances
from repro_torch.kernels.intersect import ops as ik


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def random_edge_stream(n, m, seed):
    """A simple random graph as a shuffled undirected edge array."""
    rng = np.random.default_rng(seed)
    und = set()
    while len(und) < m:
        a, b = rng.integers(0, n, 2)
        if a != b:
            und.add((min(a, b), max(a, b)))
    und = np.array(sorted(und))
    rng.shuffle(und)
    return und


def host(graph):
    """The four arrays of a graph of either package, as numpy."""
    return tuple(np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a) for a in (
        graph.offsets, graph.nbrs, graph.padded.adj, graph.padded.deg))


# ---------------------------------------------------------------------------
# Storage
# ---------------------------------------------------------------------------

def test_apply_updates_matches_full_rebuild_and_reference():
    n = 200
    und = random_edge_stream(n, 700, seed=2)
    base, stream = und[:500], und[500:]
    # duplicates, a self loop and already-present edges are dropped
    batch_edges = np.concatenate([stream, stream[:5], base[:7], [[3, 3]]])
    g = st_pt.build_graph(base, n, device="cpu")
    before = [a.clone() for a in (g.offsets, g.nbrs, g.padded.adj, g.padded.deg)]
    applied = st_pt.apply_updates(g, st_pt.GraphUpdateBatch(batch_edges))
    # the input graph is unchanged
    for a, b in zip(before, (g.offsets, g.nbrs, g.padded.adj, g.padded.deg)):
        assert torch.equal(a, b)
    full = st_pt.build_graph(und, n, device="cpu")
    for a, b in zip(host(applied.graph)[:2], host(full)[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(host(applied.graph)[3], host(full)[3])
    w = min(applied.graph.padded.d_pad, full.padded.d_pad)
    np.testing.assert_array_equal(host(applied.graph)[2][:, :w], host(full)[2][:, :w])
    assert applied.num_new_edges == stream.shape[0]
    assert applied.delta.num_edges == stream.shape[0]

    # bit for bit the reference's update
    a_ref = st_ref.apply_updates(st_ref.build_graph(base, n),
                                 st_ref.GraphUpdateBatch(batch_edges))
    for a, b in zip(host(applied.graph), host(a_ref.graph)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(host(applied.delta), host(a_ref.delta)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(applied.touched, a_ref.touched)
    np.testing.assert_array_equal(applied.edges, a_ref.edges)
    assert applied.touched.dtype == a_ref.touched.dtype
    assert applied.edges.dtype == a_ref.edges.dtype

    # re-applying the same batch is a no-op
    again = st_pt.apply_updates(applied.graph, st_pt.GraphUpdateBatch(stream))
    assert again.num_new_edges == 0 and again.graph is applied.graph


def test_apply_updates_grows_d_pad_by_lanes():
    n = 300
    g = st_pt.build_graph(np.array([[0, 1]]), n, device="cpu")
    assert g.padded.d_pad == st_pt._LANE
    # a star that overflows one row far past a lane boundary
    star = np.stack([np.zeros(n - 1, np.int64), np.arange(1, n)], axis=1)
    applied = st_pt.apply_updates(g, st_pt.GraphUpdateBatch(star))
    assert applied.graph.padded.d_pad % st_pt._LANE == 0
    assert applied.graph.padded.d_pad >= n - 1
    assert int(applied.graph.degree(torch.tensor(0))) == n - 1
    assert int(applied.graph.padded.adj[5, 1]) == st_pt.INVALID  # untouched rows stay padded
    assert g.padded.d_pad == st_pt._LANE  # the input graph is unchanged
    a_ref = st_ref.apply_updates(st_ref.build_graph(np.array([[0, 1]]), n),
                                 st_ref.GraphUpdateBatch(star))
    for a, b in zip(host(applied.graph), host(a_ref.graph)):
        np.testing.assert_array_equal(a, b)


def test_apply_updates_rejects_out_of_range():
    g = st_pt.build_graph(np.array([[0, 1]]), 3, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        st_pt.apply_updates(g, st_pt.GraphUpdateBatch(np.array([[0, 7]])))
    with pytest.raises(NotImplementedError):
        st_pt.GraphUpdateBatch(np.array([[0, 1]]), kind="delete")


# ---------------------------------------------------------------------------
# Delta flows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", ["q1", "q2", "q3", "q5"])
def test_delta_flows_equal_reference(qname):
    q = Q_PT[qname]
    plan = plan_pt(q, GS_pt.synthetic(1 << 10, 6.0), 8, "huge")
    flows = df_pt.delta_flows(plan)
    assert len(flows) == len(q.edges)  # one flow per query edge
    for i, f in enumerate(flows):
        scans = [op for op in f.ops if op.kind == "scan"]
        assert len(scans) == 1 and scans[0].scan_epoch == "delta"
        olds = sum(ep == "old" for op in f.ops for ep in op.ext_epochs)
        news = sum(ep == "new" for op in f.ops for ep in op.ext_epochs)
        # flow i probes exactly i old edges and k-1-i new ones
        assert olds == i and news == len(q.edges) - 1 - i
    merged, tenant = df_pt.merge_flows(flows)
    assert len(merged.sink_indices()) == len(flows)
    verify_flow(merged)  # the epoch rules pass
    assert df_pt.delta_flows(plan, st_pt.GraphUpdateBatch(np.zeros((0, 2), np.int64))) == []
    assert df_pt.delta_edge_order(q) == df_ref.delta_edge_order(Q_REF[qname])

    flows_ref = df_ref.delta_flows(plan_ref(Q_REF[qname], GS_ref.synthetic(1 << 10, 6.0), 8,
                                            "huge"))
    merged_ref, tenant_ref = df_ref.merge_flows(flows_ref)
    assert tenant == tenant_ref and merged.query_name == merged_ref.query_name
    assert [dataclasses.asdict(op) for op in merged.ops] == \
        [dataclasses.asdict(op) for op in merged_ref.ops]
    assert [op.label() for op in merged.ops] == [op.label() for op in merged_ref.ops]


# ---------------------------------------------------------------------------
# run_delta
# ---------------------------------------------------------------------------

def _split_powerlaw(n, seed):
    """A power-law graph's edges, shuffled and split 80/20 into a base graph
    and an insert stream."""
    g = gen_pt.powerlaw_graph(n, 5.0, seed=seed, device="cpu")
    src = np.repeat(np.arange(n), np.diff(g.offsets.numpy()))
    und = np.stack([src, g.nbrs.numpy()], 1)
    und = und[und[:, 0] < und[:, 1]]
    und = und[np.random.default_rng(seed).permutation(len(und))]
    k = int(0.8 * len(und))
    return und[:k], und[k:]


STAT_FIELDS = ("count", "pulled_bytes", "pushed_bytes", "cache_hits", "cache_misses",
               "batches", "rows_emitted", "peak_queue_rows", "peak_queue_bytes")


@pytest.mark.parametrize("qname", ["q1", "q2", "q3"])
def test_run_delta_equals_oracle_diff_and_reference(qname):
    n = 300
    base, stream = _split_powerlaw(n, seed=3)
    kw = dict(batch_size=128, materialize=True, fused=True)
    q = Q_PT[qname]
    eng = eng_pt.HugeEngine(st_pt.build_graph(base, n, device="cpu"),
                            eng_pt.EngineConfig(**kw), device="cpu")
    ref = eng_ref.HugeEngine(st_ref.build_graph(base, n), eng_ref.EngineConfig(**kw))
    c_before = count_instances(eng.graph, list(q.edges))
    total = 0
    ik.reset_launches()
    for chunk in np.array_split(stream, 3):
        eng.apply_updates(st_pt.GraphUpdateBatch(chunk))
        ref.apply_updates(st_ref.GraphUpdateBatch(chunk))
        r_pt = eng.run_delta(q)
        r_ref = ref.run_delta(Q_REF[qname])
        for f in STAT_FIELDS:
            assert getattr(r_pt.stats, f) == getattr(r_ref.stats, f), f
        assert r_pt.schedule.steps == r_ref.schedule.steps
        np.testing.assert_array_equal(r_pt.matches, r_ref.matches)
        total += r_pt.count
    assert total == count_instances(eng.graph, list(q.edges)) - c_before
    assert all(v == 0 for v in ik.launches.values())  # CPU tensors: plain versions only


def test_run_delta_exactly_once_materialised():
    """Every new match appears exactly once across batches, compared as row
    tuples against the engine's own full enumeration before and after (which,
    unlike the vertex-set oracle, keeps distinct embeddings that share a
    vertex set apart)."""
    n = 120
    und = random_edge_stream(n, 500, seed=11)
    base, stream = und[:400], und[400:]
    cfg = eng_pt.EngineConfig(batch_size=128, materialize=True)

    def full_rows(graph, q):
        r = eng_pt.HugeEngine(graph, cfg, device="cpu").run(q)
        return set(map(tuple, r.matches)) if r.matches is not None else set()

    for qname in ("q1", "q2", "q3"):
        q = Q_PT[qname]
        g0 = st_pt.build_graph(base, n, device="cpu")
        before = full_rows(g0, q)
        eng = eng_pt.HugeEngine(g0, cfg, device="cpu")
        got = []
        for chunk in np.array_split(stream, 4):
            eng.apply_updates(st_pt.GraphUpdateBatch(chunk))
            r = eng.run_delta(q)
            if r.matches is not None:
                got.extend(map(tuple, r.matches))
        after = full_rows(eng.graph, q)
        assert len(got) == len(set(got)), f"{qname}: duplicate emission"
        assert set(got) == after - before, f"{qname}: wrong delta set"


def test_run_delta_requires_armed_delta():
    g = st_pt.build_graph(np.array([[0, 1], [1, 2]]), 3, device="cpu")
    eng = eng_pt.HugeEngine(g, eng_pt.EngineConfig(batch_size=32), device="cpu")
    with pytest.raises(RuntimeError, match="apply_updates"):
        eng.run_delta(Q_PT["q1"])
    flow = df_pt.merge_flows(df_pt.delta_flows(
        plan_pt(Q_PT["q1"], GS_pt.from_graph(g), 8, "huge")))[0]
    with pytest.raises(RuntimeError, match="apply_updates"):
        eng.run(flow)  # a delta-seeded scan needs an armed batch too
    eng.apply_updates(st_pt.GraphUpdateBatch(np.array([[0, 2]])))
    with pytest.raises(TypeError):
        eng.run_delta(flow)  # delta flows come from the query, not a dataflow


def test_delta_operators_equal_reference():
    """``delta_extend_batch`` / ``delta_verify_batch`` on random rows against
    the JAX versions, every old/new epoch pattern of two positions."""
    from repro.core import operators as ops_ref
    from repro_torch.core import operators as ops_pt

    n = 200
    und = random_edge_stream(n, 900, seed=5)
    base, stream = und[:700], und[700:]
    a_pt = st_pt.apply_updates(st_pt.build_graph(base, n, device="cpu"),
                               st_pt.GraphUpdateBatch(stream))
    a_ref = st_ref.apply_updates(st_ref.build_graph(base, n), st_ref.GraphUpdateBatch(stream))
    rng = np.random.default_rng(0)
    rows = rng.integers(0, n, (64, 3)).astype(np.int32)
    rows[-5:] = np.iinfo(np.int32).max
    for old in ((False, False), (True, False), (False, True), (True, True)):
        out_pt, m_pt = ops_pt.delta_extend_batch(
            a_pt.graph.padded.adj, a_pt.delta.padded.adj, torch.from_numpy(rows), 60,
            (0, 2), old, (1,), (), 64 * a_pt.graph.padded.d_pad)
        out_ref, m_ref = ops_ref.delta_extend_batch(
            a_ref.graph.padded.adj, a_ref.delta.padded.adj, jnp.asarray(rows), jnp.int32(60),
            (0, 2), old, (1,), (), 64 * a_pt.graph.padded.d_pad)
        assert m_pt == int(m_ref)
        np.testing.assert_array_equal(out_pt.numpy(), np.asarray(out_ref))
        out_pt, m_pt = ops_pt.delta_verify_batch(
            a_pt.graph.padded.adj, a_pt.delta.padded.adj, torch.from_numpy(rows), 60,
            (0, 2), old, 1, 64)
        out_ref, m_ref = ops_ref.delta_verify_batch(
            a_ref.graph.padded.adj, a_ref.delta.padded.adj, jnp.asarray(rows), jnp.int32(60),
            (0, 2), old, 1, 64)
        assert m_pt == int(m_ref)
        np.testing.assert_array_equal(out_pt.numpy(), np.asarray(out_ref))
