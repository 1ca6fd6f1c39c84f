"""The port's distributed engine against the JAX engine, on the CPU.

The reference's own cases (``tests/test_distributed.py``) on their graphs:
q1-q3 at 8 shards, work stealing on and off, the four PUSH-JOIN plans, and
``run_concurrent``; plus q1-q3 at world sizes 1 and 2. Each side runs once
for the whole file: the JAX engine in one interpreter per device count (4
and 8 host devices, ``shard_map``), the port in one ``run_ranks`` group per
world size (gloo on the CPU, plain kernel versions, one torch thread a
rank), both at once. Every count must equal the JAX engine's and the
networkx oracle's, every rank must return the same count and statistics,
and every statistic but ``"engine"`` must equal the JAX engine's.

Also here: ``partition_graph`` bit for bit against the reference, the
config's fields, and ``run_ranks``' handling of a rank that fails, dies or
hangs."""
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

import pytest
import torch

from repro_torch.core import distributed as dist_pt
from repro_torch.core.faults import KernelFault
from repro_torch.core.query import PAPER_QUERIES as Q
from repro_torch.graph import erdos_renyi, partition_graph, powerlaw_graph
from repro_torch.graph.oracle import count_instances
from repro_torch.graph.partition import shard_adjacency

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRAPHS = {
    "er250": ("erdos_renyi", (250, 6.0), {"seed": 11}),
    "pl300": ("powerlaw_graph", (300, 6.0), {"seed": 12}),
    "pl240": ("powerlaw_graph", (240, 5.0), {"seed": 3}),
    "cl24": ("ring_of_cliques", (24, 5), {}),
    "er200": ("erdos_renyi", (200, 5.0), {"seed": 13}),
}
C128 = {"batch_size": 128, "queue_capacity": 1 << 14}
# (case, graph, ranks, queries, plan space, config, engine): cases with the
# same engine key share one engine, as the reference's tests share theirs.
CASES = [
    *[(f"er250-{q}", "er250", 8, q, "huge", C128, "er250") for q in ("q1", "q2", "q3")],
    ("steal-on", "pl300", 8, "q1", "huge", {**C128, "rebalance": True}, "steal-on"),
    ("steal-off", "pl300", 8, "q1", "huge", {**C128, "rebalance": False}, "steal-off"),
    ("pushjoin-q1-seed", "pl240", 4, "q1", "seed", C128, "pl240"),
    ("pushjoin-q7-huge", "pl240", 4, "q7", "huge", C128, "pl240"),
    ("pushjoin-q2-seed", "cl24", 4, "q2", "seed", C128, "cl24"),
    ("pushjoin-q8-starjoin", "cl24", 4, "q8", "starjoin", C128, "cl24"),
    ("concurrent", "er200", 4, ["q1", "q2", "q3"], "huge", C128, "er200"),
    *[(f"concurrent-alone-{q}", "er200", 4, q, "huge", C128, "er200") for q in ("q1", "q2", "q3")],
    *[(f"world{p}-{q}", "er250", p, q, "huge", C128, "er250") for p in (1, 2)
      for q in ("q1", "q2", "q3")],
]
PUSH_JOIN = {"pushjoin-q1-seed", "pushjoin-q7-huge", "pushjoin-q2-seed", "pushjoin-q8-starjoin"}
# networkx counts of q7 on pl240 (repro_torch.graph.oracle.count_instances,
# about a minute); every other oracle count is computed here.
ORACLE_CONST = {("pl240", "q7"): 470291}

# The reference side: every case of one device count in one interpreter.
JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
import repro.graph as G
from repro.core import query as Q
from repro.core.distributed import DistributedEngine, DistConfig

spec = json.loads(sys.argv[1])
cache = sys.argv[2]
if cache:
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
graphs, engines, out = {}, {}, {}
for cid, gkey, p, qs, space, cfg, ekey in spec["cases"]:
    if gkey not in graphs:
        name, args, kw = spec["graphs"][gkey]
        graphs[gkey] = getattr(G, name)(*args, **kw)
    if (ekey, p) not in engines:
        mesh = Mesh(np.array(jax.devices()[:p]), ("shards",))
        engines[(ekey, p)] = DistributedEngine(graphs[gkey], mesh, DistConfig(**cfg))
    eng = engines[(ekey, p)]
    if isinstance(qs, list):
        count, stats = eng.run_concurrent([Q.PAPER_QUERIES[q] for q in qs], space=space)
        labels = [rt.label for rt in eng._last_runtimes]
    else:
        count, stats = eng.run(Q.PAPER_QUERIES[qs], space=space)
        labels = []
    out[cid] = [count, dict(stats), labels]
    print("case", cid, count, file=sys.stderr, flush=True)
print(json.dumps(out))
"""


def _build(gkey, device="cpu"):
    import repro_torch.graph as G

    name, args, kw = GRAPHS[gkey]
    return getattr(G, name)(*args, **kw, device=device)


def run_cases(comm, cases):
    """Rank body: the port's side of ``CASES`` (one world size)."""
    graphs, engines, out = {}, {}, {}
    for cid, gkey, _, qs, space, cfg, ekey in cases:
        if gkey not in graphs:
            graphs[gkey] = _build(gkey, comm.device)
        if ekey not in engines:
            engines[ekey] = dist_pt.DistributedEngine(graphs[gkey], comm,
                                                      dist_pt.DistConfig(**cfg))
        eng = engines[ekey]
        if isinstance(qs, list):
            count, stats = eng.run_concurrent([Q[q] for q in qs], space=space)
            labels = eng._last_labels
        else:
            count, stats = eng.run(Q[qs], space=space)
            labels = []
        out[cid] = [count, dict(stats), labels]
    return out


def start_reference(cases, devices, tmp):
    """Start the JAX side of ``cases`` on ``devices`` host devices, its
    compilation cache and output under ``tmp``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    spec = json.dumps({"graphs": GRAPHS, "cases": cases})
    out = open(tmp / f"ref{devices}.out", "w+")
    err = open(tmp / f"ref{devices}.err", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, spec, str(tmp / f"cache{devices}")], env=env,
        cwd=ROOT, stdout=out, stderr=err, text=True)
    return proc, out, err


def finish_reference(started, timeout=600):
    proc, out, err = started
    proc.wait(timeout=timeout)
    out.seek(0)
    err.seek(0)
    assert proc.returncode == 0, err.read()[-4000:]
    return json.loads(out.read().strip().splitlines()[-1])


def run_port(cases, world):
    ranks = dist_pt.run_ranks(run_cases, world, backend="gloo", device="cpu",
                              timeout_s=600, args=(cases,))
    for r in ranks[1:]:
        assert r.value == ranks[0].value, f"rank {r.rank} disagrees with rank 0"
    return ranks[0].value


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(reference results, port results, oracle counts) for every case."""
    tmp = tmp_path_factory.mktemp("reference")
    by_devices = {8: [c for c in CASES if c[2] == 8], 4: [c for c in CASES if c[2] != 8]}
    procs = {d: start_reference(cs, d, tmp) for d, cs in by_devices.items()}
    port = {}
    for world in (8, 4, 2, 1):
        port.update(run_port([c for c in CASES if c[2] == world], world))
    oracle = {}
    for _, gkey, _, qs, _, _, _ in CASES:
        for q in qs if isinstance(qs, list) else [qs]:
            if (gkey, q) not in oracle:
                oracle[(gkey, q)] = ORACLE_CONST.get((gkey, q)) or count_instances(
                    _build(gkey), list(Q[q].edges))
    ref = {}
    for proc in procs.values():
        ref.update(finish_reference(proc))
    return ref, port, oracle


def assert_same_stats(ref_stats, port_stats):
    assert ref_stats.pop("engine") == "shard_map"
    assert port_stats.pop("engine") == "torch.distributed"
    assert port_stats == ref_stats


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != "concurrent"],
                         ids=lambda c: c[0])
def test_counts_and_stats_equal_reference(both, case):
    ref, port, oracle = both
    cid, gkey, p, qname, space = case[:5]
    count, stats, _ = port[cid]
    ref_count, ref_stats, _ = ref[cid]
    assert count == ref_count == oracle[(gkey, qname)], (cid, count, ref_count)
    assert stats["shards"] == p
    if cid in PUSH_JOIN:
        assert stats["joins"] >= 1 and stats["probe_batches"] > 0, cid
    assert_same_stats(dict(ref_stats), dict(stats))


def test_run_concurrent_equals_reference_and_isolated_runs(both):
    ref, port, oracle = both
    counts, stats, labels = port["concurrent"]
    ref_counts, ref_stats, ref_labels = ref["concurrent"]
    assert counts == ref_counts
    assert stats["tenants"] == 3 and stats["per_tenant_matches"] == counts
    assert any(lbl.startswith("t0:") for lbl in labels)
    assert any(lbl.startswith("t2:") for lbl in labels)
    assert labels == ref_labels
    for q, got in zip(("q1", "q2", "q3"), counts):
        assert got == port[f"concurrent-alone-{q}"][0] == oracle[("er200", q)], q
    assert_same_stats(dict(ref_stats), dict(stats))


def test_stealing_moves_rows_only_when_on(both):
    _, port, _ = both
    assert port["steal-on"][1]["steal_rows"] > 0
    assert port["steal-off"][1]["steal_rows"] == 0
    assert port["steal-on"][1]["a2a_calls"] > port["steal-off"][1]["a2a_calls"]


# ---------------------------------------------------------------------------
# partition_graph and the config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs_both():
    from repro.graph import erdos_renyi as er_ref

    return er_ref(250, 6.0, seed=11), erdos_renyi(250, 6.0, seed=11, device="cpu")


@pytest.mark.parametrize("shards", range(1, 9))
def test_partition_graph_equals_reference(graphs_both, shards):
    import numpy as np
    from repro.graph.partition import partition_graph as partition_ref

    g_ref, g_pt = graphs_both
    a = partition_ref(g_ref, shards)
    b = partition_graph(g_pt, shards)
    assert b.adj.dtype == torch.int32 and b.deg.dtype == torch.int32
    np.testing.assert_array_equal(b.adj.numpy(), np.asarray(a.adj))
    np.testing.assert_array_equal(b.deg.numpy(), np.asarray(a.deg))
    assert (b.v_per_shard, b.d_pad, b.num_vertices, b.num_shards) == (
        a.v_per_shard, a.d_pad, a.num_vertices, a.num_shards)
    assert b.shard_bytes() == a.shard_bytes()
    vids = np.array([-1, 0, 1, shards, 249])
    np.testing.assert_array_equal(b.owner(torch.from_numpy(vids)).numpy(),
                                  np.asarray(a.owner(vids)))
    np.testing.assert_array_equal(b.local_index(torch.from_numpy(vids)).numpy(),
                                  np.asarray(a.local_index(vids)))
    for rank in range(shards):
        adj, deg = shard_adjacency(g_pt, shards, rank)
        assert adj.is_contiguous()
        assert torch.equal(adj, b.adj[rank]) and torch.equal(deg, b.deg[rank])
    if shards == 1:  # a view: the graph's own adjacency, no copy
        assert shard_adjacency(g_pt, 1, 0)[0].data_ptr() == g_pt.padded.adj.data_ptr()


def test_dist_config_fields_equal_reference_minus_jax_mechanisms():
    from repro.core.distributed import DistConfig as RefConfig

    ref = {f.name: f.default for f in dataclasses.fields(RefConfig)
           if f.name not in ("force_kernel", "axis")}
    port = {f.name: f.default for f in dataclasses.fields(dist_pt.DistConfig)}
    assert port == ref


# ---------------------------------------------------------------------------
# run_ranks: a rank that fails, dies or hangs
# ---------------------------------------------------------------------------

def kernel_fault_on_rank1(comm):
    from repro_torch.kernels.intersect import ops as ik

    if comm.rank == 1:
        def broken(*args, **kwargs):
            raise KernelFault("fused_extend launch failed: injected by the test",
                              op="fused_extend")
        ik.fused_extend = broken
    g = powerlaw_graph(240, 5.0, seed=3, device=comm.device)
    eng = dist_pt.DistributedEngine(g, comm, dist_pt.DistConfig(batch_size=128, fused=True))
    return eng.run(Q["q1"])[0]


def exit_on_rank1(comm):
    comm.all_sum(1)
    if comm.rank == 1:
        os._exit(3)
    comm.all_sum(1)  # rank 0 waits here for a peer that is gone
    return comm.rank


def sleep_forever(comm):
    time.sleep(3600)


@pytest.mark.parametrize("fn, error, match", [
    (kernel_fault_on_rank1, RuntimeError, "(?s)rank 1 failed.*KernelFault"),
    (exit_on_rank1, RuntimeError, "rank 1 exited with code 3"),
    (sleep_forever, TimeoutError, "had not finished"),
], ids=["kernel-fault", "rank-exits", "timeout"])
def test_failed_rank_raises_and_no_rank_is_left(fn, error, match):
    timeout = 60 if fn is not sleep_forever else 8
    t0 = time.monotonic()
    with pytest.raises(error, match=match):
        dist_pt.run_ranks(fn, 2, backend="gloo", device="cpu", timeout_s=timeout)
    assert time.monotonic() - t0 < timeout + 20
    assert multiprocessing.active_children() == []
