"""The port's batching, cache and scheduling suites against the JAX
package's, on the CPU: Exp-4 (batch size), Exp-5 (cache capacity), Exp-6
(cache design) and Exp-7 (queue size), and fused against plain runs.

As in ``test_torch_suites_plans.py``, each reference suite's ``main()``
runs on ``powerlaw_graph(256, 5.0, seed=3)`` and the port's runner on the
same graph: row names in order and every run's deterministic fields must be
equal. There the suites' capacities (2^10 to 2^16) exceed the working set,
so every policy gives the same hit rate; at a capacity of 64 entries the
policies differ, and those runs are held to the reference too.
"""
import pytest
import torch

from benchmarks import common as common_ref
from repro.graph import generators as gen_ref
from repro_torch.graph import generators as gen_pt
from repro_torch.launch import common as common_pt
from repro_torch.launch import exp5_cache, exp6_cache_design
from suite_parity import DETERMINISTIC, assert_parity, port, reference

G = (256, 5.0, 3)
SMALL_CACHE = 64  # entries a machine: below this graph's working set


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def graphs():
    n, deg, seed = G
    return (gen_ref.powerlaw_graph(n, deg, seed=seed),
            gen_pt.powerlaw_graph(n, deg, seed=seed, device="cpu"))


@pytest.mark.parametrize("name, fn", [
    ("exp4_batching", "exp4"),
    ("exp5_cache", "exp5"),
    ("exp6_cache_design", "exp6"),
    ("exp7_scheduling", "exp7"),
])
def test_suite_matches_the_reference(monkeypatch, graphs, name, fn):
    g_ref, g_pt = graphs
    ref = reference(monkeypatch, name, g_ref)
    got = port(monkeypatch, name, lambda mod: getattr(mod, fn)(g_pt))
    assert_parity(ref, got)


def test_exp7_sweeps_from_dfs_to_bfs(graphs):
    from repro_torch.launch import exp7_scheduling

    rows = exp7_scheduling.exp7(graphs[1])
    assert [r["queue_capacity"] for r in rows] == list(exp7_scheduling.QUEUES)
    assert rows[0]["yields_full"] > 0 and rows[-1]["yields_full"] == 0
    assert {r["matches"] for r in rows} == {1268}


def test_exp6_policies_differ_below_the_working_set(graphs):
    """At capacity 64 LRBU, LRU and direct-mapped give different hit rates and
    pulled bytes (q1: 429/765, 380/814 and 374/820 hits/misses), each equal
    to the reference's; at the suite's 2^12 they are all 0.423."""
    g_ref, g_pt = graphs
    rows = exp6_cache_design.exp6(g_pt, capacity=SMALL_CACHE, queries=("q1",))
    got = {r["cache_policy"]: (r["cache_hits"], r["cache_misses"], r["pulled_bytes"])
           for r in rows}
    assert got == {"lrbu": (429, 765, 30904), "lru": (380, 814, 33060),
                   "direct": (374, 820, 34900)}
    for r in rows:
        ref = common_ref.run_query(g_ref, "q1", cache_policy=r["cache_policy"],
                                   cache_capacity=SMALL_CACHE)
        assert {k: r[k] for k in DETERMINISTIC} == common_pt.fields(ref)
    assert len({r["hit_rate"] for r in rows}) == 3
    full = exp6_cache_design.exp6(g_pt, queries=("q1",))
    assert {round(r["hit_rate"], 3) for r in full} == {0.423}


def test_exp5_small_capacity_matches_the_reference(graphs):
    g_ref, g_pt = graphs
    rows = exp5_cache.exp5(g_pt, capacities=(0, SMALL_CACHE))
    assert [r["name"] for r in rows] == ["exp5/cache=0/q1", "exp5/cache=64/q1",
                                         "exp5/cache=0/q2", "exp5/cache=64/q2"]
    for r in rows:
        q = r["name"].rsplit("/", 1)[1]
        ref = common_ref.run_query(g_ref, q, cache_capacity=r["cache_capacity"])
        assert {k: r[k] for k in DETERMINISTIC} == common_pt.fields(ref)
    small = [r for r in rows if r["cache_capacity"] == SMALL_CACHE]
    assert all(0 < r["hit_rate"] < 0.423 for r in small)


def test_fused_runs_equal_plain_runs(monkeypatch, graphs):
    """The port's fused path (the kernels' plain versions on the CPU) gives
    every deterministic field of the plain path, row by row."""
    g_pt = graphs[1]
    plain = port(monkeypatch, "exp4_batching", lambda mod: mod.exp4(g_pt))
    fused = port(monkeypatch, "exp4_batching", lambda mod: mod.exp4(g_pt, fused=True))
    assert fused.rows == plain.rows and fused.runs == plain.runs
    assert all(e["fused"] for e in fused.entries)
    assert not any(e["fused"] for e in plain.entries)
