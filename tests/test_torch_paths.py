"""The port's §6 path applications against networkx and the JAX package's
``core/paths.py``, on the CPU."""
import networkx as nx
import pytest
import torch

from repro.core import paths as paths_ref
from repro.graph import generators as gen_ref
from repro_torch.core.paths import hop_constrained_paths, shortest_path_length
from repro_torch.graph import generators as gen_pt
from repro_torch.graph.storage import to_networkx


def graphs(gname):
    if gname == "er":
        return gen_pt.erdos_renyi(120, 5.0, seed=3, device="cpu"), gen_ref.erdos_renyi(120, 5.0, seed=3)
    if gname == "grid":
        return gen_pt.grid_graph(8, 8, device="cpu"), gen_ref.grid_graph(8, 8)
    # sparse enough to leave vertices unreachable
    return gen_pt.erdos_renyi(80, 1.2, seed=1, device="cpu"), gen_ref.erdos_renyi(80, 1.2, seed=1)


@pytest.mark.parametrize("gname", ["er", "grid", "sparse"])
def test_shortest_path_matches_networkx_and_reference(gname):
    graph, g_ref = graphs(gname)
    g = to_networkx(graph)
    n = graph.num_vertices
    pairs = [(0, n - 1), (1, n // 2), (2, 7), (5, 5), (3, 60), (n - 2, 4)]
    for s, t in pairs:
        try:
            want = nx.shortest_path_length(g, s, t)
        except nx.NetworkXNoPath:
            want = None
        got = shortest_path_length(graph, s, t)
        assert got == paths_ref.shortest_path_length(g_ref, s, t), (s, t)
        if s != t:
            assert got == want, (s, t, got, want)
    assert shortest_path_length(graph, 0, n - 1, max_hops=1) == \
        paths_ref.shortest_path_length(g_ref, 0, n - 1, max_hops=1)


@pytest.mark.parametrize("gname,s,t,hops", [("er40", 0, 5, 4), ("grid5", 0, 6, 3),
                                            ("grid5", 0, 1, 1), ("er40", 3, 9, 5)])
def test_hop_constrained_paths_match_bruteforce_and_reference(gname, s, t, hops):
    if gname == "er40":
        graph, g_ref = gen_pt.erdos_renyi(40, 4.0, seed=5, device="cpu"), gen_ref.erdos_renyi(40, 4.0, seed=5)
    else:
        graph, g_ref = gen_pt.grid_graph(5, 5, device="cpu"), gen_ref.grid_graph(5, 5)
    g = to_networkx(graph)
    want = {
        tuple(p) for p in nx.all_simple_paths(g, s, t, cutoff=hops) if len(p) == hops + 1
    }
    got = hop_constrained_paths(graph, s, t, hops, cap=1 << 12)
    assert set(got) == want
    assert got == paths_ref.hop_constrained_paths(g_ref, s, t, hops, cap=1 << 12)  # same order
