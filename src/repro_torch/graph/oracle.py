"""Host-side oracles for subgraph-enumeration correctness.

Engine counts are checked against networkx's VF2 matcher:
``#instances = #monomorphisms(q -> G) / |Aut(q)|``. Symmetry breaking makes
the engine produce each subgraph instance exactly once, so its count must
equal this quantity exactly.
"""
from __future__ import annotations

import networkx as nx
from networkx.algorithms import isomorphism as iso

from repro_torch.graph.storage import Graph, to_networkx


def query_to_networkx(query_edges) -> "nx.Graph":
    q = nx.Graph()
    q.add_edges_from([tuple(map(int, e)) for e in query_edges])
    return q


def num_automorphisms(query_edges) -> int:
    q = query_to_networkx(query_edges)
    return sum(1 for _ in iso.GraphMatcher(q, q).isomorphisms_iter())


def count_monomorphisms(graph: Graph | "nx.Graph", query_edges) -> int:
    g = graph if isinstance(graph, nx.Graph) else to_networkx(graph)
    q = query_to_networkx(query_edges)
    return sum(1 for _ in iso.GraphMatcher(g, q).subgraph_monomorphisms_iter())


def count_instances(graph: Graph | "nx.Graph", query_edges) -> int:
    """#distinct subgraph instances of the query in the data graph."""
    mono = count_monomorphisms(graph, query_edges)
    aut = num_automorphisms(query_edges)
    assert mono % aut == 0, (mono, aut)
    return mono // aut


def enumerate_instances_bruteforce(graph: Graph, query_edges) -> set:
    """Tiny-graph brute force: frozensets of matched data vertices."""
    g = to_networkx(graph)
    q = query_to_networkx(query_edges)
    out = set()
    nq = q.number_of_nodes()
    for mapping in iso.GraphMatcher(g, q).subgraph_monomorphisms_iter():
        inv = {qv: gv for gv, qv in mapping.items()}
        out.add(frozenset(inv[i] for i in range(nq)))
    return out
