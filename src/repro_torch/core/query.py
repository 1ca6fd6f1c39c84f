"""Query graphs, automorphisms, and symmetry breaking.

Query graphs are tiny (≤ 8 vertices); everything here is host-side Python and
runs at plan time. Symmetry breaking follows Grochow-Kellis [27]: a set of
partial-order constraints ``ID(f(v_a)) < ID(f(v_b))`` such that exactly one
match per automorphism class of the query survives.

The paper's Figure 4 lists queries q1..q8 with their partial orders; the
figure itself is not reproduced in the text dump, so we adopt the standard
benchmark set of [46] (the codebase the paper builds from), which covers the
same structural spectrum: cycles, cliques, paths and their compositions.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Sequence, Tuple

Edge = Tuple[int, int]


def _canon(e: Sequence[int]) -> Edge:
    a, b = int(e[0]), int(e[1])
    return (a, b) if a < b else (b, a)


@dataclasses.dataclass(frozen=True)
class QueryGraph:
    """An undirected, connected query graph over vertices 0..n-1."""

    num_vertices: int
    edges: FrozenSet[Edge]
    name: str = "query"

    @staticmethod
    def from_edges(edges: Sequence[Sequence[int]], name: str = "query") -> "QueryGraph":
        es = frozenset(_canon(e) for e in edges)
        n = max(max(e) for e in es) + 1
        return QueryGraph(num_vertices=n, edges=es, name=name)

    def adjacency(self) -> Dict[int, FrozenSet[int]]:
        adj: Dict[int, set] = {v: set() for v in range(self.num_vertices)}
        for a, b in self.edges:
            adj[a].add(b)
            adj[b].add(a)
        return {v: frozenset(s) for v, s in adj.items()}

    def degree(self, v: int) -> int:
        return sum(1 for e in self.edges if v in e)

    def has_edge(self, a: int, b: int) -> bool:
        return _canon((a, b)) in self.edges

    def automorphisms(self) -> List[Tuple[int, ...]]:
        """All permutations of V(q) preserving adjacency (n ≤ 8 → brute force)."""
        auts = []
        es = self.edges
        for perm in itertools.permutations(range(self.num_vertices)):
            if all(_canon((perm[a], perm[b])) in es for a, b in es):
                auts.append(perm)
        return auts

    def is_clique(self) -> bool:
        n = self.num_vertices
        return len(self.edges) == n * (n - 1) // 2

    def is_star(self) -> bool:
        root = self.star_root()
        return root is not None

    def star_root(self) -> int | None:
        """If the query is a star (tree of depth 1) return its root, else None."""
        n = self.num_vertices
        if len(self.edges) != n - 1:
            return None
        degs = [self.degree(v) for v in range(n)]
        if n == 2:
            return 0  # single edge: either endpoint roots it
        centers = [v for v in range(n) if degs[v] == n - 1]
        return centers[0] if centers else None


def symmetry_break(query: QueryGraph) -> List[Edge]:
    """Grochow-Kellis symmetry-breaking conditions.

    Returns a list of pairs (a, b) meaning the constraint ``f(a) < f(b)``.
    Iteratively: pick the smallest vertex with a non-trivial orbit, constrain
    it to be the minimum of its orbit, then restrict to its stabilizer.
    """
    conditions: List[Edge] = []
    auts = query.automorphisms()
    while len(auts) > 1:
        # Orbits under the current group.
        orbit_of: Dict[int, set] = {}
        for v in range(query.num_vertices):
            orbit_of[v] = {perm[v] for perm in auts}
        pivot = min(v for v in range(query.num_vertices) if len(orbit_of[v]) > 1)
        for u in sorted(orbit_of[pivot]):
            if u != pivot:
                conditions.append((pivot, u))
        auts = [perm for perm in auts if perm[pivot] == pivot]
    return conditions


# ---------------------------------------------------------------------------
# Benchmark query library (paper Figure 4 analogues).
# ---------------------------------------------------------------------------

def triangle() -> QueryGraph:
    return QueryGraph.from_edges([(0, 1), (1, 2), (0, 2)], name="triangle")


def square() -> QueryGraph:
    """q1 of the paper's running example (Table 1): the 4-cycle."""
    return QueryGraph.from_edges([(0, 1), (1, 2), (2, 3), (3, 0)], name="square")


def diamond() -> QueryGraph:
    """4-cycle + one chord."""
    return QueryGraph.from_edges([(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)], name="diamond")


def clique(k: int) -> QueryGraph:
    return QueryGraph.from_edges(
        [(i, j) for i in range(k) for j in range(i + 1, k)], name=f"{k}-clique"
    )


def path(k: int) -> QueryGraph:
    """k-vertex simple path."""
    return QueryGraph.from_edges([(i, i + 1) for i in range(k - 1)], name=f"{k}-path")


def star(k: int) -> QueryGraph:
    """k-leaf star (k+1 vertices)."""
    return QueryGraph.from_edges([(0, i) for i in range(1, k + 1)], name=f"{k}-star")


def house() -> QueryGraph:
    """Square with a triangle roof."""
    return QueryGraph.from_edges(
        [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 4)], name="house"
    )


def tailed_triangle() -> QueryGraph:
    return QueryGraph.from_edges([(0, 1), (1, 2), (0, 2), (2, 3)], name="tailed-triangle")


def double_square() -> QueryGraph:
    """Two squares sharing an edge (the 'ladder' on 6 vertices)."""
    return QueryGraph.from_edges(
        [(0, 1), (1, 2), (2, 3), (3, 0), (2, 4), (4, 5), (5, 3)], name="double-square"
    )


def chordal_square_tail() -> QueryGraph:
    """Diamond with a pendant — mixed-plan stressor (q8 analogue)."""
    return QueryGraph.from_edges(
        [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2), (1, 4)], name="chordal-square-tail"
    )


PAPER_QUERIES: Dict[str, QueryGraph] = {
    "q1": square(),
    "q2": diamond(),
    "q3": clique(4),
    "q4": house(),
    "q5": double_square(),
    "q6": clique(5),
    "q7": path(5),
    "q8": chordal_square_tail(),
}
