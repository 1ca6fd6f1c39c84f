"""Logical + physical execution plans (paper Section 3).

A sub-query is a frozenset of canonical edges of the query graph. A plan is a
binary join tree whose leaves are *join units* (stars; optionally cliques for
the SEED plan space) and whose internal nodes are two-way joins
``(q', q'_l, q'_r)``. Physical settings per join follow Eq. 3:

    (wco,  pull) if the join is a *complete star join*        (Def. 3.1)
    (hash, pull) if q'_r is a star (root; L) with root ∈ V_l  (Property 3.1 C1)
    (hash, push) otherwise

Plan *spaces* reproduce Table 2: each prior system is the same optimiser run
under that system's constraints (join unit / order / algorithm / comm mode).
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.query import Edge, QueryGraph, _canon

SubQuery = FrozenSet[Edge]


# ---------------------------------------------------------------------------
# Sub-query helpers
# ---------------------------------------------------------------------------

def sub_vertices(edges: SubQuery) -> FrozenSet[int]:
    return frozenset(v for e in edges for v in e)


def is_connected(edges: SubQuery) -> bool:
    if not edges:
        return False
    verts = sub_vertices(edges)
    seen = {next(iter(verts))}
    frontier = list(seen)
    adj = {v: set() for v in verts}
    for a, b in edges:
        adj[a].add(b)
        adj[b].add(a)
    while frontier:
        v = frontier.pop()
        for u in adj[v]:
            if u not in seen:
                seen.add(u)
                frontier.append(u)
    return seen == verts


def star_of(edges: SubQuery) -> Optional[Tuple[int, FrozenSet[int]]]:
    """Return (root, leaves) if ``edges`` forms a star, else None.

    A single edge is a 1-star; we root it at its smaller endpoint.
    """
    if not edges:
        return None
    if len(edges) == 1:
        a, b = next(iter(edges))
        return a, frozenset([b])
    common = None
    for a, b in edges:
        cur = {a, b}
        common = cur if common is None else (common & cur)
    if not common:
        return None
    root = min(common)
    leaves = frozenset(v for e in edges for v in e if v != root)
    if len(leaves) != len(edges):
        return None
    return root, leaves


def is_clique_sub(edges: SubQuery) -> bool:
    verts = sub_vertices(edges)
    n = len(verts)
    return n >= 3 and len(edges) == n * (n - 1) // 2


def is_complete_star_join(left: SubQuery, right: SubQuery) -> Optional[Tuple[int, FrozenSet[int]]]:
    """Definition 3.1: the right side is a star whose *root* is a new vertex
    and whose leaves are all already matched on the left (BiGJoin's
    vertex-extension as a join). Returns (root, leaves) or None."""
    st = star_of(right)
    if st is None:
        return None
    root, leaves = st
    lv = sub_vertices(left)
    if root not in lv and leaves <= lv:
        return root, leaves
    # A single edge is symmetric: try the other rooting.
    if len(right) == 1:
        (a, b) = next(iter(right))
        if b not in lv and a in lv:
            return b, frozenset([a])
    return None


def pull_hash_root(left: SubQuery, right: SubQuery) -> Optional[Tuple[int, FrozenSet[int]]]:
    """Property 3.1 C1: right is a star whose root is already matched on the
    left. Returns (root, leaves) or None."""
    st = star_of(right)
    if st is None:
        return None
    root, leaves = st
    lv = sub_vertices(left)
    if root in lv:
        return root, leaves
    if len(right) == 1:
        (a, b) = next(iter(right))
        if b in lv:
            return b, frozenset([a])
    return None


# ---------------------------------------------------------------------------
# Plan tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanNode:
    """A node of the join tree. Leaves have no children and a join-unit edge set."""

    edges: SubQuery
    left: Optional["PlanNode"] = None
    right: Optional["PlanNode"] = None
    algo: Optional[str] = None  # "hash" | "wco"     (joins only)
    comm: Optional[str] = None  # "push" | "pull"    (joins only)

    @property
    def is_leaf(self) -> bool:
        return self.left is None

    def vertices(self) -> FrozenSet[int]:
        return sub_vertices(self.edges)

    def depth(self) -> int:
        if self.is_leaf:
            return 1
        return 1 + max(self.left.depth(), self.right.depth())

    def describe(self, indent: int = 0) -> str:
        pad = "  " * indent
        vs = sorted(self.vertices())
        if self.is_leaf:
            st = star_of(self.edges)
            kind = f"star root={st[0]}" if st else "unit"
            return f"{pad}SCAN {vs} ({kind})"
        head = f"{pad}JOIN {vs} [{self.algo}/{self.comm}]"
        return "\n".join([head, self.left.describe(indent + 1), self.right.describe(indent + 1)])


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    query: QueryGraph
    root: PlanNode
    symmetry_conditions: Tuple[Edge, ...]
    est_cost: float = 0.0

    def describe(self) -> str:
        conds = ", ".join(f"v{a}<v{b}" for a, b in self.symmetry_conditions)
        return (
            f"plan for {self.query.name} (est cost {self.est_cost:.3g})\n"
            f"symmetry: [{conds}]\n" + self.root.describe()
        )


# ---------------------------------------------------------------------------
# Plan spaces — Table 2
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanSpace:
    """Constraints under which the optimiser searches (Table 2 presets)."""

    name: str
    units: Tuple[str, ...] = ("star",)          # "star" and/or "clique"
    order: str = "bushy"                         # "bushy" | "leftdeep"
    algos: Tuple[str, ...] = ("hash", "wco")
    comms: Tuple[str, ...] = ("push", "pull")
    complete_star_only: bool = False             # BiGJoin/BENU: rhs must extend one vertex
    unit_max_edges: Optional[int] = None         # BiGJoin/BENU scan single edges only


PLAN_SPACES = {
    # Table 2 rows.
    "starjoin": PlanSpace("starjoin", units=("star",), order="leftdeep", algos=("hash",), comms=("push",)),
    "seed": PlanSpace("seed", units=("star", "clique"), order="bushy", algos=("hash",), comms=("push",)),
    "bigjoin": PlanSpace("bigjoin", units=("star",), order="leftdeep", algos=("wco",), comms=("push",), complete_star_only=True, unit_max_edges=1),
    "benu": PlanSpace("benu", units=("star",), order="leftdeep", algos=("wco",), comms=("pull",), complete_star_only=True, unit_max_edges=1),
    "rads": PlanSpace("rads", units=("star",), order="leftdeep", algos=("hash",), comms=("pull", "push")),
    # HUGE: the full hybrid space.
    "huge": PlanSpace("huge", units=("star",), order="bushy", algos=("hash", "wco"), comms=("push", "pull")),
    # Sequential-context hybrid planners (Exp-9): computation-only cost.
    "emptyheaded": PlanSpace("emptyheaded", units=("star",), order="bushy", algos=("hash", "wco"), comms=("push",)),
    "graphflow": PlanSpace("graphflow", units=("star",), order="bushy", algos=("hash", "wco"), comms=("push",)),
}


def assign_physical(left: SubQuery, right: SubQuery, space: PlanSpace) -> Tuple[str, str]:
    """Eq. 3, restricted to the plan space's allowed algorithms/comm modes."""
    csj = is_complete_star_join(left, right)
    if csj is not None and "wco" in space.algos:
        comm = "pull" if "pull" in space.comms else "push"
        return "wco", comm
    ph = pull_hash_root(left, right)
    if ph is not None and "pull" in space.comms and "hash" in space.algos:
        return "hash", "pull"
    if "hash" in space.algos and "push" in space.comms:
        return "hash", "push"
    if "hash" in space.algos:  # pull-only hash system (RADS always may push? keep pull)
        return "hash", "pull" if "pull" in space.comms else "push"
    # wco-only system forced to push (BiGJoin).
    return "wco", "push" if "push" in space.comms else "pull"
