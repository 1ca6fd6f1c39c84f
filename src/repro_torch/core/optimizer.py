"""Algorithm 1: OptimalExecutionPlan — DP over connected sub-queries.

The optimiser minimises computation + communication cost over the plan space:

  cost(q')  =  cost(q'_l) + cost(q'_r) + |R(q')| + comm(q', q'_l, q'_r)
  comm      =  k·|E_G|                      if Eq. 3 assigns pulling
            =  |R(q'_l)| + |R(q'_r)|        otherwise (shuffle both sides)

Sub-queries are encoded as bitmasks over the query's edge list so the DP can
enumerate every edge-disjoint decomposition ``q' = q'_l ∪ q'_r`` with the
sub-mask trick (total work Σ 3^{|E_q|}, fine for ≤ 15-edge queries).

Plan spaces (Table 2) constrain: allowed join units, left-deep vs bushy,
allowed join algorithms/communication modes (see plan.PlanSpace). This single
optimiser therefore produces HUGE's plans *and* the plug-in logical plans of
StarJoin / SEED / BiGJoin / BENU / RADS used by Exp-1/Exp-9.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.core.cost import CardinalityEstimator, GraphStats
from repro_torch.core.plan import (
    ExecutionPlan,
    PlanNode,
    PlanSpace,
    PLAN_SPACES,
    SubQuery,
    assign_physical,
    is_clique_sub,
    is_complete_star_join,
    is_connected,
    star_of,
    sub_vertices,
)
from repro_torch.core.query import QueryGraph, symmetry_break


@dataclasses.dataclass
class _Entry:
    cost: float
    split: Optional[Tuple[int, int]]  # (left_mask, right_mask) or None for a unit


def _mask_edges(mask: int, edge_list: List[Tuple[int, int]]) -> SubQuery:
    return frozenset(e for i, e in enumerate(edge_list) if mask >> i & 1)


def _is_unit(edges: SubQuery, space: PlanSpace) -> bool:
    if space.unit_max_edges is not None and len(edges) > space.unit_max_edges:
        return False
    if "star" in space.units and star_of(edges) is not None:
        return True
    if "clique" in space.units and is_clique_sub(edges):
        return True
    return False


class Optimizer:
    """Paper Algorithm 1, parameterised by a Table-2 plan space."""

    def __init__(self, stats: GraphStats, num_machines: int = 1, space: PlanSpace | str = "huge"):
        self.estimator = CardinalityEstimator(stats)
        self.k = max(1, num_machines)
        self.space = PLAN_SPACES[space] if isinstance(space, str) else space

    # -- cost pieces ---------------------------------------------------------

    def _comm_cost(self, left: SubQuery, right: SubQuery, algo: str, comm: str) -> float:
        if comm == "pull":
            # Remark 3.1: at most the whole data graph per machine.
            return self.k * self.estimator.graph_edges()
        if algo == "wco":
            # push wco: stream R(l) to each leaf owner: ~ d_avg * |R(l)|
            davg = self.estimator.stats.num_directed_edges / max(1, self.estimator.stats.num_vertices)
            return davg * self.estimator.estimate(left)
        return self.estimator.estimate(left) + self.estimator.estimate(right)

    # -- DP ------------------------------------------------------------------

    def plan(self, query: QueryGraph) -> ExecutionPlan:
        edge_list = sorted(query.edges)
        m = len(edge_list)
        full = (1 << m) - 1

        est_cache: Dict[int, float] = {}

        def est(mask: int) -> float:
            if mask not in est_cache:
                est_cache[mask] = self.estimator.estimate(_mask_edges(mask, edge_list))
            return est_cache[mask]

        conn_cache: Dict[int, bool] = {}

        def connected(mask: int) -> bool:
            if mask not in conn_cache:
                conn_cache[mask] = is_connected(_mask_edges(mask, edge_list))
            return conn_cache[mask]

        table: Dict[int, _Entry] = {}

        def solve(mask: int) -> Optional[_Entry]:
            """Best cost to *produce* R(sub-query mask); None if infeasible."""
            if mask in table:
                return table[mask]
            edges = _mask_edges(mask, edge_list)
            if not connected(mask):
                table[mask] = None
                return None
            best: Optional[_Entry] = None
            if _is_unit(edges, self.space):
                best = _Entry(cost=est(mask), split=None)
            # Try every edge-disjoint decomposition (sub-mask enumeration).
            # Skip if the space only has units and this IS a unit (paper line 4
            # returns early for units — decompositions of units never win
            # because any split adds |R(q')| again; keep the early-out).
            if best is None or not _is_unit(edges, self.space):
                sub = (mask - 1) & mask
                seen = set()
                while sub > 0:
                    l_mask, r_mask = sub, mask ^ sub
                    key = min(l_mask, r_mask)
                    if key not in seen and l_mask and r_mask:
                        seen.add(key)
                        cand = self._try_join(mask, l_mask, r_mask, edge_list, solve, est)
                        if cand is not None and (best is None or cand.cost < best.cost):
                            best = cand
                    sub = (sub - 1) & mask
            table[mask] = best
            return best

        entry = solve(full)
        if entry is None:
            raise ValueError(f"no feasible plan for {query.name} in space {self.space.name}")

        root = self._recover(full, edge_list, table)
        return ExecutionPlan(
            query=query,
            root=root,
            symmetry_conditions=tuple(symmetry_break(query)),
            est_cost=entry.cost,
        )

    def _try_join(self, mask, l_mask, r_mask, edge_list, solve, est) -> Optional[_Entry]:
        left = _mask_edges(l_mask, edge_list)
        right = _mask_edges(r_mask, edge_list)
        # Joined sides must share at least one vertex (join key non-empty).
        if not (sub_vertices(left) & sub_vertices(right)):
            return None
        best: Optional[_Entry] = None
        for a_mask, b_mask, a_edges, b_edges in ((l_mask, r_mask, left, right), (r_mask, l_mask, right, left)):
            if self.space.complete_star_only and is_complete_star_join(a_edges, b_edges) is None:
                continue
            algo, comm = assign_physical(a_edges, b_edges, self.space)
            if algo not in self.space.algos or comm not in self.space.comms:
                continue
            # left-deep: the rhs must be a *scannable* unit — except for wco
            # joins, whose star side is virtual (never materialised), so the
            # unit_max_edges scan restriction doesn't apply to it.
            if self.space.order == "leftdeep" and algo != "wco" and not _is_unit(b_edges, self.space):
                continue
            if algo == "wco" and star_of(b_edges) is None:
                continue
            ea = solve(a_mask)
            if ea is None:
                continue
            if algo == "wco":
                # A wco join never materialises its star side (that is its
                # worst-case-optimality).
                rb_cost = 0.0
            else:
                eb = solve(b_mask)
                if eb is None:
                    continue
                rb_cost = eb.cost
            c = ea.cost + rb_cost + est(a_mask | b_mask) + self._comm_cost(a_edges, b_edges, algo, comm)
            if best is None or c < best.cost:
                best = _Entry(cost=c, split=(a_mask, b_mask))
        return best

    def _recover(self, mask: int, edge_list, table) -> PlanNode:
        entry = table[mask]
        edges = _mask_edges(mask, edge_list)
        if entry.split is None:
            return PlanNode(edges=edges)
        l_mask, r_mask = entry.split
        l_edges = _mask_edges(l_mask, edge_list)
        r_edges = _mask_edges(r_mask, edge_list)
        algo, comm = assign_physical(l_edges, r_edges, self.space)
        left = self._recover(l_mask, edge_list, table)
        if algo == "wco":
            right = PlanNode(edges=r_edges)  # star side is never materialised
        else:
            right = self._recover(r_mask, edge_list, table)
        return PlanNode(edges=edges, left=left, right=right, algo=algo, comm=comm)


def optimal_plan(
    query: QueryGraph,
    stats: GraphStats,
    num_machines: int = 1,
    space: PlanSpace | str = "huge",
) -> ExecutionPlan:
    return Optimizer(stats, num_machines, space).plan(query)
