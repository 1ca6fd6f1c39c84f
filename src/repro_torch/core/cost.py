"""Cardinality estimation for the optimiser (paper Alg. 1 line 4, refs [45,50]).

We estimate ``|R(q')|`` (number of monomorphisms of the sub-query in the data
graph) with a degree-moment (Chung-Lu configuration model) formula:

    |R(q')|  ≈  ( Π_{v ∈ V(q')}  S_{deg_{q'}(v)} )  /  (2|E_G|)^{|E(q')|}

where ``S_k = Σ_u d_G(u)^k`` are the degree moments of the data graph. For an
Erdős–Rényi graph this collapses to the classic ``V^n p^m``; for power-law
graphs the higher moments capture hub-driven blow-ups (stars are costed much
higher than paths, matching the paper's observation that RADS' star
materialisation explodes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch.core.plan import SubQuery, sub_vertices
from repro_torch.graph.storage import Graph


@dataclasses.dataclass(frozen=True)
class GraphStats:
    num_vertices: int
    num_directed_edges: int  # 2|E|
    degree_moments: Dict[int, float]  # k -> S_k = sum(d^k)
    max_degree: int

    @staticmethod
    def from_graph(graph: Graph, max_k: int = 8) -> "GraphStats":
        deg = graph.padded.deg.cpu().numpy().astype(np.float64)
        moments = {k: float(np.sum(deg**k)) for k in range(1, max_k + 1)}
        return GraphStats(
            num_vertices=graph.num_vertices,
            num_directed_edges=graph.num_directed_edges,
            degree_moments=moments,
            max_degree=int(deg.max()) if deg.size else 0,
        )

    @staticmethod
    def synthetic(num_vertices: int, avg_degree: float, exponent: float = 2.5, max_k: int = 8) -> "GraphStats":
        """Closed-form power-law moments for plan-time-only estimation."""
        ranks = np.arange(1, num_vertices + 1, dtype=np.float64)
        w = ranks ** (-1.0 / (exponent - 1.0))
        w *= (num_vertices * avg_degree) / w.sum()
        moments = {k: float(np.sum(w**k)) for k in range(1, max_k + 1)}
        return GraphStats(
            num_vertices=num_vertices,
            num_directed_edges=int(num_vertices * avg_degree),
            degree_moments=moments,
            max_degree=int(w.max()),
        )


class CardinalityEstimator:
    def __init__(self, stats: GraphStats):
        self.stats = stats

    def estimate(self, edges: SubQuery) -> float:
        verts = sub_vertices(edges)
        degs = {v: 0 for v in verts}
        for a, b in edges:
            degs[a] += 1
            degs[b] += 1
        num = 1.0
        for v in verts:
            k = degs[v]
            s_k = self.stats.degree_moments.get(k)
            if s_k is None:  # degree beyond precomputed moments: extrapolate
                s_k = self.stats.degree_moments[max(self.stats.degree_moments)] * (
                    float(self.stats.max_degree) ** (k - max(self.stats.degree_moments))
                )
            num *= s_k
        denom = float(self.stats.num_directed_edges) ** len(edges)
        est = num / max(denom, 1.0)
        return max(est, 1.0)

    def graph_edges(self) -> float:
        return float(self.stats.num_directed_edges) / 2.0
