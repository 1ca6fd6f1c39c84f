"""Deterministic synthetic graph generators (host-side numpy).

Each generator makes the same ``np.random.default_rng`` draws as the JAX
package's ``graph/generators.py``, so a seed gives the identical graph; only
the storage it is built into (and its device) differs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.storage import Graph, build_graph


def erdos_renyi(num_vertices: int, avg_degree: float, seed: int = 0,
                device: str | torch.device | None = None) -> Graph:
    """G(n, p) with p chosen for the requested average degree."""
    rng = np.random.default_rng(seed)
    p = min(1.0, avg_degree / max(1, num_vertices - 1))
    n_expected = int(num_vertices * (num_vertices - 1) / 2 * p)
    m = int(n_expected * 1.2) + 16
    src = rng.integers(0, num_vertices, size=m, dtype=np.int64)
    dst = rng.integers(0, num_vertices, size=m, dtype=np.int64)
    edges = np.stack([src, dst], axis=1)
    edges = edges[src != dst][:n_expected]
    return build_graph(edges, num_vertices, device=device)


def powerlaw_graph(num_vertices: int, avg_degree: float, exponent: float = 2.5,
                   seed: int = 0, device: str | torch.device | None = None) -> Graph:
    """Configuration-model power-law graph (Chung-Lu sampling).

    Degree weights w_i ∝ i^{-1/(exponent-1)}; edge (u,v) sampled with
    probability ∝ w_u * w_v, then vertices are relabelled by a random
    permutation so owner hashing (v % P) is unbiased w.r.t. degree.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_vertices + 1, dtype=np.float64)
    w = ranks ** (-1.0 / (exponent - 1.0))
    w /= w.sum()
    target_edges = int(num_vertices * avg_degree / 2)
    m = int(target_edges * 1.3) + 16
    src = rng.choice(num_vertices, size=m, p=w)
    dst = rng.choice(num_vertices, size=m, p=w)
    edges = np.stack([src, dst], axis=1)
    edges = edges[src != dst][:target_edges]
    perm = rng.permutation(num_vertices)
    edges = perm[edges]
    return build_graph(edges, num_vertices, device=device)


def ring_of_cliques(num_cliques: int, clique_size: int,
                    device: str | torch.device | None = None) -> Graph:
    """`num_cliques` k-cliques chained in a ring — clique-query stress test."""
    edges = []
    for c in range(num_cliques):
        base = c * clique_size
        for i in range(clique_size):
            for j in range(i + 1, clique_size):
                edges.append((base + i, base + j))
        nxt = ((c + 1) % num_cliques) * clique_size
        edges.append((base, nxt))
    return build_graph(np.asarray(edges), num_cliques * clique_size, device=device)


def grid_graph(rows: int, cols: int, device: str | torch.device | None = None) -> Graph:
    """2-D grid — road-network-like: low, uniform degree."""
    edges = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if c + 1 < cols:
                edges.append((v, v + 1))
            if r + 1 < rows:
                edges.append((v, v + cols))
    return build_graph(np.asarray(edges), rows * cols, device=device)
