"""Paper §6 "Applications": path queries on the HUGE machinery.

Shortest path and hop-constrained s-t simple-path enumeration are expressed
with the same PULL-EXTEND primitive (batched neighbour expansion with
injectivity filters) and bounded queues the enumeration engine uses:

  * ``shortest_path_length``: repeated frontier expansion from the source
    (a vectorised BFS) until the target joins the frontier. Each hop gathers
    the frontier's neighbour lists from the CSR, so a hop moves the
    frontier's edges and not ``V × D_pad`` padded slots.
  * ``hop_constrained_paths``: the paper's bi-directional strategy: extend
    simple paths from both endpoints and PUSH-JOIN them in the middle on the
    meeting vertex (join key), verifying simplicity across the seam.

The results are those of the JAX package's ``core/paths.py``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core import operators as ops_mod
from repro_torch.graph.storage import INVALID, Graph


def shortest_path_length(graph: Graph, source: int, target: int,
                         max_hops: int = 64) -> Optional[int]:
    """Unweighted shortest path via vectorised frontier expansion."""
    dev = graph.device
    v = graph.num_vertices
    offsets = graph.offsets.long()
    seen = torch.zeros(v, dtype=torch.bool, device=dev)
    seen[source] = True
    frontier = torch.tensor([source], dtype=torch.int64, device=dev)
    for hop in range(1, max_hops + 1):
        # Neighbours of the whole frontier in one gather (PULL-EXTEND fetch).
        starts = offsets[frontier]
        cnt = offsets[frontier + 1] - starts
        rank = torch.arange(int(cnt.sum()), device=dev) - torch.repeat_interleave(
            torch.cumsum(cnt, 0) - cnt, cnt)
        nbrs = graph.nbrs[torch.repeat_interleave(starts, cnt) + rank].long()
        nxt = torch.zeros(v, dtype=torch.bool, device=dev)
        nxt[nbrs] = True
        nxt &= ~seen
        frontier = nxt.nonzero().squeeze(1)
        if frontier.numel() == 0:
            return None
        seen |= nxt
        if bool(seen[target]):
            # As in the reference, s = t reads 0 only once a first hop finds
            # a new vertex (an isolated s gives None).
            return 0 if target == source else hop
    return None


def _extend_simple_paths(graph: Graph, paths: torch.Tensor, n: int, cap: int):
    """One PULL-EXTEND over path tails with simplicity (injectivity) filters."""
    k = paths.shape[1]
    return ops_mod.extend_batch(
        graph.padded.adj, paths, n, ext=(k - 1,), lt=(), gt=(), out_cap=cap
    )


def hop_constrained_paths(
    graph: Graph, source: int, target: int, hops: int, cap: int = 1 << 16
) -> List[Tuple[int, ...]]:
    """All simple s-t paths with exactly ``hops`` edges (bi-directional:
    extend ⌈h/2⌉ from s and ⌊h/2⌋ from t, join on the meeting vertex)."""
    fw_hops = (hops + 1) // 2
    bw_hops = hops - fw_hops

    def grow(start: int, steps: int):
        rows = torch.full((cap, 1), INVALID, dtype=torch.int32, device=graph.device)
        rows[0, 0] = start
        n = 1
        for _ in range(steps):
            rows, n = _extend_simple_paths(graph, rows, n, cap)
            if n == 0:
                return rows, 0
        return rows, n

    fw, nf = grow(source, fw_hops)     # [*, fw_hops+1] ending at the middle
    bw, nb = grow(target, bw_hops)     # [*, bw_hops+1] ending at the middle
    if nf == 0 or nb == 0:
        return []

    # PUSH-JOIN on the meeting vertex (last column of both sides).
    kf = fw.shape[1]
    kb = bw.shape[1]
    skeys, sbuf = ops_mod.join_prepare(fw, nf, (kf - 1,))
    out, m, overflow = ops_mod.join_probe(
        skeys, sbuf, bw, nb, (kb - 1,),
        tuple(range(kb - 1)),  # append the backward path minus the join vertex
        (), (), cap,
    )
    if overflow:
        raise RuntimeError("path join overflow: raise cap")
    paths = []
    for row in out[:m].tolist():
        full = row[:kf] + row[kf:][::-1]
        if len(set(full)) == len(full):  # simplicity across the seam
            paths.append(tuple(full))
    return paths
