"""Padded CSR graph storage (PyTorch).

The same layout as the JAX package: the CSR pair ``(offsets, nbrs)`` and a
padded adjacency ``adj[V, D_pad]`` whose rows are the sorted neighbour lists
padded with ``INVALID`` (int32 max). Sorted rows plus a monotone sentinel make
set intersection a binary search, keep padding from matching anything, and
turn the symmetry-breaking orders into integer compares. ``D_pad`` is the max
degree rounded up to a multiple of 128.

The CSR arrays are computed on the host with numpy (bit for bit what the
reference computes); the padded adjacency is filled on the target device, so
a large graph never needs its ``V x D_pad`` matrix in host memory.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

# Sentinel for padded adjacency entries. Larger than any vertex id, so padded
# rows stay sorted and binary-search membership tests are safe.
INVALID = int(np.iinfo(np.int32).max)

_LANE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PaddedAdjacency:
    """Dense, padded adjacency: ``adj[v]`` = sorted neighbours of v, INVALID-padded."""

    adj: torch.Tensor  # int32[V, D_pad]
    deg: torch.Tensor  # int32[V]

    def __post_init__(self):
        if self.adj.ndim == 2 and self.adj.shape[1] % _LANE != 0:
            raise ValueError(
                f"PaddedAdjacency d_pad={self.adj.shape[1]} is not a multiple "
                f"of {_LANE} (build_graph rounds up; do the same)"
            )

    @property
    def num_vertices(self) -> int:
        return self.adj.shape[0]

    @property
    def d_pad(self) -> int:
        return self.adj.shape[1]

    def neighbors(self, vids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather padded neighbour rows for ``vids`` (INVALID rows for invalid ids)."""
        safe = vids.clamp(0, self.num_vertices - 1).long()
        rows = self.adj[safe]
        degs = self.deg[safe]
        ok = (vids >= 0) & (vids < self.num_vertices)
        rows = torch.where(ok[..., None], rows, INVALID)
        degs = torch.where(ok, degs, 0)
        return rows, degs


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected data graph in CSR + padded form, resident on one device."""

    offsets: torch.Tensor  # int32[V+1]
    nbrs: torch.Tensor  # int32[2E] sorted within each row
    padded: PaddedAdjacency

    @property
    def device(self) -> torch.device:
        return self.padded.adj.device

    @property
    def num_vertices(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def num_directed_edges(self) -> int:
        return self.nbrs.shape[0]

    @property
    def num_edges(self) -> int:
        return self.nbrs.shape[0] // 2

    @property
    def max_degree(self) -> int:
        return int(self.padded.deg.max()) if self.num_vertices else 0

    @property
    def avg_degree(self) -> float:
        return float(self.num_directed_edges) / max(1, self.num_vertices)

    def degree(self, vids: torch.Tensor) -> torch.Tensor:
        return self.padded.deg[vids.clamp(0, self.num_vertices - 1).long()]

    def neighbors(self, vids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.padded.neighbors(vids)

    def has_edge(self, u, v) -> torch.Tensor:
        """Vectorised edge test by binary search on the sorted padded rows,
        broadcast over scalar, 1-D and batched ``u``/``v``."""
        u = torch.as_tensor(u, dtype=torch.int32, device=self.device)
        v = torch.as_tensor(v, dtype=torch.int32, device=self.device)
        rows, _ = self.padded.neighbors(u)
        batch_shape = torch.broadcast_shapes(u.shape, v.shape)
        rows = rows.expand(batch_shape + rows.shape[-1:])
        flat_rows = rows.reshape(-1, rows.shape[-1]).contiguous()
        flat_v = v.expand(batch_shape).reshape(-1, 1).contiguous()
        idx = torch.searchsorted(flat_rows, flat_v).clamp_(max=flat_rows.shape[-1] - 1)
        found = flat_rows.gather(1, idx)[:, 0]
        return (found == flat_v[:, 0]).reshape(batch_shape)

    def size_bytes(self) -> int:
        return int(
            self.offsets.numel() * 4 + self.nbrs.numel() * 4
            + self.padded.adj.numel() * 4 + self.padded.deg.numel() * 4
        )

    def to(self, device: str | torch.device) -> "Graph":
        device = torch.device(device)
        if device == self.device:
            return self
        return Graph(
            offsets=self.offsets.to(device),
            nbrs=self.nbrs.to(device),
            padded=PaddedAdjacency(
                adj=self.padded.adj.to(device), deg=self.padded.deg.to(device)
            ),
        )


def _csr(edges: np.ndarray, num_vertices: int):
    """Canonical CSR of an undirected edge array (reference ``build_graph``)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    edges = edges[edges[:, 0] != edges[:, 1]]
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    und = np.unique(np.stack([lo, hi], axis=1), axis=0)
    both = np.concatenate([und, und[:, ::-1]], axis=0)
    order = np.lexsort((both[:, 1], both[:, 0]))
    both = both[order]
    src, dst = both[:, 0], both[:, 1]
    deg = np.bincount(src, minlength=num_vertices).astype(np.int32)
    offsets = np.zeros(num_vertices + 1, dtype=np.int32)
    np.cumsum(deg, out=offsets[1:])
    return src, dst.astype(np.int32), deg, offsets


def build_graph(
    edges: np.ndarray,
    num_vertices: int,
    d_pad: int | None = None,
    device: str | torch.device | None = None,
) -> Graph:
    """Build a :class:`Graph` from an undirected edge array ``int[E, 2]``.

    Self loops and duplicate edges are removed; adjacency is symmetrised and
    sorted. ``d_pad`` defaults to max degree rounded up to 128; an explicit
    ``d_pad`` is rounded up to 128 as well."""
    dev = resolve_device(device)
    src, nbrs, deg, offsets = _csr(edges, num_vertices)
    max_deg = int(deg.max()) if deg.size else 0
    if d_pad is None:
        d_pad = max(_LANE, _round_up(max(1, max_deg), _LANE))
    else:
        d_pad = max(_LANE, _round_up(int(d_pad), _LANE))
    if max_deg > d_pad:
        raise ValueError(f"d_pad={d_pad} smaller than max degree {max_deg}")

    col = np.arange(src.shape[0], dtype=np.int64) - offsets[:-1].astype(np.int64)[src]
    adj = torch.full((num_vertices, d_pad), INVALID, dtype=torch.int32, device=dev)
    adj[torch.from_numpy(src).to(dev), torch.from_numpy(col).to(dev)] = (
        torch.from_numpy(nbrs).to(dev)
    )
    return Graph(
        offsets=torch.from_numpy(offsets).to(dev),
        nbrs=torch.from_numpy(nbrs).to(dev),
        padded=PaddedAdjacency(adj=adj, deg=torch.from_numpy(deg).to(dev)),
    )


def from_numpy(
    offsets: np.ndarray,
    nbrs: np.ndarray,
    adj: np.ndarray,
    deg: np.ndarray,
    device: str | torch.device | None = None,
) -> Graph:
    """Wrap the four arrays of an existing graph (e.g. the JAX reference's, as
    numpy) as a :class:`Graph` on ``device``, unchanged."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)

    return Graph(
        offsets=t(offsets), nbrs=t(nbrs), padded=PaddedAdjacency(adj=t(adj), deg=t(deg))
    )


# ---------------------------------------------------------------------------
# Streaming updates (edge inserts)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphUpdateBatch:
    """A batch of graph mutations. Only edge inserts are supported: deletes
    would need the pre-batch adjacency, which inserts can reconstruct as
    the new adjacency minus the delta."""

    edges: np.ndarray  # int[E, 2] undirected; self loops / dups tolerated
    kind: str = "insert"

    def __post_init__(self):
        if self.kind != "insert":
            raise NotImplementedError(
                f"GraphUpdateBatch kind={self.kind!r}: only 'insert' is "
                "supported (deletes need old-epoch adjacency snapshots)"
            )

    @property
    def num_edges(self) -> int:
        return int(np.asarray(self.edges).reshape(-1, 2).shape[0])


@dataclasses.dataclass(frozen=True)
class AppliedUpdates:
    """Result of :func:`apply_updates`.

    ``graph`` is the post-batch graph G_new; ``delta`` is a :class:`Graph`
    over the *genuinely new* edges only (already-present edges and dups are
    dropped), which serves both as the delta scan source and as the
    old-epoch membership filter: for pure inserts,
    ``N_old(v) = N_new(v) \\ N_delta(v)``."""

    graph: Graph
    delta: Graph
    edges: np.ndarray       # int32[E_new, 2] canonical genuinely-new edges
    touched: np.ndarray     # int32[T] vertex ids whose adjacency rows changed

    @property
    def num_new_edges(self) -> int:
        return int(self.edges.shape[0])


def _canonical_new_edges(offsets: np.ndarray, nbrs: np.ndarray,
                         batch: GraphUpdateBatch) -> np.ndarray:
    """Canonicalise a batch against the graph's host CSR: drop self loops,
    duplicates, out-of-range endpoints (an error), and edges already present."""
    edges = np.asarray(batch.edges, dtype=np.int64).reshape(-1, 2)
    if edges.size == 0:
        return np.zeros((0, 2), np.int64)
    v = offsets.shape[0] - 1
    if edges.min() < 0 or edges.max() >= v:
        raise ValueError(
            f"update batch references vertices outside [0, {v}) "
            "(vertex inserts are not supported; grow the graph by rebuild)"
        )
    edges = edges[edges[:, 0] != edges[:, 1]]
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    und = np.unique(np.stack([lo, hi], axis=1), axis=0)
    if und.size == 0:
        return und.reshape(0, 2)
    starts = offsets[und[:, 0]]
    ends = offsets[und[:, 0] + 1]
    present = np.zeros(und.shape[0], bool)
    for i, (a, b) in enumerate(und):
        row = nbrs[starts[i] : ends[i]]
        j = np.searchsorted(row, b)
        present[i] = j < row.shape[0] and row[j] == b
    return und[~present]


def apply_updates(graph: Graph, batch: GraphUpdateBatch) -> AppliedUpdates:
    """Apply an edge-insert batch, rebuilding only the affected rows.

    CSR: the new directed neighbours are spliced into ``nbrs`` on the host
    with one ``np.insert`` (positions by per-row binary search) and the
    offsets re-accumulated. Padded adjacency: a new tensor on the graph's
    device, a clone of the old one (or, when a touched row overflows
    ``d_pad``, a fresh one grown by whole multiples of 128 lanes), into
    which only the touched rows are written; the adjacency never passes
    through the host. The input graph is left unchanged."""
    dev = graph.device
    offsets = graph.offsets.cpu().numpy().astype(np.int64)
    nbrs = graph.nbrs.cpu().numpy()
    new_edges = _canonical_new_edges(offsets, nbrs, batch)
    v = graph.num_vertices
    delta = build_graph(new_edges, v, device=dev)
    if new_edges.shape[0] == 0:
        return AppliedUpdates(
            graph=graph, delta=delta,
            edges=new_edges.astype(np.int32),
            touched=np.zeros((0,), np.int32),
        )

    deg = graph.padded.deg.cpu().numpy()
    # Directed view of the inserts, sorted by (row, value) so np.insert keeps
    # every row sorted even when one row receives several new neighbours.
    src = np.concatenate([new_edges[:, 0], new_edges[:, 1]])
    dst = np.concatenate([new_edges[:, 1], new_edges[:, 0]]).astype(np.int32)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    # Insert position of each new neighbour inside its row, relative to the
    # *original* flat nbrs array (np.insert semantics).
    pos = np.empty(src.shape[0], np.int64)
    for i in range(src.shape[0]):
        row = nbrs[offsets[src[i]] : offsets[src[i] + 1]]
        pos[i] = offsets[src[i]] + np.searchsorted(row, dst[i])
    new_nbrs = np.insert(nbrs, pos, dst)

    add_cnt = np.bincount(src, minlength=v).astype(np.int32)
    new_deg = deg + add_cnt
    new_offsets = np.zeros(v + 1, dtype=np.int32)
    np.cumsum(new_deg, out=new_offsets[1:])

    touched = np.unique(src).astype(np.int32)
    old_adj = graph.padded.adj
    d_pad = old_adj.shape[1]
    max_deg = int(new_deg.max())
    if max_deg > d_pad:
        d_pad = _round_up(max_deg, _LANE)
        adj = torch.full((v, d_pad), INVALID, dtype=torch.int32, device=dev)
        adj[:, : old_adj.shape[1]] = old_adj
    else:
        adj = old_adj.clone()
    rows = np.full((touched.shape[0], d_pad), INVALID, dtype=np.int32)
    for i, t in enumerate(touched):
        row = new_nbrs[new_offsets[t] : new_offsets[t + 1]]
        rows[i, : row.shape[0]] = row
    adj.index_copy_(0, torch.from_numpy(touched.astype(np.int64)).to(dev),
                    torch.from_numpy(rows).to(dev))

    new_graph = Graph(
        offsets=torch.from_numpy(new_offsets).to(dev),
        nbrs=torch.from_numpy(new_nbrs.astype(np.int32)).to(dev),
        padded=PaddedAdjacency(adj=adj, deg=torch.from_numpy(new_deg).to(dev)),
    )
    return AppliedUpdates(
        graph=new_graph, delta=delta,
        edges=new_edges.astype(np.int32), touched=touched,
    )


def from_edge_list(
    edge_list: Iterable[Sequence[int]],
    num_vertices: int | None = None,
    device: str | torch.device | None = None,
) -> Graph:
    edges = np.asarray(list(edge_list), dtype=np.int64).reshape(-1, 2)
    if num_vertices is None:
        num_vertices = int(edges.max()) + 1 if edges.size else 0
    return build_graph(edges, num_vertices, device=device)


def to_networkx(graph: Graph):
    """Convert to networkx (host-side) for oracle validation."""
    import networkx as nx

    g = nx.Graph()
    g.add_nodes_from(range(graph.num_vertices))
    offsets = graph.offsets.cpu().numpy()
    nbrs = graph.nbrs.cpu().numpy()
    for v in range(graph.num_vertices):
        for u in nbrs[offsets[v] : offsets[v + 1]]:
            if v < u:
                g.add_edge(v, int(u))
    return g
