"""Random (hash) vertex partitioning — paper Section 2 "Graph Storage".

Vertex ``v`` is owned by shard ``v % num_shards`` (cyclic ≈ random for
arbitrary id assignment) and stored there with its full adjacency list, at
local index ``v // num_shards``. Every shard's padded adjacency has
``ceil(V / num_shards)`` rows; rows past the shard's last vertex are INVALID.

``partition_graph`` builds the stacked ``[P, V_per, D_pad]`` form the JAX
package hands to ``shard_map`` (bit for bit). The distributed engine never
stages that form: each rank cuts its own shard out of the padded adjacency
with ``shard_adjacency`` (a view when ``P == 1``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.graph.storage import INVALID, Graph


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Padded adjacency stacked by shard. Owner(v) = v % P, local(v) = v // P."""

    adj: torch.Tensor  # int32[P, V_per, D_pad]
    deg: torch.Tensor  # int32[P, V_per]
    num_vertices: int
    num_shards: int

    @property
    def v_per_shard(self) -> int:
        return self.adj.shape[1]

    @property
    def d_pad(self) -> int:
        return self.adj.shape[2]

    def owner(self, vids: torch.Tensor) -> torch.Tensor:
        return torch.where(vids >= 0, vids % self.num_shards, -1)

    def local_index(self, vids: torch.Tensor) -> torch.Tensor:
        return torch.where(vids >= 0, vids // self.num_shards, 0)

    def shard_bytes(self) -> int:
        return int(self.adj.numel() * 4 + self.deg.numel() * 4) // self.num_shards


def partition_graph(graph: Graph, num_shards: int) -> PartitionedGraph:
    """Split ``graph`` into ``num_shards`` cyclic partitions, stacked on the
    graph's device."""
    v = graph.num_vertices
    v_per = (v + num_shards - 1) // num_shards
    dev = graph.device
    adj = torch.full((num_shards, v_per, graph.padded.d_pad), INVALID,
                     dtype=torch.int32, device=dev)
    deg = torch.zeros((num_shards, v_per), dtype=torch.int32, device=dev)
    vids = torch.arange(v, device=dev)
    adj[vids % num_shards, vids // num_shards] = graph.padded.adj
    deg[vids % num_shards, vids // num_shards] = graph.padded.deg
    return PartitionedGraph(adj=adj, deg=deg, num_vertices=v, num_shards=num_shards)


def shard_adjacency(graph: Graph, num_shards: int, rank: int,
                    device: torch.device | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard ``rank``'s rows of ``partition_graph(graph, num_shards)``:
    ``(adj[V_per, D_pad], deg[V_per])`` on ``device`` (the graph's by
    default), contiguous. At ``num_shards == 1`` these are the graph's own
    tensors, with no copy."""
    device = graph.device if device is None else torch.device(device)
    v = graph.num_vertices
    v_per = (v + num_shards - 1) // num_shards
    adj, deg = graph.padded.adj, graph.padded.deg
    if num_shards == 1:
        return adj.to(device), deg.to(device)
    rows = adj[rank::num_shards]
    out_adj = torch.full((v_per, adj.shape[1]), INVALID, dtype=torch.int32, device=device)
    out_deg = torch.zeros((v_per,), dtype=torch.int32, device=device)
    out_adj[: rows.shape[0]] = rows.to(device)
    out_deg[: rows.shape[0]] = deg[rank::num_shards].to(device)
    return out_adj, out_deg
