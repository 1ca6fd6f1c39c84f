"""Graph substrate: padded CSR storage and deterministic generators."""
from repro_torch.graph.storage import (
    INVALID,
    AppliedUpdates,
    Graph,
    GraphUpdateBatch,
    PaddedAdjacency,
    apply_updates,
    build_graph,
    from_edge_list,
    from_numpy,
)
from repro_torch.graph.partition import PartitionedGraph, partition_graph
from repro_torch.graph.generators import (
    erdos_renyi,
    grid_graph,
    powerlaw_graph,
    ring_of_cliques,
)

__all__ = [
    "INVALID",
    "AppliedUpdates",
    "Graph",
    "GraphUpdateBatch",
    "PaddedAdjacency",
    "PartitionedGraph",
    "apply_updates",
    "build_graph",
    "from_edge_list",
    "from_numpy",
    "partition_graph",
    "erdos_renyi",
    "powerlaw_graph",
    "ring_of_cliques",
    "grid_graph",
]
