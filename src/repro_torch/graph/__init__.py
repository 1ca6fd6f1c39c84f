"""Graph substrate: padded CSR storage and deterministic generators."""
from repro_torch.graph.storage import (
    INVALID,
    Graph,
    PaddedAdjacency,
    build_graph,
    from_edge_list,
    from_numpy,
)
from repro_torch.graph.generators import (
    erdos_renyi,
    grid_graph,
    powerlaw_graph,
    ring_of_cliques,
)

__all__ = [
    "INVALID",
    "Graph",
    "PaddedAdjacency",
    "build_graph",
    "from_edge_list",
    "from_numpy",
    "erdos_renyi",
    "powerlaw_graph",
    "ring_of_cliques",
    "grid_graph",
]
