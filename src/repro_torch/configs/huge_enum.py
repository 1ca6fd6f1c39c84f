"""The paper's own workload: subgraph enumeration (the JAX package's
``configs/huge_enum.py``).

``--arch huge-enum`` selects the paper-native architecture: a partitioned
data graph, a query and the HUGE engine. Its "shapes" are (graph size ×
query) pairs mirroring the paper's (dataset × q_i) grid at CI scale.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class EnumConfig:
    name: str = "huge-enum"
    num_vertices: int = 1 << 14
    avg_degree: float = 8.0
    query: str = "q1"
    batch_size: int = 1024
    queue_capacity: int = 1 << 18
    cache_capacity: int = 1 << 14
    num_machines: int = 8
    seed: int = 7

    def scaled(self, **kw) -> "EnumConfig":
        return dataclasses.replace(self, **kw)


def config() -> EnumConfig:
    return EnumConfig()


def smoke() -> EnumConfig:
    return EnumConfig(num_vertices=256, avg_degree=6.0, batch_size=128,
                      queue_capacity=1 << 14, cache_capacity=1 << 10, num_machines=4)
