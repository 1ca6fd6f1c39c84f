"""The paper's contribution as PyTorch modules.

Plan layer:   query, plan, cost, optimizer (Alg. 1), dataflow (Alg. 2)
Engine layer: operators, cache (LRBU, Alg. 3/4), scheduler (Alg. 5),
              engine (single-process + comm accounting, recovery, deltas,
              the service's queue-slot pool),
              faults (taxonomy + deterministic injection)
Comm rules:   hybrid_comm (Eq. 3 for enumeration joins and MoE/vocab joins)
Applications: paths (paper §6: shortest / hop-constrained paths)
"""
from repro_torch.core.engine import (
    EngineConfig,
    HugeEngine,
    QueueSlotPool,
    enumerate_query,
)
from repro_torch.core.optimizer import optimal_plan
from repro_torch.core.dataflow import translate
from repro_torch.core.query import PAPER_QUERIES, QueryGraph

__all__ = [
    "EngineConfig", "HugeEngine", "QueueSlotPool", "enumerate_query",
    "optimal_plan", "translate", "PAPER_QUERIES", "QueryGraph",
]
