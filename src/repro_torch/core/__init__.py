"""The paper's contribution as PyTorch modules.

Plan layer:   query, plan, cost, optimizer (Alg. 1), dataflow (Alg. 2)
Engine layer: operators, cache (LRBU, Alg. 3/4), scheduler (Alg. 5),
              engine (single-process + comm accounting)
"""
from repro_torch.core.engine import EngineConfig, HugeEngine, enumerate_query
from repro_torch.core.optimizer import optimal_plan
from repro_torch.core.dataflow import translate
from repro_torch.core.query import PAPER_QUERIES, QueryGraph

__all__ = [
    "EngineConfig", "HugeEngine", "enumerate_query",
    "optimal_plan", "translate", "PAPER_QUERIES", "QueryGraph",
]
