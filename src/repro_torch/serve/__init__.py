"""Serving: the batched LM server and the multi-tenant graph service."""
from repro_torch.serve.engine import BatchedServer, Request, ServeConfig
from repro_torch.serve.graph_service import (
    GraphQueryRequest,
    GraphService,
    QueryTicket,
    ServiceConfig,
    TenantBudget,
)

__all__ = [
    "ServeConfig", "Request", "BatchedServer",
    "GraphService", "GraphQueryRequest", "QueryTicket",
    "ServiceConfig", "TenantBudget",
]
