"""Serving: the batched LM server. The multi-tenant graph service comes with its own slice."""
from repro_torch.serve.engine import BatchedServer, Request, ServeConfig

__all__ = ["ServeConfig", "Request", "BatchedServer"]
