"""The structured fault taxonomy the engine raises.

Every fault carries its kind, the operator label it fired at and the query
name, so a log line identifies which operator of which query failed and
whether the failure is of a recoverable class. The classes are those of the
JAX package's ``core/faults.py``. Nothing in this port recovers from them
yet: a fault propagates to the caller. Seeded fault injection and the
recovery ladder belong to the fault-tolerance slice.
"""
from __future__ import annotations


class EnumerationFault(RuntimeError):
    """A structured, attributable enumeration failure.

    ``kind`` names the failure class (``queue-overflow``, ``join-overflow``,
    ``kernel-fail``, ...); ``op`` is the failing operator's label and
    ``query`` the dataflow's query name. ``recoverable`` says whether retrying
    under degradation could help."""

    def __init__(self, kind: str, message: str, *, op: str = "?",
                 query: str = "?", recoverable: bool = False):
        self.kind = kind
        self.op = op
        self.query = query
        self.recoverable = recoverable
        self.session = None  # attached by _ScopedRT for attribution
        super().__init__(f"[{kind}] op={op} query={query or '?'}: {message}")


class QueuePressure(EnumerationFault):
    """A queue (or join output buffer) could not absorb a batch: the Lemma 5.2
    slack was exhausted."""

    def __init__(self, kind: str, message: str, *, op: str = "?", query: str = "?"):
        super().__init__(kind, message, op=op, query=query, recoverable=True)


class KernelFault(EnumerationFault):
    """A hand-written kernel failed to build or to launch. The port never
    falls back to the plain version: the fault reaches the caller."""

    def __init__(self, message: str, *, op: str = "?", query: str = "?"):
        super().__init__("kernel-fail", message, op=op, query=query,
                         recoverable=True)
