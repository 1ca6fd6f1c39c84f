"""The structured fault taxonomy and deterministic fault injection.

Every fault carries its kind, the operator label it fired at and the query
name, so a log line identifies which operator of which query failed and
whether the failure is recoverable. A seeded :class:`FaultPlan` in
``EngineConfig.faults`` fires named fault kinds at chosen operator
invocations; the same ``(seed, specs)`` always fires at the same step of the
same op. The classes, kinds and trigger steps are those of the JAX package's
``core/faults.py``.

Fault kinds:

====================  =====================================================
``queue-overflow``    an operator output queue cannot absorb a batch
                      (Lemma 5.2 slack exhausted): recovered by halving the
                      batch and biasing the scheduler toward DFS
``join-overflow``     a PUSH-JOIN probe produced more rows than
                      ``join_out_capacity``: recovered the same way
``kernel-fail``       injected only: the batch is computed by the plain
                      path and counted in ``kernel_fallbacks``. A real
                      build or launch failure of a CUDA kernel is not
                      recovered: its ``KernelFault`` reaches the caller
``shard-loss``        a simulated machine died mid-query: recovered by
                      restoring the last checkpoint
``lease-oom``         the multi-tenant service's slot pool refused a lease
                      at admission (the engine injects it nowhere)
====================  =====================================================
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

FAULT_KINDS: Tuple[str, ...] = (
    "queue-overflow",
    "join-overflow",
    "kernel-fail",
    "shard-loss",
    "lease-oom",
)


# ---------------------------------------------------------------------------
# Structured failures
# ---------------------------------------------------------------------------

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
    falls back to the plain version and the recovery ladder does not retry
    it (a rebuild or relaunch would fail the same way): the fault reaches
    the caller. (The JAX package marks it recoverable, because its engine
    recomputes such a batch on the plain twin.)"""

    def __init__(self, message: str, *, op: str = "?", query: str = "?"):
        super().__init__("kernel-fail", message, op=op, query=query,
                         recoverable=False)


class ShardLoss(EnumerationFault):
    """A (simulated) machine died mid-query. Enumeration is deterministic,
    so recovery is re-execution from the last checkpoint."""

    def __init__(self, shard: int, *, op: str = "?", query: str = "?"):
        self.shard = shard
        super().__init__("shard-loss", f"shard {shard} lost", op=op,
                         query=query, recoverable=True)


# ---------------------------------------------------------------------------
# Deterministic injection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: fire ``kind`` at the ``at_step``-th eligible
    invocation of an operator whose label contains ``op`` (``"*"`` matches
    any op). ``at_step=None`` derives the step from the plan seed, so a
    seed sweep moves the trigger across the schedule deterministically.
    ``times`` bounds how often the spec fires (default one-shot, so a
    recovered retry does not re-trip the same fault forever)."""

    kind: str
    op: str = "*"
    at_step: Optional[int] = None
    times: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}"
            )


class FaultPlan:
    """A seeded, deterministic schedule of injected faults.

    ``should_fire(kind, op)`` is the single probe the engines call at every
    injection point; it counts eligible invocations per spec and returns
    True exactly when a spec's trigger step is reached (and its ``times``
    budget is not exhausted). All state is host-side counters.
    ``fired`` records every fired event for assertions and stats."""

    def __init__(self, specs: Tuple[FaultSpec, ...] | List[FaultSpec] = (),
                 seed: int = 0):
        self.seed = int(seed)
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self._seen: Dict[int, int] = {i: 0 for i in range(len(self.specs))}
        self._hits: Dict[int, int] = {i: 0 for i in range(len(self.specs))}
        self.fired: List[Tuple[str, str, int]] = []  # (kind, op, step)

    # -- construction --------------------------------------------------------

    @classmethod
    def single(cls, kind: str, op: str = "*", at_step: Optional[int] = None,
               seed: int = 0, times: int = 1) -> "FaultPlan":
        return cls((FaultSpec(kind, op, at_step, times),), seed=seed)

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultPlan"]:
        """Build a plan from ``REPRO_FAULT_KIND`` / ``REPRO_FAULT_SEED`` /
        ``REPRO_FAULT_OP`` / ``REPRO_FAULT_STEP`` (the JAX package's variables).
        Returns None when no kind is requested."""
        env = os.environ if env is None else env
        kind = env.get("REPRO_FAULT_KIND", "")
        if not kind:
            return None
        step = env.get("REPRO_FAULT_STEP", "")
        return cls.single(
            kind,
            op=env.get("REPRO_FAULT_OP", "*"),
            at_step=int(step) if step else None,
            seed=int(env.get("REPRO_FAULT_SEED", "0")),
        )

    # -- probing -------------------------------------------------------------

    def _trigger_step(self, i: int) -> int:
        spec = self.specs[i]
        if spec.at_step is not None:
            return spec.at_step
        # Seed-derived trigger: a small deterministic hash spreads different
        # (seed, spec) pairs over the first few invocations of the op, so a
        # REPRO_FAULT_SEED sweep exercises early/mid-schedule triggers.
        h = self.seed * 1000003 + i * 10007 + len(spec.kind) * 101
        return (h ^ (h >> 7)) % 6

    def should_fire(self, kind: str, op: str) -> bool:
        fired = False
        for i, spec in enumerate(self.specs):
            if spec.kind != kind:
                continue
            if spec.op != "*" and spec.op.lower() not in op.lower():
                continue  # case-insensitive: labels are uppercase (SCAN/EXT…)
            step = self._seen[i]
            self._seen[i] = step + 1
            if self._hits[i] < spec.times and step >= self._trigger_step(i):
                self._hits[i] += 1
                self.fired.append((kind, op, step))
                fired = True
        return fired

    def fired_count(self, kind: Optional[str] = None) -> int:
        if kind is None:
            return len(self.fired)
        return sum(1 for k, _, _ in self.fired if k == kind)

    def reset(self) -> None:
        """Forget all counters (a fresh run under the same plan)."""
        self._seen = {i: 0 for i in range(len(self.specs))}
        self._hits = {i: 0 for i in range(len(self.specs))}
        self.fired = []
