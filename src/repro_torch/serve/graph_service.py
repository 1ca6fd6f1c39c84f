"""Multi-tenant graph service: subgraph matching as a service.

N concurrent ``GraphQueryRequest``s (query graph + plan space + per-tenant
match/memory budgets) share ONE ``HugeEngine``: every admitted query becomes
an ``EngineSession`` owning a slot-slice of the device queues, leased from a
``QueueSlotPool`` whose total is the service-level Theorem 5.4 bound. One
scheduler pass per service ``tick`` drives a single ``AdaptiveScheduler``
over the *concatenation* of all active sessions' operator chains: the
BFS/DFS-adaptive policy interleaves runnable ops across tenants exactly as it
interleaves ops within one query, so the aggregate in-flight state stays
under the pool bound structurally (every queue is preallocated from the
lease). Finished queries drain their counts, release their cells, and the
admission queue refills the freed slots; requests that would exceed a
tenant's caps are rejected or queued instead of running the device out of
memory. With ``EngineConfig(fused=True)`` every session runs the engine's
CUDA kernels.

Lifecycle of a request::

    submit() ──▶ QUEUED ──admission (pool lease + tenant caps)──▶ RUNNING
                   │                                                │
                   └──caps violated / queue full──▶ REJECTED        ├─▶ DONE
                                                                    └─▶ BUDGET_EXCEEDED

Latency is stamped per request on the host clock, ``submitted_at`` at submit
and ``finished_at`` when the service decides the request is finished (on a
card, queued device work of the last tick may still be running then).

The service is cooperative and single-threaded: a "tick" is the unit a
driving loop (``launch/serve.py`` graph mode, ``launch/service_load.py``)
calls as fast as it likes; all state lives in device queues and host
cursors, so the outcome is the same under any tick schedule, and equal to
the JAX package's service on the same inputs.

Two things differ from the JAX package's service. A retired session is
closed (``EngineSession.close``), so its device queues are freed by
reference counting and not by the cycle collector. And a real
``KernelFault`` (a CUDA kernel that failed to build or launch) is not a
ticket outcome: ``tick`` releases the session's lease, slot and tenant
accounting and re-raises it (the JAX engine recomputes such a batch on its
plain path, so its service never sees one).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

# The pre-flight is looked up in its module at each call, as the engine's
# ``prepare`` does, so a caller can wrap ``flowcheck.verify_flow`` to time it.
from repro_torch.analysis import flowcheck
from repro_torch.analysis.diagnostics import Diagnostic, FlowcheckError, errors
from repro_torch.core.cost import GraphStats
from repro_torch.core.dataflow import Dataflow, delta_flows, merge_flows
from repro_torch.core.engine import (
    EngineConfig,
    EngineSession,
    EngineStats,
    HugeEngine,
    QueueSlotPool,
    flow_queue_cells,
)
from repro_torch.core.faults import EnumerationFault, FaultPlan, KernelFault, ShardLoss
from repro_torch.core.optimizer import optimal_plan
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.query import PAPER_QUERIES, QueryGraph
from repro_torch.core.scheduler import AdaptiveScheduler
from repro_torch.graph.storage import Graph, GraphUpdateBatch

# Request states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
REJECTED = "rejected"
BUDGET_EXCEEDED = "budget_exceeded"
CANCELLED = "cancelled"
FAILED = "failed"          # fault not recovered within the retry budget
TIMED_OUT = "timed_out"    # request deadline_s expired


@dataclasses.dataclass(frozen=True)
class TenantBudget:
    """Per-tenant caps. ``None`` means uncapped (subject to the global pool)."""

    max_matches: Optional[int] = None     # default per-query match budget
    max_queue_cells: Optional[int] = None # aggregate int32 cells across the
                                          #   tenant's admitted queries
    max_inflight: int = 8                 # queued + running queries


@dataclasses.dataclass
class GraphQueryRequest:
    """One tenant's enumeration request.

    ``query`` is a :class:`QueryGraph`, a name in ``PAPER_QUERIES`` (q1..q8),
    or, for tenants that bring their own planning, an
    :class:`ExecutionPlan` or raw :class:`Dataflow`; all forms pass the same
    flowcheck pre-flight at admission, so a malformed submission is rejected
    with structured diagnostics before any queue is leased. ``match_budget``
    stops the query once at least that many matches have been produced
    (batch-granular: the reported count may overshoot by up to the in-flight
    batches of the tick that crossed the line, never undershoot)."""

    tenant: str
    query: QueryGraph | ExecutionPlan | Dataflow | str
    space: str = "huge"
    match_budget: Optional[int] = None
    deadline_s: Optional[float] = None  # submit→finish wall-clock budget:
    #   past it the request times out (queued or running) instead of retrying


@dataclasses.dataclass
class QueryTicket:
    """Handle returned by ``submit``; the service mutates it in place."""

    id: int
    request: GraphQueryRequest
    status: str = QUEUED
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    count: int = 0
    queue_cells: int = 0
    stats: Optional[EngineStats] = None
    error: Optional[str] = None
    # Structured flowcheck findings when the request was rejected at
    # admission (rule ids + hints; see repro_torch.analysis.diagnostics).
    diagnostics: Tuple[Diagnostic, ...] = ()
    # Fault-tolerance bookkeeping: how many admissions this ticket consumed,
    # the structured message of every fault it survived, and the earliest
    # tick at which a requeued attempt may re-admit (retry backoff).
    attempts: int = 0
    failures: List[str] = dataclasses.field(default_factory=list)
    not_before_tick: int = 0

    @property
    def latency_s(self) -> Optional[float]:
        """Submit→finish host time, stamped per request (never inherited
        from requests served before it)."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    # Global admission bound: total int32 cells all active sessions' device
    # queues may occupy (the service-level Theorem 5.4 budget the pool
    # enforces).
    total_queue_cells: int = 64 << 20
    # Slot-slice sizing per admitted query (passed to EngineSession; smaller
    # than the single-query engine defaults so many tenants fit the pool).
    queue_capacity: int = 1 << 12
    join_buffer_capacity: int = 1 << 14
    max_active: int = 8               # concurrent sessions (slots)
    admission_queue_len: int = 64     # beyond this, submit() rejects
    tick_steps: int = 32              # scheduler steps per active session per tick
    default_budget: TenantBudget = TenantBudget()
    # Fault tolerance. Every N ticks each active session is snapshotted; 0
    # disables checkpoints, in which case a recoverable fault restarts the
    # query from scratch via the retry path.
    checkpoint_every_ticks: int = 0
    max_retries: int = 2              # re-admissions after the first attempt
    retry_backoff_ticks: int = 2      # backoff = this * attempts ticks
    faults: Optional[FaultPlan] = None  # service-level injection (lease-oom)


@dataclasses.dataclass
class _Active:
    ticket: QueryTicket
    session: EngineSession


@dataclasses.dataclass
class StandingQuery:
    """A continuous subgraph query: registered once, answered per batch.

    The delta-join decomposition depends only on the query, so the merged
    multi-sink delta dataflow is translated and cached at registration;
    every ``apply_batch`` re-submits it as an ordinary request: standing
    deltas ride the *same* QueueSlotPool admission and Theorem-5.4 pricing
    as ad-hoc queries. ``history`` records one (ticket, count) outcome per
    applied batch."""

    id: int
    tenant: str
    query: QueryGraph
    plan: ExecutionPlan
    delta_flow: Dataflow                      # merged k-sink delta DAG
    match_budget: Optional[int] = None
    total_count: int = 0
    history: List[Tuple[QueryTicket, int]] = dataclasses.field(default_factory=list)


class GraphService:
    """Subgraph matching as a service over one shared :class:`HugeEngine`,
    built on ``device`` (the card unless the caller asks for the CPU).

    >>> svc = GraphService(graph)
    >>> t = svc.submit(GraphQueryRequest(tenant="a", query="q1"))
    >>> svc.run_until_idle()
    >>> t.status, t.count
    """

    def __init__(
        self,
        graph: Graph,
        cfg: ServiceConfig | None = None,
        engine_cfg: EngineConfig | None = None,
        tenants: Dict[str, TenantBudget] | None = None,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg or ServiceConfig()
        self.engine = HugeEngine(graph, engine_cfg, device=device)
        self.gstats = GraphStats.from_graph(self.engine.graph)
        self.pool = QueueSlotPool(self.cfg.total_queue_cells)
        self.tenants: Dict[str, TenantBudget] = dict(tenants or {})
        self._tenant_cells: Dict[str, int] = {}
        self._tenant_inflight: Dict[str, int] = {}
        self._ids = itertools.count()
        self._planned: Dict[int, tuple] = {}  # ticket id -> (cells, flow)
        # ticket id -> (flow, session snapshot): the newest checkpoint of each
        # running query (taken every cfg.checkpoint_every_ticks ticks) and the
        # pinned resume state for tickets re-admitted via ``resume``.
        self._checkpoints: Dict[int, tuple] = {}
        self._restore_snap: Dict[int, tuple] = {}
        self.admission: deque[QueryTicket] = deque()
        self.active: List[_Active] = []
        self._rr = 0                      # round-robin offset for tick fairness
        self.ticks = 0
        self.peak_pool_cells = 0
        self.peak_inflight_rows = 0
        self.standing: List[StandingQuery] = []
        self.batches_applied = 0

    # -- tenant accounting ---------------------------------------------------

    def _budget(self, tenant: str) -> TenantBudget:
        return self.tenants.get(tenant, self.cfg.default_budget)

    def tenant_usage(self, tenant: str) -> Dict[str, int]:
        return {
            "inflight": self._tenant_inflight.get(tenant, 0),
            "queue_cells": self._tenant_cells.get(tenant, 0),
        }

    # -- submission / admission ----------------------------------------------

    def _resolve_query(self, req: GraphQueryRequest) -> QueryGraph | ExecutionPlan | Dataflow:
        if isinstance(req.query, (QueryGraph, ExecutionPlan, Dataflow)):
            return req.query
        if req.query in PAPER_QUERIES:
            return PAPER_QUERIES[req.query]
        raise KeyError(f"unknown query name: {req.query!r}")

    def submit(self, req: GraphQueryRequest) -> QueryTicket:
        """Accept a request into the admission queue (or reject it outright).

        Rejection happens at submit time only for violations no amount of
        waiting can cure or that protect the queue itself: an unknown query,
        a full admission queue, or a tenant over its inflight cap. Memory-cap
        checks happen at admission time, when the queues are actually sized."""
        ticket = QueryTicket(id=next(self._ids), request=req,
                             submitted_at=time.perf_counter())
        try:
            self._resolve_query(req)
        except KeyError as e:
            ticket.status = REJECTED
            ticket.error = str(e)
            ticket.finished_at = time.perf_counter()
            return ticket
        budget = self._budget(req.tenant)
        if self._tenant_inflight.get(req.tenant, 0) >= budget.max_inflight:
            ticket.status = REJECTED
            ticket.error = f"tenant {req.tenant!r} over max_inflight={budget.max_inflight}"
            ticket.finished_at = time.perf_counter()
            return ticket
        if len(self.admission) >= self.cfg.admission_queue_len:
            ticket.status = REJECTED
            ticket.error = "admission queue full"
            ticket.finished_at = time.perf_counter()
            return ticket
        self._tenant_inflight[req.tenant] = self._tenant_inflight.get(req.tenant, 0) + 1
        self.admission.append(ticket)
        return ticket

    def _price(self, ticket: QueryTicket):
        """Plan once, verify once, price once: ``(cells, flow)`` the
        request's session will lease and execute (cached, so waiting tickets
        are not re-planned every admission sweep).

        Raises :class:`FlowcheckError` when the submission fails static
        verification (query/plan checks for self-planned forms, then the
        full dataflow check), so ``_try_admit`` can reject with the rule ids
        *before* touching the slot pool."""
        if ticket.id not in self._planned:
            req = ticket.request
            target = self._resolve_query(req)
            if isinstance(target, QueryGraph):
                bad = errors(flowcheck.check_query(target))
                if bad:
                    raise FlowcheckError(bad)
            elif isinstance(target, ExecutionPlan):
                bad = errors(flowcheck.check_plan(target))
                if bad:
                    raise FlowcheckError(bad)
            flow = self.engine.to_flow(target, req.space, self.gstats)
            flowcheck.verify_flow(
                flow, cfg=self.engine.cfg, d_pad=self.engine.d_pad,
                queue_capacity=self.cfg.queue_capacity,
                join_buffer_capacity=self.cfg.join_buffer_capacity,
            )
            cells = flow_queue_cells(
                flow, self.engine.cfg, self.engine.d_pad,
                self.cfg.queue_capacity, self.cfg.join_buffer_capacity,
            )
            self._planned[ticket.id] = (cells, flow)
        return self._planned[ticket.id]

    def _try_admit(self) -> int:
        """First-fit admission sweep: walk the queue in arrival order, admit
        every request whose slot-slice fits the pool, its tenant's cell cap,
        and a free active slot. Requests that exceed their tenant's *absolute*
        cap (could never fit even on an idle service) are rejected."""
        admitted = 0
        still_waiting: deque[QueryTicket] = deque()
        fp = self.cfg.faults
        while self.admission:
            ticket = self.admission.popleft()
            if ticket.not_before_tick > self.ticks:
                still_waiting.append(ticket)  # retry backoff not elapsed
                continue
            if len(self.active) >= self.cfg.max_active:
                still_waiting.append(ticket)
                continue
            req = ticket.request
            budget = self._budget(req.tenant)
            try:
                cells, flow = self._price(ticket)
            except FlowcheckError as e:
                # Malformed submission: reject with the structured findings.
                # Nothing was leased, so the pool is untouched.
                ticket.diagnostics = e.diagnostics
                rules = ", ".join(sorted({d.rule for d in e.diagnostics}))
                self._reject(ticket, f"flowcheck rejected query ({rules}): {e}")
                continue
            if budget.max_queue_cells is not None and cells > budget.max_queue_cells:
                self._reject(ticket,
                             f"query needs {cells} cells > tenant cap "
                             f"{budget.max_queue_cells}")
                continue
            if cells > self.pool.total_cells:
                ticket.diagnostics = (Diagnostic(
                    "queue-over-pool",
                    f"flow preallocates {cells} int32 queue cells > service "
                    f"pool {self.pool.total_cells}",
                    hint="shrink queue/join-buffer capacities or split the query",
                ),)
                self._reject(ticket,
                             f"query needs {cells} cells > service pool "
                             f"{self.pool.total_cells}")
                continue
            used = self._tenant_cells.get(req.tenant, 0)
            if fp is not None and fp.should_fire("lease-oom", "admit"):
                # Injected transient allocator refusal: indistinguishable from
                # a momentarily full pool, so the ticket simply waits for the
                # next sweep (lease-oom is recoverable by construction).
                ticket.failures.append(
                    "[lease-oom] op=admit: injected transient lease refusal")
                # One-tick backoff, so run_until_idle's no-progress guard
                # sees the deferral as pending work, not a deadlock.
                ticket.not_before_tick = max(
                    ticket.not_before_tick, self.ticks + 1)
                still_waiting.append(ticket)
                continue
            if (
                budget.max_queue_cells is not None
                and used + cells > budget.max_queue_cells
            ) or not self.pool.try_lease(cells):
                still_waiting.append(ticket)  # fits eventually; wait
                continue
            # From here the lease is held: any failure building the session
            # must give the cells back or the pool leaks on every crash.
            try:
                pinned = self._restore_snap.get(ticket.id)
                if pinned is not None:
                    rflow, snap = pinned
                    session = EngineSession.restore(
                        self.engine, rflow, snap,
                        queue_capacity=self.cfg.queue_capacity,
                        join_buffer_capacity=self.cfg.join_buffer_capacity,
                    )
                else:
                    session = EngineSession(
                        self.engine, flow,
                        queue_capacity=self.cfg.queue_capacity,
                        join_buffer_capacity=self.cfg.join_buffer_capacity,
                    )
                if session.queue_cells != cells:
                    raise RuntimeError(
                        f"admission pricing drifted: priced {cells} cells, "
                        f"the session holds {session.queue_cells}")
            except BaseException:
                self.pool.release(cells)
                raise
            self._restore_snap.pop(ticket.id, None)
            ticket.attempts += 1
            ticket.queue_cells = cells
            ticket.admitted_at = time.perf_counter()
            ticket.status = RUNNING
            ticket.stats = session.stats
            self._tenant_cells[req.tenant] = used + cells
            self.active.append(_Active(ticket, session))
            self.peak_pool_cells = max(self.peak_pool_cells, self.pool.leased_cells)
            admitted += 1
        self.admission = still_waiting
        return admitted

    def _reject(self, ticket: QueryTicket, why: str) -> None:
        ticket.status = REJECTED
        ticket.error = why
        ticket.finished_at = time.perf_counter()
        self._release_inflight(ticket)

    def _release_inflight(self, ticket: QueryTicket) -> None:
        t = ticket.request.tenant
        self._tenant_inflight[t] = max(0, self._tenant_inflight.get(t, 0) - 1)

    # -- the service tick ------------------------------------------------------

    def _release_active(self, act: _Active) -> None:
        """Return an active session's lease, tenant cells, slot, and
        checkpoint, and close the session (its device queues are freed
        when the last reference goes). try/finally-audited: even if the pool
        raises (the over-release guard), the slot and per-tenant accounting
        are still unwound, so a fault can never strand a phantom session."""
        ticket = act.ticket
        t = ticket.request.tenant
        try:
            self._tenant_cells[t] = max(
                0, self._tenant_cells.get(t, 0) - ticket.queue_cells)
            self.pool.release(ticket.queue_cells)
        finally:
            ticket.queue_cells = 0
            self._checkpoints.pop(ticket.id, None)
            if act in self.active:
                self.active.remove(act)
            act.session.close()

    def _finish(self, act: _Active, status: str) -> None:
        ticket = act.ticket
        ticket.count = act.session.stats.count
        ticket.status = status
        ticket.finished_at = time.perf_counter()
        self._planned.pop(ticket.id, None)
        try:
            self._release_active(act)
        finally:
            self._release_inflight(ticket)

    def _memory_probe(self):
        # Host counters only (DeviceQueue.n): no device read per step.
        rows = sum(a.session.rows_in_flight() for a in self.active)
        nbytes = sum(a.session.bytes_in_flight() for a in self.active)
        self.peak_inflight_rows = max(self.peak_inflight_rows, rows)
        return rows, nbytes

    def tick(self) -> Dict[str, int]:
        """One service tick: admit what fits, run one shared scheduler pass
        over all active sessions (budgeted at ``tick_steps`` per session),
        then retire sessions that completed or crossed their match budget.

        A fault raised by any session's operator aborts only that session's
        tick share: the owning ticket is degraded in place (checkpoint
        restore at a smaller batch) or requeued/failed per the retry budget;
        the other tenants' sessions are untouched and resume next tick. A
        real ``KernelFault`` is the exception: the session's lease, slot and
        tenant accounting are released and the fault propagates."""
        self.ticks += 1
        self._expire_deadlines()
        admitted = self._try_admit()
        steps = 0
        faulted = 0
        if self.active:
            # Rotate the concatenation order so no tenant permanently owns
            # the scheduler's starting cursor (round-robin fairness).
            order = self.active[self._rr % len(self.active):] + \
                self.active[: self._rr % len(self.active)]
            self._rr += 1
            chain = [rt for a in order for rt in a.session.chain]
            sched = AdaptiveScheduler(chain, memory_probe=self._memory_probe)
            try:
                st = sched.run(max_steps=self.cfg.tick_steps * len(self.active))
                steps = st.steps
            except EnumerationFault as f:
                steps = sched.stats.steps
                act = next(
                    (a for a in self.active if a.session is f.session), None)
                if act is None:
                    raise  # fault outside any active session: not ours to eat
                if isinstance(f, KernelFault):
                    self._drop(act, f)
                    raise
                self._handle_fault(act, f)
                faulted = 1
        if (
            self.cfg.checkpoint_every_ticks > 0
            and self.ticks % self.cfg.checkpoint_every_ticks == 0
        ):
            for act in self.active:
                self._checkpoints[act.ticket.id] = (
                    act.session.flow, act.session.snapshot())
        completed = 0
        for act in list(self.active):
            req = act.ticket.request
            budget = req.match_budget
            if budget is None:
                budget = self._budget(req.tenant).max_matches
            if act.session.done():
                self._finish(act, DONE)
                completed += 1
            elif budget is not None and act.session.stats.count >= budget:
                self._finish(act, BUDGET_EXCEEDED)
                completed += 1
        if completed:
            admitted += self._try_admit()
        return {"admitted": admitted, "steps": steps, "completed": completed,
                "faulted": faulted,
                "active": len(self.active), "queued": len(self.admission)}

    # -- fault handling ----------------------------------------------------------

    def _drop(self, act: _Active, fault: KernelFault) -> None:
        """Unwind a session whose kernel failed, before its ``KernelFault``
        propagates: lease, tenant cells, slot and inflight count go back,
        and the ticket keeps its status (the exception is the outcome)."""
        ticket = act.ticket
        ticket.error = str(fault)
        self._planned.pop(ticket.id, None)
        try:
            self._release_active(act)
        finally:
            self._release_inflight(ticket)

    def _handle_fault(self, act: _Active, fault: EnumerationFault) -> None:
        """Degrade in place when possible, otherwise requeue or fail.

        Preference order: (1) a recoverable fault with a live checkpoint →
        restore this session from it at half the batch size (shard-loss: same
        batch, the replay is deterministic) with DFS-biased draining; the
        queue capacities are repriced identically so the ticket's lease is
        unchanged and no pool traffic occurs. (2) no checkpoint, or the
        degradation ladder bottomed out → release everything and requeue with
        backoff while the retry budget and deadline allow. (3) otherwise the
        ticket fails with the structured fault message."""
        ticket = act.ticket
        ticket.failures.append(str(fault))
        ckpt = self._checkpoints.get(ticket.id)
        ecfg = self.engine.cfg
        if fault.recoverable and ckpt is not None:
            rflow, snap = ckpt
            prev_batch = snap["batch_size"]
            shard_loss = isinstance(fault, ShardLoss)
            new_batch = prev_batch if shard_loss else max(
                prev_batch // 2, ecfg.min_batch_size)
            if shard_loss or new_batch < prev_batch:
                old = act.session
                act.session = EngineSession.restore(
                    self.engine, rflow, snap, stats=old.stats,
                    queue_capacity=self.cfg.queue_capacity,
                    join_buffer_capacity=self.cfg.join_buffer_capacity,
                    batch_size=new_batch,
                    dfs_bias=not shard_loss,
                )
                old.close()
                act.session.stats.retries += 1
                if shard_loss:
                    act.session.stats.restarts += 1
                else:
                    act.session.stats.pressure_events += 1
                ticket.stats = act.session.stats
                # Re-checkpoint at the degraded batch so a repeat fault keeps
                # descending the ladder instead of retrying the same size.
                self._checkpoints[ticket.id] = (rflow, act.session.snapshot())
                return
        self._fail_attempt(act, fault)

    def _fail_attempt(self, act: _Active, fault: EnumerationFault) -> None:
        """Tear down a faulted session; requeue with backoff or fail the
        ticket. The lease/slot release is audited (``_release_active``), so a
        crashed query leaves the pool exactly where admission found it."""
        ticket = act.ticket
        now = time.perf_counter()
        req = ticket.request
        deadline_ok = (req.deadline_s is None
                       or now - ticket.submitted_at < req.deadline_s)
        ticket.count = act.session.stats.count  # partial progress, observable
        try:
            self._release_active(act)
        finally:
            if (fault.recoverable and deadline_ok
                    and ticket.attempts <= self.cfg.max_retries):
                ticket.status = QUEUED
                ticket.stats = None
                ticket.not_before_tick = (
                    self.ticks + self.cfg.retry_backoff_ticks * ticket.attempts)
                self.admission.append(ticket)
            else:
                ticket.status = FAILED
                ticket.error = str(fault)
                ticket.finished_at = now
                self._planned.pop(ticket.id, None)
                self._release_inflight(ticket)

    def _expire_deadlines(self) -> None:
        """Time out requests (queued or running) past their ``deadline_s``."""
        now = time.perf_counter()
        for act in list(self.active):
            d = act.ticket.request.deadline_s
            if d is not None and now - act.ticket.submitted_at > d:
                self._finish(act, TIMED_OUT)
                act.ticket.error = f"deadline_s={d} exceeded while running"
        if any(t.request.deadline_s is not None for t in self.admission):
            still: deque[QueryTicket] = deque()
            for t in self.admission:
                d = t.request.deadline_s
                if d is not None and now - t.submitted_at > d:
                    t.status = TIMED_OUT
                    t.error = f"deadline_s={d} exceeded before admission"
                    t.finished_at = now
                    self._planned.pop(t.id, None)
                    self._restore_snap.pop(t.id, None)
                    self._release_inflight(t)
                else:
                    still.append(t)
            self.admission = still

    def run_until_idle(self, max_ticks: int = 1_000_000) -> Dict[str, int]:
        """Tick until the admission queue and all slots drain."""
        done_total = 0
        for _ in range(max_ticks):
            if not self.active and not self.admission:
                break
            out = self.tick()
            done_total += out["completed"]
            backing_off = any(
                t.not_before_tick > self.ticks for t in self.admission)
            if (
                out["steps"] == 0 and out["admitted"] == 0
                and out["completed"] == 0 and out["faulted"] == 0
                and not backing_off and (self.active or self.admission)
            ):
                raise RuntimeError(
                    "graph service made no progress: active sessions are "
                    "deadlocked or queued work can never be admitted "
                    f"(active={len(self.active)}, queued={len(self.admission)})"
                )
        return {
            "ticks": self.ticks,
            "completed": done_total,
            "peak_pool_cells": self.peak_pool_cells,
            "peak_inflight_rows": self.peak_inflight_rows,
        }

    # -- crash recovery ------------------------------------------------------------

    def snapshot(self) -> Dict[str, list]:
        """Crash-recovery state: every standing-query definition (with its
        accumulated total) plus the newest checkpoint of each running query
        (queue prefixes held as device clones). Running queries only appear
        when ``cfg.checkpoint_every_ticks > 0``: without periodic checkpoints
        there is nothing consistent to resume from and they restart."""
        running = []
        for act in self.active:
            ckpt = self._checkpoints.get(act.ticket.id)
            if ckpt is not None:
                running.append((act.ticket.request, ckpt[0], ckpt[1]))
        return {
            "standing": [
                (sq.tenant, sq.query, sq.match_budget, sq.total_count)
                for sq in self.standing
            ],
            "running": running,
        }

    @classmethod
    def restore(
        cls,
        graph: Graph,
        snap: Dict[str, list],
        cfg: ServiceConfig | None = None,
        engine_cfg: EngineConfig | None = None,
        tenants: Dict[str, TenantBudget] | None = None,
        device: str | torch.device | None = None,
    ) -> "GraphService":
        """Rebuild a crashed service from ``snapshot()`` output: standing
        queries re-register (keeping their accumulated totals), and every
        checkpointed running query is re-admitted from its snapshot via
        :meth:`resume`, so completed work is not repeated."""
        svc = cls(graph, cfg, engine_cfg, tenants, device=device)
        for tenant, query, match_budget, total in snap["standing"]:
            sq = svc.register_standing(tenant, query, match_budget=match_budget)
            sq.total_count = total
        for req, flow, sess_snap in snap["running"]:
            svc.resume(req, flow, sess_snap)
        return svc

    def resume(self, req: GraphQueryRequest, flow: Dataflow,
               sess_snap: Dict[str, object]) -> QueryTicket:
        """Re-admit an interrupted query from a checkpoint. The request rides
        the ordinary submit→admission path (inflight caps, pool pricing,
        first-fit sweep), but the priced flow is pinned and the session is
        built with :meth:`EngineSession.restore` at admission instead of
        fresh, resuming mid-enumeration with exactly-once counts."""
        ticket = self.submit(req)
        if ticket.status == QUEUED:
            cells = flow_queue_cells(
                flow, self.engine.cfg, self.engine.d_pad,
                self.cfg.queue_capacity, self.cfg.join_buffer_capacity,
            )
            self._planned[ticket.id] = (cells, flow)
            self._restore_snap[ticket.id] = (flow, sess_snap)
        return ticket

    # -- standing queries over streaming updates -----------------------------------

    def register_standing(
        self,
        tenant: str,
        query: QueryGraph | ExecutionPlan | str,
        space: str = "huge",
        match_budget: Optional[int] = None,
    ) -> StandingQuery:
        """Register a continuous query; per-batch match deltas arrive via
        ``apply_batch``. The plan (and thus the delta decomposition) is fixed
        at registration time against the current graph statistics."""
        if isinstance(query, str):
            if query not in PAPER_QUERIES:
                raise KeyError(f"unknown query name: {query!r}")
            query = PAPER_QUERIES[query]
        if isinstance(query, QueryGraph):
            bad = errors(flowcheck.check_query(query))
            if bad:
                raise FlowcheckError(bad)
            plan = optimal_plan(
                query, self.gstats, self.engine.cfg.num_machines, space
            )
        elif isinstance(query, ExecutionPlan):
            bad = errors(flowcheck.check_plan(query))
            if bad:
                raise FlowcheckError(bad)
            plan = query
            query = plan.query
        else:
            raise TypeError(
                "standing queries need a QueryGraph/ExecutionPlan/name: the "
                "delta decomposition is derived from the query, not from a "
                "pre-translated Dataflow"
            )
        merged, _ = merge_flows(delta_flows(plan))
        flowcheck.verify_flow(
            merged, cfg=self.engine.cfg, d_pad=self.engine.d_pad,
            queue_capacity=self.cfg.queue_capacity,
            join_buffer_capacity=self.cfg.join_buffer_capacity,
        )
        sq = StandingQuery(
            id=next(self._ids), tenant=tenant, query=query, plan=plan,
            delta_flow=merged, match_budget=match_budget,
        )
        self.standing.append(sq)
        return sq

    def unregister_standing(self, sq: StandingQuery) -> bool:
        if sq in self.standing:
            self.standing.remove(sq)
            return True
        return False

    def apply_batch(self, batch: GraphUpdateBatch) -> Dict[str, object]:
        """Apply an edge batch and deliver each standing query's match delta.

        Consistency barrier first: in-flight ad-hoc queries are drained
        before the graph mutates (their sessions hold pre-batch adjacency
        state; partial matches extended against a mutated graph would be
        neither pre- nor post-batch semantics). Then the engine applies the
        update (row-local rebuild + cache drop), graph statistics are
        refreshed, and one delta ticket per standing query goes through the
        ordinary submit→admit→tick lifecycle, so concurrent standing tenants
        share the pool under the same pricing as ad-hoc traffic."""
        self.run_until_idle()
        applied = self.engine.apply_updates(batch)
        self.gstats = GraphStats.from_graph(self.engine.graph)
        self.batches_applied += 1
        tickets: List[Tuple[StandingQuery, QueryTicket]] = []
        for sq in self.standing:
            t = self.submit(GraphQueryRequest(
                tenant=sq.tenant, query=sq.delta_flow,
                match_budget=sq.match_budget,
            ))
            tickets.append((sq, t))
        self.run_until_idle()
        deltas: Dict[int, int] = {}
        for sq, t in tickets:
            count = t.count if t.status in (DONE, BUDGET_EXCEEDED) else 0
            sq.total_count += count
            sq.history.append((t, count))
            deltas[sq.id] = count
        return {
            "new_edges": applied.num_new_edges,
            "touched_vertices": int(applied.touched.shape[0]),
            "deltas": deltas,
            "tickets": [t for _, t in tickets],
        }

    def cancel(self, ticket: QueryTicket) -> bool:
        """Cancel a queued or running request; frees its slots immediately."""
        for act in self.active:
            if act.ticket is ticket:
                self._finish(act, CANCELLED)
                return True
        if ticket in self.admission:
            self.admission.remove(ticket)
            ticket.status = CANCELLED
            ticket.finished_at = time.perf_counter()
            self._release_inflight(ticket)
            return True
        return False
