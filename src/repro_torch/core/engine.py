"""The HUGE engine: dataflow execution with the adaptive scheduler (§4-§5).

The single-process engine. It executes the full dataflow on one device while
*simulating* the k-machine deployment for communication accounting, as the
paper measures it:

  * partial results live on the machine owning their first matched vertex;
  * a PULL-EXTEND's fetch stage dedups the batch's remote vertices per
    machine (merged RPCs) and runs them through a per-machine LRBU cache;
    misses are charged ``(deg(v) + 2) * 4`` bytes of pull traffic;
  * PUSH-JOIN charges the shuffle of both inputs; pushing-mode wco extends
    charge ``|ext| · rows · K`` words.

With ``fused=True`` extends and verifies read their adjacency slabs through
an LRBU value cache and run the fused CUDA kernels, and PUSH-JOIN probes run
the bounds kernel. A kernel that fails to build or launch raises; nothing
falls back to the plain path. The one exception is an *injected*
``kernel-fail`` fault (``EngineConfig.faults``): that batch runs the plain
path and is counted in ``kernel_fallbacks``. (The JAX engine also degrades a
real kernel failure to its twin; the port does not.)

``prepare`` runs the static flowcheck on every flow; ``drive`` runs a
session under the recovery ladder (checkpoint, restore at half the batch for
queue pressure, the same batch for a lost shard); ``apply_updates`` and
``run_delta`` enumerate only the matches a batch of edge inserts creates.

The control flow is the JAX reference's, including its host syncs: every
queue append reads the appended count on the host, and so do the fetch-stage
statistics and the sink.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cache as lrbu
from repro_torch.core import operators as ops_mod
from repro_torch.core.cost import GraphStats
from repro_torch.core.dataflow import (
    Dataflow,
    OpDesc,
    delta_flows,
    merge_flows,
    translate,
)
from repro_torch.core.faults import (
    EnumerationFault,
    FaultPlan,
    QueuePressure,
    ShardLoss,
)
from repro_torch.core.optimizer import optimal_plan
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.query import QueryGraph
from repro_torch.core.scheduler import AdaptiveScheduler, ScheduleStats
from repro_torch.device import resolve_device
from repro_torch.graph.storage import (
    INVALID,
    AppliedUpdates,
    Graph,
    GraphUpdateBatch,
    apply_updates as storage_apply_updates,
)

_log = logging.getLogger("repro_torch.engine")


# ---------------------------------------------------------------------------
# Config / stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 256
    queue_capacity: int = 1 << 17          # rows per operator output queue
    join_buffer_capacity: int = 1 << 20    # rows buffered per PUSH-JOIN input
    join_out_capacity: int = 1 << 18       # worst-case rows per join step
    num_machines: int = 8                  # simulated cluster size (k)
    cache_capacity: int = 1 << 14          # entries per machine (0 = disabled)
    cache_ways: int = 4
    cache_policy: str = "lrbu"             # "lrbu" | "lru" | "direct"
    materialize: bool = False              # keep final matches (tests only)
    materialize_cap: int = 1 << 20
    use_intersect_kernel: bool = False     # membership kernel inside extend_batch
    fused: bool = False                    # fused hot path: value-cache probe →
    #   slab gather → intersect in one kernel (extend/verify), and the bounds
    #   kernel inside PUSH-JOIN probes
    faults: Optional[FaultPlan] = None     # deterministic fault injection
    recover: bool = True                   # recovery ladder on recoverable
    #   faults; False = fail fast
    max_retries: int = 4                   # recovery attempts per driven run
    min_batch_size: int = 32               # degradation floor for batch halving
    checkpoint_every_steps: int = 0        # snapshot cadence inside drive()
    #   (0 = a single snapshot at start; a crash replays the whole query)


@dataclasses.dataclass
class EngineStats:
    count: int = 0
    pulled_bytes: int = 0
    pushed_bytes: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    batches: int = 0
    rows_emitted: int = 0
    compute_time: float = 0.0   # T_R analogue: intersect/join/scan (host clock)
    comm_time: float = 0.0      # T_C analogue: fetch stage (host clock)
    peak_queue_rows: int = 0
    peak_queue_bytes: int = 0
    join_overflows: int = 0
    kernel_fallbacks: int = 0   # injected kernel-fail batches run on the plain path
    pressure_events: int = 0    # QueuePressure signals absorbed by recovery
    retries: int = 0            # checkpoint restores (pressure + shard loss)
    restarts: int = 0           # of which: shard-loss recoveries
    wall_time: float = 0.0
    per_machine_rows: Optional[np.ndarray] = None

    @property
    def total_comm_bytes(self) -> int:
        return self.pulled_bytes + self.pushed_bytes

    @property
    def hit_rate(self) -> float:
        tot = self.cache_hits + self.cache_misses
        return self.cache_hits / tot if tot else 0.0


@dataclasses.dataclass
class EnumerationResult:
    count: int
    stats: EngineStats
    schedule: ScheduleStats
    matches: Optional[np.ndarray] = None  # [n, |V_q|] columns in query-vertex order


# ---------------------------------------------------------------------------
# Request routing (fetch stage, Alg. 4 lines 1-9)
# ---------------------------------------------------------------------------

def route_requests(vids: torch.Tensor, machs: torch.Tensor, valid: torch.Tensor,
                   num_machines: int, num_vertices: int, r_cap: int):
    """Dedup (machine, vid) request pairs into per-machine fixed-width lists.
    Returns ``(reqs[M, r_cap] INVALID-padded, cnt[M])``."""
    big = num_machines * num_vertices
    key = torch.where(valid, machs.long() * num_vertices + vids.long(), big)
    ks = torch.sort(key, stable=True).values
    valid_s = ks < big
    uniq = valid_s.clone()
    uniq[1:] &= ks[1:] != ks[:-1]
    m_s = torch.where(valid_s, ks // num_vertices, num_machines)
    v_s = torch.where(valid_s, ks % num_vertices, INVALID).to(torch.int32)
    cnt = torch.zeros(num_machines + 1, dtype=torch.int64, device=vids.device)
    cnt.scatter_add_(0, m_s, uniq.long())
    cnt = cnt[:num_machines]
    offs_ext = torch.zeros(num_machines + 1, dtype=torch.int64, device=vids.device)
    offs_ext[:num_machines] = torch.cumsum(cnt, 0) - cnt
    slot = torch.cumsum(uniq, 0) - 1 - offs_ext[m_s.clamp(max=num_machines)]
    reqs = torch.full((num_machines + 1, r_cap + 1), INVALID, dtype=torch.int32,
                      device=vids.device)
    reqs[torch.where(uniq, m_s, num_machines), torch.where(uniq, slot, r_cap)] = v_s
    return reqs[:num_machines, :r_cap], cnt.to(torch.int32)


# ---------------------------------------------------------------------------
# Device queues
# ---------------------------------------------------------------------------

class DeviceQueue:
    def __init__(self, capacity: int, width: int, device: torch.device,
                 label: str = "queue", query: str = ""):
        self.buf = torch.full((capacity, width), INVALID, dtype=torch.int32, device=device)
        self.n = 0  # host-side authoritative count
        self.capacity = capacity
        self.width = width
        self.label = label   # producing op's label (fault attribution)
        self.query = query   # owning dataflow's query name

    def append(self, rows: torch.Tensor, m) -> int:
        m_host = int(m)
        if self.n + m_host > self.capacity:
            raise QueuePressure(
                "queue-overflow",
                f"{self.n}+{m_host} > {self.capacity} rows "
                "(scheduler slack invariant violated)",
                op=self.label, query=self.query,
            )
        self.buf, _ = ops_mod.queue_append(self.buf, self.n, rows, m_host)
        self.n += m_host
        return m_host

    def pop(self, batch: int) -> Tuple[torch.Tensor, int]:
        rows, take, _ = ops_mod.queue_pop(self.buf, self.n, batch)
        self.n -= take
        return rows, take

    def free(self) -> int:
        return self.capacity - self.n

    def bytes_used(self) -> int:
        return self.n * self.width * 4


# ---------------------------------------------------------------------------
# Operator runtimes
# ---------------------------------------------------------------------------

class _BaseRT:
    label = "op"

    def __init__(self, engine: "HugeEngine", desc: OpDesc, out_q: Optional[DeviceQueue]):
        self.e = engine
        self.desc = desc
        self.out_q = out_q
        self.label = desc.label()
        # Per-session batch size: the recovery ladder restores a session at a
        # halved batch; queue pricing stays at cfg.batch_size.
        self.batch = engine.cfg.batch_size
        self.query = ""  # owning dataflow's query name (fault attribution)

    def output_free(self) -> int:
        return self.out_q.free() if self.out_q is not None else 1 << 62

    def required_slack(self) -> int:
        return 0


class _ScanRT(_BaseRT):
    def __init__(self, engine, desc, out_q):
        super().__init__(engine, desc, out_q)
        self.cursor = 0
        self.delta = desc.scan_epoch == "delta"
        if self.delta:
            if engine.delta_adj is None:
                raise RuntimeError(
                    "delta-seeded scan on an engine with no applied update "
                    "batch — call HugeEngine.apply_updates first"
                )
            self.total = int(engine.delta_total)
        else:
            self.total = int(engine.graph.num_directed_edges)

    def has_input(self) -> bool:
        return self.cursor < self.total

    def required_slack(self) -> int:
        return self.batch

    def run_one(self) -> None:
        e = self.e
        e._inject(("queue-overflow", "shard-loss"), self.label, self.query)
        t0 = time.perf_counter()
        src = e.delta_src_pad if self.delta else e.src_pad
        dst = e.delta_dst_pad if self.delta else e.dst_pad
        rows, n = ops_mod.scan_batch(
            src, dst, self.cursor, self.total,
            self.batch, self.desc.lt_positions, self.desc.gt_positions,
        )
        self.cursor += self.batch
        m = self.out_q.append(rows, n)
        e.stats.compute_time += time.perf_counter() - t0
        e.stats.batches += 1
        e.stats.rows_emitted += m


class _ExtendRT(_BaseRT):
    def __init__(self, engine, desc, in_q, out_q, comm: str):
        super().__init__(engine, desc, out_q)
        self.in_q = in_q
        self.comm = comm

    def has_input(self) -> bool:
        return self.in_q.n > 0

    def required_slack(self) -> int:
        return self.batch * self.e.d_pad

    def run_one(self) -> None:
        e = self.e
        e._inject(("queue-overflow", "shard-loss"), self.label, self.query)
        rows, n = self.in_q.pop(self.batch)
        if self.comm == "pull":
            e.fetch_stage(rows, n, self.desc.ext)
        elif self.comm == "push":
            e.push_wco_stage(n, len(self.desc.ext), rows.shape[1])
        t0 = time.perf_counter()
        if "old" in self.desc.ext_epochs:
            # Old-epoch positions veto delta membership; the fused kernels
            # know nothing of epochs, so these extends take the plain path.
            out, m = ops_mod.delta_extend_batch(
                e.adj, e.delta_adj, rows, n, self.desc.ext,
                tuple(ep == "old" for ep in self.desc.ext_epochs),
                self.desc.lt_positions, self.desc.gt_positions,
                self.batch * e.d_pad,
            )
        elif e.cfg.fused and not e._kernel_fail_injected(self.label):
            tab0, tab1, idx, sel, ok = e._fused_tables(rows, self.desc.ext)
            out, m = ops_mod.fused_extend_batch(
                tab0, tab1, idx, sel, ok, rows, n,
                self.desc.lt_positions, self.desc.gt_positions, self.batch * e.d_pad,
            )
        else:
            out, m = ops_mod.extend_batch(
                e.adj, rows, n, self.desc.ext, self.desc.lt_positions,
                self.desc.gt_positions, self.batch * e.d_pad,
                # an injected kernel-fail's batch launches no kernel
                use_kernel=e.cfg.use_intersect_kernel and not e.cfg.fused,
            )
        cnt = self.out_q.append(out, m)
        e.stats.compute_time += time.perf_counter() - t0
        e.stats.batches += 1
        e.stats.rows_emitted += cnt


class _VerifyRT(_BaseRT):
    def __init__(self, engine, desc, in_q, out_q):
        super().__init__(engine, desc, out_q)
        self.in_q = in_q

    def has_input(self) -> bool:
        return self.in_q.n > 0

    def required_slack(self) -> int:
        return self.batch

    def run_one(self) -> None:
        e = self.e
        e._inject(("queue-overflow", "shard-loss"), self.label, self.query)
        rows, n = self.in_q.pop(self.batch)
        e.fetch_stage(rows, n, self.desc.ext)
        t0 = time.perf_counter()
        if "old" in self.desc.ext_epochs:
            out, m = ops_mod.delta_verify_batch(
                e.adj, e.delta_adj, rows, n, self.desc.ext,
                tuple(ep == "old" for ep in self.desc.ext_epochs),
                self.desc.verify_pos, self.batch,
            )
        elif e.cfg.fused and not e._kernel_fail_injected(self.label):
            tab0, tab1, idx, sel, ok = e._fused_tables(rows, self.desc.ext)
            out, m = ops_mod.fused_verify_batch(
                tab0, tab1, idx, sel, ok, rows, n, self.desc.verify_pos, self.batch,
            )
        else:
            out, m = ops_mod.verify_batch(
                e.adj, rows, n, self.desc.ext, self.desc.verify_pos, self.batch
            )
        cnt = self.out_q.append(out, m)
        e.stats.compute_time += time.perf_counter() - t0
        e.stats.batches += 1
        e.stats.rows_emitted += cnt


class _JoinRT(_BaseRT):
    """PUSH-JOIN: the left input is fully buffered (barrier, §5.4), then the
    right queue is streamed batch-wise against it. The barrier is expressed
    through ``has_input``: the join reports no input until every ancestor of
    its left branch has drained (``left_branch_done``, wired by the session)."""

    def __init__(self, engine, desc, left_q, right_q, out_q):
        super().__init__(engine, desc, out_q)
        self.left_q = left_q
        self.right_q = right_q
        self.shuffle_charged = False
        self._prepared = None  # (sorted_keys, sorted_buf) once left side final
        self.left_branch_done = lambda: True  # installed by the session

    def has_input(self) -> bool:
        return self.right_q.n > 0 and self.left_branch_done()

    def required_slack(self) -> int:
        return self.e.cfg.join_out_capacity

    def run_one(self) -> None:
        e = self.e
        e._inject(("join-overflow", "shard-loss"), self.label, self.query)
        frac = (e.cfg.num_machines - 1) / max(1, e.cfg.num_machines)
        if not self.shuffle_charged:
            # Left side is complete at the barrier: charge its shuffle once.
            e.stats.pushed_bytes += int(self.left_q.n * self.left_q.width * 4 * frac)
            self.shuffle_charged = True
        if self._prepared is None:
            t0 = time.perf_counter()
            self._prepared = ops_mod.join_prepare(
                self.left_q.buf, self.left_q.n, self.desc.key_left
            )
            e.stats.compute_time += time.perf_counter() - t0
        rrows, rn = self.right_q.pop(max(64, self.batch))
        e.stats.pushed_bytes += int(rn * self.right_q.width * 4 * frac)
        t0 = time.perf_counter()
        out, m, overflow = ops_mod.join_probe(
            self._prepared[0], self._prepared[1], rrows, rn,
            self.desc.key_right, self.desc.right_extra,
            self.desc.cross_neq, self.desc.cross_lt, e.cfg.join_out_capacity,
            use_kernel=e.cfg.fused and not e._kernel_fail_injected(self.label),
        )
        if overflow:
            e.stats.join_overflows += 1
            raise QueuePressure(
                "join-overflow",
                f"probe output exceeded join_out_capacity="
                f"{e.cfg.join_out_capacity} with right batch {rn} "
                "(results would be lost)",
                op=self.label, query=self.query,
            )
        cnt = self.out_q.append(out, m)
        e.stats.compute_time += time.perf_counter() - t0
        e.stats.batches += 1
        e.stats.rows_emitted += cnt


class _SinkRT(_BaseRT):
    def __init__(self, engine, desc, in_q):
        super().__init__(engine, desc, None)
        self.in_q = in_q
        self.rows_out: List[np.ndarray] = []
        # Drain in large fixed-size chunks.
        self.drain = min(in_q.capacity, max(engine.cfg.batch_size * engine.d_pad, 1 << 15))

    def has_input(self) -> bool:
        return self.in_q.n > 0

    def run_one(self) -> None:
        e = self.e
        rows, n = self.in_q.pop(self.drain)
        e.stats.count += n
        if e.cfg.materialize and sum(r.shape[0] for r in self.rows_out) < e.cfg.materialize_cap:
            # A copy: on the CPU, ``.cpu()`` would alias the queue buffer,
            # which later appends overwrite.
            self.rows_out.append(rows[:n].to("cpu", copy=True).numpy())
        # Per-machine result distribution (load balance), kept on the device.
        if e.track_balance and n:
            e.balance_rows += torch.bincount(
                rows[:n, 0] % e.cfg.num_machines, minlength=e.cfg.num_machines)
        e.stats.batches += 1


# ---------------------------------------------------------------------------
# Multi-tenant building blocks (serve/graph_service.py)
# ---------------------------------------------------------------------------

class QueueSlotPool:
    """Aggregate queue budget shared by every session on one engine.

    Theorem 5.4 bounds a single query's intermediate state by O(|V_q|²·D_G);
    the pool turns that into a *service* invariant: each admitted query leases
    the int32 cells (rows × width) its preallocated queues will occupy, and
    admission fails, queueing the request instead of running the device out
    of memory, once the aggregate lease would exceed ``total_cells``. Cells
    are released when a query completes or is cancelled."""

    def __init__(self, total_cells: int):
        self.total_cells = int(total_cells)
        self.leased_cells = 0

    def free_cells(self) -> int:
        return self.total_cells - self.leased_cells

    def try_lease(self, cells: int) -> bool:
        if cells > self.free_cells():
            return False
        self.leased_cells += cells
        return True

    def release(self, cells: int) -> None:
        # Not an assert (stripped under python -O): an over-release is
        # corrupt accounting. Clamp so the pool stays usable, then raise with
        # the offending lease size so the caller is attributable.
        if cells > self.leased_cells:
            leaked = cells - self.leased_cells
            _log.error(
                "queue-slot pool over-release: released %d cells with only %d "
                "leased (%d excess)", cells, self.leased_cells, leaked,
            )
            self.leased_cells = 0
            raise RuntimeError(
                f"queue-slot pool released {cells} cells but only "
                f"{cells - leaked} were leased (over-release of {leaked})"
            )
        self.leased_cells -= cells


class _ScopedRT:
    """OperatorRuntime view that charges its work to one session's stats: it
    swaps the engine's stats target around each ``run_one`` (every stats
    mutation goes through ``engine.stats``) and attributes faults to the
    session."""

    __slots__ = ("rt", "e", "stats", "label", "session")

    def __init__(self, rt: _BaseRT, engine: "HugeEngine", stats: EngineStats,
                 session: "EngineSession" = None):
        self.rt = rt
        self.e = engine
        self.stats = stats
        self.label = rt.label
        self.session = session

    def has_input(self) -> bool:
        return self.rt.has_input()

    def output_free(self) -> int:
        return self.rt.output_free()

    def required_slack(self) -> int:
        return self.rt.required_slack()

    def run_one(self) -> None:
        prev = self.e.stats
        self.e.stats = self.stats
        try:
            self.rt.run_one()
        except EnumerationFault as f:
            f.session = self.session
            raise
        finally:
            self.e.stats = prev


def fault_tolerant_sizing(cfg: EngineConfig) -> bool:
    """Whether queue sizing must include retry slack: true when a fault plan
    is armed *and* the recovery ladder is on (a recovered retry replays a
    checkpointed batch while the original batch may still occupy its queue,
    so each queue needs a second worst-case batch of Lemma 5.2 slack)."""
    return cfg.faults is not None and cfg.recover


def _queue_plan(
    flow: Dataflow,
    cfg: EngineConfig,
    d_pad: int,
    queue_capacity: int | None = None,
    join_buffer_capacity: int | None = None,
    fault_tolerant: bool | None = None,
) -> Dict[int, Tuple[int, int]]:
    """Queue sizing for a dataflow: ``{op_index: (physical_rows, width)}``.

    An op feeding a PUSH-JOIN buffers its side fully; every queue carries one
    worst-case batch of slack on top (the Lemma 5.2 overflow allowance).
    Fault-tolerant configs (armed fault plan + recovery on) double that
    slack: a retry after a restore can re-append a replayed batch on top of
    rows the original attempt already parked (flowcheck's ``retry-slack``
    rule catches pricing that ignores this)."""
    qcap = cfg.queue_capacity if queue_capacity is None else queue_capacity
    jcap = cfg.join_buffer_capacity if join_buffer_capacity is None else join_buffer_capacity
    if fault_tolerant is None:
        fault_tolerant = fault_tolerant_sizing(cfg)
    slack_mult = 2 if fault_tolerant else 1
    succ: Dict[int, int] = {}
    for i, op in enumerate(flow.ops):
        for j in op.inputs:
            succ[j] = i
    plan: Dict[int, Tuple[int, int]] = {}
    for i, op in enumerate(flow.ops):
        if op.kind == "sink":
            continue
        slack = {
            "scan": cfg.batch_size,
            "verify": cfg.batch_size,
            "extend": cfg.batch_size * d_pad,
            "join": cfg.join_out_capacity,
        }[op.kind] * slack_mult
        s = succ.get(i)
        cap = (jcap if s is not None and flow.ops[s].kind == "join" else qcap) + slack
        plan[i] = (cap, len(op.schema))
    return plan


def flow_queue_cells(
    flow: Dataflow,
    cfg: EngineConfig,
    d_pad: int,
    queue_capacity: int | None = None,
    join_buffer_capacity: int | None = None,
    fault_tolerant: bool | None = None,
) -> int:
    """Total int32 cells a session over ``flow`` will preallocate (what a
    multi-tenant slot-pool lease is denominated in). ``fault_tolerant``
    defaults to deriving from ``cfg`` (see ``fault_tolerant_sizing``), so
    pricing and allocation always agree."""
    return sum(
        cap * width
        for cap, width in _queue_plan(
            flow, cfg, d_pad, queue_capacity, join_buffer_capacity,
            fault_tolerant,
        ).values()
    )


class EngineSession:
    """One query's execution state on an engine: its device queues, its
    operator runtimes (barrier-wired) and its stats. Driven to completion by
    ``run`` or in bounded slices by ``tick``."""

    def __init__(
        self,
        engine: "HugeEngine",
        flow: Dataflow,
        stats: EngineStats | None = None,
        queue_capacity: int | None = None,
        join_buffer_capacity: int | None = None,
        batch_size: int | None = None,
        dfs_bias: bool = False,
    ):
        self.engine = engine
        self.flow = flow
        self.stats = stats if stats is not None else EngineStats()
        self.sched_stats = ScheduleStats()
        # Degradation state: a restored session may run a smaller batch with
        # a DFS-biased scheduler while keeping cfg-priced queues.
        self.batch_size = int(batch_size) if batch_size else engine.cfg.batch_size
        self.dfs_bias = dfs_bias
        ops = flow.ops
        plan = _queue_plan(flow, engine.cfg, engine.d_pad,
                           queue_capacity, join_buffer_capacity)
        self.queues: Dict[int, DeviceQueue] = {
            i: DeviceQueue(cap, width, engine.device, label=ops[i].label(),
                           query=flow.query_name)
            for i, (cap, width) in plan.items()
        }
        self.queue_cells = sum(cap * width for cap, width in plan.values())

        self.runtimes: Dict[int, _BaseRT] = {}
        for i, op in enumerate(ops):
            q = self.queues.get(i)
            if op.kind == "scan":
                self.runtimes[i] = _ScanRT(engine, op, q)
            elif op.kind == "extend":
                self.runtimes[i] = _ExtendRT(engine, op, self.queues[op.inputs[0]], q, op.comm)
            elif op.kind == "verify":
                self.runtimes[i] = _VerifyRT(engine, op, self.queues[op.inputs[0]], q)
            elif op.kind == "join":
                self.runtimes[i] = _JoinRT(
                    engine, op, self.queues[op.inputs[0]], self.queues[op.inputs[1]], q,
                )
            else:
                self.runtimes[i] = _SinkRT(engine, op, self.queues[op.inputs[0]])
        for rt in self.runtimes.values():
            rt.batch = self.batch_size
            rt.query = flow.query_name

        # Join barriers: a PUSH-JOIN may only probe once every ancestor of its
        # left (buffered) input has drained.
        runtimes = self.runtimes
        for i, op in enumerate(ops):
            if op.kind != "join":
                continue
            branch = (*flow.ancestors(op.inputs[0]), op.inputs[0])

            def make_done(branch=branch):
                def done() -> bool:
                    return not any(runtimes[j].has_input() for j in branch)
                return done

            runtimes[i].left_branch_done = make_done()

        self.chain = [
            _ScopedRT(self.runtimes[i], engine, self.stats, session=self)
            for i in range(len(ops))
        ]

    def close(self) -> None:
        """Drop the session's queues, runtimes and chain. A session is a
        reference cycle (each ``_ScopedRT`` of its chain points back at it,
        and a join's barrier closure at the runtimes that hold it), so without
        this its device queues wait for the cycle collector; after it they
        are freed as soon as the caller lets go. Stats, flow and snapshots
        taken earlier stay valid; the session cannot run again."""
        self.chain = []
        self.runtimes.clear()
        self.queues.clear()

    def done(self) -> bool:
        """True once every operator has drained (the criterion that ends a
        scheduler pass, so a finished session never resumes)."""
        return not any(rt.has_input() for rt in self.runtimes.values())

    def rows_in_flight(self) -> int:
        return sum(q.n for q in self.queues.values())

    def bytes_in_flight(self) -> int:
        return sum(q.bytes_used() for q in self.queues.values())

    def memory_probe(self) -> Tuple[int, int]:
        return self.rows_in_flight(), self.bytes_in_flight()

    # -- checkpoint / resume ---------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Capture of the session's complete execution state.

        Taken *between* scheduler steps, queue contents plus the host-side
        cursors (scan position, join shuffle flag, sink rows, stats) are the
        entire state: every other device tensor is immutable graph data. The
        queue prefixes stay on the device as clones. ``restore`` therefore
        resumes exactly once: stats roll back to the snapshot, so rows
        replayed after a restore are never double-counted. Shuffle bytes of
        already-popped join batches may be charged again on replay (counts
        stay exact; comm stats are approximate under recovery)."""
        return {
            "query": self.flow.query_name,
            "batch_size": self.batch_size,
            "queues": {i: (q.buf[: q.n].clone(), q.n) for i, q in self.queues.items()},
            "scan_cursors": {
                i: rt.cursor
                for i, rt in self.runtimes.items()
                if isinstance(rt, _ScanRT)
            },
            "join_charged": {
                i: rt.shuffle_charged
                for i, rt in self.runtimes.items()
                if isinstance(rt, _JoinRT)
            },
            "sink_rows": {
                i: [r.copy() for r in rt.rows_out]
                for i, rt in self.runtimes.items()
                if isinstance(rt, _SinkRT)
            },
            "stats": copy.copy(self.stats),
            "sched_stats": copy.copy(self.sched_stats),
        }

    @classmethod
    def restore(
        cls,
        engine: "HugeEngine",
        flow: Dataflow,
        snap: Dict[str, object],
        *,
        stats: EngineStats | None = None,
        queue_capacity: int | None = None,
        join_buffer_capacity: int | None = None,
        batch_size: int | None = None,
        dfs_bias: bool = False,
    ) -> "EngineSession":
        """Rebuild a session from ``snapshot()``, optionally degraded to a
        smaller ``batch_size`` (the recovery ladder's halving). Queue
        capacities come from the same pricing as a fresh session. When
        ``stats`` is supplied, snapshot values are written into it in place
        so existing references stay valid."""
        if snap.get("query") not in ("", None, flow.query_name):
            raise ValueError(
                f"snapshot is for query {snap['query']!r}, not "
                f"{flow.query_name!r}"
            )
        sess = cls(
            engine, flow, stats=stats, queue_capacity=queue_capacity,
            join_buffer_capacity=join_buffer_capacity,
            batch_size=batch_size or snap["batch_size"], dfs_bias=dfs_bias,
        )
        for i, (rows, n) in snap["queues"].items():
            q = sess.queues[i]
            if n > q.capacity:
                raise ValueError(
                    f"snapshot queue {i} holds {n} rows but the restored "
                    f"queue caps at {q.capacity}"
                )
            if n:
                q.buf[:n] = rows
            q.n = int(n)
        for i, cur in snap["scan_cursors"].items():
            sess.runtimes[i].cursor = int(cur)
        for i, charged in snap["join_charged"].items():
            sess.runtimes[i].shuffle_charged = bool(charged)
        for i, rows in snap["sink_rows"].items():
            sess.runtimes[i].rows_out = [r.copy() for r in rows]
        sess.stats.__dict__.update(copy.copy(snap["stats"]).__dict__)
        sess.sched_stats.__dict__.update(copy.copy(snap["sched_stats"]).__dict__)
        return sess

    # -- execution -------------------------------------------------------------

    def tick(self, max_steps: int) -> ScheduleStats:
        """Run up to ``max_steps`` operator batches of this session."""
        st = AdaptiveScheduler(
            self.chain, memory_probe=self.memory_probe, dfs_bias=self.dfs_bias
        ).run(max_steps)
        self.sched_stats.merge(st)
        return st

    def run(self) -> ScheduleStats:
        st = AdaptiveScheduler(
            self.chain, memory_probe=self.memory_probe, dfs_bias=self.dfs_bias
        ).run()
        self.sched_stats.merge(st)
        return st

    def result(self) -> EnumerationResult:
        self.stats.peak_queue_rows = self.sched_stats.peak_queue_rows
        self.stats.peak_queue_bytes = self.sched_stats.peak_queue_bytes
        matches = None
        if self.engine.cfg.materialize:
            chunks: List[np.ndarray] = []
            # Every sink: a merged flow (delta unions) has one per source
            # flow, and each orders the query vertices its own way.
            for si in self.flow.sink_indices():
                sink_rt = self.runtimes[si]
                if not sink_rt.rows_out:
                    continue
                rows = np.concatenate(sink_rt.rows_out, axis=0)
                schema = self.flow.ops[si].schema
                chunks.append(rows[:, [schema.index(v) for v in sorted(schema)]])
            if chunks:
                matches = np.concatenate(chunks, axis=0)
        return EnumerationResult(
            count=self.stats.count, stats=self.stats,
            schedule=self.sched_stats, matches=matches,
        )


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _edge_scan_arrays(graph: Graph, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Directed edge arrays padded to a batch multiple plus one batch
    (scan_batch's contract: its window never clamps)."""
    dev = graph.device
    deg = graph.offsets[1:] - graph.offsets[:-1]
    src = torch.repeat_interleave(
        torch.arange(graph.num_vertices, dtype=torch.int32, device=dev), deg.long())
    e = src.shape[0]
    pad = (-e) % batch + batch
    src_pad = torch.zeros(e + pad, dtype=torch.int32, device=dev)
    dst_pad = torch.full((e + pad,), INVALID, dtype=torch.int32, device=dev)
    src_pad[:e] = src
    dst_pad[:e] = graph.nbrs
    return src_pad, dst_pad


class HugeEngine:
    def __init__(self, graph: Graph, cfg: EngineConfig | None = None,
                 device: str | torch.device | None = None,
                 track_balance: bool = False):
        self.cfg = cfg or EngineConfig()
        self.device = resolve_device(device)
        self._load_graph(graph.to(self.device))
        self.stats = EngineStats()
        # Result rows per simulated machine (owner of the first matched
        # vertex), summed on the device over every run of this engine.
        self.track_balance = track_balance
        self.balance_rows = torch.zeros(self.cfg.num_machines, dtype=torch.int64,
                                        device=self.device)
        self._reset_caches()
        # Delta state (streaming): installed by apply_updates.
        self.delta_adj: Optional[torch.Tensor] = None
        self.delta_src_pad: Optional[torch.Tensor] = None
        self.delta_dst_pad: Optional[torch.Tensor] = None
        self.delta_total: int = 0

    def _load_graph(self, graph: Graph) -> None:
        """(Re)bind every graph-derived tensor (also the update path's)."""
        self.graph = graph
        self.adj = graph.padded.adj
        self.deg = graph.padded.deg
        self.d_pad = graph.padded.d_pad
        assert graph.num_vertices * self.cfg.num_machines < 2**31, (
            "machine-id × vertex-id key must fit int32"
        )
        self.src_pad, self.dst_pad = _edge_scan_arrays(graph, self.cfg.batch_size)

    def _reset_caches(self) -> None:
        """Build the fetch caches from scratch: per-machine stats caches, and
        with ``fused`` the device-level LRBU value cache the kernels read.
        Called at init and after every apply_updates: a cached slab of the
        pre-batch graph would corrupt Eq.-2 intersections."""
        cfg = self.cfg
        self._cache = None
        if cfg.cache_capacity > 0:
            ways = 1 if cfg.cache_policy == "direct" else cfg.cache_ways
            self._cache = lrbu.make_stacked_cache(
                cfg.num_machines, cfg.cache_capacity, ways, device=self.device)
        self._vcache = None
        if cfg.fused and cfg.cache_capacity > 0:
            self._vcache = lrbu.make_cache(
                cfg.cache_capacity, ways=cfg.cache_ways, d_pad=self.d_pad, device=self.device)

    # -- streaming updates -----------------------------------------------------

    def apply_updates(self, batch: GraphUpdateBatch) -> AppliedUpdates:
        """Apply an edge-insert batch and arm the delta execution state.

        Row-local storage rebuild (``graph.storage.apply_updates``), then
        every graph-derived tensor is rebound and both fetch caches are
        dropped. The delta graph (genuinely new edges only) becomes the seed
        of delta-seeded scans and the old-epoch membership veto."""
        applied = storage_apply_updates(self.graph, batch)
        self._load_graph(applied.graph)
        self._reset_caches()
        delta = applied.delta
        self.delta_adj = delta.padded.adj
        self.delta_src_pad, self.delta_dst_pad = _edge_scan_arrays(
            delta, self.cfg.batch_size
        )
        self.delta_total = int(delta.num_directed_edges)
        return applied

    def run_delta(
        self,
        query_or_plan: QueryGraph | ExecutionPlan,
        space: str = "huge",
        stats: GraphStats | None = None,
    ) -> EnumerationResult:
        """Enumerate only the matches *created* by the last applied batch.

        Runs the delta-join decomposition (``dataflow.delta_flows``): one
        delta-seeded flow per query edge, merged into one multi-sink DAG that
        one scheduler pass drives. Exactly once: a new match is produced by
        the flow of its minimum-index delta query edge."""
        if self.delta_adj is None:
            raise RuntimeError(
                "run_delta before apply_updates: no delta batch is armed"
            )
        if isinstance(query_or_plan, QueryGraph):
            gstats = stats or GraphStats.from_graph(self.graph)
            plan = optimal_plan(query_or_plan, gstats, self.cfg.num_machines, space)
        elif isinstance(query_or_plan, ExecutionPlan):
            plan = query_or_plan
        else:
            raise TypeError(
                "run_delta needs a QueryGraph or ExecutionPlan (delta flows "
                "are derived from the query, not from an existing Dataflow)"
            )
        t_start = time.perf_counter()
        merged, _ = merge_flows(delta_flows(plan))
        session = self.drive(self.prepare(merged))
        result = session.result()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        result.stats.wall_time = time.perf_counter() - t_start
        return result

    # -- fetch stage (pull accounting) ---------------------------------------

    def fetch_stage(self, rows: torch.Tensor, n: int, ext: Tuple[int, ...]) -> None:
        t0 = time.perf_counter()
        cfg = self.cfg
        b = rows.shape[0]
        row_valid = torch.arange(b, device=rows.device) < n
        shard = torch.where(rows[:, 0] >= 0, rows[:, 0] % cfg.num_machines, 0)
        vids = rows[:, list(ext)]                       # [B, E]
        machs = shard[:, None].expand_as(vids)
        remote = (vids % cfg.num_machines) != machs
        valid = row_valid[:, None] & (vids != INVALID) & (vids >= 0) & remote
        reqs, _ = route_requests(
            vids.reshape(-1), machs.reshape(-1), valid.reshape(-1),
            cfg.num_machines, self.graph.num_vertices, r_cap=vids.numel(),
        )
        req_valid = reqs != INVALID
        if self._cache is not None:
            self._cache, hit = lrbu.fetch_update_stacked(self._cache, reqs, cfg.cache_policy)
            hit = hit & req_valid
        else:
            hit = torch.zeros_like(req_valid)
        miss = req_valid & ~hit
        degs = torch.where(
            miss, self.deg[reqs.clamp(0, self.graph.num_vertices - 1).long()], 0)
        pulled, hits, misses = torch.stack([
            ((degs.long() + 2) * 4 * miss).sum(), hit.sum(), miss.sum(),
        ]).tolist()  # one host sync for the three statistics
        self.stats.pulled_bytes += pulled
        self.stats.cache_hits += hits
        self.stats.cache_misses += misses
        self.stats.comm_time += time.perf_counter() - t0

    # -- fused hot path: value-cache probe prologue ----------------------------

    def _fused_tables(self, rows: torch.Tensor, ext: Tuple[int, ...]):
        """The (tab0, tab1, idx, sel, ok) slab addressing of the fused kernels
        for one batch: insert the batch's deduped vertices into the LRBU value
        cache (seal/release), then probe it — hits read cache slabs (tab0),
        misses fall back to the adjacency table (tab1)."""
        v = self.graph.num_vertices
        vids = rows[:, list(ext)]                       # [B, E]
        ok = (vids >= 0) & (vids < v)
        idx1 = vids.clamp(0, v - 1)
        if self._vcache is not None:
            flat = torch.where(ok, vids, INVALID).reshape(-1)
            uniq = ops_mod.dedup_pad(flat)
            lrbu.fetch_update_adjacency(self._vcache, uniq, self.adj, self.deg)
            idx0, hit = lrbu.probe_indices(self._vcache, flat)
            tab0 = self._vcache.values.view(-1, self.d_pad)
            idx0 = idx0.view(vids.shape)
            sel = hit.view(vids.shape)
        else:
            tab0 = self.adj[:1]
            idx0 = torch.zeros_like(idx1)
            sel = torch.zeros(vids.shape, dtype=torch.bool, device=vids.device)
        idx = torch.stack([idx0, idx1])
        return tab0, self.adj, idx, sel.to(torch.int32), ok.to(torch.int32)

    # -- push accounting for wco-push extends (BiGJoin-style plans) -----------

    def push_wco_stage(self, n: int, n_ext: int, k: int) -> None:
        frac = (self.cfg.num_machines - 1) / max(1, self.cfg.num_machines)
        self.stats.pushed_bytes += int(n * k * 4 * n_ext * frac)

    # -- fault injection ---------------------------------------------------------

    def _inject(self, kinds: Tuple[str, ...], op: str, query: str = "") -> None:
        """Probe the armed FaultPlan at an operator invocation and raise the
        matching structured fault."""
        fp = self.cfg.faults
        if fp is None:
            return
        for kind in kinds:
            if fp.should_fire(kind, op):
                if kind == "shard-loss":
                    raise ShardLoss(fp.seed % self.cfg.num_machines,
                                    op=op, query=query)
                raise QueuePressure(kind, "injected fault", op=op, query=query)

    def _kernel_fail_injected(self, op: str) -> bool:
        """Whether the armed FaultPlan fires ``kernel-fail`` at this fused
        operator invocation. Such a batch runs the plain path and is counted
        in ``kernel_fallbacks``. Only an injected fault degrades this way: a
        real build or launch failure raises ``KernelFault``."""
        fp = self.cfg.faults
        if fp is None or not fp.should_fire("kernel-fail", op):
            return False
        self.stats.kernel_fallbacks += 1
        _log.warning("injected kernel-fail at op=%s: batch runs the plain path", op)
        return True

    # -- execution --------------------------------------------------------------

    def to_flow(
        self,
        query_or_plan: QueryGraph | ExecutionPlan | Dataflow,
        space: str = "huge",
        stats: GraphStats | None = None,
    ) -> Dataflow:
        """Resolve a query / plan / dataflow into an executable dataflow."""
        if isinstance(query_or_plan, Dataflow):
            return query_or_plan
        if isinstance(query_or_plan, QueryGraph):
            gstats = stats or GraphStats.from_graph(self.graph)
            plan = optimal_plan(query_or_plan, gstats, self.cfg.num_machines, space)
        else:
            plan = query_or_plan
        return translate(plan)

    def prepare(
        self,
        query_or_plan: QueryGraph | ExecutionPlan | Dataflow,
        space: str = "huge",
        stats: GraphStats | None = None,
        session_stats: EngineStats | None = None,
        queue_capacity: int | None = None,
        join_buffer_capacity: int | None = None,
    ) -> EngineSession:
        """Build an execution session without running it, after the static
        pre-flight: a malformed flow fails here with structured diagnostics
        (``FlowcheckError``), not mid-run on the device."""
        flow = self.to_flow(query_or_plan, space, stats)
        # Imported here: analysis.flowcheck imports core.dataflow, and the
        # repro_torch.core package imports this module.
        from repro_torch.analysis.flowcheck import verify_flow

        verify_flow(flow, cfg=self.cfg, d_pad=self.d_pad,
                    queue_capacity=queue_capacity,
                    join_buffer_capacity=join_buffer_capacity)
        return EngineSession(
            self, flow, stats=session_stats,
            queue_capacity=queue_capacity, join_buffer_capacity=join_buffer_capacity,
        )

    def drive(self, session: EngineSession) -> EngineSession:
        """Run a session to completion under the recovery ladder. On a
        recoverable fault the last checkpoint is restored (at half the batch
        with a DFS-biased scheduler for ``QueuePressure``, drain before
        produce; unchanged for ``ShardLoss``, since enumeration is
        deterministic and replay is exact) and the run retries, up to
        ``cfg.max_retries`` times and never below ``cfg.min_batch_size``.
        Returns the session holding the final state (a *new* object when
        recovery restored). With ``cfg.recover`` off the session runs once
        and any fault propagates."""
        cfg = self.cfg
        if not cfg.recover:
            session.run()
            return session
        ckpt_steps = cfg.checkpoint_every_steps
        snap = session.snapshot()
        retries = 0
        while True:
            try:
                if ckpt_steps > 0:
                    while not session.done():
                        session.tick(ckpt_steps)
                        snap = session.snapshot()
                else:
                    session.run()
                return session
            except EnumerationFault as f:
                if not f.recoverable or retries >= cfg.max_retries:
                    raise
                retries += 1
                prev_batch = snap["batch_size"]
                if isinstance(f, ShardLoss):
                    new_batch = prev_batch
                else:
                    new_batch = max(prev_batch // 2, cfg.min_batch_size)
                    if new_batch >= prev_batch:
                        raise EnumerationFault(
                            f.kind,
                            "recovery ladder exhausted: batch already at "
                            f"floor {prev_batch} "
                            "(raise queue capacities or min_batch_size)",
                            op=f.op, query=f.query,
                        ) from f
                _log.warning(
                    "recovering from %s (attempt %d/%d): batch %d -> %d",
                    f, retries, cfg.max_retries, prev_batch, new_batch,
                )
                session = EngineSession.restore(
                    self, session.flow, snap, stats=session.stats,
                    batch_size=new_batch,
                    dfs_bias=not isinstance(f, ShardLoss),
                )
                # Counters go up *after* the restore rolled stats back to the
                # snapshot, so recovery history survives the rollback.
                session.stats.retries += 1
                if isinstance(f, ShardLoss):
                    session.stats.restarts += 1
                else:
                    session.stats.pressure_events += 1
                snap = session.snapshot()

    def run(
        self,
        query_or_plan: QueryGraph | ExecutionPlan | Dataflow,
        space: str = "huge",
        stats: GraphStats | None = None,
    ) -> EnumerationResult:
        t_start = time.perf_counter()
        session = self.drive(self.prepare(query_or_plan, space, stats, session_stats=self.stats))
        result = session.result()
        # One copy to the host a run (the sink counts on the device).
        self.stats.per_machine_rows = self.balance_rows.cpu().numpy().copy()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.wall_time = time.perf_counter() - t_start
        return result


def enumerate_query(
    graph: Graph,
    query: QueryGraph,
    cfg: EngineConfig | None = None,
    space: str = "huge",
    device: str | torch.device | None = None,
) -> EnumerationResult:
    """One-call API: plan, translate, schedule, execute, count."""
    return HugeEngine(graph, cfg, device=device).run(query, space=space)
