"""Distributed HUGE engine: SPMD execution of plan DAGs over ``torch.distributed``.

The real-collective counterpart of ``engine.py``: one process per rank,
joined in a process group. The graph is hash-partitioned over the ranks
(paper §2: vertex ``v`` lives on rank ``v % P`` at row ``v // P``), partial
matches live on their producing rank, and every operator of the translated
dataflow — SCAN, PULL-EXTEND, VERIFY, PUSH-JOIN, SINK — runs with actual
communication:

  fetch stage     dedup the batch's vertices (merged-RPC aggregation),
                  route requests to their owners with an ``all_to_all``,
                  gather the owners' adjacency rows, return them with a
                  second ``all_to_all`` — the GetNbrs RPC as a collective;
  intersect stage Eq. 2 membership over the local shard and the fetched
                  table; with ``fused`` the fused CUDA kernels read both
                  (``tab0`` the fetched table, ``tab1`` the local shard);
  shuffle join    PUSH-JOIN hash-partitions both inputs by join key with an
                  ``all_to_all``, so matching keys co-locate and the probe
                  (with ``fused``, the bounds kernel) is local;
  stealing        each extend batch's results are re-spread evenly over the
                  ranks with two more ``all_to_all`` calls (§5.3 work
                  stealing, deterministic under SPMD).

Every rank executes the same schedule. The scheduler's decisions read only
global values — queue fill levels all-reduced over the ranks (cached until a
queue changes, as the JAX engine caches its device-side maxima) — and fault
plans fire host-side at the same invocation on every rank, so all ranks take
the same branches and meet in the same collectives.

The data plane (``all_to_all``) runs on the group's backend; the control
plane (reductions of host integers: queue counts, sink totals, traffic
counters, the join-overflow flag) on a gloo group, the same group when the
backend is gloo. Gloo's ``all_to_all_single`` takes CUDA tensors and stages
them through host memory itself (PyTorch 2.11 on an H100 host), so several
ranks can share one card over gloo; NCCL takes one GPU per rank.

The control flow is the JAX package's ``core/distributed.py`` (its
``shard_map`` steps become one process per rank), so counts and every
statistic equal its counts and statistics; ``stats["engine"]`` names the
mechanism, ``"torch.distributed"``. Two departures: a real ``KernelFault``
raises (an *injected* ``kernel-fail`` runs the batch on the plain path, as
the reference does), and the fetch stage's routing key is int64.

``run_ranks`` spawns the ranks of a group on one host and returns each
rank's result; ``process_group`` sets up a group around a block (a world of
one in the caller's own process, for instance).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import operators as ops_mod
from repro_torch.core.cost import GraphStats
from repro_torch.core.dataflow import Dataflow, OpDesc, delta_flows, merge_flows, translate
from repro_torch.core.engine import route_requests
from repro_torch.core.faults import EnumerationFault, FaultPlan, QueuePressure, ShardLoss
from repro_torch.core.optimizer import optimal_plan
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.query import QueryGraph
from repro_torch.core.scheduler import AdaptiveScheduler
from repro_torch.device import resolve_device
from repro_torch.graph.partition import shard_adjacency
from repro_torch.graph.storage import INVALID, Graph, GraphUpdateBatch
from repro_torch.graph.storage import apply_updates as storage_apply_updates
from repro_torch.kernels.intersect import ops as ik

_log = logging.getLogger("repro_torch.distributed")


@dataclasses.dataclass
class DistConfig:
    batch_size: int = 256
    queue_capacity: int = 1 << 16
    join_buffer_capacity: int = 1 << 17  # rows per join side buffer per rank
    join_out_capacity: int = 1 << 17     # worst-case rows per probe step
    rebalance: bool = True               # inter-machine work stealing
    fused: bool = False                  # fused extend/verify + probe kernels
    faults: Optional[FaultPlan] = None   # deterministic fault injection
    recover: bool = True                 # restart-based recovery: SPMD
    #   execution is deterministic, so a recoverable fault rebuilds the
    #   runtimes and re-runs the flow (halved batch on QueuePressure)
    max_retries: int = 3                 # recovery attempts per _execute
    min_batch_size: int = 32             # degradation floor for batch halving


# ---------------------------------------------------------------------------
# The collective layer
# ---------------------------------------------------------------------------

class Comm:
    """One rank's view of its process group.

    ``a2a`` is the tiled all-to-all of the JAX engine (``split_axis=0,
    concat_axis=0``): a contiguous tensor whose leading dimension is the
    world size, block ``d`` sent to rank ``d``, block ``s`` of the result
    received from rank ``s``. ``all_gather`` is the tiled all-gather
    (``axis=0``): every rank's tensor, in rank order, along the leading
    dimension. ``all_max`` and ``all_sum`` reduce host integers on the
    control group. The counters say what the rank moved: ``a2a_bytes`` the
    tensors it handed to ``a2a``, ``ag_bytes`` the tensors ``all_gather``
    returned to it (its own block counted in both)."""

    def __init__(self, rank: int, world_size: int, device: torch.device, backend: str,
                 group=None, ctrl=None):
        self.rank = rank
        self.world_size = world_size
        self.device = device
        self.backend = backend
        self.group = group
        self.ctrl = ctrl
        self.a2a_calls = 0
        self.a2a_bytes = 0
        self.ag_calls = 0
        self.ag_bytes = 0
        self.ctrl_calls = 0

    def a2a(self, t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] != self.world_size:
            raise ValueError(f"a2a: leading dimension {t.shape[0]} != world size "
                             f"{self.world_size}")
        t = t.contiguous()
        self.a2a_calls += 1
        self.a2a_bytes += t.numel() * t.element_size()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t, group=self.group)
        out = torch.cat(parts)
        self.ag_calls += 1
        self.ag_bytes += out.numel() * out.element_size()
        return out

    def _reduce(self, vals: Sequence[int], op) -> List[int]:
        x = torch.tensor([int(v) for v in vals], dtype=torch.int64)
        dist.all_reduce(x, op=op, group=self.ctrl)
        self.ctrl_calls += 1
        return x.tolist()

    def all_max(self, *vals: int) -> List[int]:
        return self._reduce(vals, dist.ReduceOp.MAX)

    def all_sum(self, *vals: int) -> List[int]:
        return self._reduce(vals, dist.ReduceOp.SUM)


@contextlib.contextmanager
def process_group(backend: str = "gloo", device: str | torch.device | None = None, *,
                  rank: int = 0, world_size: int = 1, init_method: Optional[str] = None,
                  timeout_s: float = 600.0):
    """Join (and on exit leave) a process group; yields this rank's ``Comm``.
    Without ``init_method`` a world of one is set up through a store file in
    a fresh temporary directory."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        torch.cuda.set_device(dev)
    tmp = None
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs an init_method")
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        init_method = "file://" + os.path.join(tmp, "store")
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            group = dist.group.WORLD
            ctrl = group if backend == "gloo" else dist.new_group(backend="gloo")
            yield Comm(rank, world_size, dev, backend, group=group, ctrl=ctrl)
        finally:
            dist.destroy_process_group()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Distributed queues
# ---------------------------------------------------------------------------

class _DQueue:
    """One rank's part of a distributed queue: ``buf[cap+slack, K]`` and its
    own count ``n``. ``capacity`` is the physical row count, the logical fill
    level plus ``slack`` (one worst-case batch, Lemma 5.2). ``max_n`` — the
    level the scheduler gates on — is an all-reduce MAX over the ranks,
    cached until the queue changes; ``total`` an all-reduce SUM."""

    def __init__(self, eng: "DistributedEngine", width: int, slack: int,
                 capacity: Optional[int] = None):
        cap = eng.cfg.queue_capacity if capacity is None else capacity
        self.capacity = cap + slack
        self.width = width
        self.buf = torch.full((cap + slack, width), INVALID, dtype=torch.int32,
                              device=eng.device)
        self.n = 0
        self._eng = eng
        self._max = 0
        self._dirty = False

    def set(self, buf: torch.Tensor, n: int) -> None:
        self.buf, self.n = buf, int(n)
        self._dirty = True

    def set_n(self, n: int) -> None:
        self.n = int(n)
        self._dirty = True

    @property
    def max_n(self) -> int:
        if self._dirty:
            self._max = self._eng.comm.all_max(self.n)[0]
            self._dirty = False
        return self._max

    def total(self) -> int:
        return self._eng.comm.all_sum(self.n)[0]

    def free(self) -> int:
        """Physical free rows; gate ``free() >= worst_case_batch`` before
        running a producer (the Lemma 5.2 slack invariant)."""
        return self.capacity - self.max_n

    def drain(self) -> None:
        self.n = 0
        self._max = 0
        self._dirty = False


# ---------------------------------------------------------------------------
# Operator runtimes (scheduler.OperatorRuntime)
# ---------------------------------------------------------------------------

class _DScanRT:
    def __init__(self, eng: "DistributedEngine", desc: OpDesc, out_q: _DQueue):
        self.e, self.desc, self.out_q = eng, desc, out_q
        self.label = desc.label()
        self.cursor = 0
        self.rounds_done = 0
        self.delta = desc.scan_epoch == "delta"
        if self.delta and eng.delta_adj is None:
            raise RuntimeError(
                "delta-seeded scan on a distributed engine with no applied "
                "update batch — call DistributedEngine.apply_updates first"
            )
        # Scan sources are padded to a multiple of the configured batch, and
        # recovery only halves it, so the division stays exact.
        scan_len = eng.delta_scan_len if self.delta else eng.scan_len
        self.rounds = scan_len // eng.cfg.batch_size
        self.query = ""

    def has_input(self) -> bool:
        return self.rounds_done < self.rounds

    def internal_pending(self) -> bool:
        return self.has_input()

    def output_free(self) -> int:
        return self.out_q.free()

    def required_slack(self) -> int:
        return self.e.cfg.batch_size

    def run_one(self) -> None:
        e = self.e
        e._inject(("queue-overflow", "shard-loss"), self.label, self.query)
        b = e.cfg.batch_size
        if self.delta:
            src, dst, total = e.delta_src, e.delta_dst, e.delta_scan_total
        else:
            src, dst, total = e.src, e.dst, e.scan_total
        rows, n = ops_mod.scan_batch(src, dst, self.cursor, total, b,
                                     self.desc.lt_positions, self.desc.gt_positions)
        buf, n2 = ops_mod.queue_append(self.out_q.buf, self.out_q.n, rows, n)
        self.out_q.set(buf, n2)
        self.cursor += b
        self.rounds_done += 1
        e.stats["rounds"] += 1


class _DExtendRT:
    """PULL-EXTEND / VERIFY: fetch (2 a2a) + intersect + optional steal (2 a2a)."""

    def __init__(self, eng: "DistributedEngine", desc: OpDesc, in_q: _DQueue,
                 out_q: _DQueue):
        self.e, self.desc, self.in_q, self.out_q = eng, desc, in_q, out_q
        self.label = desc.label()
        self.is_verify = desc.kind == "verify"
        self.delta = "old" in desc.ext_epochs
        if self.delta and eng.delta_adj is None:
            raise RuntimeError(
                "old-epoch extend/verify on a distributed engine with no "
                "applied update batch — call apply_updates first"
            )
        self.query = ""
        # The steal all_to_all is skipped when a batch's worst-case output
        # cannot be split P ways (the reference's out_w >= p guard).
        self.steal = (
            not self.is_verify
            and eng.cfg.rebalance
            and eng.cfg.batch_size * eng.d_pad >= eng.p
        )

    def has_input(self) -> bool:
        return self.in_q.max_n > 0

    def internal_pending(self) -> bool:
        return False

    def output_free(self) -> int:
        return self.out_q.free()

    def required_slack(self) -> int:
        b = self.e.cfg.batch_size
        return b if self.is_verify else b * self.e.d_pad

    def run_one(self) -> None:
        e = self.e
        e._inject(("queue-overflow", "shard-loss"), self.label, self.query)
        fused = e.cfg.fused and not self.delta
        if (
            fused
            and e.cfg.faults is not None
            and e.cfg.faults.should_fire("kernel-fail", self.label)
        ):
            # Injected kernel-fail: this batch runs the plain path, exact.
            e.stats["kernel_fallbacks"] += 1
            _log.warning("injected kernel-fail at op=%s query=%s: batch runs the "
                         "plain path", self.label, self.query)
            fused = False
        rem, m, fetched, stolen = e._extend_step(self.desc, self.is_verify, fused,
                                                 self.in_q, self.out_q)
        fetched, stolen = e.comm.all_sum(fetched, stolen)
        e.stats["rounds"] += 1
        e.stats["a2a_calls"] += 2 + (2 if self.steal else 0)
        e.stats["pulled_vids"] += fetched
        e.stats["pulled_bytes"] += fetched * (e.d_pad + 2) * 4
        e.stats["steal_rows"] += stolen
        e.stats["steal_bytes"] += stolen * self.out_q.width * 4


class _DJoinRT:
    """PUSH-JOIN: hash-shuffle both inputs by join key (all_to_all), buffer
    them in preallocated side buffers, and — once the left branch has
    drained (the §5.4 barrier) — sort the left side once and stream the
    right side through local probes."""

    def __init__(self, eng: "DistributedEngine", desc: OpDesc,
                 left_q: _DQueue, right_q: _DQueue, out_q: _DQueue):
        self.e, self.desc = eng, desc
        self.left_q, self.right_q, self.out_q = left_q, right_q, out_q
        self.label = desc.label()
        jcap = eng.cfg.join_buffer_capacity
        shuffle_slack = eng.p * eng.cfg.batch_size
        self.lbuf = _DQueue(eng, left_q.width, shuffle_slack, capacity=jcap)
        self.rbuf = _DQueue(eng, right_q.width, shuffle_slack, capacity=jcap)
        self.query = ""
        self._sorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        # installed by the engine: () -> bool, True once every ancestor of the
        # left input (and the left queue itself) has drained
        self.left_branch_done = lambda: True

    # A join has three micro-operations with different targets and worst
    # cases (shuffle-left → lbuf, shuffle-right → rbuf, probe → out_q), so
    # capacity gating is internal: ``_runnable`` picks the next action that
    # has input and fits; output_free/required_slack are a 0/1 gate on it.

    def has_input(self) -> bool:
        return (
            self.left_q.max_n > 0
            or self.right_q.max_n > 0
            or (self.rbuf.max_n > 0 and self.left_branch_done())
        )

    def internal_pending(self) -> bool:
        # Rows shuffled but not yet probed keep this join's branch alive.
        return self.rbuf.max_n > 0

    def _runnable(self) -> Optional[str]:
        shuffle_slack = self.e.p * self.e.cfg.batch_size
        if self.left_q.max_n > 0 and self.lbuf.free() >= shuffle_slack:
            return "lshuf"
        # Probing precedes shuffle-right so the probe drains rbuf; it never
        # competes with shuffle-left because the barrier implies the left
        # queue has drained.
        if (
            self.rbuf.max_n > 0
            and self.left_branch_done()
            and self.out_q.free() >= self.e.cfg.join_out_capacity
        ):
            return "probe"
        if self.right_q.max_n > 0 and self.rbuf.free() >= shuffle_slack:
            return "rshuf"
        return None

    def output_free(self) -> int:
        return 1 if self._runnable() is not None else 0

    def required_slack(self) -> int:
        return 1

    def _shuffle(self, key_col: int, in_q: _DQueue, side: _DQueue) -> None:
        e = self.e
        rem, n2, moved = e._shuffle_step(key_col, in_q, side)
        in_q.set_n(rem)
        side.set(side.buf, n2)
        assert self._sorted is None or side is self.rbuf, (
            "left side grew after the join barrier released"
        )
        moved_rows = e.comm.all_sum(moved)[0]
        e.stats["rounds"] += 1
        e.stats["a2a_calls"] += 1
        e.stats["shuffle_rows"] += moved_rows
        e.stats["shuffle_bytes"] += moved_rows * side.width * 4

    def run_one(self) -> None:
        e = self.e
        e._inject(("join-overflow", "shard-loss"), self.label, self.query)
        a = self._runnable()
        if a == "lshuf":
            self._shuffle(self.desc.key_left[0], self.left_q, self.lbuf)
            return
        if a == "rshuf":
            self._shuffle(self.desc.key_right[0], self.right_q, self.rbuf)
            return
        if self._sorted is None:
            # Barrier released: sort the buffered branch once.
            self._sorted = ops_mod.join_prepare(self.lbuf.buf, self.lbuf.n,
                                                self.desc.key_left)
        use_kernel = e.cfg.fused
        if (
            use_kernel
            and e.cfg.faults is not None
            and e.cfg.faults.should_fire("kernel-fail", self.label)
        ):
            # Injected kernel-fail: this probe runs the plain bounds search.
            e.stats["kernel_fallbacks"] += 1
            _log.warning("injected kernel-fail at op=%s query=%s: probe runs the "
                         "plain bounds search", self.label, self.query)
            use_kernel = False
        d = self.desc
        rrows, take, rem = ops_mod.queue_pop(self.rbuf.buf, self.rbuf.n, e.cfg.batch_size)
        out, m, overflow = ops_mod.join_probe(
            self._sorted[0], self._sorted[1], rrows, take,
            d.key_right, d.right_extra, d.cross_neq, d.cross_lt,
            e.cfg.join_out_capacity, use_kernel=use_kernel,
        )
        buf, n2 = ops_mod.queue_append(self.out_q.buf, self.out_q.n, out, m)
        # Every rank raises when any rank overflowed.
        if e.comm.all_max(int(overflow))[0]:
            raise QueuePressure(
                "join-overflow",
                "distributed PUSH-JOIN probe exceeded join_out_capacity="
                f"{e.cfg.join_out_capacity} (results would be lost)",
                op=self.label, query=self.query,
            )
        self.rbuf.set_n(rem)
        self.out_q.set(buf, n2)
        e.stats["rounds"] += 1
        e.stats["probe_batches"] += 1


class _DSinkRT:
    def __init__(self, eng: "DistributedEngine", desc: OpDesc, in_q: _DQueue):
        self.e, self.desc, self.in_q = eng, desc, in_q
        self.label = desc.label()
        self.count = 0

    def has_input(self) -> bool:
        return self.in_q.max_n > 0

    def internal_pending(self) -> bool:
        return False

    def output_free(self) -> int:
        return 1 << 62

    def required_slack(self) -> int:
        return 0

    def run_one(self) -> None:
        self.count += self.in_q.total()
        self.in_q.drain()
        self.e.stats["rounds"] += 1


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class DistributedEngine:
    """SPMD execution of translated dataflows, one instance per rank.

    Runs any optimiser plan — hybrid plans mixing PULL-EXTEND and PUSH-JOIN
    included — with collectives over ``comm``'s group; every rank must call
    the same methods with the same arguments. ``stats["engine"]`` is
    ``"torch.distributed"`` and ``stats["joins"]`` counts the PUSH-JOINs."""

    def __init__(self, graph: Graph, comm: Comm, cfg: DistConfig | None = None):
        self.cfg = cfg or DistConfig()
        self.comm = comm
        self.p = comm.world_size
        self.rank = comm.rank
        self.device = resolve_device(comm.device)
        self._load_graph(graph)
        # Delta state (streaming): armed by apply_updates.
        self.delta_adj: Optional[torch.Tensor] = None
        self.delta_src = self.delta_dst = None
        self.delta_scan_total = 0
        self.delta_scan_len = 0
        self.stats: Dict[str, object] = {}
        self._last_labels: List[str] = []  # the last pass's runtime labels

    def _sharded_edge_lists(self, graph: Graph):
        """This rank's directed edges (those whose source it owns), padded to
        the largest shard's count rounded up to a multiple of the batch — the
        scan source layout, shared by the full graph and the delta graph.
        Returns ``(src, dst, count, padded length)``."""
        offsets = graph.offsets.cpu().numpy().astype(np.int64)
        src_all = np.repeat(np.arange(graph.num_vertices, dtype=np.int32), np.diff(offsets))
        dst_all = graph.nbrs.cpu().numpy().astype(np.int32)
        owners = src_all % self.p
        b = self.cfg.batch_size
        max_e = int(np.bincount(owners, minlength=self.p).max()) if owners.size else 0
        max_e = max(b, ((max_e + b - 1) // b) * b)
        sel = owners == self.rank
        n = int(sel.sum())
        src = np.zeros((max_e,), np.int32)
        dst = np.full((max_e,), INVALID, np.int32)
        src[:n] = src_all[sel]
        dst[:n] = dst_all[sel]
        return (torch.from_numpy(src).to(self.device), torch.from_numpy(dst).to(self.device),
                n, max_e)

    def _load_graph(self, graph: Graph) -> None:
        """(Re)partition and bind every graph-derived tensor of this rank."""
        self.graph = graph
        self.v = graph.num_vertices
        self.d_pad = graph.padded.d_pad
        self.adj = shard_adjacency(graph, self.p, self.rank, self.device)[0]
        self.src, self.dst, self.scan_total, self.scan_len = self._sharded_edge_lists(graph)

    # -- streaming updates -----------------------------------------------------

    def apply_updates(self, batch: GraphUpdateBatch):
        """Apply an edge-insert batch on every rank.

        The storage rebuild is row-local (``graph.storage.apply_updates``);
        ownership is ``v % P``, so it never moves, only the owners' rows
        change. The delta graph is kept two ways: its directed edges sharded
        by owner like the scan sources, and its padded adjacency
        **replicated** on every rank for the old-epoch membership veto (delta
        batches are small, so replication is cheaper than a second fetch)."""
        applied = storage_apply_updates(self.graph, batch)
        self._load_graph(applied.graph)
        delta = applied.delta
        self.delta_adj = delta.padded.adj.to(self.device)
        (self.delta_src, self.delta_dst, self.delta_scan_total,
         self.delta_scan_len) = self._sharded_edge_lists(delta)
        return applied

    # -- rank-local pieces of a step ---------------------------------------------

    def _offshard(self, per_dest: torch.Tensor) -> torch.Tensor:
        """Entries of a per-destination count ``[P]`` bound for other ranks."""
        return per_dest.sum() - per_dest[self.rank]

    def _fetch(self, rows: torch.Tensor, valid: torch.Tensor, ext: Tuple[int, ...]):
        """Fetch stage: dedup the needed vids, exchange requests and rows with
        their owners, return a sorted lookup table ``(vids, rows)`` and the
        number of requests this rank sent to other ranks (a device scalar)."""
        p = self.p
        vids = rows[:, list(ext)].reshape(-1)
        ok = (vids != INVALID) & (vids >= 0) & valid[:, None].expand(-1, len(ext)).reshape(-1)
        r_cap = vids.shape[0]
        reqs, cnt = route_requests(vids, vids % p, ok, p, self.v, r_cap)
        got = self.comm.a2a(reqs)
        gv = got != INVALID
        lid = torch.where(gv, got // p, 0).clamp_(0, self.adj.shape[0] - 1)
        served = self.adj[lid.reshape(-1).long()].reshape(p, r_cap, -1)
        served = torch.where(gv[:, :, None], served, INVALID)
        back = self.comm.a2a(served)
        back_vids = reqs.reshape(-1)
        order = torch.sort(back_vids, stable=True).indices
        return back_vids[order], back.reshape(-1, self.d_pad)[order], self._offshard(cnt)

    def _lookup(self, table_vids, table_rows, vids):
        """Adjacency rows of ``vids``: local rows from the shard, remote ones
        from the fetched table; INVALID rows for invalid or missing ids."""
        p = self.p
        ok = (vids != INVALID) & (vids >= 0)
        local = ok & ((vids % p) == self.rank)
        lrows = self.adj[torch.where(ok, vids // p, 0).clamp(0, self.adj.shape[0] - 1).long()]
        idx = torch.searchsorted(table_vids, vids.contiguous()).clamp_(
            0, table_vids.shape[0] - 1)
        hit = table_vids[idx] == vids
        rrows = table_rows[idx]
        rows = torch.where(local[:, None], lrows, torch.where(hit[:, None], rrows, INVALID))
        return torch.where(ok[:, None], rows, INVALID)

    def _fused_addressing(self, table_vids, rows, ext):
        """``_lookup`` as the fused kernels' slab addressing: ``tab0`` is the
        fetched table, ``tab1`` the local shard. Returns ``(idx[2, B, E],
        sel, ok)``: ``sel`` routes remote hits to the table, ``ok`` covers
        exactly the rows ``_lookup`` returns non-INVALID."""
        p = self.p
        vids = rows[:, list(ext)]                       # [B, E]
        okv = (vids != INVALID) & (vids >= 0)
        local = okv & ((vids % p) == self.rank)
        idx1 = torch.where(okv, vids // p, 0).clamp(0, self.adj.shape[0] - 1)
        idx0 = torch.searchsorted(table_vids, vids.contiguous()).clamp_(
            0, table_vids.shape[0] - 1)
        hit = table_vids[idx0] == vids
        sel = ~local & hit
        ok = okv & (local | hit)
        idx = torch.stack([idx0.to(torch.int32), idx1.to(torch.int32)])
        return idx, sel.to(torch.int32), ok.to(torch.int32)

    def _delta_rows(self, vids):
        safe = vids.clamp(0, self.delta_adj.shape[0] - 1).long()
        ok = (vids >= 0) & (vids != INVALID)
        return torch.where(ok[:, None], self.delta_adj[safe], INVALID)

    def _extend_step(self, op: OpDesc, is_verify: bool, fused: bool,
                     in_q: _DQueue, out_q: _DQueue):
        """One PULL-EXTEND / VERIFY batch on this rank: pop, fetch,
        intersect, steal, append. Returns ``(rem, m, fetched, stolen)``: the
        input's remaining rows, the rows appended, and this rank's
        cross-rank requests and stolen rows (host integers)."""
        b = self.cfg.batch_size
        p = self.p
        ext, lt, gt = op.ext, op.lt_positions, op.gt_positions
        old_mask = tuple(ep == "old" for ep in op.ext_epochs) or (False,) * len(ext)
        if any(old_mask):
            fused = False  # the fused kernels know nothing of epochs
        rows, take, rem = ops_mod.queue_pop(in_q.buf, in_q.n, b)
        valid = torch.arange(b, device=rows.device) < take
        tv, tr, remote = self._fetch(rows, valid, ext)
        k = rows.shape[1]
        if is_verify and fused:
            idx, sel, okm = self._fused_addressing(tv, rows, ext)
            new_rows, m = ops_mod.fused_verify_batch(tr, self.adj, idx, sel, okm, rows,
                                                     take, op.verify_pos, b)
        elif is_verify:
            target = rows[:, op.verify_pos : op.verify_pos + 1]
            mask = valid
            for d, is_old in zip(ext, old_mask):
                other = self._lookup(tv, tr, rows[:, d])
                mask = mask & ops_mod.row_membership(other, target)[:, 0]
                if is_old:
                    mask = mask & ~ops_mod.row_membership(self._delta_rows(rows[:, d]),
                                                          target)[:, 0]
            new_rows, m = ops_mod.compact(rows, mask, b)
        elif fused:
            idx, sel, okm = self._fused_addressing(tv, rows, ext)
            new_rows, m = ops_mod.fused_extend_batch(tr, self.adj, idx, sel, okm, rows,
                                                     take, lt, gt, b * self.d_pad)
        else:
            cands = self._lookup(tv, tr, rows[:, ext[0]])
            mask = (cands != INVALID) & valid[:, None]
            if old_mask[0]:
                mask &= ~ops_mod.row_membership(self._delta_rows(rows[:, ext[0]]), cands)
            for d, is_old in zip(ext[1:], old_mask[1:]):
                mask &= ops_mod.row_membership(self._lookup(tv, tr, rows[:, d]), cands)
                if is_old:
                    mask &= ~ops_mod.row_membership(self._delta_rows(rows[:, d]), cands)
            for col in range(k):
                mask &= cands != rows[:, col : col + 1]
            for pp in lt:
                mask &= cands < torch.where(valid, rows[:, pp], -1)[:, None]
            for pp in gt:
                mask &= cands > torch.where(valid, rows[:, pp], INVALID)[:, None]
            new_rows, m = ops_mod._expand_compact(rows, cands, mask, b * self.d_pad)
        stolen = 0
        out_w = b if is_verify else b * self.d_pad
        if self.cfg.rebalance and not is_verify and out_w >= p:
            # Work stealing: chunk d of the packed output goes to rank d.
            share = out_w // p
            kk = new_rows.shape[1]
            chunks = new_rows[: share * p].reshape(p, share, kk)
            per_dest = [min(max(m - d * share, 0), share) for d in range(p)]
            stolen = sum(per_dest) - per_dest[self.rank]
            cvalid = (torch.arange(share * p, device=rows.device) < m).reshape(p, share)
            got = self.comm.a2a(chunks)
            gvalid = self.comm.a2a(cvalid.to(torch.uint8))
            new_rows, m = ops_mod.compact(got.reshape(-1, kk), gvalid.reshape(-1).bool(), out_w)
        buf, n2 = ops_mod.queue_append(out_q.buf, out_q.n, new_rows, m)
        in_q.set_n(rem)
        out_q.set(buf, n2)
        return rem, m, int(remote), stolen

    def _shuffle_step(self, key_col: int, in_q: _DQueue, side: _DQueue):
        """Pop a batch, route each row to rank ``row[key_col] % P`` with one
        all_to_all, append the arrivals to the join side buffer. Returns
        ``(rem, side count, rows this rank sent to other ranks)``."""
        b = self.cfg.batch_size
        p = self.p
        rows, take, rem = ops_mod.queue_pop(in_q.buf, in_q.n, b)
        valid = torch.arange(b, device=rows.device) < take
        send = ops_mod.partition_rows_by_key(rows, valid, rows[:, key_col], p)
        moved = self._offshard((send[:, :, 0] != INVALID).sum(dim=1))
        got = self.comm.a2a(send)
        flat = got.reshape(p * b, rows.shape[1])
        packed, m = ops_mod.compact(flat, flat[:, 0] != INVALID, p * b)
        _, n2 = ops_mod.queue_append(side.buf, side.n, packed, m)
        return rem, n2, int(moved)

    # ------------------------------------------------------------------

    def _build_runtimes(self, flow: Dataflow,
                        tenant_of_op: Optional[Tuple[int, ...]] = None) -> List[object]:
        ops = flow.ops
        b = self.cfg.batch_size
        queues: Dict[int, _DQueue] = {}
        for i, op in enumerate(ops):
            if op.kind == "sink":
                continue
            slack = {
                "scan": b,
                "verify": b,
                "extend": b * self.d_pad,
                "join": self.cfg.join_out_capacity,
            }[op.kind]
            queues[i] = _DQueue(self, len(op.schema), slack)

        runtimes: List[object] = []
        for i, op in enumerate(ops):
            if op.kind == "scan":
                rt = _DScanRT(self, op, queues[i])
            elif op.kind in ("extend", "verify"):
                rt = _DExtendRT(self, op, queues[op.inputs[0]], queues[i])
            elif op.kind == "join":
                rt = _DJoinRT(self, op, queues[op.inputs[0]], queues[op.inputs[1]], queues[i])
            else:
                rt = _DSinkRT(self, op, queues[op.inputs[0]])
            runtimes.append(rt)

        # Tenant tags for mixed traffic (run_concurrent): every queue and
        # runtime of a merged flow carries its tenant id; rows never mix
        # queues, so the tag lives on the queue, not in the rows.
        for i, rt in enumerate(runtimes):
            t = 0 if tenant_of_op is None else tenant_of_op[i]
            rt.tenant = t
            rt.query = flow.query_name
            if tenant_of_op is not None:
                rt.label = f"t{t}:{rt.label}"
            if i in queues:
                queues[i].tenant = t

        # Join barriers: probing may start only once every ancestor of the
        # left input has drained — no scans pending, no queued rows, no
        # unprobed rows inside ancestor joins. A barrier holds its ancestors'
        # runtimes and queues, not the list: a finished pass is then no
        # reference cycle, and its queues go as soon as the caller lets go.
        for i, op in enumerate(ops):
            if op.kind != "join":
                continue
            branch = (*flow.ancestors(op.inputs[0]), op.inputs[0])

            def make_done(deps=tuple((runtimes[j], queues.get(j)) for j in branch)):
                def done() -> bool:
                    for rt, q in deps:
                        if rt.internal_pending():
                            return False
                        if q is not None and q.max_n > 0:
                            return False
                    return True
                return done

            runtimes[i].left_branch_done = make_done()
        return runtimes

    def run(self, query_or_plan: QueryGraph | ExecutionPlan | Dataflow,
            space: str = "huge") -> Tuple[int, Dict]:
        """Plan (if needed), translate and execute on every rank. Returns
        ``(count, stats)``; every rank returns the same."""
        flow = self._to_flow(query_or_plan, space)
        sinks = flow.sink_indices()
        if len(sinks) != 1:
            raise ValueError(
                f"run() got a flow with {len(sinks)} sinks — merged multi-sink "
                "flows carry one result per source flow; use run_concurrent "
                "(per-tenant counts) or run_delta (delta unions) instead"
            )
        runtimes, _ = self._execute(flow)
        return runtimes[sinks[0]].count, self.stats

    def run_concurrent(self, queries: List[QueryGraph | ExecutionPlan | Dataflow],
                       space: str = "huge") -> Tuple[List[int], Dict]:
        """Serve N tenants' queries through one scheduler pass: the flows are
        merged into one multi-sink DAG whose tenant-tagged runtimes share the
        collectives. Returns per-tenant counts in input order."""
        from repro_torch.analysis import flowcheck

        flows = [self._to_flow(q, space) for q in queries]
        merged, tenant_of_op = merge_flows(flows)
        flowcheck.verify_flow(merged)
        runtimes, _ = self._execute(merged, tenant_of_op)
        counts = [runtimes[i].count for i in merged.sink_indices()]
        self.stats["tenants"] = len(flows)
        self.stats["per_tenant_matches"] = list(counts)
        return counts, self.stats

    def run_delta(self, query_or_plan: QueryGraph | ExecutionPlan,
                  space: str = "huge") -> Tuple[int, Dict]:
        """Count only the matches the last applied batch created: the
        delta-join decomposition merged into one multi-sink DAG (delta scans
        sharded like normal scans, old-epoch extends vetoed against the
        replicated delta adjacency), run by one scheduler pass."""
        from repro_torch.analysis import flowcheck

        if self.delta_adj is None:
            raise RuntimeError("run_delta before apply_updates: no delta batch is armed")
        if isinstance(query_or_plan, QueryGraph):
            plan = optimal_plan(query_or_plan, GraphStats.from_graph(self.graph), self.p, space)
        elif isinstance(query_or_plan, ExecutionPlan):
            plan = query_or_plan
        else:
            raise TypeError(
                "run_delta needs a QueryGraph or ExecutionPlan (delta flows "
                "are derived from the query, not from an existing Dataflow)"
            )
        flows = delta_flows(plan)
        merged, tenant_of_op = merge_flows(flows)
        flowcheck.verify_flow(merged)
        runtimes, _ = self._execute(merged, tenant_of_op)
        count = sum(runtimes[i].count for i in merged.sink_indices())
        self.stats["delta_flows"] = len(flows)
        return count, self.stats

    def _to_flow(self, query_or_plan: QueryGraph | ExecutionPlan | Dataflow,
                 space: str) -> Dataflow:
        from repro_torch.analysis import flowcheck

        if isinstance(query_or_plan, Dataflow):
            flow = query_or_plan
        else:
            if isinstance(query_or_plan, QueryGraph):
                plan = optimal_plan(query_or_plan, GraphStats.from_graph(self.graph),
                                    self.p, space)
            else:
                plan = query_or_plan
            flow = translate(plan)
        # Mandatory structural pre-flight before any device work.
        flowcheck.verify_flow(flow)
        return flow

    # -- fault injection ---------------------------------------------------------

    def _inject(self, kinds: Tuple[str, ...], op: str, query: str = "") -> None:
        """Probe the armed FaultPlan at an operator invocation and raise the
        matching structured fault (host-side, at the same step on every rank)."""
        fp = self.cfg.faults
        if fp is None:
            return
        for kind in kinds:
            if fp.should_fire(kind, op):
                if kind == "shard-loss":
                    raise ShardLoss(fp.seed % self.p, op=op, query=query)
                raise QueuePressure(kind, "injected fault", op=op, query=query)

    def _execute(self, flow: Dataflow, tenant_of_op: Optional[Tuple[int, ...]] = None):
        """Build runtimes and drive one scheduler pass, with restart-based
        recovery: execution is deterministic, so a recoverable fault rebuilds
        the runtimes — fresh queues, zero counts — and re-runs the flow,
        halving the batch on QueuePressure. The original config is restored
        on exit, so degradation never leaks across queries."""
        orig_cfg = self.cfg
        attempts = restarts = pressure = 0
        try:
            while True:
                # Release the previous attempt's queues before allocating.
                runtimes = None
                self.stats = {
                    "engine": "torch.distributed",
                    "shards": self.p,
                    "joins": flow.num_joins(),
                    "rounds": 0,
                    "a2a_calls": 0,
                    "pulled_vids": 0,
                    "pulled_bytes": 0,
                    "shuffle_rows": 0,
                    "shuffle_bytes": 0,
                    "steal_rows": 0,
                    "steal_bytes": 0,
                    "probe_batches": 0,
                    "kernel_fallbacks": 0,
                    "retries": attempts,
                    "restarts": restarts,
                    "pressure_events": pressure,
                }
                runtimes = self._build_runtimes(flow, tenant_of_op)
                self._last_labels = [rt.label for rt in runtimes]
                sched = AdaptiveScheduler(runtimes, dfs_bias=attempts > 0)
                try:
                    st = sched.run()
                except EnumerationFault as f:
                    if (
                        not orig_cfg.recover
                        or not f.recoverable
                        or attempts >= orig_cfg.max_retries
                    ):
                        raise
                    attempts += 1
                    if isinstance(f, ShardLoss):
                        restarts += 1
                        _log.warning("restarting after %s (attempt %d/%d)",
                                     str(f), attempts, orig_cfg.max_retries)
                    else:
                        pressure += 1
                        nb = max(self.cfg.batch_size // 2, orig_cfg.min_batch_size)
                        if nb >= self.cfg.batch_size:
                            raise EnumerationFault(
                                f.kind,
                                "recovery ladder exhausted: batch already at "
                                f"floor {self.cfg.batch_size} (raise queue "
                                "capacities or min_batch_size)",
                                op=f.op, query=f.query,
                            ) from f
                        _log.warning("restarting after %s (attempt %d/%d): batch %d -> %d",
                                     str(f), attempts, orig_cfg.max_retries,
                                     self.cfg.batch_size, nb)
                        self.cfg = dataclasses.replace(self.cfg, batch_size=nb)
                    continue
                self.stats["sched_steps"] = st.steps
                self.stats["sched_backtracks"] = st.backtracks
                return runtimes, st
        finally:
            self.cfg = orig_cfg


# ---------------------------------------------------------------------------
# Spawning the ranks of a group on one host
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RankResult:
    rank: int
    value: Any                 # what the rank's function returned
    launches: Dict[str, int]   # the rank's intersect kernel launches during it


def _rank_main(fn, args, rank, world_size, backend, device_type, init_method,
               timeout_s, results) -> None:
    """A spawned rank: join the group, run ``fn(comm, *args)``, report."""
    torch.set_num_threads(1)
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    reported = False
    try:
        with process_group(backend, dev, rank=rank, world_size=world_size,
                           init_method=init_method, timeout_s=timeout_s) as comm:
            try:
                ik.reset_launches()
                value = fn(comm, *args)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                launches = dict(ik.launches)
            except BaseException:
                # Report before leaving the group: teardown may wait on peers.
                results.put((rank, False, traceback.format_exc(), None))
                reported = True
                raise
            results.put((rank, True, value, launches))
            reported = True
    except BaseException:
        if not reported:
            results.put((rank, False, traceback.format_exc(), None))
        raise


def run_ranks(fn: Callable[..., Any], world_size: int, *, backend: str = "gloo",
              device: str | torch.device | None = None, timeout_s: float = 600.0,
              args: Tuple = ()) -> List[RankResult]:
    """Run ``fn(comm, *args)`` on ``world_size`` spawned ranks of one process
    group and return each rank's result, in rank order. ``fn`` must be
    importable by name (a module-level function). Rank ``r`` uses
    ``cuda:(r % device_count)`` (``device="cpu"``: the CPU), with one torch
    thread. NCCL takes one GPU per rank, so it is refused for more
    ranks than GPUs: pass ``backend="gloo"``. The intersect kernels are built
    here, once, before the ranks start.

    Raises ``RuntimeError`` as soon as a rank fails (with its traceback) and
    ``TimeoutError`` when ``timeout_s`` passes first; either way every rank
    still running is killed, so none is left blocked in a collective."""
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"nccl takes one GPU per rank: {world_size} ranks, "
                f"{torch.cuda.device_count()} GPUs (pass backend='gloo')"
            )
    if dev.type == "cuda":
        ik.LIB.build()  # once, here: ranks building at once would race
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init_method = "file://" + os.path.join(tmp, "store")
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(fn, args, r, world_size, backend, dev.type, init_method,
                          timeout_s, results))
        for r in range(world_size)
    ]
    out: Dict[int, RankResult] = {}
    failures: List[str] = []
    failed = set()
    ok = False

    def exited() -> List[str]:
        return [f"rank {r} exited with code {pr.exitcode} before reporting"
                for r, pr in enumerate(procs)
                if r not in out and r not in failed and pr.exitcode not in (None, 0)]

    try:
        for pr in procs:
            pr.start()
        deadline = time.monotonic() + timeout_s
        while len(out) < world_size and not failures:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: {world_size - len(out)} of {world_size} ranks had not "
                    f"finished after {timeout_s} s"
                )
            try:
                rank, good, payload, launches = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                failures = exited()
                continue
            if good:
                out[rank] = RankResult(rank, payload, launches)
            else:
                failed.add(rank)
                failures.append(f"rank {rank} failed:\n{payload}")
        if failures:
            # The failure's echoes (peers whose collectives broke) arrive
            # within moments: report them all, the first first.
            end = time.monotonic() + 2.0
            while time.monotonic() < end:
                try:
                    rank, good, payload, _ = results.get(
                        timeout=max(0.0, end - time.monotonic()))
                except queue_mod.Empty:
                    break
                if not good:
                    failed.add(rank)
                    failures.append(f"rank {rank} failed:\n{payload}")
            failures += exited()
            raise RuntimeError("run_ranks: " + "\n".join(failures))
        ok = True
    finally:
        for pr in procs:
            if ok:
                pr.join(timeout=30)
            if pr.is_alive():
                pr.kill()
            pr.join(timeout=10)
        results.close()
        results.join_thread()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
