"""BFS/DFS-adaptive scheduler — paper Algorithm 5 (§5.2), generalised to DAGs.

Each operator owns a fixed-capacity output queue. The scheduler lets the
current operator consume as many input batches as possible (BFS-style, max
parallelism) but *yields* it the moment its output queue cannot absorb another
batch's worst-case results, scheduling the successor instead; when an operator
drains its input the scheduler backtracks to the precursor. Queue capacities
are preallocated device arrays, so the paper's O(|V_q|²·D_G) bound becomes a
structural compile-time constant.

The scheduler works over an abstract runtime interface so the same loop
drives SCAN / PULL-EXTEND / VERIFY / PUSH-JOIN dataflows of the engine
(engine.py). It is pure Python and identical to the JAX package's.

Operator *DAGs* (plans with PUSH-JOIN barriers) are scheduled as their
topological order (Dataflow emission order): every producer precedes its
consumers, so "backtrack to the precursor" is simply "move left". A
multi-input operator such as PUSH-JOIN participates through the same
four-method protocol — its ``has_input`` consults *both* upstream queues (and
its barrier condition: probing only once the buffered branch has drained, see
DESIGN.md §Shuffle-join), so the scheduler itself stays oblivious to arity.
Termination is unchanged: the loop exits when no operator reports input,
and a barrier op always eventually unblocks because its upstream branch
strictly precedes it in the order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Protocol


class OperatorRuntime(Protocol):
    label: str

    def has_input(self) -> bool: ...
    def output_free(self) -> int: ...
    def required_slack(self) -> int: ...
    def run_one(self) -> None: ...


@dataclasses.dataclass
class ScheduleStats:
    steps: int = 0
    yields_full: int = 0
    yields_empty: int = 0
    backtracks: int = 0
    peak_queue_rows: int = 0
    peak_queue_bytes: int = 0
    completed: bool = True  # False only when run(max_steps=...) hit its budget

    def merge(self, other: "ScheduleStats") -> "ScheduleStats":
        """Accumulate another pass's counters (used by tick-driven callers
        that build one scheduler pass per service tick)."""
        self.steps += other.steps
        self.yields_full += other.yields_full
        self.yields_empty += other.yields_empty
        self.backtracks += other.backtracks
        self.peak_queue_rows = max(self.peak_queue_rows, other.peak_queue_rows)
        self.peak_queue_bytes = max(self.peak_queue_bytes, other.peak_queue_bytes)
        self.completed = other.completed
        return self


class AdaptiveScheduler:
    """Algorithm 5 over a topologically ordered operator list (chain or DAG).

    The paper's literal pseudocode bounces precursor↔successor when the head
    of the chain is exhausted; we resolve direction by whether *any* upstream
    operator still has input (identical schedule on live inputs, guaranteed
    termination on drained ones). For DAGs, "upstream" means "earlier in the
    topological order" — a superset of the true ancestors, which only makes
    the liveness check conservative, never wrong.
    """

    def __init__(self, chain: List[OperatorRuntime], memory_probe=None,
                 dfs_bias: bool = False):
        self.chain = chain
        self.memory_probe = memory_probe  # () -> (rows, bytes)
        self.dfs_bias = dfs_bias  # one batch per visit: drain downstream
        #   before producing more (the recovery ladder's memory-pressure mode,
        #   DESIGN.md §Fault-tolerance)
        self.stats = ScheduleStats()

    def _probe(self):
        if self.memory_probe is not None:
            rows, nbytes = self.memory_probe()
            self.stats.peak_queue_rows = max(self.stats.peak_queue_rows, rows)
            self.stats.peak_queue_bytes = max(self.stats.peak_queue_bytes, nbytes)

    def run(self, max_steps: int | None = None) -> ScheduleStats:
        """Drive the chain until every operator drains, or — when ``max_steps``
        is given — until that many ``run_one`` calls have executed. A budgeted
        return sets ``stats.completed = False`` so tick-driven callers (the
        multi-tenant graph service) know work remains; calling ``run`` again
        on a fresh scheduler over the same runtimes resumes exactly where the
        queues left off (all scheduling state lives in the queues/cursors)."""
        chain = self.chain
        last = len(chain) - 1
        cur = 0
        stall = 0  # iterations since the last batch ran (deadlock guard)
        budget = max_steps if max_steps is not None else -1
        while True:
            if budget == 0:
                self.stats.completed = False
                return self.stats
            if stall > 4 * len(chain) + 8:
                raise RuntimeError(
                    "scheduler stalled: every operator is blocked on a full "
                    "output queue — raise queue/join-buffer capacity "
                    f"(chain: {[op.label for op in chain]})"
                )
            op = chain[cur]
            if op.has_input():
                # Schedule(O): consume until the output queue can no longer
                # absorb a worst-case batch, or the input drains.
                ran = False
                while op.has_input() and op.output_free() >= op.required_slack():
                    op.run_one()
                    ran = True
                    self.stats.steps += 1
                    self._probe()
                    if budget > 0:
                        budget -= 1
                        if budget == 0:
                            self.stats.completed = False
                            return self.stats
                    if self.dfs_bias:
                        # Memory-pressure mode: emit one batch, then move on
                        # so downstream ops drain it before more is produced.
                        break
                stall = 0 if ran else stall + 1
                if op.has_input():
                    self.stats.yields_full += 1  # yielded on full queue
                else:
                    self.stats.yields_empty += 1
                if cur == last:
                    self.stats.backtracks += 1
                    cur = max(cur - 1, 0)
                else:
                    cur += 1
                continue
            # O has no input: backtrack to the nearest upstream op that can
            # actually *run* (has input and output room), jumping over blocked
            # and drained ones. Stepping back one at a time would strand the
            # cursor against a blocked multi-input op — it has input, so it
            # bounces the cursor forward again, and runnable work further
            # upstream is never reached. An upstream op that is merely blocked
            # is no reason to stop: in a DAG its relief (the consumer of its
            # full queue) lies *downstream*, so prefer advancing when anything
            # later is live. (On a linear chain the op downstream of a blocked
            # op always has input, so neither situation arises and the
            # schedule is unchanged.)
            stall += 1
            up_run = next(
                (
                    j for j in range(cur - 1, -1, -1)
                    if chain[j].has_input()
                    and chain[j].output_free() >= chain[j].required_slack()
                ),
                None,
            )
            down_live = any(chain[j].has_input() for j in range(cur + 1, len(chain)))
            if up_run is not None:
                self.stats.backtracks += 1
                cur = up_run
            elif down_live:
                cur += 1
            elif any(chain[j].has_input() for j in range(cur)):
                self.stats.backtracks += 1
                cur -= 1  # only blocked work left upstream: let the stall
                          # guard prove it a real deadlock
            else:
                break  # every operator drained → dataflow complete
        return self.stats
