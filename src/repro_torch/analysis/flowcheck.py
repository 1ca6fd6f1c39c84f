"""Static verifier for execution plans and operator dataflows.

Checks, *without executing* (DESIGN.md §Static-analysis):

``check_flow`` over a translated :class:`~repro_torch.core.dataflow.Dataflow`:

* DAG well-formedness — topological emission order (``inputs[i] < i``), per-
  kind input arity, at least one sink, sinks never consumed, no orphan ops
  (every producer is an ancestor of some sink), and cycle-freedom so every
  PUSH-JOIN barrier (``Dataflow.ancestors`` of its left input) is reachable
  and drainable;
* per-op schema propagation — scan emits its edge's two distinct endpoints,
  extend appends exactly its new vertex, verify preserves its input schema,
  injectivity (no duplicate query vertex per schema), and every
  ``ext`` / ``verify_pos`` / lt/gt order-filter column exists;
* extend-order connectivity — an extend/verify with an empty ``ext`` would
  enumerate a cross product (its new vertex is disconnected from the matched
  prefix), the dataflow-level mirror of ``plan.is_connected`` per sub-query;
* join compatibility — key columns exist on both sides, have equal length,
  and bind the *same query vertices* in the same order; the output schema is
  exactly ``left + right_extra``; cross filters index real columns;
* Eq.-3 comm-mode legality — a materialised join node must be ``push``
  (§5.2 rewrites every pulling join into VERIFY + PULL-EXTENDs before the
  dataflow exists), extends are local/pull/push, scans local;
* delta-epoch legality — only scans carry a ``scan_epoch`` and it is
  ``full`` or ``delta``; ``ext_epochs`` appears only on extend/verify, tags
  every probed adjacency list with ``old``/``new``, and an op probing the
  ``old`` epoch must descend from a delta-seeded scan (the old/new split is
  meaningful only in the exactly-once delta decomposition, DESIGN.md
  §Delta-plans);
* queue-cell accounting — ``engine.flow_queue_cells`` totals against the
  configured Theorem-5.4 bound and/or a ``QueueSlotPool`` capacity, so a
  query that could never be admitted is diagnosed before any lease.

``check_plan`` over an :class:`~repro_torch.core.plan.ExecutionPlan`: sub-query
connectivity per node (``is_connected``), join children partitioning, plan
coverage of the query, Eq.-3 ``(algo, comm)`` legality per join node
(Def. 3.1 / Property 3.1), and symmetry conditions referencing real
vertices. ``check_query`` vets the query graph itself (what a tenant
submits): connectivity and canonical edges.

All three return ``List[Diagnostic]``; ``verify_flow`` raises
:class:`FlowcheckError` on any error-severity finding: the mandatory
pre-flight of ``HugeEngine.prepare``. The rules are the JAX package's
``analysis/flowcheck.py``, unchanged.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Set

from repro_torch.analysis.diagnostics import Diagnostic, FlowcheckError, errors
from repro_torch.core.dataflow import Dataflow, OpDesc
from repro_torch.core.plan import (
    ExecutionPlan,
    PlanNode,
    is_complete_star_join,
    is_connected,
    pull_hash_root,
    sub_vertices,
)
from repro_torch.core.query import QueryGraph

_ARITY = {"scan": 0, "extend": 1, "verify": 1, "join": 2, "sink": 1}
_OP_COMM = {
    "scan": ("local",),
    "extend": ("local", "pull", "push"),
    "verify": ("local", "pull"),
    "join": ("push",),          # Eq. 3 / §5.2: pulling joins are rewritten away
    "sink": ("local",),
}


def _diag(rule: str, op: int, msg: str, hint: str = "") -> Diagnostic:
    return Diagnostic(rule=rule, message=msg, op_index=op, hint=hint)


# ---------------------------------------------------------------------------
# Dataflow checks
# ---------------------------------------------------------------------------

def _check_dag(flow: Dataflow, out: List[Diagnostic]) -> bool:
    """Structural DAG checks. Returns False when the graph is too broken for
    the schema pass to walk safely (bad input indices)."""
    ops = flow.ops
    ok = True
    for i, op in enumerate(ops):
        if op.kind not in _ARITY:
            out.append(_diag("op-kind", i, f"unknown operator kind {op.kind!r}",
                             "use scan/extend/verify/join/sink"))
            ok = False
            continue
        if len(op.inputs) != _ARITY[op.kind]:
            out.append(_diag(
                "op-arity", i,
                f"{op.kind} has {len(op.inputs)} inputs, expects {_ARITY[op.kind]}",
                "re-run dataflow.translate; hand-built flows must wire every input",
            ))
            ok = False
        for j in op.inputs:
            if not (0 <= j < len(ops)):
                out.append(_diag("dag-order", i,
                                 f"input {j} outside op range [0, {len(ops)})"))
                ok = False
            elif j >= i:
                out.append(_diag(
                    "dag-order", i,
                    f"input {j} does not precede op {i} (topological emission "
                    "order violated)",
                    "emit producers before consumers (Dataflow contract)",
                ))
                ok = False
            elif ops[j].kind == "sink":
                out.append(_diag("sink-consumed", i,
                                 f"op {i} consumes sink op {j}",
                                 "sinks terminate a flow; nothing reads them"))
    sinks = [i for i, op in enumerate(ops) if op.kind == "sink"]
    if not sinks:
        out.append(_diag("no-sink", len(ops) - 1 if ops else 0,
                         "dataflow has no sink operator",
                         "append a sink so results are counted/materialised"))
        ok = False
    if not ok:
        return False
    # Cycle check via self-reachability (covers barrier reachability: a join
    # inside its own left-branch ancestor set could never release).
    for i, op in enumerate(ops):
        if i in flow.ancestors(i):
            out.append(_diag("dag-cycle", i,
                             f"op {i} is its own ancestor (cycle)",
                             "a PUSH-JOIN barrier over this branch deadlocks"))
            return False
    # Orphans: every non-sink op must feed some sink, else its rows are
    # silently dropped (a dangling branch — typically a mis-merged flow).
    fed: Set[int] = set()
    for s in sinks:
        fed.update(flow.ancestors(s))
    for i, op in enumerate(ops):
        if op.kind != "sink" and i not in fed:
            out.append(_diag(
                "orphan-op", i,
                f"op {i} ({op.label()}) never reaches a sink; its results are dropped",
                "wire the op into a sink's ancestor tree or remove it",
            ))
    return True


def _check_schemas(flow: Dataflow, out: List[Diagnostic]) -> None:
    ops = flow.ops
    for i, op in enumerate(ops):
        schema = op.schema
        if len(set(schema)) != len(schema):
            out.append(_diag(
                "schema-dup", i,
                f"schema {schema} matches a query vertex twice (injectivity broken)",
            ))
        for pos in op.lt_positions + op.gt_positions:
            if not (0 <= pos < len(schema)):
                out.append(_diag(
                    "filter-bounds", i,
                    f"order-filter position {pos} outside schema width {len(schema)}",
                    "symmetry filters must reference matched columns",
                ))
        if op.kind == "scan":
            if op.scan_edge is None or len(schema) != 2 or schema[0] == schema[1]:
                out.append(_diag("schema-scan", i,
                                 f"scan must emit two distinct vertices, got {schema}"))
            elif set(schema) != set(op.scan_edge):
                out.append(_diag(
                    "schema-scan", i,
                    f"scan schema {schema} does not match its edge {op.scan_edge}",
                ))
            continue
        if not op.inputs:
            continue  # arity errors already reported
        in_schema = ops[op.inputs[0]].schema
        if op.kind in ("extend", "verify"):
            if not op.ext:
                out.append(_diag(
                    "ext-disconnected", i,
                    f"{op.kind} intersects zero adjacency lists (Eq. 2 over an "
                    "empty set): the extension is disconnected from the matched "
                    "prefix and would enumerate a cross product",
                    "extend along at least one query edge (plan.is_connected "
                    "per sub-query)",
                ))
            for pos in op.ext:
                if not (0 <= pos < len(in_schema)):
                    out.append(_diag(
                        "ext-bounds", i,
                        f"ext position {pos} outside input schema width {len(in_schema)}",
                    ))
        if op.kind == "extend":
            if op.new_vertex is None:
                out.append(_diag("schema-extend", i, "extend without a new vertex"))
            elif op.new_vertex in in_schema:
                out.append(_diag(
                    "schema-extend", i,
                    f"new vertex v{op.new_vertex} already matched by the input schema",
                ))
            if schema != tuple(in_schema) + ((op.new_vertex,) if op.new_vertex is not None else ()):
                out.append(_diag(
                    "schema-extend", i,
                    f"extend schema {schema} is not input schema {in_schema} + "
                    f"new vertex {op.new_vertex}",
                ))
        elif op.kind == "verify":
            if schema != tuple(in_schema):
                out.append(_diag(
                    "schema-verify", i,
                    f"verify must preserve its input schema, got {schema} from {in_schema}",
                ))
            if op.verify_pos is None or not (0 <= op.verify_pos < len(in_schema)):
                out.append(_diag(
                    "schema-verify", i,
                    f"verify_pos {op.verify_pos} outside input schema width {len(in_schema)}",
                ))
        elif op.kind == "join":
            _check_join(flow, i, out)


def _check_join(flow: Dataflow, i: int, out: List[Diagnostic]) -> None:
    op = flow.ops[i]
    ls = flow.ops[op.inputs[0]].schema
    rs = flow.ops[op.inputs[1]].schema
    if not op.key_left or not op.key_right:
        out.append(_diag("join-key-empty", i,
                         "join with an empty key is a cross product",
                         "key on the common vertices of both input schemas"))
        return
    bad_bounds = False
    for side, key, width in (("left", op.key_left, len(ls)), ("right", op.key_right, len(rs))):
        for pos in key:
            if not (0 <= pos < width):
                out.append(_diag(
                    "join-key-incompatible", i,
                    f"{side} key position {pos} outside schema width {width}",
                ))
                bad_bounds = True
    if len(op.key_left) != len(op.key_right):
        out.append(_diag(
            "join-key-incompatible", i,
            f"key arity differs: left {op.key_left} vs right {op.key_right}",
        ))
        bad_bounds = True
    if not bad_bounds:
        lverts = tuple(ls[p] for p in op.key_left)
        rverts = tuple(rs[p] for p in op.key_right)
        if lverts != rverts:
            out.append(_diag(
                "join-key-incompatible", i,
                f"key columns bind different query vertices: left {lverts} vs "
                f"right {rverts} — rows would match on unrelated vertices",
                "key both sides on the shared vertices, in the same order",
            ))
    extra_ok = all(0 <= p < len(rs) for p in op.right_extra)
    if not extra_ok:
        out.append(_diag("join-schema", i,
                         f"right_extra {op.right_extra} outside right schema width {len(rs)}"))
    else:
        expect = tuple(ls) + tuple(rs[p] for p in op.right_extra)
        if op.schema != expect:
            out.append(_diag(
                "join-schema", i,
                f"join schema {op.schema} != left + right_extra = {expect}",
            ))
        overlap = set(rs[p] for p in op.right_extra) & set(ls)
        if overlap:
            out.append(_diag(
                "join-schema", i,
                f"right_extra re-emits vertices already on the left: {sorted(overlap)}",
            ))
    for a, b in op.cross_neq + op.cross_lt:
        if not (0 <= a < len(op.schema) and 0 <= b < len(op.schema)):
            out.append(_diag(
                "join-cross-bounds", i,
                f"cross filter ({a}, {b}) outside output schema width {len(op.schema)}",
            ))


def _check_comm(flow: Dataflow, out: List[Diagnostic]) -> None:
    for i, op in enumerate(flow.ops):
        legal = _OP_COMM.get(op.kind)
        if legal is not None and op.comm not in legal:
            out.append(_diag(
                "comm-illegal", i,
                f"{op.kind} with comm={op.comm!r}; Eq. 3 allows {legal} "
                "(pulling joins are rewritten to VERIFY + PULL-EXTENDs by §5.2 "
                "before translation)",
                "fix the translator/plan; joins always shuffle (push)",
            ))


_SCAN_EPOCHS = ("full", "delta")
_EXT_EPOCHS = ("old", "new")


def _check_epochs(flow: Dataflow, out: List[Diagnostic]) -> None:
    """Delta-flow epoch legality (DESIGN.md §Delta-plans). A delta dataflow
    is seeded from the update batch (``scan_epoch="delta"``) and threads
    old/new adjacency epochs through its extends/verifies so the k flows of
    a k-edge query emit each new match exactly once; epoch tags anywhere
    else mean a hand-built or mis-merged flow."""
    ops = flow.ops
    for i, op in enumerate(ops):
        if op.kind == "scan":
            if op.scan_epoch not in _SCAN_EPOCHS:
                out.append(_diag(
                    "epoch-illegal", i,
                    f"scan_epoch {op.scan_epoch!r}; a scan is seeded from "
                    f"{_SCAN_EPOCHS} (whole graph vs. update batch)",
                ))
        elif op.scan_epoch != "full":
            out.append(_diag(
                "epoch-illegal", i,
                f"{op.kind} carries scan_epoch={op.scan_epoch!r}; only scans "
                "are seeded from an epoch",
            ))
        if not op.ext_epochs:
            continue
        if op.kind not in ("extend", "verify"):
            out.append(_diag(
                "epoch-illegal", i,
                f"{op.kind} carries ext_epochs={op.ext_epochs}; only "
                "extend/verify probe adjacency epochs",
            ))
            continue
        bad = [e for e in op.ext_epochs if e not in _EXT_EPOCHS]
        if bad:
            out.append(_diag(
                "epoch-illegal", i,
                f"unknown adjacency epoch(s) {bad}; each probed query edge "
                "reads 'old' (pre-batch) or 'new' (post-batch) adjacency",
            ))
        if len(op.ext_epochs) != len(op.ext):
            out.append(_diag(
                "epoch-illegal", i,
                f"{len(op.ext_epochs)} epoch tags for {len(op.ext)} probed "
                "adjacency lists; ext_epochs must tag every ext position",
            ))
        if "old" in op.ext_epochs and not any(
            ops[j].kind == "scan" and ops[j].scan_epoch == "delta"
            for j in flow.ancestors(i)
        ):
            out.append(_diag(
                "epoch-no-delta-scan", i,
                "op probes the 'old' adjacency epoch but no ancestor scan "
                "is seeded from the delta batch: the old/new split only "
                "deduplicates matches rooted at a Δ-edge, so on a full scan "
                "it silently drops matches",
                "seed the flow from a delta scan (dataflow.delta_flows)",
            ))


def check_flow(
    flow: Dataflow,
    *,
    cfg=None,
    d_pad: Optional[int] = None,
    max_cells: Optional[int] = None,
    queue_capacity: Optional[int] = None,
    join_buffer_capacity: Optional[int] = None,
) -> List[Diagnostic]:
    """Statically verify a dataflow. When ``cfg`` (an ``EngineConfig``) and
    ``d_pad`` are given, also price the flow's preallocated queues via
    ``engine.flow_queue_cells`` and check the total against ``max_cells``
    (a Theorem-5.4 budget / ``QueueSlotPool.total_cells``)."""
    out: List[Diagnostic] = []
    if not flow.ops:
        return [_diag("no-sink", 0, "dataflow is empty")]
    if _check_dag(flow, out):
        _check_schemas(flow, out)
        _check_comm(flow, out)
        _check_epochs(flow, out)
    if cfg is not None and d_pad is not None and not errors(out):
        # engine imports this module for its pre-flight; keep the reverse
        # dependency lazy to avoid the cycle.
        from repro_torch.core.engine import flow_queue_cells

        cells = flow_queue_cells(
            flow, cfg, d_pad, queue_capacity, join_buffer_capacity
        )
        if max_cells is not None and cells > max_cells:
            # Fault-tolerant configs double the Lemma-5.2 slack so a degraded
            # retry still fits its queues; when the flow fits the budget at
            # plain pricing but not with that retry slack, say so — the fix
            # is a different knob (disable recovery or grow the pool), not
            # "shrink the query".
            plain = flow_queue_cells(
                flow, cfg, d_pad, queue_capacity, join_buffer_capacity,
                fault_tolerant=False,
            )
            # Anchor on the first sink: merged (multi-sink) flows are legal
            # here, and the whole flow — not one op — is over budget.
            if plain <= max_cells:
                out.append(_diag(
                    "retry-slack", flow.sink_indices()[0],
                    f"flow fits the budget at plain pricing ({plain} cells) "
                    f"but the fault-tolerant retry slack prices it at {cells} "
                    f"> {max_cells}: recovery headroom (doubled Lemma-5.2 "
                    "slack) is what breaks admission",
                    "grow the pool / budget, or disarm faults (recover=False) "
                    "for this engine config",
                ))
            else:
                out.append(_diag(
                    "queue-over-pool", flow.sink_indices()[0],
                    f"flow preallocates {cells} int32 queue cells > budget "
                    f"{max_cells} (Theorem 5.4 bound / slot-pool capacity): it "
                    "could never be admitted",
                    "shrink queue/join-buffer capacities or split the query",
                ))
    return out


def verify_flow(flow: Dataflow, **kwargs) -> None:
    """Raise :class:`FlowcheckError` if ``check_flow`` finds any error."""
    errs = errors(check_flow(flow, **kwargs))
    if errs:
        raise FlowcheckError(errs)


# ---------------------------------------------------------------------------
# Plan / query checks
# ---------------------------------------------------------------------------

def check_query(query: QueryGraph) -> List[Diagnostic]:
    """Vet a query graph as submitted by a tenant (pre-planning)."""
    out: List[Diagnostic] = []
    edges = frozenset(query.edges)
    if not edges:
        out.append(Diagnostic("query-empty", "query has no edges",
                              hint="a pattern needs at least one edge"))
        return out
    verts = sub_vertices(edges)
    if set(range(query.num_vertices)) != set(verts):
        out.append(Diagnostic(
            "query-vertex-gap",
            f"query declares {query.num_vertices} vertices but edges touch "
            f"{sorted(verts)}",
            hint="number vertices densely from 0",
        ))
    if not is_connected(edges):
        out.append(Diagnostic(
            "query-disconnected",
            "query graph is disconnected; enumeration would be a cross "
            "product of components",
            hint="submit each connected component as its own query",
        ))
    for a, b in edges:
        if a == b:
            out.append(Diagnostic("query-self-loop", f"self-loop on v{a}",
                                  hint="simple graphs only"))
    return out


def _walk_plan(node: PlanNode, plan: ExecutionPlan, depth: int,
               out: List[Diagnostic]) -> None:
    where = f"plan-depth-{depth}"
    if not node.edges:
        out.append(Diagnostic("plan-empty-node", f"empty sub-query at {where}",
                              where=where))
        return
    if not is_connected(node.edges):
        out.append(Diagnostic(
            "subquery-disconnected",
            f"sub-query {sorted(node.edges)} at {where} is disconnected "
            "(plan.is_connected): the extend order would leave the matched "
            "prefix and enumerate a cross product",
            where=where,
            hint="every join unit and join result must induce a connected "
                 "subgraph of the query",
        ))
    if node.is_leaf:
        return
    if node.left is None or node.right is None:
        out.append(Diagnostic("join-children", f"join at {where} missing a child",
                              where=where))
        return
    if node.left.edges | node.right.edges != node.edges:
        out.append(Diagnostic(
            "join-children",
            f"join at {where} does not cover its children: "
            f"{sorted(node.left.edges | node.right.edges)} != {sorted(node.edges)}",
            where=where,
        ))
    _check_eq3(node, where, out)
    _walk_plan(node.left, plan, depth + 1, out)
    _walk_plan(node.right, plan, depth + 1, out)


def _check_eq3(node: PlanNode, where: str, out: List[Diagnostic]) -> None:
    """Eq.-3 legality of the join's physical setting (Def. 3.1 / Prop. 3.1)."""
    algo, comm = node.algo, node.comm
    if algo not in ("hash", "wco") or comm not in ("push", "pull"):
        out.append(Diagnostic(
            "eq3-illegal", f"join at {where} has physical setting "
            f"({algo!r}, {comm!r}); Eq. 3 knows (wco|hash, push|pull)",
            where=where,
        ))
        return
    l, r = node.left.edges, node.right.edges
    if algo == "wco":
        # wco = vertex extension as a join: one side must be a complete star
        # join of the other (Definition 3.1), whatever the comm mode.
        if is_complete_star_join(l, r) is None and is_complete_star_join(r, l) is None:
            out.append(Diagnostic(
                "eq3-illegal",
                f"(wco, {comm}) at {where} but neither side is a complete "
                "star join of the other (Def. 3.1)",
                where=where,
                hint="use (hash, push) for general joins",
            ))
    elif comm == "pull":
        # (hash, pull): the right star's root must already be matched on the
        # left (Property 3.1 C1) so §5.2 can rewrite it to VERIFY + extends.
        if pull_hash_root(l, r) is None and pull_hash_root(r, l) is None:
            out.append(Diagnostic(
                "eq3-illegal",
                f"(hash, pull) at {where} but no side is a star rooted at an "
                "already-matched vertex (Property 3.1 C1)",
                where=where,
                hint="use (hash, push): shuffle both sides",
            ))


def check_plan(plan: ExecutionPlan) -> List[Diagnostic]:
    """Statically verify an execution plan (pre-translation)."""
    out: List[Diagnostic] = list(check_query(plan.query))
    qedges = frozenset(plan.query.edges)
    if plan.root.edges != qedges:
        out.append(Diagnostic(
            "plan-cover",
            f"plan covers {sorted(plan.root.edges)} but the query is "
            f"{sorted(qedges)}",
            where="plan-depth-0",
            hint="the root node must carry exactly the query's edge set",
        ))
    nverts = plan.query.num_vertices
    for a, b in plan.symmetry_conditions:
        if not (0 <= a < nverts and 0 <= b < nverts) or a == b:
            out.append(Diagnostic(
                "symmetry-unknown",
                f"symmetry condition v{a} < v{b} references unknown vertices",
                where="plan-depth-0",
            ))
    _walk_plan(plan.root, plan, 0, out)
    return out
