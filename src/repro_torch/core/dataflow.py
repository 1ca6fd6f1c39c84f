"""Algorithm 2: ExecutionPlanTranslation — plan tree → operator dataflow.

Operators (paper §4.2):
  SCAN        emit matches of a single query edge from the local partition
  PULL-EXTEND extend every partial match by one vertex via the multiway
              intersection of Eq. 2 (two-stage: fetch → intersect)
  VERIFY      the paper's pulling-hash "hint" (§5.2): a PULL-EXTEND that
              matches no new vertex, only verifying f(root) ∈ ∩ N(f(V1))
  PUSH-JOIN   distributed hash join, shuffling both sides by the join key
  SINK        count / materialise final matches

Per §5.2 the translation rewrites (a) star SCANs into an edge SCAN followed
by chained PULL-EXTENDs, and (b) pulling-based hash joins into VERIFY +
chained PULL-EXTENDs — this is what gives the O(|V_q|²·D_G) memory bound.

Schemas: each operator's output rows are tuples of data vertices in a fixed
column order; ``schema[i]`` is the query vertex matched by column ``i``.
Symmetry-breaking conditions (f(a) < f(b)) are installed at the earliest
operator whose output schema contains both endpoints.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.plan import (
    ExecutionPlan,
    PlanNode,
    is_complete_star_join,
    pull_hash_root,
    star_of,
    sub_vertices,
)
from repro_torch.core.query import Edge


@dataclasses.dataclass(frozen=True)
class OpDesc:
    kind: str  # "scan" | "extend" | "verify" | "join" | "sink"
    schema: Tuple[int, ...]
    inputs: Tuple[int, ...] = ()
    # scan
    scan_edge: Optional[Edge] = None
    # extend / verify
    ext: Tuple[int, ...] = ()          # input-schema positions intersected (Eq. 2)
    new_vertex: Optional[int] = None   # extend only
    verify_pos: Optional[int] = None   # verify only: position of the root column
    lt_positions: Tuple[int, ...] = () # candidate <  f[pos]   (symmetry)
    gt_positions: Tuple[int, ...] = () # candidate >  f[pos]
    # join
    key_left: Tuple[int, ...] = ()     # key column positions in left schema
    key_right: Tuple[int, ...] = ()
    right_extra: Tuple[int, ...] = ()  # right-schema positions appended to output
    cross_neq: Tuple[Tuple[int, int], ...] = ()  # (out_a, out_b) must differ
    cross_lt: Tuple[Tuple[int, int], ...] = ()   # out[:, a] < out[:, b]
    # communication mode of this operator: "local" (star-scan extends read the
    # locally-owned root's adjacency), "pull" (fetch-stage GetNbrs) or "push"
    # (BiGJoin-style shuffled wco extends).
    comm: str = "local"
    # Streaming epochs (DESIGN.md §Delta-plans). ``scan_epoch`` is "full"
    # (whole data graph) or "delta" (seed rows from the update batch only).
    # ``ext_epochs`` — aligned with ``ext`` — tags each intersected query edge
    # of an extend/verify: "new" probes the post-batch adjacency, "old" probes
    # post-batch minus the delta (legal for insert batches). Empty means every
    # position is "new", which is what ``translate`` emits.
    scan_epoch: str = "full"
    ext_epochs: Tuple[str, ...] = ()

    def label(self) -> str:
        if self.kind == "scan":
            tag = "Δ" if self.scan_epoch == "delta" else ""
            return f"{tag}SCAN{self.scan_edge}"
        if self.kind == "extend":
            ep = f"|ep={self.ext_epochs}" if self.ext_epochs else ""
            return f"EXT(v{self.new_vertex}|ext={self.ext}{ep})"
        if self.kind == "verify":
            ep = f"|ep={self.ext_epochs}" if self.ext_epochs else ""
            return f"VRF(pos{self.verify_pos}|ext={self.ext}{ep})"
        if self.kind == "join":
            return f"JOIN(key={self.key_left})"
        return "SINK"


@dataclasses.dataclass
class Dataflow:
    """Operator DAG in topological emission order: ``ops[i].inputs`` are always
    indices < i, so any scheduler that walks the list front-to-back sees
    producers before consumers (what the generalised AdaptiveScheduler and
    the engine rely on)."""

    ops: List[OpDesc]
    query_name: str = ""

    @property
    def sink_index(self) -> int:
        return len(self.ops) - 1

    def sink_indices(self) -> Tuple[int, ...]:
        """All sink ops — more than one only for merged multi-tenant flows."""
        return tuple(i for i, op in enumerate(self.ops) if op.kind == "sink")

    def ancestors(self, i: int) -> Tuple[int, ...]:
        """All transitive producers of op ``i`` (excluding ``i``), ascending.

        A PUSH-JOIN's barrier is expressed through this set: the join may only
        probe once every ancestor of its *left* input has drained (DESIGN.md
        §Shuffle-join)."""
        seen: set = set()
        stack = list(self.ops[i].inputs)
        while stack:
            j = stack.pop()
            if j not in seen:
                seen.add(j)
                stack.extend(self.ops[j].inputs)
        return tuple(sorted(seen))

    def num_joins(self) -> int:
        return sum(1 for op in self.ops if op.kind == "join")

    def describe(self) -> str:
        lines = []
        for i, op in enumerate(self.ops):
            ins = ",".join(str(j) for j in op.inputs)
            lines.append(f"[{i}] {op.label():28s} schema={op.schema} <- ({ins})")
        return "\n".join(lines)


class _Translator:
    def __init__(self, plan: ExecutionPlan):
        self.plan = plan
        self.conds = list(plan.symmetry_conditions)
        self.ops: List[OpDesc] = []

    # -- symmetry helpers ----------------------------------------------------

    def _new_vertex_filters(self, schema: Sequence[int], new_v: int):
        """Conditions between the new vertex and already-matched vertices."""
        lt, gt = [], []
        for a, b in self.conds:  # constraint f(a) < f(b)
            if a == new_v and b in schema:
                lt.append(schema.index(b))  # cand < f(b)
            elif b == new_v and a in schema:
                gt.append(schema.index(a))  # cand > f(a)
        return tuple(lt), tuple(gt)

    def _cross_conditions(self, out_schema, left_set, right_set):
        cross = []
        for a, b in self.conds:
            if (a in left_set and b in right_set) or (a in right_set and b in left_set):
                cross.append((out_schema.index(a), out_schema.index(b)))
        return tuple(cross)

    def _emit(self, op: OpDesc) -> int:
        self.ops.append(op)
        return len(self.ops) - 1

    # -- unit translation (star SCAN rewrite, §5.2) ---------------------------

    def _translate_unit(self, node: PlanNode) -> int:
        edges = node.edges
        st = star_of(edges)
        if st is not None:
            root, leaves = st
            leaves = sorted(leaves)
            first = leaves[0]
            schema = (root, first)
            lt, gt = [], []
            for a, b in self.conds:
                if (a, b) == (root, first):
                    lt.append(1)  # col0 < col1
                elif (a, b) == (first, root):
                    gt.append(1)
            idx = self._emit(
                OpDesc(
                    kind="scan",
                    schema=schema,
                    scan_edge=(root, first),
                    lt_positions=tuple(lt),
                    gt_positions=tuple(gt),
                )
            )
            for leaf in leaves[1:]:
                schema_list = list(self.ops[idx].schema)
                flt, fgt = self._new_vertex_filters(schema_list, leaf)
                idx = self._emit(
                    OpDesc(
                        kind="extend",
                        schema=tuple(schema_list + [leaf]),
                        inputs=(idx,),
                        ext=(0,),  # star: all edges from the root (position 0)
                        new_vertex=leaf,
                        lt_positions=flt,
                        gt_positions=fgt,
                    )
                )
            return idx
        # Clique unit (SEED space): edge scan + wco extends over all previous.
        verts = sorted(sub_vertices(edges))
        a, b = verts[0], verts[1]
        schema = (a, b)
        lt, gt = [], []
        for ca, cb in self.conds:
            if (ca, cb) == (a, b):
                lt.append(1)
            elif (ca, cb) == (b, a):
                gt.append(1)
        idx = self._emit(OpDesc(kind="scan", schema=schema, scan_edge=(a, b),
                                lt_positions=tuple(lt), gt_positions=tuple(gt)))
        for v in verts[2:]:
            schema_list = list(self.ops[idx].schema)
            ext = tuple(
                schema_list.index(u)
                for u in schema_list
                if (min(u, v), max(u, v)) in edges
            )
            flt, fgt = self._new_vertex_filters(schema_list, v)
            idx = self._emit(
                OpDesc(
                    kind="extend",
                    schema=tuple(schema_list + [v]),
                    inputs=(idx,),
                    ext=ext,
                    new_vertex=v,
                    lt_positions=flt,
                    gt_positions=fgt,
                    comm="pull",
                )
            )
        return idx

    # -- join translation ------------------------------------------------------

    def _translate(self, node: PlanNode) -> int:
        if node.is_leaf:
            return self._translate_unit(node)

        if node.algo == "wco" and node.comm == "pull":
            # Complete star join → PULL-EXTEND (Alg. 2 lines 12-18).
            csj = is_complete_star_join(node.left.edges, node.right.edges)
            right_node, left_node = node.right, node.left
            if csj is None:  # orientation was flipped by the optimiser
                csj = is_complete_star_join(node.right.edges, node.left.edges)
                right_node, left_node = node.left, node.right
            root, leaves = csj
            in_idx = self._translate(left_node)
            schema_list = list(self.ops[in_idx].schema)
            ext = tuple(schema_list.index(l) for l in sorted(leaves))
            lt, gt = self._new_vertex_filters(schema_list, root)
            return self._emit(
                OpDesc(
                    kind="extend",
                    schema=tuple(schema_list + [root]),
                    inputs=(in_idx,),
                    ext=ext,
                    new_vertex=root,
                    lt_positions=lt,
                    gt_positions=gt,
                    comm=node.comm or "pull",
                )
            )

        if node.algo == "hash" and node.comm == "pull":
            # Pulling hash join → VERIFY + chained PULL-EXTENDs (§5.2).
            ph = pull_hash_root(node.left.edges, node.right.edges)
            right_node, left_node = node.right, node.left
            if ph is None:
                ph = pull_hash_root(node.right.edges, node.left.edges)
                right_node, left_node = node.left, node.right
            root, leaves = ph
            in_idx = self._translate(left_node)
            schema_list = list(self.ops[in_idx].schema)
            v1 = sorted(l for l in leaves if l in schema_list)
            v2 = sorted(l for l in leaves if l not in schema_list)
            idx = in_idx
            if v1:
                idx = self._emit(
                    OpDesc(
                        kind="verify",
                        schema=tuple(schema_list),
                        inputs=(idx,),
                        ext=tuple(schema_list.index(l) for l in v1),
                        verify_pos=schema_list.index(root),
                        comm="pull",
                    )
                )
            for v in v2:
                schema_list = list(self.ops[idx].schema)
                lt, gt = self._new_vertex_filters(schema_list, v)
                idx = self._emit(
                    OpDesc(
                        kind="extend",
                        schema=tuple(schema_list + [v]),
                        inputs=(idx,),
                        ext=(schema_list.index(root),),
                        new_vertex=v,
                        lt_positions=lt,
                        gt_positions=gt,
                        comm="pull",
                    )
                )
            return idx

        # Pushing hash join → PUSH-JOIN.
        li = self._translate(node.left)
        ri = self._translate(node.right)
        ls = list(self.ops[li].schema)
        rs = list(self.ops[ri].schema)
        key = sorted(set(ls) & set(rs))
        assert key, "join key must be non-empty"
        right_extra_verts = [v for v in rs if v not in ls]
        out_schema = tuple(ls + right_extra_verts)
        left_only = set(ls) - set(key)
        right_only = set(right_extra_verts)
        cross_neq = tuple(
            (out_schema.index(a), out_schema.index(b))
            for a in sorted(left_only)
            for b in sorted(right_only)
        )
        cross_lt = self._cross_conditions(out_schema, set(ls), right_only)
        return self._emit(
            OpDesc(
                kind="join",
                comm="push",
                schema=out_schema,
                inputs=(li, ri),
                key_left=tuple(ls.index(k) for k in key),
                key_right=tuple(rs.index(k) for k in key),
                right_extra=tuple(rs.index(v) for v in right_extra_verts),
                cross_neq=cross_neq,
                cross_lt=cross_lt,
            )
        )

    def run(self) -> Dataflow:
        last = self._translate(self.plan.root)
        final_schema = self.ops[last].schema
        assert set(final_schema) == set(range(self.plan.query.num_vertices)), (
            f"plan does not cover query: {final_schema}"
        )
        self._emit(OpDesc(kind="sink", schema=final_schema, inputs=(last,)))
        return Dataflow(ops=self.ops, query_name=self.plan.query.name)


def translate(plan: ExecutionPlan) -> Dataflow:
    """Paper Algorithm 2."""
    return _Translator(plan).run()


# ---------------------------------------------------------------------------
# Delta-join decomposition for streaming updates (DESIGN.md §Delta-plans)
# ---------------------------------------------------------------------------

def delta_edge_order(query) -> List[Edge]:
    """Canonical total order over the query's edges.

    The exactly-once guarantee of :func:`delta_flows` hinges on every caller
    agreeing on this order: flow ``i`` emits a match iff ``i`` is the *minimum*
    index whose query edge lands on a delta data edge."""
    return sorted(query.edges)


def delta_flows(plan: ExecutionPlan, batch=None) -> List[Dataflow]:
    """Delta-join decomposition: one dataflow per query edge.

    For a k-edge query with canonical edge order ``e_0 < … < e_{k-1}``, flow
    ``i`` scans matches of ``e_i`` from the *delta* (new edges only), then
    extends to the remaining query vertices; each query edge ``e_j`` checked
    along the way probes the **old** adjacency when ``j < i`` and the **new**
    adjacency when ``j > i``. A new match whose query edges land on delta
    data edges at index set ``S ≠ ∅`` is produced exactly by flow ``min(S)``
    — no duplicates, no misses — and an unchanged match (``S = ∅``) by none.

    The flows depend only on the query (not the batch contents), so standing
    queries translate once and re-execute per batch; ``batch`` is accepted
    for the natural call shape and only used to short-circuit empty batches.
    Every extend intersects over *all* already-matched neighbours of the new
    vertex (Eq. 2), so each query edge is enforced exactly once — at the op
    where its second endpoint enters the schema — and no trailing VERIFY is
    needed. Symmetry-breaking conditions are installed exactly as in
    :func:`translate`, so per-automorphism-class dedup carries over."""
    if batch is not None and getattr(batch, "num_edges", None) == 0:
        return []
    query = plan.query
    order = delta_edge_order(query)
    index_of = {e: i for i, e in enumerate(order)}
    qadj = query.adjacency()
    conds = list(plan.symmetry_conditions)
    flows: List[Dataflow] = []

    for i, (a, b) in enumerate(order):
        ops: List[OpDesc] = []
        schema = [a, b]
        lt, gt = [], []
        for ca, cb in conds:
            if (ca, cb) == (a, b):
                lt.append(1)
            elif (ca, cb) == (b, a):
                gt.append(1)
        ops.append(
            OpDesc(
                kind="scan",
                schema=(a, b),
                scan_edge=(a, b),
                scan_epoch="delta",
                lt_positions=tuple(lt),
                gt_positions=tuple(gt),
            )
        )
        while len(schema) < query.num_vertices:
            # Greedy: next vertex with the most matched neighbours (densest
            # Eq.-2 intersection first), smallest id on ties — deterministic.
            candidates = [
                v for v in range(query.num_vertices)
                if v not in schema and any(u in schema for u in qadj[v])
            ]
            v = max(candidates, key=lambda c: (len(qadj[c] & set(schema)), -c))
            ext, epochs = [], []
            for p, u in enumerate(schema):
                if u in qadj[v]:
                    ext.append(p)
                    j = index_of[(min(u, v), max(u, v))]
                    epochs.append("old" if j < i else "new")
            flt, fgt = [], []
            for ca, cb in conds:
                if ca == v and cb in schema:
                    flt.append(schema.index(cb))
                elif cb == v and ca in schema:
                    fgt.append(schema.index(ca))
            ops.append(
                OpDesc(
                    kind="extend",
                    schema=tuple(schema + [v]),
                    inputs=(len(ops) - 1,),
                    ext=tuple(ext),
                    ext_epochs=tuple(epochs),
                    new_vertex=v,
                    lt_positions=tuple(flt),
                    gt_positions=tuple(fgt),
                    comm="pull",
                )
            )
            schema.append(v)
        ops.append(OpDesc(kind="sink", schema=tuple(schema), inputs=(len(ops) - 1,)))
        flows.append(Dataflow(ops=ops, query_name=f"Δ{i}:{query.name}"))
    return flows


def merge_flows(flows: Sequence[Dataflow]) -> Tuple[Dataflow, Tuple[int, ...]]:
    """Concatenate independent dataflows into one multi-sink DAG.

    Returns ``(merged, tenant_of_op)`` where ``tenant_of_op[i]`` is the index
    of the source flow op ``i`` came from. Concatenating per-flow topological
    orders yields a valid topological order of the union (there are no cross-
    flow edges), so one AdaptiveScheduler pass over the merged op list
    interleaves runnable ops across tenants — this is how N concurrent
    queries share a single engine's scheduler tick (serve/graph_service.py,
    distributed.run_concurrent). Per-tenant results stay separable because
    each flow keeps its own sink (``merged.sink_indices()``, in input order)."""
    ops: List[OpDesc] = []
    tenant_of_op: List[int] = []
    for t, flow in enumerate(flows):
        off = len(ops)
        for op in flow.ops:
            ops.append(
                dataclasses.replace(op, inputs=tuple(j + off for j in op.inputs))
            )
            tenant_of_op.append(t)
    name = "+".join(f.query_name or f"flow{t}" for t, f in enumerate(flows))
    return Dataflow(ops=ops, query_name=name), tuple(tenant_of_op)
