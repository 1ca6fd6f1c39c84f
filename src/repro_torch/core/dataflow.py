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

    def label(self) -> str:
        if self.kind == "scan":
            return f"SCAN{self.scan_edge}"
        if self.kind == "extend":
            return f"EXT(v{self.new_vertex}|ext={self.ext})"
        if self.kind == "verify":
            return f"VRF(pos{self.verify_pos}|ext={self.ext})"
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
