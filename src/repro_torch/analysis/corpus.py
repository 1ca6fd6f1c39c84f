"""Clean-tree flowcheck corpus: every paper query under every plan space,
plus each query's merged delta-flow decomposition (DESIGN.md §Delta-plans).

The optimiser and translator must produce plans/dataflows the static
verifier accepts, for the whole Table-2 plan-space matrix, with queue plans
that fit the default service pool (the JAX package's ``analysis/corpus.py``). Planning is done against synthetic power-law statistics
(``GraphStats.synthetic``) so the corpus needs no data graph and stays fast
(pure Python, no device work).
"""
from __future__ import annotations

import functools
from typing import List, Tuple

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.flowcheck import check_flow, check_plan
from repro_torch.core.cost import GraphStats
from repro_torch.core.dataflow import delta_flows, merge_flows, translate
from repro_torch.core.optimizer import optimal_plan
from repro_torch.core.plan import PLAN_SPACES
from repro_torch.core.query import PAPER_QUERIES

# Nominal sizing for the queue-cell accounting leg: a mid-size power-law
# graph and the default single-query engine configuration.
_CORPUS_VERTICES = 1 << 11
_CORPUS_AVG_DEG = 6.0
_CORPUS_D_PAD = 64
_CORPUS_MACHINES = 8
# The multi-tenant service's default slot-pool budget in int32 cells (the
# JAX package's ``ServiceConfig.total_queue_cells``): every corpus flow's
# queues must fit it.
SERVICE_POOL_CELLS = 64 << 20


def corpus_cases() -> List[Tuple[str, str]]:
    return [(q, s) for q in PAPER_QUERIES for s in PLAN_SPACES]


@functools.lru_cache(maxsize=1)
def _corpus_findings_cached() -> Tuple[Diagnostic, ...]:
    from repro_torch.core.engine import EngineConfig

    stats = GraphStats.synthetic(_CORPUS_VERTICES, _CORPUS_AVG_DEG)
    cfg = EngineConfig()
    pool = SERVICE_POOL_CELLS
    out: List[Diagnostic] = []
    for qname, space in corpus_cases():
        where = f"corpus::{qname}/{space}"
        try:
            plan = optimal_plan(PAPER_QUERIES[qname], stats, _CORPUS_MACHINES, space)
        except Exception as e:  # noqa: BLE001 — a planner crash is a finding
            out.append(Diagnostic(
                "plan-failure", f"optimiser failed: {type(e).__name__}: {e}",
                where=where,
            ))
            continue
        for d in check_plan(plan):
            out.append(Diagnostic(d.rule, d.message, d.severity,
                                  where=f"{where}/{d.where or 'plan'}",
                                  hint=d.hint))
        try:
            flow = translate(plan)
        except Exception as e:  # noqa: BLE001
            out.append(Diagnostic(
                "translate-failure",
                f"translation failed: {type(e).__name__}: {e}", where=where,
            ))
            continue
        for d in check_flow(flow, cfg=cfg, d_pad=_CORPUS_D_PAD, max_cells=pool):
            out.append(Diagnostic(d.rule, d.message, d.severity,
                                  where=f"{where}/op[{d.op_index}]", hint=d.hint))
    # Delta leg: the merged k-sink delta decomposition of each paper query
    # (the flow a standing query re-runs per batch) must also verify clean —
    # epochs, schemas, and queue pricing alike. The flows are batch-
    # independent, so one plan per query suffices.
    for qname in PAPER_QUERIES:
        where = f"corpus::{qname}/delta"
        try:
            plan = optimal_plan(PAPER_QUERIES[qname], stats, _CORPUS_MACHINES,
                                "huge")
            merged, _ = merge_flows(delta_flows(plan))
        except Exception as e:  # noqa: BLE001
            out.append(Diagnostic(
                "translate-failure",
                f"delta decomposition failed: {type(e).__name__}: {e}",
                where=where,
            ))
            continue
        for d in check_flow(merged, cfg=cfg, d_pad=_CORPUS_D_PAD, max_cells=pool):
            out.append(Diagnostic(d.rule, d.message, d.severity,
                                  where=f"{where}/op[{d.op_index}]", hint=d.hint))
    return tuple(out)


def corpus_findings() -> List[Diagnostic]:
    return list(_corpus_findings_cached())
