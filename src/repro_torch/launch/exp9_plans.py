"""Paper Exp-9 on the port: hybrid plans compared (the JAX package's
``benchmarks/exp9_plans.py``): wco-only (BiGJoin's space), a
sequential-context hybrid planner that costs computation only
(EmptyHeaded/GraphFlow) and HUGE (computation and communication), for q7
and q8 on ``bench_graph(1024, 5.0)`` (GO-like; the paper uses GO here).

Rows ``exp9/<planner>/<query>`` report T, C and the count; a plan that is
infeasible in its space gives a row saying so, not a crash.

    python -m repro_torch.launch.exp9_plans [--fused] [--out FILE]
"""
from __future__ import annotations

from typing import List

from repro_torch.launch.common import (
    bench_graph,
    device_record,
    emit,
    entry,
    finish,
    run_query,
    suite_parser,
)

GRAPH = (1 << 10, 5.0, 7)
QUERIES = ("q7", "q8")
PLANNERS = (("HUGE-WCO", "bigjoin"), ("HUGE-EH", "emptyheaded"), ("HUGE", "huge"))


def exp9(graph, fused: bool = False) -> List[dict]:
    where = device_record(graph.device)
    entries = []
    for qname in QUERIES:
        for label, space in PLANNERS:
            name = f"exp9/{label}/{qname}"
            try:
                res = run_query(graph, qname, space=space, queue_capacity=1 << 18,
                                batch_size=128, join_out_capacity=1 << 21, fused=fused)
            except ValueError as e:  # no feasible plan in this space
                emit(name, 0.0, f"infeasible:{e}")
                entries.append({"suite": "exp9", "name": name, "fused": fused,
                                "space": space, "infeasible": str(e), **where})
                continue
            s = res.stats
            emit(name, s.wall_time * 1e6,
                 f"T={s.wall_time:.2f}s;C={s.total_comm_bytes / 1e6:.2f}MB;count={res.count}")
            entries.append(entry("exp9", name, res, where, fused, space=space))
    return entries


def main(argv=None) -> List[dict]:
    args = suite_parser("repro_torch.launch.exp9_plans", GRAPH).parse_args(argv)
    graph = bench_graph(args.vertices, args.avg_degree, args.seed, device=args.device)
    return finish(args, exp9(graph, args.fused))


if __name__ == "__main__":
    main()
