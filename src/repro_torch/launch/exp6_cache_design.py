"""Paper Exp-6 on the port: the cache design (the JAX package's
``benchmarks/exp6_cache_design.py``).

The paper compares LRBU with copy and lock variants in wall time. The
two-stage execution is the lock-freedom here too, so the comparable axis is
the replacement policy under the same execution: LRBU (epoch-sealed)
against classic LRU and direct-mapped, at equal capacity (2^12 entries a
machine). Rows ``exp6/<policy>/<query>`` report hit rate and pulled bytes
for q1-q3.

    python -m repro_torch.launch.exp6_cache_design [--fused] [--out FILE]
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.launch.common import (
    bench_graph,
    device_record,
    emit,
    entry,
    finish,
    run_query,
    suite_parser,
)

QUERIES = ("q1", "q2", "q3")
POLICIES = ("lrbu", "lru", "direct")
CAPACITY = 1 << 12


def exp6(graph, fused: bool = False, capacity: int = CAPACITY,
         queries: Sequence[str] = QUERIES) -> List[dict]:
    where = device_record(graph.device)
    entries = []
    for qname in queries:
        for policy in POLICIES:
            res = run_query(graph, qname, cache_policy=policy, cache_capacity=capacity,
                            fused=fused)
            s = res.stats
            name = f"exp6/{policy}/{qname}"
            emit(name, s.wall_time * 1e6,
                 f"hit_rate={s.hit_rate:.3f};pulled={s.pulled_bytes / 1e6:.2f}MB;"
                 f"count={res.count}")
            entries.append(entry("exp6", name, res, where, fused, cache_policy=policy,
                                 cache_capacity=capacity))
    return entries


def main(argv=None) -> List[dict]:
    args = suite_parser("repro_torch.launch.exp6_cache_design").parse_args(argv)
    graph = bench_graph(args.vertices, args.avg_degree, args.seed, device=args.device)
    return finish(args, exp6(graph, args.fused))


if __name__ == "__main__":
    main()
