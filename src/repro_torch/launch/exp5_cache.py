"""Paper Exp-5 on the port: the cache capacity swept, hit rate and pulled
bytes against capacity (the JAX package's ``benchmarks/exp5_cache.py``).

Rows ``exp5/cache=<capacity>/<query>`` for q1 and q2, capacities 0 to 2^16
entries a machine.

    python -m repro_torch.launch.exp5_cache [--fused] [--out FILE]
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

QUERIES = ("q1", "q2")
CAPACITIES = (0, 1 << 10, 1 << 12, 1 << 14, 1 << 16)


def exp5(graph, fused: bool = False, capacities: Sequence[int] = CAPACITIES) -> List[dict]:
    where = device_record(graph.device)
    entries = []
    for qname in QUERIES:
        for cap in capacities:
            res = run_query(graph, qname, cache_capacity=cap, fused=fused)
            s = res.stats
            name = f"exp5/cache={cap}/{qname}"
            emit(name, s.wall_time * 1e6,
                 f"hit_rate={s.hit_rate:.3f};pulled={s.pulled_bytes / 1e6:.2f}MB;"
                 f"count={res.count}")
            entries.append(entry("exp5", name, res, where, fused, cache_capacity=cap))
    return entries


def main(argv=None) -> List[dict]:
    args = suite_parser("repro_torch.launch.exp5_cache").parse_args(argv)
    graph = bench_graph(args.vertices, args.avg_degree, args.seed, device=args.device)
    return finish(args, exp5(graph, args.fused))


if __name__ == "__main__":
    main()
