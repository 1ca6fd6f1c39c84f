"""Paper Exp-4 on the port: the batch size, with the cache disabled as in the
paper (the JAX package's ``benchmarks/exp4_batching.py``).

Larger batches merge more pull requests a round: rows
``exp4/batch=<b>/<query>`` report the pulled bytes (deduplicated within a
batch) and the gain over the smallest batch, for q1 and q3.

    python -m repro_torch.launch.exp4_batching [--fused] [--out FILE]
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

QUERIES = ("q1", "q3")
BATCHES = (128, 256, 512, 1024)


def exp4(graph, fused: bool = False) -> List[dict]:
    where = device_record(graph.device)
    entries = []
    for qname in QUERIES:
        base = None
        for batch in BATCHES:
            res = run_query(graph, qname, batch_size=batch, cache_capacity=0, fused=fused)
            s = res.stats
            base = base or s.pulled_bytes
            gain = base / max(s.pulled_bytes, 1)
            name = f"exp4/batch={batch}/{qname}"
            emit(name, s.wall_time * 1e6,
                 f"pulled={s.pulled_bytes / 1e6:.2f}MB;dedup_gain={gain:.2f}x;count={res.count}")
            entries.append(entry("exp4", name, res, where, fused, batch_size=batch,
                                 dedup_gain=gain))
    return entries


def main(argv=None) -> List[dict]:
    args = suite_parser("repro_torch.launch.exp4_batching").parse_args(argv)
    graph = bench_graph(args.vertices, args.avg_degree, args.seed, device=args.device)
    return finish(args, exp4(graph, args.fused))


if __name__ == "__main__":
    main()
