"""Paper Exp-7 (Figure 9) on the port: the queue size sweeps DFS, adaptive
and BFS (the JAX package's ``benchmarks/exp7_scheduling.py``).

A queue of one batch is about DFS, a huge one about BFS. Rows
``exp7/queue=<capacity>/q1`` (batch 256) report the peak queue memory, the
scheduler's steps and its yields on a full queue; the paper's OOM at the
BFS end shows as peak memory bounded only by the preallocated capacity.

    python -m repro_torch.launch.exp7_scheduling [--fused] [--out FILE]
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

QUERY = "q1"
QUEUES = (1 << 10, 1 << 13, 1 << 15, 1 << 17, 1 << 19)


def exp7(graph, fused: bool = False) -> List[dict]:
    where = device_record(graph.device)
    entries = []
    for qcap in QUEUES:
        res = run_query(graph, QUERY, queue_capacity=qcap, batch_size=256, fused=fused)
        s = res.stats
        name = f"exp7/queue={qcap}/{QUERY}"
        emit(name, s.wall_time * 1e6,
             f"peakM={s.peak_queue_bytes / 1e6:.2f}MB;steps={res.schedule.steps};"
             f"yields_full={res.schedule.yields_full};count={res.count}")
        entries.append(entry("exp7", name, res, where, fused, queue_capacity=qcap))
    return entries


def main(argv=None) -> List[dict]:
    args = suite_parser("repro_torch.launch.exp7_scheduling").parse_args(argv)
    graph = bench_graph(args.vertices, args.avg_degree, args.seed, device=args.device)
    return finish(args, exp7(graph, args.fused))


if __name__ == "__main__":
    main()
