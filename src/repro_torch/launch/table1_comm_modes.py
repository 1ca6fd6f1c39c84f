"""Paper Table 1 on the port: q1 across communication modes and systems
(the JAX package's ``benchmarks/table1_comm_modes.py``).

Each prior system is its Table-2 plan space run in the port's engine; HUGE
is the full hybrid optimiser. Rows ``table1/<system>/q1`` report T, T_R,
T_C, C (bytes moved) and M (peak queue memory); every system must count
the same matches. ``table1/summary`` compares HUGE's bytes and peak memory
with the better of the push systems (SEED, BiGJoin).

    python -m repro_torch.launch.table1_comm_modes [--fused] [--out FILE]
    python -m repro_torch.launch.table1_comm_modes --device cpu --vertices 256
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

SYSTEMS = (("SEED", "seed"), ("BiGJoin", "bigjoin"), ("BENU", "benu"),
           ("RADS", "rads"), ("HUGE", "huge"))


def table1(graph, fused: bool = False) -> List[dict]:
    where = device_record(graph.device)
    rows, entries = [], []
    for system, space in SYSTEMS:
        res = run_query(graph, "q1", space=space, fused=fused)
        s = res.stats
        rows.append((system, res, s))
        name = f"table1/{system}/q1"
        emit(name, s.wall_time * 1e6,
             f"T={s.wall_time:.2f}s;T_R={s.compute_time:.2f}s;T_C={s.comm_time:.2f}s;"
             f"C={s.total_comm_bytes / 1e6:.2f}MB;M={s.peak_queue_bytes / 1e6:.2f}MB;"
             f"count={res.count}")
        entries.append(entry("table1", name, res, where, fused, space=space))
    counts = {r[0]: r[1].count for r in rows}
    assert len(set(counts.values())) == 1, f"count mismatch across systems: {counts}"
    huge = rows[-1][2]
    best_push = min(r[2].total_comm_bytes for r in rows[:2])   # SEED, BiGJoin
    best_mem = min(r[2].peak_queue_bytes for r in rows[:2])
    comm_x = best_push / max(huge.total_comm_bytes, 1)
    mem_x = best_mem / max(huge.peak_queue_bytes, 1)
    emit("table1/summary", 0.0,
         f"HUGE_comm_vs_best_push={comm_x:.1f}x;HUGE_peakmem_vs_best_push={mem_x:.1f}x;"
         "note=bytes and peak memory are the paper-comparable columns")
    entries.append({"suite": "table1", "name": "table1/summary", "fused": fused,
                    "huge_comm_vs_best_push": comm_x, "huge_peakmem_vs_best_push": mem_x,
                    **where})
    return entries


def main(argv=None) -> List[dict]:
    args = suite_parser("repro_torch.launch.table1_comm_modes").parse_args(argv)
    graph = bench_graph(args.vertices, args.avg_degree, args.seed, device=args.device)
    return finish(args, table1(graph, args.fused))


if __name__ == "__main__":
    main()
