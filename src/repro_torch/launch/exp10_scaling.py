"""Paper Exp-10 on the port: scalability against the machine count (the JAX
package's ``benchmarks/exp10_scaling.py``).

The simulated cluster size k is scaled (1 to 16) on one device; rows
``exp10/k=<k>/<query>`` report the bytes moved and the balance of result
rows over the machines (std / mean, the paper's Exp-8 metric), for q1 and
q2. The distributed engine's own scaling is ``launch/dist_hybrid``'s.

    python -m repro_torch.launch.exp10_scaling [--fused] [--out FILE]
"""
from __future__ import annotations

from typing import List

from repro_torch.core.engine import EngineConfig, HugeEngine
from repro_torch.core.query import PAPER_QUERIES
from repro_torch.launch.common import (
    bench_graph,
    device_record,
    emit,
    entry,
    finish,
    suite_parser,
)

QUERIES = ("q1", "q2")
MACHINES = (1, 2, 4, 8, 16)


def exp10(graph, fused: bool = False) -> List[dict]:
    where = device_record(graph.device)
    entries = []
    for qname in QUERIES:
        for k in MACHINES:
            cfg = EngineConfig(num_machines=k, batch_size=1024, cache_capacity=1 << 13,
                               fused=fused)
            eng = HugeEngine(graph, cfg, device=graph.device, track_balance=True)
            res = eng.run(PAPER_QUERIES[qname])
            s = res.stats
            bal = s.per_machine_rows.astype(float)
            cv = float(bal.std() / max(bal.mean(), 1e-9)) if k > 1 else 0.0
            name = f"exp10/k={k}/{qname}"
            emit(name, s.wall_time * 1e6,
                 f"C={s.total_comm_bytes / 1e6:.2f}MB;balance_cv={cv:.3f};count={res.count}")
            entries.append(entry("exp10", name, res, where, fused, machines=k, balance_cv=cv))
    return entries


def main(argv=None) -> List[dict]:
    args = suite_parser("repro_torch.launch.exp10_scaling").parse_args(argv)
    graph = bench_graph(args.vertices, args.avg_degree, args.seed, device=args.device)
    return finish(args, exp10(graph, args.fused))


if __name__ == "__main__":
    main()
