"""Paper Exp-1 on the port: prior systems' logical plans run under HUGE's
physical configuration (the JAX package's ``benchmarks/exp1_plugin_plans.py``).

Remark 3.2: each prior system's plan space, with its join units and order
kept, is given HUGE's physical freedom (Eq. 3: hash or wco, push or pull)
and compared with the same space under its own settings, for q1 and q2.
Rows ``exp1/HUGE-<SYSTEM>/<query>`` report the speed-up and the reduction
in bytes moved; both runs must count the same matches.

    python -m repro_torch.launch.exp1_plugin_plans [--fused] [--out FILE]
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.plan import PLAN_SPACES, PlanSpace
from repro_torch.launch.common import (
    bench_graph,
    device_record,
    emit,
    entry,
    fields,
    finish,
    run_query,
    suite_parser,
)

QUERIES = ("q1", "q2")
SYSTEMS = ("benu", "rads", "seed", "bigjoin")


def hugeified(space_name: str) -> PlanSpace:
    """Same logical space (units, order), HUGE's physical freedom (Eq. 3)."""
    base = PLAN_SPACES[space_name]
    return dataclasses.replace(
        base, name=f"huge-{space_name}", algos=("hash", "wco"), comms=("push", "pull"))


def exp1(graph, fused: bool = False) -> List[dict]:
    where = device_record(graph.device)
    entries = []
    for qname in QUERIES:
        for system in SYSTEMS:
            native = run_query(graph, qname, space=system, fused=fused)
            hugeed = run_query(graph, qname, space=hugeified(system), fused=fused)
            assert native.count == hugeed.count, (system, qname)
            speed = native.stats.wall_time / max(hugeed.stats.wall_time, 1e-9)
            comm = native.stats.total_comm_bytes / max(hugeed.stats.total_comm_bytes, 1)
            name = f"exp1/HUGE-{system.upper()}/{qname}"
            emit(name, hugeed.stats.wall_time * 1e6,
                 f"speedup={speed:.2f}x;comm_reduction={comm:.2f}x;count={hugeed.count}")
            entries.append(entry(
                "exp1", name, hugeed, where, fused, space=system,
                native={**fields(native), "wall_s": native.stats.wall_time},
                speedup=speed, comm_reduction=comm))
    return entries


def main(argv=None) -> List[dict]:
    args = suite_parser("repro_torch.launch.exp1_plugin_plans").parse_args(argv)
    graph = bench_graph(args.vertices, args.avg_degree, args.seed, device=args.device)
    return finish(args, exp1(graph, args.fused))


if __name__ == "__main__":
    main()
