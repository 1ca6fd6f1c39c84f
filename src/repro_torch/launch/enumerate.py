"""Subgraph-enumeration command line (the paper's own workload).

``python -m repro_torch.launch.enumerate --query q1 --vertices 4096 --machines 8``
runs the full HUGE pipeline on the card: optimiser → dataflow →
BFS/DFS-adaptive scheduler → count, with Table-1-style communication and
memory accounting. ``--device cpu`` runs the plain PyTorch path instead.
"""
from __future__ import annotations

import argparse

from repro_torch.core.cost import GraphStats
from repro_torch.core.dataflow import translate
from repro_torch.core.engine import EngineConfig, HugeEngine
from repro_torch.core.optimizer import optimal_plan
from repro_torch.core.query import PAPER_QUERIES
from repro_torch.device import resolve_device
from repro_torch.graph import powerlaw_graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", default="q1", choices=list(PAPER_QUERIES))
    ap.add_argument("--vertices", type=int, default=1 << 13)
    ap.add_argument("--avg-degree", type=float, default=8.0)
    ap.add_argument("--machines", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--queue-capacity", type=int, default=1 << 18)
    ap.add_argument("--cache-capacity", type=int, default=1 << 14)
    ap.add_argument("--space", default="huge",
                    choices=["huge", "bigjoin", "benu", "rads", "seed", "starjoin"])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--verify", action="store_true", help="check against networkx")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    graph = powerlaw_graph(args.vertices, args.avg_degree, seed=args.seed, device=device)
    query = PAPER_QUERIES[args.query]
    plan = optimal_plan(query, GraphStats.from_graph(graph), args.machines, args.space)
    print(plan.describe())
    flow = translate(plan)
    print(flow.describe())

    cfg = EngineConfig(
        batch_size=args.batch_size,
        queue_capacity=args.queue_capacity,
        cache_capacity=args.cache_capacity,
        num_machines=args.machines,
    )
    res = HugeEngine(graph, cfg, device=device).run(flow)
    s = res.stats
    print(
        f"\n[enumerate] {args.query} on |V|={args.vertices} (space={args.space}, "
        f"device={device}): count={res.count}\n"
        f"  T={s.wall_time:.2f}s (T_R={s.compute_time:.2f}s, T_C={s.comm_time:.2f}s)\n"
        f"  C: pulled={s.pulled_bytes / 1e6:.2f}MB pushed={s.pushed_bytes / 1e6:.2f}MB "
        f"cache-hit-rate={s.hit_rate:.2%}\n"
        f"  M: peak queue {s.peak_queue_bytes / 1e6:.2f}MB ({s.peak_queue_rows} rows)"
    )
    if args.verify:
        from repro_torch.graph.oracle import count_instances
        oracle = count_instances(graph, list(query.edges))
        print(f"  oracle={oracle}  MATCH={oracle == res.count}")
        assert oracle == res.count
    return res.count


if __name__ == "__main__":
    main()
