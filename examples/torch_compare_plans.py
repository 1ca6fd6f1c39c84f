"""Plan-space comparison on the PyTorch port (the paper's Exp-1/Exp-9 in
example form): run one query under every prior system's plan space and print
the Table-1-style breakdown.

    PYTHONPATH=src python examples/torch_compare_plans.py --query q1     # on the card
    PYTHONPATH=src python examples/torch_compare_plans.py --device cpu --vertices 256
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.core.cost import GraphStats  # noqa: E402
from repro_torch.core.engine import EngineConfig, HugeEngine  # noqa: E402
from repro_torch.core.optimizer import optimal_plan  # noqa: E402
from repro_torch.core.query import PAPER_QUERIES  # noqa: E402
from repro_torch.graph import powerlaw_graph  # noqa: E402

SYSTEMS = ("starjoin", "seed", "bigjoin", "benu", "rads", "huge")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", default="q1", choices=list(PAPER_QUERIES))
    ap.add_argument("--vertices", type=int, default=4096)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    graph = powerlaw_graph(args.vertices, 8.0, seed=7, device=args.device)
    query = PAPER_QUERIES[args.query]
    stats = GraphStats.from_graph(graph)
    print(f"{'system':10s} {'T':>8s} {'T_R':>8s} {'T_C':>8s} {'C(MB)':>8s} {'M(MB)':>8s} "
          f"{'count':>10s}")
    counts = {}
    for system in SYSTEMS:
        plan = optimal_plan(query, stats, 8, system)
        res = HugeEngine(graph, EngineConfig(num_machines=8), device=args.device).run(plan)
        s = res.stats
        counts[system] = res.count
        print(
            f"{system:10s} {s.wall_time:8.2f} {s.compute_time:8.2f} {s.comm_time:8.2f} "
            f"{s.total_comm_bytes / 1e6:8.2f} {s.peak_queue_bytes / 1e6:8.2f} {res.count:>10,}"
        )
    return counts


if __name__ == "__main__":
    main()
