"""Quickstart on the PyTorch port: enumerate subgraphs with HUGE on the card.

    PYTHONPATH=src python examples/torch_quickstart.py                  # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --vertices 256
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.core.engine import EngineConfig, enumerate_query  # noqa: E402
from repro_torch.core.query import PAPER_QUERIES, clique  # noqa: E402
from repro_torch.graph import powerlaw_graph  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--vertices", type=int, default=2048)
    args = ap.parse_args(argv)

    # 1. A data graph (here a synthetic power-law one; build your own from an
    #    edge list with repro_torch.graph.build_graph).
    graph = powerlaw_graph(num_vertices=args.vertices, avg_degree=6.0, seed=0,
                           device=args.device)
    print(f"graph: |V|={graph.num_vertices} |E|={graph.num_edges} d_max={graph.max_degree}")

    # 2. A query pattern: the paper's q1 (square) and a 4-clique.
    counts = {}
    for query in (PAPER_QUERIES["q1"], clique(4)):
        # 3. One call: optimiser (Alg. 1) -> dataflow (Alg. 2) -> BFS/DFS-adaptive
        #    scheduler (Alg. 5) -> count, with communication accounting.
        res = enumerate_query(graph, query, EngineConfig(num_machines=8), device=args.device)
        s = res.stats
        counts[query.name] = res.count
        print(
            f"{query.name:10s} count={res.count:>10,}  "
            f"T={s.wall_time:.2f}s (compute {s.compute_time:.2f}s / comm {s.comm_time:.2f}s)  "
            f"pulled={s.pulled_bytes / 1e6:.1f}MB pushed={s.pushed_bytes / 1e6:.1f}MB "
            f"cache-hits={s.hit_rate:.0%}  peak-mem={s.peak_queue_bytes / 1e6:.1f}MB"
        )
    return counts


if __name__ == "__main__":
    main()
