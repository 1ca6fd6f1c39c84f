"""Distributed Table 1 on the port: communication modes with real collectives.

``python -m repro_torch.launch.dist_hybrid [--ranks 8] [--backend gloo]
[--out BENCH_torch_dist.json]`` runs q1 and q2 under three plan spaces on
``powerlaw_graph(512, 6.0, seed=7)`` through ``DistributedEngine`` on
``--ranks`` spawned ranks (``run_ranks``), unfused and fused, with
``batch_size=256`` and ``queue_capacity=2^15`` (the JAX package's
``benchmarks/exp_dist_hybrid.py`` configuration):

  pull-only  ``benu``: extend/verify chains, GetNbrs fetch traffic;
  push-only  ``seed``: every join a PUSH-JOIN hash shuffle;
  hybrid     ``huge``: the optimiser mixes both per Eq. 3.

Each entry holds the count, the wall (the slowest rank's, ending in a
sync), the bytes the all-to-alls moved (fetched rows, shuffled rows, stolen
rows), the intersect kernel launches summed over the ranks, and the device's
name and power limit; the Eq.-3 line of each query comes from
``core.hybrid_comm.enum_join_mode``. Every run of a query must give the
same count. On one card, ranks beyond the first share it: pass ``--backend
gloo`` (NCCL takes one GPU per rank). ``--device cpu`` runs the plain path
(the tests do, at ``--ranks 2 --vertices 64``).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import torch

from repro_torch.core.cost import GraphStats
from repro_torch.core.distributed import DistConfig, DistributedEngine, run_ranks
from repro_torch.core.hybrid_comm import enum_join_mode
from repro_torch.core.query import PAPER_QUERIES
from repro_torch.device import resolve_device
from repro_torch.graph import powerlaw_graph
from repro_torch.kernels.intersect import ops as ik
from repro_torch.launch.table4 import device_record, record

GRAPH = (512, 6.0, 7)  # vertices, average degree, seed
RANKS = 8
QUERIES = ("q1", "q2")
SYSTEMS = (("pull-only", "benu"), ("push-only", "seed"), ("hybrid", "huge"))
STAT_KEYS = ("joins", "a2a_calls", "pulled_vids", "pulled_bytes", "shuffle_rows",
             "shuffle_bytes", "steal_rows", "steal_bytes", "probe_batches", "sched_steps")


def rank_body(comm, graph_args) -> List[dict]:
    """One rank's runs: every (query, space, fused) in order, each with its
    wall on this rank and this rank's kernel launches."""
    n, deg, seed = graph_args
    graph = powerlaw_graph(n, deg, seed=seed, device=comm.device)
    engines = {fused: DistributedEngine(graph, comm, DistConfig(
        batch_size=256, queue_capacity=1 << 15, fused=fused)) for fused in (False, True)}
    sync = torch.cuda.synchronize if comm.device.type == "cuda" else (lambda: None)
    runs = []
    for qname in QUERIES:
        for system, space in SYSTEMS:
            for fused in (False, True):
                before = dict(ik.launches)
                sync()
                t0 = time.perf_counter()
                count, stats = engines[fused].run(PAPER_QUERIES[qname], space=space)
                sync()
                runs.append({"query": qname, "system": system, "fused": fused,
                             "count": count, "wall_s": time.perf_counter() - t0,
                             "stats": {k: stats[k] for k in STAT_KEYS},
                             "launches": {k: ik.launches[k] - before[k] for k in before}})
    return runs


def dist_hybrid(ranks: int = RANKS, backend: str = "gloo", device=None,
                graph_args=GRAPH, timeout_s: float = 1800.0) -> List[dict]:
    dev = resolve_device(device)
    results = run_ranks(rank_body, ranks, backend=backend, device=dev,
                        timeout_s=timeout_s, args=(tuple(graph_args),))
    where = device_record(dev)
    per_rank = [r.value for r in results]
    stats = GraphStats.from_graph(powerlaw_graph(*graph_args[:2], seed=graph_args[2],
                                                 device="cpu"))
    entries: List[dict] = []
    for i, run in enumerate(per_rank[0]):
        for other in per_rank[1:]:
            if (other[i]["count"], other[i]["stats"]) != (run["count"], run["stats"]):
                raise AssertionError(f"ranks disagree on {run['system']}/{run['query']}")
        wall = max(r[i]["wall_s"] for r in per_rank)
        launches = {k: sum(r[i]["launches"][k] for r in per_rank) for k in run["launches"]}
        entries.append({
            "suite": "dist_hybrid", "case": f"{run['system']}/{run['query']}",
            "mode": "fused" if run["fused"] else "unfused", "matches": run["count"],
            "wall_s": wall, "matches_per_s": run["count"] / max(wall, 1e-9),
            "ranks": ranks, "backend": backend, "graph": list(graph_args),
            **run["stats"], "launches": launches, **where,
        })
    for qname in QUERIES:
        counts: Dict[str, int] = {f"{e['case']}/{e['mode']}": e["matches"] for e in entries
                                  if e["case"].endswith("/" + qname)}
        if len(set(counts.values())) != 1:
            raise AssertionError(f"{qname}: counts differ across runs: {counts}")
        q = PAPER_QUERIES[qname]
        hybrid = max(next(iter(counts.values())), 1)
        dec = enum_join_mode(left_rows=hybrid, right_rows=hybrid, width_left=q.num_vertices,
                             width_right=q.num_vertices,
                             graph_edges=stats.num_directed_edges / 2, machines=ranks)
        entries.append({"suite": "dist_hybrid", "case": f"eq3/{qname}", "mode": dec.mode,
                        "push_bytes": dec.push_bytes, "pull_bytes": dec.pull_bytes,
                        "ranks": ranks, "graph": list(graph_args), **where})
    return entries


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=RANKS)
    ap.add_argument("--backend", default="gloo", help="gloo (default) or nccl")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--vertices", type=int, default=GRAPH[0])
    ap.add_argument("--avg-degree", type=float, default=GRAPH[1])
    ap.add_argument("--seed", type=int, default=GRAPH[2])
    ap.add_argument("--out", default=None,
                    help="JSON file the entries are appended to (none by default)")
    args = ap.parse_args(argv)
    entries = dist_hybrid(args.ranks, args.backend, args.device,
                          (args.vertices, args.avg_degree, args.seed))
    for e in entries:
        if e["case"].startswith("eq3/"):
            print(f"dist_hybrid/{e['case']},0.0,mode={e['mode']};"
                  f"push={e['push_bytes'] / 1e6:.3f}MB;pull={e['pull_bytes'] / 1e6:.3f}MB")
            continue
        print(f"dist_hybrid/{e['case']}/{e['mode']},{e['wall_s'] * 1e6:.1f},"
              f"count={e['matches']};joins={e['joins']};a2a={e['a2a_calls']};"
              f"pull={e['pulled_bytes'] / 1e6:.3f}MB;push={e['shuffle_bytes'] / 1e6:.3f}MB;"
              f"steal={e['steal_bytes'] / 1e6:.3f}MB;launches={e['launches']};"
              f"ranks={e['ranks']};backend={e['backend']};device={e['device']};"
              f"power_limit={e['power_limit']}")
    if args.out:
        record(args.out, entries, bench="torch_dist")
        print(f"# wrote {args.out}")
    return entries


if __name__ == "__main__":
    main()
