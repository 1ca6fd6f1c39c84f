"""Streaming on the port: delta enumeration against full re-enumeration
(the JAX package's ``benchmarks/exp_streaming.py``).

A power-law graph receives a stream of edge-insert batches; after each
batch a standing query's new matches must be delivered. The incremental
path applies the batch (``apply_updates``) and runs the delta decomposition
(``run_delta``); the baseline re-enumerates the whole graph on a fresh
engine and takes the difference. Both deliver the same new matches, so the
figure of merit is new matches/s a path. Each case's first batch is a
discarded warm-up; the summed deltas must equal the full counts'
difference before the entry is kept.

    python -m repro_torch.launch.exp_streaming [--fused] [--out FILE]  # q1, q2; 4096 vertices
    python -m repro_torch.launch.exp_streaming --smoke                 # 512 vertices, q1
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig, HugeEngine
from repro_torch.core.query import PAPER_QUERIES
from repro_torch.graph import GraphUpdateBatch, build_graph
from repro_torch.launch.common import bench_graph, device_record, emit, fields, finish


def undirected_edges(graph) -> np.ndarray:
    """The undirected edge array ``int[E, 2]`` (u < v) of a built graph."""
    offs = graph.offsets.cpu().numpy()
    nbrs = graph.nbrs.cpu().numpy()
    src = np.repeat(np.arange(graph.num_vertices), np.diff(offs))
    und = np.stack([src, nbrs], axis=1)
    return und[und[:, 0] < und[:, 1]]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_case(und: np.ndarray, n: int, qname: str, batch_edges: int, batches: int,
             cfg: EngineConfig, seed: int, device) -> dict:
    """Stream ``batches`` batches of ``batch_edges`` edges onto a base graph;
    time delta enumeration against full re-enumeration after each batch."""
    rng = np.random.default_rng(seed)
    und = und[rng.permutation(len(und))]
    tail = (batches + 1) * batch_edges  # +1: the warm-up batch
    base, stream = und[:-tail], und[-tail:]
    chunks = np.array_split(stream, batches + 1)

    q = PAPER_QUERIES[qname]
    eng = HugeEngine(build_graph(base, n, device=device), cfg, device=device)

    # The baseline re-enumerates from scratch on a fresh engine a batch, as a
    # deployment without deltas would (an engine's stats also accumulate).
    def full(graph):
        return HugeEngine(graph, cfg, device=device).run(q)

    eng.apply_updates(GraphUpdateBatch(chunks[0]))
    eng.run_delta(q)
    c_prev = full(eng.graph).count

    delta_s = full_s = apply_s = 0.0
    new_matches = 0
    deltas, fulls = [], []
    for chunk in chunks[1:]:
        t0 = time.perf_counter()
        eng.apply_updates(GraphUpdateBatch(chunk))
        _sync(eng.device)
        apply_s += time.perf_counter() - t0

        t0 = time.perf_counter()
        r = eng.run_delta(q)
        delta_s += time.perf_counter() - t0
        new_matches += r.count
        deltas.append(fields(r))

        t0 = time.perf_counter()
        f = full(eng.graph)
        full_s += time.perf_counter() - t0
        fulls.append(fields(f))
        c_now = f.count

    assert new_matches == c_now - c_prev, (qname, new_matches, c_now - c_prev)
    return {
        "query": qname, "batch_edges": batch_edges, "batches": batches, "vertices": n,
        "new_matches": new_matches, "deltas": deltas, "fulls": fulls,
        "delta_s": delta_s, "full_s": full_s, "apply_s": apply_s,
        "delta_matches_per_s": new_matches / max(delta_s, 1e-9),
        "full_matches_per_s": new_matches / max(full_s, 1e-9),
        "speedup": full_s / max(delta_s, 1e-9),
    }


def streaming(graph, queries=("q1", "q2"), batch_edges=(8, 64), batches: int = 3,
              fused: bool = False) -> List[dict]:
    where = device_record(graph.device)
    und = undirected_edges(graph)
    cfg = EngineConfig(batch_size=256, materialize=False, fused=fused)
    entries = []
    for qname in queries:
        for b in batch_edges:
            out = run_case(und, graph.num_vertices, qname, b, batches, cfg, seed=100 + b,
                           device=graph.device)
            entries.append(dict(suite="exp_streaming", name=f"streaming/{qname}_b{b}",
                                case=f"{qname}_b{b}", fused=fused, **out, **where))
            emit(f"streaming/{qname}_b{b}/delta", out["delta_s"] * 1e6 / batches,
                 f"{out['delta_matches_per_s']:.0f}mps")
            emit(f"streaming/{qname}_b{b}/full", out["full_s"] * 1e6 / batches,
                 f"speedup={out['speedup']:.1f}x")
            print(f"[streaming] {qname} batch={b}: {out['new_matches']} new matches, "
                  f"delta {out['delta_matches_per_s']:,.0f}/s vs full "
                  f"{out['full_matches_per_s']:,.0f}/s -> {out['speedup']:.1f}x "
                  f"(apply {out['apply_s'] * 1e3:.1f}ms total)", flush=True)
    small = min(e["batch_edges"] for e in entries)
    worst = min(e["speedup"] for e in entries if e["batch_edges"] == small)
    print(f"[streaming] min speedup at batch={small}: {worst:.1f}x", flush=True)
    return entries


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.exp_streaming")
    ap.add_argument("--vertices", type=int, default=1 << 12)
    ap.add_argument("--deg", type=float, default=6.0)
    ap.add_argument("--queries", nargs="+", default=["q1", "q2"])
    ap.add_argument("--batch-edges", nargs="+", type=int, default=[8, 64])
    ap.add_argument("--batches", type=int, default=3,
                    help="timed batches a case (one warm-up batch on top)")
    ap.add_argument("--smoke", action="store_true",
                    help="512-vertex graph, q1, one small batch size")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fused", action="store_true", help="run on the fused kernels")
    ap.add_argument("--out", default=None,
                    help="JSON file the entries are appended to (none by default)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.vertices, args.queries = 512, ["q1"]
        args.batch_edges, args.batches = [8], 2
    graph = bench_graph(args.vertices, args.deg, seed=7, device=args.device)
    return finish(args, streaming(graph, args.queries, args.batch_edges, args.batches,
                                  args.fused))


if __name__ == "__main__":
    main()
