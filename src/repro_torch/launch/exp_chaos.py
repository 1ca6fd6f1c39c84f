"""Chaos on the port: the recovery overhead of the fault-tolerance ladder
(the JAX package's ``benchmarks/exp_chaos.py``).

For each query a fault-free baseline run (after a warm-up run) is timed
against runs that recover from an injected fault: queue-overflow (restore
the checkpoint at half the batch), shard-loss (deterministic replay) and
kernel-fail (the batch runs the plain path once, on a fused engine). Each
fault must fire once and the recovered count must equal the baseline's
before its entry is kept, so every entry is a successful recovery; the
figure of merit is the wall-time overhead of surviving the fault.

    python -m repro_torch.launch.exp_chaos [--fused] [--out FILE]   # q1-q3, 2048 vertices
    python -m repro_torch.launch.exp_chaos --smoke                   # 512 vertices, q1
"""
from __future__ import annotations

import argparse
import time
from typing import List

from repro_torch.core.engine import EngineConfig, HugeEngine
from repro_torch.core.faults import FaultPlan
from repro_torch.core.query import PAPER_QUERIES
from repro_torch.launch.common import bench_graph, device_record, emit, fields, finish

# (case label, fault kind, extra EngineConfig fields)
FAULT_CASES = (
    ("queue-overflow", "queue-overflow", {}),
    ("shard-loss", "shard-loss", {}),
    ("kernel-fail", "kernel-fail", {"fused": True}),
)


def _cfg(seed: int, kind: str | None, **extra) -> EngineConfig:
    faults = None if kind is None else FaultPlan.single(kind, at_step=seed % 3, seed=seed)
    return EngineConfig(batch_size=256, queue_capacity=1 << 15,
                        join_buffer_capacity=1 << 17, faults=faults, recover=True, **extra)


def run_case(graph, qname: str, kind: str | None, seed: int, **extra):
    eng = HugeEngine(graph, _cfg(seed, kind, **extra), device=graph.device)
    t0 = time.perf_counter()
    res = eng.run(PAPER_QUERIES[qname])
    wall = time.perf_counter() - t0
    if kind is not None:
        assert eng.cfg.faults.fired_count(kind) == 1, (
            f"{qname}/{kind}: fault never fired — not a recovery measurement")
    return res, wall


def chaos(graph, queries=("q1", "q2", "q3"), seed: int = 0, fused: bool = False) -> List[dict]:
    where = device_record(graph.device)
    base_extra = {"fused": True} if fused else {}
    entries = []
    for qname in queries:
        # The warm-up run builds every operator's first batch; the timed
        # baseline then measures what recovery re-executes.
        run_case(graph, qname, None, seed, **base_extra)
        base, base_wall = run_case(graph, qname, None, seed, **base_extra)
        emit(f"chaos/{qname}/baseline", base_wall * 1e6, f"{base.count}m")
        for label, kind, extra in FAULT_CASES:
            extra = {**base_extra, **extra}
            if extra != base_extra:
                # warm the other path's first batches too, so the overhead
                # measures recovery, not a first run
                run_case(graph, qname, None, seed, **extra)
            res, wall = run_case(graph, qname, kind, seed, **extra)
            assert res.count == base.count, (
                f"{qname}/{label}: recovered count {res.count} != baseline {base.count}")
            overhead = wall / max(base_wall, 1e-9)
            name = f"chaos/{qname}/{label}"
            entries.append({
                "suite": "exp_chaos", "name": name, "case": f"{qname}_{label}",
                "mode": "recovered", "fused": bool(extra.get("fused", False)),
                **fields(res), "baseline": fields(base),
                "wall_s": wall, "baseline_wall_s": base_wall,
                "overhead_x": overhead, "seed": seed, **where,
            })
            emit(name, wall * 1e6, f"overhead={overhead:.2f}x")
            print(f"[chaos] {qname} {label}: recovered {res.count} matches in {wall:.2f}s "
                  f"vs baseline {base_wall:.2f}s ({overhead:.2f}x)", flush=True)
    worst = max(e["overhead_x"] for e in entries)
    print(f"[chaos] worst recovery overhead: {worst:.2f}x baseline", flush=True)
    return entries


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.exp_chaos")
    ap.add_argument("--vertices", type=int, default=1 << 11)
    ap.add_argument("--deg", type=float, default=6.0)
    ap.add_argument("--queries", nargs="+", default=["q1", "q2", "q3"])
    ap.add_argument("--seed", type=int, default=0,
                    help="FaultPlan seed (shifts the trigger step)")
    ap.add_argument("--smoke", action="store_true", help="512-vertex graph, q1 only")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fused", action="store_true", help="every run on the fused kernels")
    ap.add_argument("--out", default=None,
                    help="JSON file the entries are appended to (none by default)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.vertices, args.queries = 512, ["q1"]
    graph = bench_graph(args.vertices, args.deg, seed=7, device=args.device)
    return finish(args, chaos(graph, args.queries, args.seed, args.fused))


if __name__ == "__main__":
    main()
