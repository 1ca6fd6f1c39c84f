"""Service load on the port: the multi-tenant graph service under mixed
q1-q3 traffic (the JAX package's ``benchmarks/exp_service_load.py``).

T tenants each submit R enumeration requests (round-robin over q1=square,
q2=diamond, q3=4-clique) to ONE ``GraphService`` sharing one engine; the
driver ticks the service to idle and reports per-request latency percentiles
(p50/p99, host stamps from submit to the service's finish) and aggregate
matches/s over a wall that ends in a device sync.

    python -m repro_torch.launch.service_load [--fused] [--out BENCH_torch_service.json]
    python -m repro_torch.launch.service_load --smoke --device cpu

The defaults are the reference's: T3×R4 on powerlaw_graph(1024, 6.0,
seed=7), ``max_active`` 4, ``tick_steps`` 32, ``queue_capacity`` 2^12,
``join_buffer_capacity`` 2^14, ``EngineConfig(batch_size=256,
cache_capacity=2^12)``, unfused; ``--fused`` runs the same load on the fused
kernels. A warm-up pass (one request per tenant, discarded) runs first;
``--smoke`` (2 tenants, 1 request each, 256 vertices) skips it, as
``--no-warmup`` does. At those two cases the match counts must be the
reference's (59,500 and 3,040). Each entry carries the device's name and, on
a card, its power limit; ``--out`` appends the entries to a JSON trajectory
file.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.graph import powerlaw_graph
from repro_torch.launch.table4 import device_record, record
from repro_torch.serve.graph_service import (
    DONE,
    GraphQueryRequest,
    GraphService,
    ServiceConfig,
)

MIX = ("q1", "q2", "q3")
SEED = 7
# The reference's match counts (BENCH_service.json) by case.
COUNTS = {"T3xR4_v1024": 59500, "T2xR1_v256": 3040}


def engine_config(fused: bool = False) -> EngineConfig:
    return EngineConfig(batch_size=256, cache_capacity=1 << 12, fused=fused)


def build_service(graph, max_active: int, tick_steps: int,
                  engine_cfg: Optional[EngineConfig] = None,
                  device: str | torch.device | None = None) -> GraphService:
    return GraphService(
        graph,
        ServiceConfig(
            max_active=max_active,
            tick_steps=tick_steps,
            queue_capacity=1 << 12,
            join_buffer_capacity=1 << 14,
        ),
        engine_cfg or engine_config(),
        device=device,
    )


def run_load(graph, tenants: int, requests: int, max_active: int,
             tick_steps: int, engine_cfg: Optional[EngineConfig] = None,
             device: str | torch.device | None = None) -> dict:
    """Submit ``tenants × requests`` mixed queries, tick to idle, measure."""
    svc = build_service(graph, max_active, tick_steps, engine_cfg, device)
    dev = svc.engine.device
    t0 = time.perf_counter()
    tickets = []
    # Interleave tenants in submission order: the admission queue sees mixed
    # traffic, not one tenant's burst followed by another's.
    for r in range(requests):
        for t in range(tenants):
            q = MIX[(r * tenants + t) % len(MIX)]
            tickets.append(
                svc.submit(GraphQueryRequest(tenant=f"tenant{t}", query=q))
            )
    svc.run_until_idle()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    bad = [(tk.request.tenant, tk.status, tk.error) for tk in tickets if tk.status != DONE]
    if bad:
        raise AssertionError(f"requests not done: {bad}")
    lat = np.array([tk.latency_s for tk in tickets])
    matches = int(sum(tk.count for tk in tickets))
    return {
        "requests": len(tickets),
        "tenants": tenants,
        "matches": matches,
        "wall_s": wall,
        "matches_per_s": matches / max(wall, 1e-9),
        "p50_s": float(np.percentile(lat, 50)),
        "p99_s": float(np.percentile(lat, 99)),
        "mean_s": float(lat.mean()),
        "peak_pool_cells": svc.peak_pool_cells,
        "peak_inflight_rows": svc.peak_inflight_rows,
        "ticks": svc.ticks,
    }


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.service_load")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=4, help="requests per tenant")
    ap.add_argument("--vertices", type=int, default=1 << 10)
    ap.add_argument("--deg", type=float, default=6.0)
    ap.add_argument("--max-active", type=int, default=4)
    ap.add_argument("--tick-steps", type=int, default=32)
    ap.add_argument("--smoke", action="store_true",
                    help="2 tenants, 1 request each, 256-vertex graph, no warm-up")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--fused", action="store_true",
                    help="run the sessions on the fused kernels")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="JSON file the entry is appended to (none by default)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.tenants, args.requests, args.vertices = 2, 1, 256
        args.no_warmup = True

    dev = resolve_device(args.device)
    graph = powerlaw_graph(args.vertices, args.deg, seed=SEED, device=dev)
    ecfg = engine_config(args.fused)
    if not args.no_warmup:
        run_load(graph, args.tenants, 1, args.max_active, args.tick_steps, ecfg, dev)

    out = run_load(graph, args.tenants, args.requests, args.max_active,
                   args.tick_steps, ecfg, dev)
    case = f"T{args.tenants}xR{args.requests}_v{args.vertices}"
    if case in COUNTS and args.deg == 6.0 and out["matches"] != COUNTS[case]:
        raise AssertionError(f"{case}: {out['matches']} matches != {COUNTS[case]}")
    entry: List[dict] = [dict(
        suite="exp_service_load", case=case, mode="mixed-q1q3",
        fused=args.fused, graph=[args.vertices, args.deg, SEED],
        **out, **device_record(dev),
    )]
    print(f"service/{case}/{'fused' if args.fused else 'unfused'},"
          f"{out['p50_s'] * 1e6:.1f},p99_s={out['p99_s']:.3f};"
          f"throughput={out['matches_per_s']:,.0f}/s;count={out['matches']};"
          f"device={entry[0]['device']};power_limit={entry[0]['power_limit']}")
    print(
        f"[service] {out['requests']} requests / {out['tenants']} tenants: "
        f"{out['matches']} matches, {out['matches_per_s']:,.0f} matches/s, "
        f"p50 {out['p50_s']:.3f}s, p99 {out['p99_s']:.3f}s "
        f"({out['ticks']} ticks, peak pool {out['peak_pool_cells']} cells)"
    )
    if args.out:
        record(args.out, entry, bench="torch_service")
        print(f"# wrote {args.out}")
    return entry[0]


if __name__ == "__main__":
    main()
