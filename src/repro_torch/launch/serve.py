"""Serving driver.

LM batch serving (the default when no mode is given), on the card:

    python -m repro_torch.launch.serve lm --arch granite-3-8b [--smoke] [--device cpu]

Multi-tenant graph service (N tenants' enumeration queries multiplexed onto
one shared engine), on the card:

    python -m repro_torch.launch.serve graph --tenants 3 --requests 2 [--device cpu]

The flags are the JAX launcher's, plus ``--device``. LM parameters are
random, drawn on the device from ``--seed``; the graph is
``powerlaw_graph(--vertices, --deg, seed=--seed)``, built on the device.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import BatchedServer, Request, ServeConfig


def lm_main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve lm")
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(args.seed)
    params = T.init_params(cfg, seed=args.seed, device=device)
    scfg = ServeConfig(
        max_len=args.prompt_len + args.max_new + 8,
        batch_slots=args.slots,
        temperature=args.temperature,
        max_new_tokens=args.max_new,
        eos_token=-1,  # never stop early in the benchmark
    )
    server = BatchedServer(cfg, params, scfg, device=device,
                           generator=torch.Generator(device=device).manual_seed(args.seed))
    reqs = [
        Request(prompt=rng.integers(2, cfg.vocab_size, size=args.prompt_len).astype(np.int32))
        for _ in range(args.requests)
    ]
    stats = server.run(reqs)
    lat = [r.latency_s for r in reqs]
    print(
        f"[serve] {cfg.name} on {device}: {stats['requests']} requests, "
        f"{stats['new_tokens']} new tokens, {stats['tokens_per_s']:,.1f} tok/s, "
        f"latency p50 {np.percentile(lat, 50):.3f}s p99 {np.percentile(lat, 99):.3f}s"
    )
    return stats


def graph_main(argv=None):
    from repro_torch.core.engine import EngineConfig
    from repro_torch.graph import powerlaw_graph
    from repro_torch.serve.graph_service import (
        GraphQueryRequest,
        GraphService,
        ServiceConfig,
        TenantBudget,
    )

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve graph")
    ap.add_argument("--vertices", type=int, default=1 << 10)
    ap.add_argument("--deg", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=2, help="queries per tenant")
    ap.add_argument("--queries", default="q1,q2,q3",
                    help="comma-separated names from PAPER_QUERIES, round-robin")
    ap.add_argument("--max-active", type=int, default=4)
    ap.add_argument("--tick-steps", type=int, default=32)
    ap.add_argument("--match-budget", type=int, default=None,
                    help="per-query match cap (stops queries early)")
    ap.add_argument("--pool-cells", type=int, default=64 << 20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    graph = powerlaw_graph(args.vertices, args.deg, seed=args.seed, device=device)
    svc = GraphService(
        graph,
        ServiceConfig(
            total_queue_cells=args.pool_cells,
            max_active=args.max_active,
            tick_steps=args.tick_steps,
            default_budget=TenantBudget(max_matches=args.match_budget),
        ),
        EngineConfig(batch_size=256),
        device=device,
    )
    names = args.queries.split(",")
    t0 = time.perf_counter()
    tickets = []
    for r in range(args.requests):
        for t in range(args.tenants):
            q = names[(r * args.tenants + t) % len(names)]
            tickets.append(
                svc.submit(GraphQueryRequest(tenant=f"tenant{t}", query=q))
            )
    summary = svc.run_until_idle()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    lat = [tk.latency_s for tk in tickets if tk.latency_s is not None]
    total = sum(tk.count for tk in tickets)
    print(f"[graph-service] {len(tickets)} requests, {args.tenants} tenants, "
          f"{summary['ticks']} ticks, wall {wall:.2f}s on {device}")
    for tk in tickets:
        print(f"  #{tk.id} {tk.request.tenant:>9s} {tk.request.query:>4} "
              f"-> {tk.status:15s} count={tk.count:<8d} "
              f"latency={tk.latency_s:.3f}s wait={tk.queue_wait_s or 0:.3f}s")
    if lat:
        print(f"  p50 {np.percentile(lat, 50):.3f}s  p99 {np.percentile(lat, 99):.3f}s  "
              f"aggregate {total / max(wall, 1e-9):,.0f} matches/s  "
              f"peak pool {svc.peak_pool_cells} cells")
    return tickets


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "graph":
        return graph_main(argv[1:])
    if argv and argv[0] == "lm":
        return lm_main(argv[1:])
    return lm_main(argv)


if __name__ == "__main__":
    main()
