"""Shared fixtures of the paper's suites on the port (the JAX package's
``benchmarks/common.py``): the benchmark graph, one engine run at the
suites' defaults, the CSV rows, each row's entry and its recording.

Every suite prints ``name,us_per_call,derived`` rows (``emit``) under the
reference's row names and returns one entry per row. An entry holds the
row's deterministic fields (``fields``: count, pulled and pushed bytes,
cache hits and misses, peak queue rows and bytes, scheduler steps and full
yields, result rows per simulated machine, recovery counters), its walls,
and the device's name and power limit. ``record`` appends entries to a JSON
trajectory file, each stamped with the git revision (``unknown`` outside a
checkout) and the clean-tree flowcheck's error count.
"""
from __future__ import annotations

import argparse
import functools
import os
import subprocess
from typing import List

import torch

from repro_torch.core.cost import GraphStats
from repro_torch.core.dataflow import translate
from repro_torch.core.engine import EngineConfig, EnumerationResult, HugeEngine
from repro_torch.core.optimizer import optimal_plan
from repro_torch.core.query import PAPER_QUERIES
from repro_torch.device import resolve_device
from repro_torch.graph import powerlaw_graph
from repro_torch.launch import table4

GRAPH = (1 << 11, 6.0, 7)  # bench_graph(): vertices, average degree, seed
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
device_record = table4.device_record


def bench_graph(n: int = GRAPH[0], deg: float = GRAPH[1], seed: int = GRAPH[2],
                device: str | torch.device | None = None):
    """The suites' power-law data graph, on the card unless ``device`` says
    otherwise."""
    return powerlaw_graph(n, deg, seed=seed, device=resolve_device(device))


def run_query(
    graph,
    qname: str,
    space="huge",
    machines: int = 8,
    batch_size: int = 512,
    queue_capacity: int = 1 << 16,
    cache_capacity: int = 1 << 13,
    cache_policy: str = "lrbu",
    join_out_capacity: int = 1 << 18,
    fused: bool = False,
) -> EnumerationResult:
    """One run at the suites' defaults (the reference's ``run_query``):
    plan under ``space`` (a name or a ``PlanSpace``), translate, run on a
    fresh engine on the graph's device."""
    cfg = EngineConfig(
        batch_size=batch_size,
        queue_capacity=queue_capacity,
        cache_capacity=cache_capacity,
        cache_policy=cache_policy,
        num_machines=machines,
        join_out_capacity=join_out_capacity,
        join_buffer_capacity=1 << 21,
        fused=fused,
    )
    plan = optimal_plan(PAPER_QUERIES[qname], GraphStats.from_graph(graph), machines, space)
    return HugeEngine(graph, cfg, device=graph.device).run(translate(plan))


def emit(name: str, us_per_call: float, derived: str) -> None:
    """One CSV row per result: name,us_per_call,derived."""
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def fields(res) -> dict:
    """The deterministic fields of one run's result."""
    s, sch = res.stats, res.schedule
    rows = s.per_machine_rows
    return {
        "matches": int(res.count),
        "pulled_bytes": int(s.pulled_bytes),
        "pushed_bytes": int(s.pushed_bytes),
        "cache_hits": int(s.cache_hits),
        "cache_misses": int(s.cache_misses),
        "peak_queue_rows": int(s.peak_queue_rows),
        "peak_queue_bytes": int(s.peak_queue_bytes),
        "steps": int(sch.steps),
        "yields_full": int(sch.yields_full),
        "per_machine_rows": None if rows is None else [int(r) for r in rows],
        "retries": int(s.retries),
        "restarts": int(s.restarts),
        "pressure_events": int(s.pressure_events),
        "kernel_fallbacks": int(s.kernel_fallbacks),
    }


def entry(suite: str, name: str, res, where: dict, fused: bool, **extra) -> dict:
    """A row's entry: its deterministic fields, its walls (the engine's host
    clock, ending in a device sync) and the device it ran on."""
    s = res.stats
    return {"suite": suite, "name": name, "fused": fused, **fields(res),
            "hit_rate": s.hit_rate, "wall_s": s.wall_time,
            "compute_s": s.compute_time, "comm_s": s.comm_time, **extra, **where}


@functools.lru_cache(maxsize=1)
def flowcheck_rule_count() -> int:
    """Error count of the clean-tree flowcheck corpus (0 on a healthy tree)."""
    from repro_torch.analysis import clean_tree_flowcheck

    return len([d for d in clean_tree_flowcheck() if d.severity == "error"])


@functools.lru_cache(maxsize=1)
def git_rev() -> str:
    """Short git revision of the repo (``unknown`` outside a checkout)."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO_ROOT,
                             capture_output=True, text=True, timeout=10)
    except OSError:
        return "unknown"
    rev = out.stdout.strip()
    return rev if out.returncode == 0 and rev else "unknown"


def record(path: str, entries: List[dict], bench: str = "torch_paper") -> None:
    """Append ``entries`` to the trajectory at ``path``, each stamped with the
    git revision and the flowcheck's error count (``table4.record`` adds the
    time and writes a temporary file renamed over the target)."""
    table4.record(path, [dict(e, git=git_rev(), flowcheck_rules=flowcheck_rule_count())
                         for e in entries], bench=bench)


def suite_parser(prog: str, graph: tuple = GRAPH) -> argparse.ArgumentParser:
    """The arguments of a suite that runs on one graph: ``--device``,
    ``--fused``, ``--out`` and the graph's size."""
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fused", action="store_true", help="run on the fused kernels")
    ap.add_argument("--out", default=None,
                    help="JSON file the entries are appended to (none by default)")
    ap.add_argument("--vertices", type=int, default=graph[0])
    ap.add_argument("--avg-degree", type=float, default=graph[1])
    ap.add_argument("--seed", type=int, default=graph[2])
    return ap


def finish(args, entries: List[dict]) -> List[dict]:
    """Record the entries where ``--out`` asks for it; return them."""
    if args.out:
        record(args.out, entries)
        print(f"# wrote {args.out}", flush=True)
    return entries
