"""Paper Table 4 on the port: enumeration throughput of q1-q3, fused and plain.

``python -m repro_torch.launch.table4 [--out BENCH_torch_table4.json]`` runs
q1-q3 under the ``huge`` plan space on ``powerlaw_graph(4096, 8.0, seed=7)``
with ``batch_size=1024`` and ``queue_capacity=2^17`` (the JAX package's
``benchmarks/table4_throughput.py`` configuration), once plain and once
fused, on the card. The fused and plain counts must be equal, and at that
graph they must be the reference's 110508, 67887 and 1782. Each entry
carries the device's name and, on a card, its power limit. ``--out`` appends
the entries to a JSON trajectory file; without it nothing is written.
``--device cpu`` runs the plain PyTorch path (the tests do, at a smaller
graph).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.cost import GraphStats
from repro_torch.core.dataflow import translate
from repro_torch.core.engine import EngineConfig, HugeEngine
from repro_torch.core.optimizer import optimal_plan
from repro_torch.core.query import PAPER_QUERIES
from repro_torch.device import resolve_device
from repro_torch.graph import powerlaw_graph

GRAPH = (4096, 8.0, 7)  # vertices, average degree, seed
# The reference's counts at GRAPH (JAX engine and networkx agree).
COUNTS = {"q1": 110508, "q2": 67887, "q3": 1782}
MACHINES = 8


def device_record(device: torch.device) -> Dict[str, Optional[str]]:
    """The device a run was measured on: its name and, for a card, the power
    limit ``nvidia-smi`` reports (a card set below 700 W runs slower)."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return {"device": torch.cuda.get_device_name(device),
            "power_limit": smi.split(",")[-1].strip()}


def table4(device: str | torch.device | None = None,
           graph_args: Sequence = GRAPH,
           queries: Sequence[str] = tuple(COUNTS)) -> List[dict]:
    """Run each query plain, then fused; return one entry per run. Raises
    if the fused and plain counts differ, or, at ``GRAPH``, if a count is
    not the reference's."""
    dev = resolve_device(device)
    n, deg, seed = graph_args
    graph = powerlaw_graph(n, deg, seed=seed, device=dev)
    stats = GraphStats.from_graph(graph)
    where = device_record(dev)
    entries = []
    for qname in queries:
        flow = translate(optimal_plan(PAPER_QUERIES[qname], stats, MACHINES, "huge"))
        counts = {}
        for fused in (False, True):
            cfg = EngineConfig(batch_size=1024, queue_capacity=1 << 17,
                               cache_capacity=1 << 13, num_machines=MACHINES,
                               join_out_capacity=1 << 18, join_buffer_capacity=1 << 21,
                               fused=fused)
            res = HugeEngine(graph, cfg, device=dev, track_balance=True).run(flow)
            s = res.stats
            mode = "fused" if fused else "unfused"
            counts[mode] = res.count
            entries.append({
                "suite": "table4_throughput", "case": qname, "mode": mode,
                "matches": int(res.count), "wall_s": s.wall_time,
                "matches_per_s": res.count / max(s.wall_time, 1e-9),
                "peak_queue_bytes": s.peak_queue_bytes,
                "per_machine_rows": s.per_machine_rows.tolist(),
                "graph": list(graph_args), **where,
            })
        if counts["fused"] != counts["unfused"]:
            raise AssertionError(f"{qname}: fused and plain counts differ: {counts}")
        if tuple(graph_args) == GRAPH and counts["fused"] != COUNTS[qname]:
            raise AssertionError(f"{qname}: count {counts['fused']} != {COUNTS[qname]}")
    return entries


def record(path: str, entries: List[dict], bench: str = "torch_table4") -> None:
    """Append ``entries`` to the JSON trajectory at ``path`` (created if
    missing, named ``bench``), stamped with the time; written to a temporary
    file and renamed over the target."""
    doc = {"bench": bench, "entries": []}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
    stamp = time.strftime("%Y-%m-%dT%H:%M:%S%z")
    doc["updated"] = stamp
    doc["entries"].extend(dict(e, recorded=stamp) for e in entries)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--vertices", type=int, default=GRAPH[0])
    ap.add_argument("--avg-degree", type=float, default=GRAPH[1])
    ap.add_argument("--seed", type=int, default=GRAPH[2])
    ap.add_argument("--out", default=None,
                    help="JSON file the entries are appended to (none by default)")
    args = ap.parse_args(argv)
    entries = table4(args.device, (args.vertices, args.avg_degree, args.seed))
    for e in entries:
        print(f"table4/{e['case']}/{e['mode']},{e['wall_s'] * 1e6:.1f},"
              f"throughput={e['matches_per_s']:,.0f}/s;count={e['matches']};"
              f"M={e['peak_queue_bytes'] / 1e6:.1f}MB;device={e['device']};"
              f"power_limit={e['power_limit']}")
    if args.out:
        record(args.out, entries)
        print(f"# wrote {args.out}")
    return entries


if __name__ == "__main__":
    main()
