"""The paper's suites on the port, one registry (the JAX package's
``benchmarks/run.py``).

    python -m repro_torch.launch.run [--fused] [--out BENCH_torch_paper.json]   # every suite
    python -m repro_torch.launch.run exp6 table1 --device cpu                   # some
    python -m repro_torch.launch.run --list                                     # the registry

``SUITES`` maps the reference's 13 suite keys to the port's modules. Each
suite runs at the reference's workload on the card (``--device cpu`` runs
the plain PyTorch path) and prints ``name,us_per_call,derived`` rows;
``--fused`` runs the sessions on the fused kernels (table4 and
exp_dist_hybrid run both ways themselves). A suite's error is printed as a
``<suite>/ERROR`` row and the rest run on; the exit status is then 1.
``--out FILE`` appends every suite's entries to one trajectory file.

The registry checks itself: every module under ``repro_torch/launch/`` but
the command lines that are not suites (``NOT_SUITES``) must be registered
exactly once, and every registered module must exist, or the run refuses
to start (exit 2), as it does for an unknown suite.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List

from repro_torch.launch import (
    dist_hybrid,
    exp1_plugin_plans,
    exp4_batching,
    exp5_cache,
    exp6_cache_design,
    exp7_scheduling,
    exp9_plans,
    exp10_scaling,
    exp_chaos,
    exp_streaming,
    service_load,
    table1_comm_modes,
    table4,
)
from repro_torch.launch.common import record

SUITES = {
    "table1": table1_comm_modes,
    "exp1": exp1_plugin_plans,
    "exp4": exp4_batching,
    "exp5": exp5_cache,
    "exp6": exp6_cache_design,
    "exp7": exp7_scheduling,
    "exp9": exp9_plans,
    "exp10": exp10_scaling,
    "exp_chaos": exp_chaos,
    "exp_dist_hybrid": dist_hybrid,
    "exp_service_load": service_load,
    "exp_streaming": exp_streaming,
    "table4": table4,
}
# Modules of this package that are command lines, not suites.
NOT_SUITES = ("__init__", "common", "enumerate", "run", "serve")
# Suites that run plain and fused themselves (they take no --fused).
RUNS_BOTH = ("table4", "exp_dist_hybrid")


def registry_problems(launch_dir: str | None = None) -> List[str]:
    """Every suite module on disk registered exactly once, and every
    registered module on disk."""
    launch_dir = launch_dir or os.path.dirname(os.path.abspath(__file__))
    on_disk = sorted(f[: -len(".py")] for f in os.listdir(launch_dir)
                     if f.endswith(".py") and f[: -len(".py")] not in NOT_SUITES)
    registered = [m.__name__.rsplit(".", 1)[-1] for m in SUITES.values()]
    problems = []
    for mod in on_disk:
        n = registered.count(mod)
        if n == 0:
            problems.append(f"repro_torch/launch/{mod}.py is not registered in SUITES")
        elif n > 1:
            problems.append(f"repro_torch/launch/{mod}.py is registered {n} times")
    for mod in registered:
        if mod not in on_disk:
            problems.append(f"SUITES entry {mod!r} has no repro_torch/launch/{mod}.py")
    return problems


def suite_argv(name: str, device: str, fused: bool) -> List[str]:
    argv = ["--device", device]
    if fused and name not in RUNS_BOTH:
        argv.append("--fused")
    return argv


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.run")
    ap.add_argument("suites", nargs="*", help="suite keys (default: every suite)")
    ap.add_argument("--list", action="store_true", help="print the registry")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fused", action="store_true", help="run the sessions on the kernels")
    ap.add_argument("--out", default=None,
                    help="JSON file every suite's entries are appended to")
    args = ap.parse_args(argv)
    problems = registry_problems()
    if problems:
        for p in problems:
            print(f"registry error: {p}", file=sys.stderr)
        return 2
    if args.list:
        for name, mod in SUITES.items():
            print(f"{name:18s} repro_torch/launch/{mod.__name__.rsplit('.', 1)[-1]}.py")
        return 0
    wanted = args.suites or list(SUITES)
    unknown = [w for w in wanted if w not in SUITES]
    if unknown:
        print(f"unknown suite(s): {', '.join(unknown)} (--list prints the registry)",
              file=sys.stderr)
        return 2
    print("name,us_per_call,derived", flush=True)
    failed = []
    for name in wanted:
        t0 = time.time()
        try:
            out = SUITES[name].main(suite_argv(name, args.device, args.fused))
        except Exception as e:  # noqa: BLE001 — the other suites run on
            print(f"{name}/ERROR,0.0,{type(e).__name__}:{e}", flush=True)
            failed.append(name)
        else:
            entries = out if isinstance(out, list) else [out]
            if args.out:
                record(args.out, [dict(e, registry_suite=name) for e in entries])
        print(f"{name}/_suite_wall,{(time.time() - t0) * 1e6:.0f},done", flush=True)
    if args.out:
        print(f"# wrote {args.out}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
