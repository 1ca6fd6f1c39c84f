"""Command line of the static analyses (the JAX package's
``python -m repro.analysis``, with the same flags and exit codes).

    python -m repro_torch.analysis --all [--baseline FILE]

Passes:
  --flowcheck   verify every paper query x plan space (optimiser -> plan ->
                dataflow -> queue-cell accounting), no execution
  --tracelint   AST lint of src/repro_torch: queue dtype drift, and kernel
                ops without their plain PyTorch twin or card test (the
                tracer rules have no PyTorch meaning)
  --all         both (the default when no pass is selected)

  --baseline F  suppress findings whose keys appear in F (checked-in,
                justified); only *new* error findings fail the run
  --root DIR    source tree to lint (default: the repro_torch package)
  --fixture N   run one seeded known-bad fixture instead (exits nonzero with
                its rule ids; N=list prints the fixture names)
  --list-rules  print the rule catalogue and exit

Exit status: 0 when no new error-severity findings, 1 otherwise (and after
a fixture ran), 2 on usage errors or a fixture whose rules did not fire.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

from repro_torch.analysis.diagnostics import (
    Diagnostic,
    format_diagnostics,
    load_baseline,
    split_baselined,
)

RULES = {
    # flowcheck — dataflow
    "dag-order": "op inputs must precede the op (topological emission order)",
    "dag-cycle": "op is its own ancestor; a join barrier over it deadlocks",
    "op-kind": "unknown operator kind",
    "op-arity": "wrong number of inputs for the operator kind",
    "no-sink": "dataflow lacks a sink operator",
    "sink-consumed": "an op reads a sink's output",
    "orphan-op": "op never reaches a sink; its results are silently dropped",
    "schema-scan": "scan schema does not match its edge",
    "schema-extend": "extend schema is not input schema + new vertex",
    "schema-verify": "verify must preserve its input schema / verify_pos bounds",
    "schema-dup": "schema matches a query vertex twice (injectivity broken)",
    "ext-disconnected": "extend/verify with empty Eq.-2 set (cross product)",
    "ext-bounds": "ext position outside the input schema",
    "filter-bounds": "lt/gt order-filter column does not exist",
    "join-key-empty": "join with an empty key (cross product)",
    "join-key-incompatible": "join key binds different query vertices per side",
    "join-schema": "join output schema is not left + right_extra",
    "join-cross-bounds": "cross filter indexes outside the output schema",
    "comm-illegal": "op comm mode illegal per Eq. 3 (§5.2 rewrites pull joins)",
    "epoch-illegal": "bad scan_epoch/ext_epochs tag, or epoch on the wrong op kind",
    "epoch-no-delta-scan": "'old'-epoch probe without a delta-seeded ancestor scan",
    "queue-over-pool": "queue plan exceeds the Theorem-5.4 / slot-pool budget",
    "retry-slack": "queue plan fits only without the armed fault plan's retry slack",
    # flowcheck — plan/query
    "query-empty": "query has no edges",
    "query-vertex-gap": "query vertex numbering is not dense",
    "query-disconnected": "query graph is disconnected",
    "query-self-loop": "query has a self loop",
    "plan-cover": "plan root does not cover the query's edge set",
    "plan-empty-node": "plan node with an empty sub-query",
    "subquery-disconnected": "plan node's sub-query is disconnected",
    "join-children": "join node's children do not partition its edges",
    "eq3-illegal": "join (algo, comm) not legal per Eq. 3",
    "symmetry-unknown": "symmetry condition references unknown vertices",
    "plan-failure": "optimiser crashed on a corpus case",
    "translate-failure": "plan translation crashed on a corpus case",
    # source lint
    "queue-dtype": "non-int32 dtype flowing into an INVALID-filled queue buffer",
    "kernel-ref-missing": "kernel op lacks its plain PyTorch ref twin",
    "kernel-test-missing": "kernel op not named by tests/test_torch_gpu.py",
}


def _src_root() -> str:
    import repro_torch

    return os.path.dirname(os.path.abspath(repro_torch.__file__))


def _tests_file() -> str:
    repo = os.path.dirname(os.path.dirname(_src_root()))
    return os.path.join(repo, "tests", "test_torch_gpu.py")


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--flowcheck", action="store_true")
    ap.add_argument("--tracelint", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--baseline", metavar="FILE", default=None)
    ap.add_argument("--root", metavar="DIR", default=None,
                    help="source tree to lint (default: the repro_torch package)")
    ap.add_argument("--fixture", metavar="NAME", default=None)
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule:24s} {desc}")
        return 0

    if args.fixture is not None:
        from repro_torch.analysis.fixtures import FIXTURES, run_fixture

        if args.fixture == "list" or args.fixture not in FIXTURES:
            print("fixtures:", ", ".join(sorted(FIXTURES)))
            return 0 if args.fixture == "list" else 2
        diags, expected = run_fixture(args.fixture)
        print(format_diagnostics(diags))
        fired = {d.rule for d in diags}
        missing = [r for r in expected if r not in fired]
        if missing:
            print(f"FIXTURE BROKEN: expected rule(s) {missing} did not fire")
            return 2
        print(f"fixture {args.fixture!r}: expected rule(s) {list(expected)} fired")
        return 1  # a fixture run is supposed to find problems

    run_flow = args.flowcheck or args.all or not (args.flowcheck or args.tracelint)
    run_lint = args.tracelint or args.all or not (args.flowcheck or args.tracelint)

    findings: List[Diagnostic] = []
    if run_flow:
        from repro_torch.analysis.corpus import corpus_cases, corpus_findings

        flow_findings = corpus_findings()
        findings.extend(flow_findings)
        print(f"flowcheck: {len(corpus_cases())} query×space cases, "
              f"{len(flow_findings)} finding(s)")
    if run_lint:
        from repro_torch.analysis.lint import lint_tree

        root = args.root or _src_root()
        lint_findings = lint_tree(root, _tests_file())
        findings.extend(lint_findings)
        print(f"tracelint: scanned {root}, {len(lint_findings)} finding(s)")

    baseline = load_baseline(args.baseline) if args.baseline else {}
    new, suppressed = split_baselined(findings, baseline)
    if suppressed:
        print(f"baseline: suppressed {len(suppressed)} known finding(s)")
    stale = sorted(set(baseline) - {d.key() for d in findings})
    if stale:
        print(f"baseline: {len(stale)} stale entr(y/ies) no longer firing "
              f"(prune them): {', '.join(stale)}")
    new_errors = [d for d in new if d.severity == "error"]
    if new:
        print(format_diagnostics(new))
    print(f"result: {len(new_errors)} new error(s), "
          f"{len(new) - len(new_errors)} new warning(s)")
    return 1 if new_errors else 0


if __name__ == "__main__":
    sys.exit(main())
