"""Static analysis of plans, dataflows and the port's source: flowcheck and
the source lint.

:mod:`repro_torch.analysis.flowcheck` verifies ``ExecutionPlan`` and
``Dataflow`` values without executing them: DAG well-formedness, per-op
schema propagation, Eq.-3 comm-mode legality, extend-order connectivity,
delta epochs, and Theorem-5.4 queue-cell accounting. ``HugeEngine.prepare``
runs it as a mandatory pre-flight, so a malformed query is rejected with a
structured :class:`Diagnostic` before anything runs on the device. The rules
are the JAX package's. Of its source lint (tracelint), the tracer rules
(``host-sync``, ``traced-branch``) have no PyTorch meaning and are not
ported; :mod:`repro_torch.analysis.lint` keeps ``queue-dtype`` and the kernel
twin rules.

CLI: ``python -m repro_torch.analysis --all [--baseline FILE]``.
"""
from __future__ import annotations

from repro_torch.analysis.diagnostics import (
    Diagnostic,
    FlowcheckError,
    format_diagnostics,
    load_baseline,
    split_baselined,
)
from repro_torch.analysis.flowcheck import (
    check_flow,
    check_plan,
    check_query,
    verify_flow,
)

__all__ = [
    "Diagnostic",
    "FlowcheckError",
    "check_flow",
    "check_plan",
    "check_query",
    "verify_flow",
    "format_diagnostics",
    "load_baseline",
    "split_baselined",
    "clean_tree_flowcheck",
]


def clean_tree_flowcheck():
    """Flowcheck every paper query under every plan space (the clean-tree
    corpus). Returns the list of diagnostics, expected empty on a healthy
    tree."""
    from repro_torch.analysis.corpus import corpus_findings

    return corpus_findings()
