"""Structured findings of the static analyses (the JAX package's
``analysis/diagnostics.py``, unchanged).

A :class:`Diagnostic` is the unit every consumer (engine pre-flight, service
admission, a CLI, CI) agrees on: a stable rule id, a severity, a location (op
index for plan/dataflow findings, a ``path::qualname::symbol`` triple for
source findings), a human message, and a fix hint. Locations deliberately
exclude line numbers so baseline entries survive unrelated edits.

Baseline file format (``analysis/baseline.txt``), one finding key per line::

    rule|where        # one-line justification (required)

Lines starting with ``#`` and blank lines are ignored. ``split_baselined``
partitions findings into (new, suppressed); only *new* error-severity
findings fail a run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    rule: str                       # stable rule id, e.g. "join-key-incompatible"
    message: str
    severity: str = ERROR           # "error" | "warning"
    where: str = ""                 # source findings: "path::qualname::symbol"
    op_index: Optional[int] = None  # plan/dataflow findings: offending op
    hint: str = ""                  # how to fix it

    def key(self) -> str:
        """Stable identity used for baseline matching (no line numbers)."""
        loc = self.where if self.where else (
            f"op[{self.op_index}]" if self.op_index is not None else "-"
        )
        return f"{self.rule}|{loc}"

    def format(self) -> str:
        loc = self.where or (
            f"op[{self.op_index}]" if self.op_index is not None else ""
        )
        parts = [f"{self.severity}: {self.rule}"]
        if loc:
            parts.append(f"[{loc}]")
        parts.append(self.message)
        if self.hint:
            parts.append(f"(fix: {self.hint})")
        return " ".join(parts)


class FlowcheckError(ValueError):
    """Raised by the mandatory engine/service pre-flight when a plan or
    dataflow fails static verification. Carries the structured diagnostics so
    callers (e.g. ``GraphService`` admission) can reject with the rule ids
    instead of a stringly-typed error."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics: Tuple[Diagnostic, ...] = tuple(diagnostics)
        super().__init__(
            "flowcheck failed: "
            + "; ".join(d.format() for d in self.diagnostics)
        )


def errors(diags: Iterable[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def format_diagnostics(diags: Iterable[Diagnostic]) -> str:
    return "\n".join(d.format() for d in diags)


def load_baseline(path: str) -> Dict[str, str]:
    """Parse a baseline file into ``{finding_key: justification}``. Every
    entry must carry a justification comment — an unjustified suppression is
    itself rejected (the baseline is a reviewed artifact, not a mute list)."""
    entries: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            key, sep, why = line.partition("#")
            key = key.strip()
            why = why.strip()
            if "|" not in key:
                raise ValueError(
                    f"{path}:{lineno}: malformed baseline key {key!r} "
                    "(expected 'rule|where  # justification')"
                )
            if not sep or not why:
                raise ValueError(
                    f"{path}:{lineno}: baseline entry {key!r} lacks a "
                    "justification comment"
                )
            entries[key] = why
    return entries


def split_baselined(
    diags: Sequence[Diagnostic], baseline: Dict[str, str]
) -> Tuple[List[Diagnostic], List[Diagnostic]]:
    """Partition findings into ``(new, suppressed)`` by baseline key."""
    new: List[Diagnostic] = []
    suppressed: List[Diagnostic] = []
    for d in diags:
        (suppressed if d.key() in baseline else new).append(d)
    return new, suppressed
