"""Harness of the paper-suite parity tests (numpy, torch and both packages).

``reference`` runs a JAX suite's own ``main()`` with the names it looks up
wrapped by pytest's ``monkeypatch``: ``bench_graph`` returns the test's
graph, ``emit`` records the row names, ``record_bench`` records the entries
instead of writing the repo's ``BENCH_*.json``, and ``run_query`` and
``HugeEngine`` record the deterministic fields of every engine run in call
order. ``port`` wraps the same names of the port's runner module and calls
its function. The wrappers last for the one call; nothing of either package
changes on disk.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, List

from repro_torch.launch.common import fields

# The deterministic fields an entry carries (``common.fields``' keys).
DETERMINISTIC = ("matches", "pulled_bytes", "pushed_bytes", "cache_hits", "cache_misses",
                 "peak_queue_rows", "peak_queue_bytes", "steps", "yields_full",
                 "per_machine_rows", "retries", "restarts", "pressure_events",
                 "kernel_fallbacks")


@dataclasses.dataclass
class Capture:
    rows: List[str] = dataclasses.field(default_factory=list)
    runs: List[dict] = dataclasses.field(default_factory=list)
    recorded: List[dict] = dataclasses.field(default_factory=list)
    entries: List[dict] = dataclasses.field(default_factory=list)


def _counting_engine(cls, runs: List[dict]):
    class Counted(cls):
        def run(self, *args, **kwargs):
            res = super().run(*args, **kwargs)
            runs.append(fields(res))
            return res

        def run_delta(self, *args, **kwargs):
            res = super().run_delta(*args, **kwargs)
            runs.append(fields(res))
            return res

    return Counted


def _wrap(monkeypatch, mod, cap: Capture) -> None:
    monkeypatch.setattr(mod, "emit", lambda name, us, derived: cap.rows.append(name))
    if hasattr(mod, "run_query"):
        run_query = mod.run_query

        def counted(*args, **kwargs):
            res = run_query(*args, **kwargs)
            cap.runs.append(fields(res))
            return res

        monkeypatch.setattr(mod, "run_query", counted)
    if hasattr(mod, "HugeEngine"):
        monkeypatch.setattr(mod, "HugeEngine", _counting_engine(mod.HugeEngine, cap.runs))


def reference(monkeypatch, name: str, graph, argv=None) -> Capture:
    """Run ``benchmarks.<name>.main`` on ``graph``."""
    mod = importlib.import_module(f"benchmarks.{name}")
    cap = Capture()
    with monkeypatch.context() as mp:
        _wrap(mp, mod, cap)
        mp.setattr(mod, "bench_graph", lambda *args, **kwargs: graph)
        if hasattr(mod, "record_bench"):
            mp.setattr(mod, "record_bench", lambda bench, entries: cap.recorded.extend(entries))
        if argv is None:
            mod.main()
        else:
            mod.main(argv)
    return cap


def port(monkeypatch, name: str, call: Callable) -> Capture:
    """Call ``call(module)`` for ``repro_torch.launch.<name>``; its entries
    land in ``entries``."""
    mod = importlib.import_module(f"repro_torch.launch.{name}")
    cap = Capture()
    with monkeypatch.context() as mp:
        _wrap(mp, mod, cap)
        cap.entries = call(mod)
    return cap


def assert_parity(ref: Capture, got: Capture) -> None:
    """Row names in order, every engine run's deterministic fields in order,
    and each port entry's fields among the port's runs."""
    assert got.rows == ref.rows
    assert len(got.runs) == len(ref.runs) > 0
    for i, (a, b) in enumerate(zip(got.runs, ref.runs)):
        assert a == b, f"run {i}: port {a} != reference {b}"
    names = [e["name"] for e in got.entries]
    assert len(set(names)) == len(names)
    for n in names:  # a row's name, or the stem of its rows (streaming's delta/full)
        assert any(r == n or r.startswith(n + "/") for r in got.rows), n
    for e in got.entries:
        if "matches" in e:
            assert {k: e[k] for k in DETERMINISTIC} in got.runs, e["name"]
        assert e["device"] == "cpu" and e["power_limit"] is None
