"""Seeded known-bad fixtures for flowcheck and the source lint.

Each fixture is a deliberately malformed plan, dataflow or source with the
rule id(s) the analyses must report: the flow and plan fixtures of the JAX
package's ``analysis/fixtures.py``, and in place of its tracer-rule source
fixture two of the port's own: a queue buffer filled with ``INVALID`` and no
int32 dtype (``bad-queue-dtype``), and a kernels directory whose op has
neither its twin nor its card test (``bad-kernel-twins``).
``python -m repro_torch.analysis --fixture <name>`` runs one and exits
nonzero with its rule ids.
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable, Dict, List, Tuple

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.flowcheck import check_flow, check_plan
from repro_torch.analysis.lint import check_kernel_twins, lint_source
from repro_torch.core.dataflow import Dataflow, OpDesc
from repro_torch.core.plan import ExecutionPlan, PlanNode
from repro_torch.core.query import QueryGraph


def _scan(a: int, b: int) -> OpDesc:
    return OpDesc(kind="scan", schema=(a, b), scan_edge=(a, b))


def dangling_sink_flow() -> Dataflow:
    """An extend branch that never reaches the sink: its rows are dropped."""
    return Dataflow(ops=[
        _scan(0, 1),
        OpDesc(kind="extend", schema=(0, 1, 2), inputs=(0,), ext=(0,),
               new_vertex=2, comm="pull"),          # orphan: nothing consumes it
        _scan(0, 2),
        OpDesc(kind="sink", schema=(0, 2), inputs=(2,)),
    ], query_name="fixture-dangling-sink")


def bad_join_key_flow() -> Dataflow:
    """Join keyed on columns that bind different query vertices per side."""
    return Dataflow(ops=[
        _scan(0, 1),
        _scan(1, 2),
        OpDesc(kind="join", comm="push", schema=(0, 1, 2), inputs=(0, 1),
               key_left=(0,),    # binds v0 on the left...
               key_right=(1,),   # ...but v2 on the right
               right_extra=(1,)),
        OpDesc(kind="sink", schema=(0, 1, 2), inputs=(2,)),
    ], query_name="fixture-bad-join-key")


def disconnected_extend_flow() -> Dataflow:
    """Extend with an empty Eq.-2 intersection set: a cross product."""
    return Dataflow(ops=[
        _scan(0, 1),
        OpDesc(kind="extend", schema=(0, 1, 2), inputs=(0,), ext=(),
               new_vertex=2, comm="pull"),
        OpDesc(kind="sink", schema=(0, 1, 2), inputs=(1,)),
    ], query_name="fixture-disconnected-extend")


def pull_join_flow() -> Dataflow:
    """A materialised join in pull mode — illegal per Eq. 3 / §5.2."""
    return Dataflow(ops=[
        _scan(0, 1),
        _scan(1, 2),
        OpDesc(kind="join", comm="pull", schema=(0, 1, 2), inputs=(0, 1),
               key_left=(1,), key_right=(0,), right_extra=(1,)),
        OpDesc(kind="sink", schema=(0, 1, 2), inputs=(2,)),
    ], query_name="fixture-pull-join")


def oversized_queue_flow() -> Dataflow:
    """A wide, join-heavy flow whose preallocated queues overflow any sane
    slot pool once priced (the queue-cell fixture pairs it with a tiny
    ``max_cells`` budget in the runner below)."""
    ops: List[OpDesc] = [_scan(0, 1)]
    schema = (0, 1)
    for v in range(2, 8):
        ops.append(OpDesc(kind="extend", schema=schema + (v,),
                          inputs=(len(ops) - 1,), ext=(0,), new_vertex=v,
                          comm="pull"))
        schema = schema + (v,)
    ops.append(OpDesc(kind="sink", schema=schema, inputs=(len(ops) - 1,)))
    return Dataflow(ops=ops, query_name="fixture-oversized-queues")


def bad_delta_epoch_flow() -> Dataflow:
    """A would-be delta flow seeded from a *full* scan: its 'old'-epoch
    extend silently drops matches (the old/new split only deduplicates
    matches rooted at a Δ-edge), and one epoch tag is misspelled."""
    return Dataflow(ops=[
        _scan(0, 1),                                 # scan_epoch="full"
        OpDesc(kind="extend", schema=(0, 1, 2), inputs=(0,), ext=(0, 1),
               new_vertex=2, comm="pull", ext_epochs=("old", "stale")),
        OpDesc(kind="sink", schema=(0, 1, 2), inputs=(1,)),
    ], query_name="fixture-bad-delta-epoch")


def disconnected_plan() -> ExecutionPlan:
    """Plan whose join unit is a disconnected edge set (extend order leaves
    the matched prefix)."""
    query = QueryGraph.from_edges([(0, 1), (2, 3), (1, 2)], name="fixture-disc")
    root = PlanNode(edges=frozenset({(0, 1), (2, 3)}))
    return ExecutionPlan(query=query, root=root, symmetry_conditions=())


def illegal_eq3_plan() -> ExecutionPlan:
    """(wco, pull) on a join that is not a complete star join (Def. 3.1)."""
    query = QueryGraph.from_edges([(0, 1), (1, 2), (2, 3), (3, 0)], name="fixture-eq3")
    left = PlanNode(edges=frozenset({(0, 1)}))
    right = PlanNode(edges=frozenset({(1, 2), (2, 3), (0, 3)}))
    root = PlanNode(edges=frozenset(query.edges), left=left, right=right,
                    algo="wco", comm="pull")
    return ExecutionPlan(query=query, root=root, symmetry_conditions=())


BAD_QUEUE_SOURCE = '''\
import torch
from repro_torch.graph.storage import INVALID


def make_queue(cap, width, device):
    buf = torch.full((cap, width), INVALID, device=device)   # queue-dtype: int64
    return buf


def make_side_queue(cap, width):
    queue = torch.full((cap, width), fill_value=INVALID, dtype=torch.int64)  # queue-dtype
    return queue
'''

# A kernel op that launches the library, with a ref.py that lacks its twin
# and card tests that never name it.
BAD_KERNEL_OPS = '''\
from repro_torch.kernels.build import CudaLibrary

LIB = CudaLibrary("demo", None, None)


def demo_op(x):
    return LIB.load().demo_launch(x)
'''
BAD_KERNEL_REF = '''\
def other_ref(x):
    return x
'''


def _run_bad_kernel_twins() -> List[Diagnostic]:
    with tempfile.TemporaryDirectory(prefix="repro_torch_fixture_") as tmp:
        pkg = os.path.join(tmp, "kernels", "demo")
        os.makedirs(pkg)
        for fname, text in (("ops.py", BAD_KERNEL_OPS), ("ref.py", BAD_KERNEL_REF)):
            with open(os.path.join(pkg, fname), "w", encoding="utf-8") as f:
                f.write(text)
        tests = os.path.join(tmp, "test_torch_gpu.py")
        with open(tests, "w", encoding="utf-8") as f:
            f.write("def test_other():\n    pass\n")
        return check_kernel_twins(os.path.join(tmp, "kernels"), tests)


# fixture name -> (runner, expected rule ids). A runner returns diagnostics.
FIXTURES: Dict[str, Tuple[Callable[[], List[Diagnostic]], Tuple[str, ...]]] = {
    "dangling-sink": (lambda: check_flow(dangling_sink_flow()), ("orphan-op",)),
    "bad-join-key": (lambda: check_flow(bad_join_key_flow()),
                     ("join-key-incompatible",)),
    "disconnected-extend": (lambda: check_flow(disconnected_extend_flow()),
                            ("ext-disconnected",)),
    "pull-join": (lambda: check_flow(pull_join_flow()), ("comm-illegal",)),
    "oversized-queues": (lambda: _run_oversized(), ("queue-over-pool",)),
    "retry-slack": (lambda: _run_retry_slack(), ("retry-slack",)),
    "bad-delta-epoch": (lambda: check_flow(bad_delta_epoch_flow()),
                        ("epoch-illegal", "epoch-no-delta-scan")),
    "disconnected-plan": (lambda: check_plan(disconnected_plan()),
                          ("subquery-disconnected",)),
    "illegal-eq3": (lambda: check_plan(illegal_eq3_plan()), ("eq3-illegal",)),
    "bad-queue-dtype": (lambda: lint_source(BAD_QUEUE_SOURCE, "fixture.py"), ("queue-dtype",)),
    "bad-kernel-twins": (_run_bad_kernel_twins, ("kernel-ref-missing", "kernel-test-missing")),
}


def _run_oversized() -> List[Diagnostic]:
    from repro_torch.core.engine import EngineConfig

    return check_flow(oversized_queue_flow(), cfg=EngineConfig(), d_pad=64,
                      max_cells=1 << 20)


def _run_retry_slack() -> List[Diagnostic]:
    """A flow that fits its budget at plain pricing but not once the armed
    fault plan doubles the Lemma-5.2 retry slack: the diagnostic must blame
    the recovery headroom (rule ``retry-slack``), not the query size."""
    from repro_torch.core.engine import EngineConfig, flow_queue_cells
    from repro_torch.core.faults import FaultPlan

    flow = oversized_queue_flow()
    ft_cfg = EngineConfig(faults=FaultPlan.single("queue-overflow"),
                          recover=True)
    plain = flow_queue_cells(flow, ft_cfg, 64, None, None,
                             fault_tolerant=False)
    return check_flow(flow, cfg=ft_cfg, d_pad=64, max_cells=plain)


def run_fixture(name: str) -> Tuple[List[Diagnostic], Tuple[str, ...]]:
    runner, expected = FIXTURES[name]
    return runner(), expected
