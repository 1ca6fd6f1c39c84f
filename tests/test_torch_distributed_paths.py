"""The distributed engine's other paths against the JAX engine, on the CPU.

At 4 ranks, the reference's own cases on their graphs: the fused hot path
against the unfused one (``tests/test_distributed.py``, its interpret-mode
kernel run held against the port's plain versions), ``run_delta`` batch by
batch (``tests/test_streaming.py``) and the chaos matrix's four fault kinds
(``tests/test_chaos.py``). As in ``test_torch_distributed.py``, each side
runs once for the whole file (the JAX engine in one interpreter with 4 host
devices, the port in one ``run_ranks`` group, both at once), and every
count, fired fault and statistic but ``"engine"`` must equal the JAX
engine's, every rank's the same. Also the ``launch/dist_hybrid`` CLI."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.core import distributed as dist_pt
from repro_torch.core.faults import FaultPlan
from repro_torch.core.query import PAPER_QUERIES as Q
from repro_torch.graph import build_graph, powerlaw_graph, ring_of_cliques
from repro_torch.graph.oracle import count_instances
from repro_torch.graph.storage import GraphUpdateBatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
SEED = int(os.environ.get("REPRO_FAULT_SEED", "0"))
FUSED_CASES = (("q1", "huge"), ("q2", "seed"), ("q7", "huge"))
# The reference's interpret-mode run: q2 on ring_of_cliques(4, 5).
INTERPRET_CFG = dict(batch_size=16, queue_capacity=1 << 10, join_buffer_capacity=1 << 9,
                     join_out_capacity=1 << 10, fused=True)
# networkx counts on powerlaw_graph(240, 5.0, seed=3) (q7: about a minute of
# repro_torch.graph.oracle.count_instances) and ring_of_cliques(4, 5).
ORACLE = {"q1": 875, "q2": 352, "q7": 470291, "interpret": 120}
CHAOS = (("queue-overflow", SEED % 3, False), ("shard-loss", SEED % 3, False),
         ("kernel-fail", SEED % 2, True))


def delta_stream():
    """The reference's insert stream: 700 random edges on 200 vertices,
    550 of them the base graph, the rest in three batches."""
    rng = np.random.default_rng(5)
    und = set()
    while len(und) < 700:
        a, b = rng.integers(0, 200, 2)
        if a != b:
            und.add((min(a, b), max(a, b)))
    und = np.array(sorted(und))
    rng.shuffle(und)
    return und[:550], np.array_split(und[550:], 3)


# The reference side (its control flow is the port side's, below, line by line).
JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core import query as Q
from repro.core.distributed import DistributedEngine, DistConfig
from repro.core.faults import FaultPlan
from repro.graph import build_graph, powerlaw_graph, ring_of_cliques
from repro.graph.storage import GraphUpdateBatch

args = json.loads(sys.argv[1])
jax.config.update("jax_compilation_cache_dir", sys.argv[2])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
mesh = Mesh(np.array(jax.devices()[:args["ranks"]]), ("shards",))
base = np.array(args["base"]); chunks = [np.array(c) for c in args["chunks"]]
out = {}

pl = powerlaw_graph(240, 5.0, seed=3)
for qname, space in args["fused_cases"]:
    for fused in (False, True):
        eng = DistributedEngine(pl, mesh, DistConfig(batch_size=128, queue_capacity=1 << 14,
                                                     fused=fused))
        out[f"{qname}/{space}/{fused}"] = eng.run(Q.PAPER_QUERIES[qname], space=space)
out["interpret"] = DistributedEngine(ring_of_cliques(4, 5), mesh, DistConfig(
    force_kernel=True, **args["interpret_cfg"])).run(Q.PAPER_QUERIES["q2"])

for qname in ("q1", "q2"):
    q = Q.PAPER_QUERIES[qname]
    eng = DistributedEngine(build_graph(base, 200), mesh, DistConfig(batch_size=128))
    steps = [eng.run(q)]
    for chunk in chunks:
        applied = eng.apply_updates(GraphUpdateBatch(chunk))
        steps.append([*eng.run_delta(q), applied.num_new_edges])
    steps.append(DistributedEngine(eng.graph, mesh, DistConfig(batch_size=128)).run(q))
    out[f"delta/{qname}"] = steps

g = powerlaw_graph(220, 5.0, seed=4)
for kind, at_step, fused in args["chaos"]:
    fp = FaultPlan.single(kind, at_step=at_step, seed=args["seed"])
    eng = DistributedEngine(g, mesh, DistConfig(batch_size=128, queue_capacity=1 << 14,
                                                faults=fp, recover=True, fused=fused))
    out[f"chaos/{kind}"] = [*eng.run(Q.PAPER_QUERIES["q1"]), fp.fired]
fp = FaultPlan.single("join-overflow", at_step=args["seed"] % 2, seed=args["seed"])
eng = DistributedEngine(g, mesh, DistConfig(batch_size=128, queue_capacity=1 << 14,
                                            join_out_capacity=1 << 18, faults=fp, recover=True))
out["chaos/join-overflow"] = [*eng.run(Q.PAPER_QUERIES["q3"], space="starjoin"), fp.fired]
print(json.dumps(out))
"""


def port_side(comm, base, chunks):
    """Rank body: the same runs as ``JAX_SCRIPT`` through the port."""
    DistConfig, DistributedEngine = dist_pt.DistConfig, dist_pt.DistributedEngine
    dev = comm.device
    out = {}
    pl = powerlaw_graph(240, 5.0, seed=3, device=dev)
    for qname, space in FUSED_CASES:
        for fused in (False, True):
            eng = DistributedEngine(pl, comm, DistConfig(batch_size=128,
                                                         queue_capacity=1 << 14, fused=fused))
            out[f"{qname}/{space}/{fused}"] = eng.run(Q[qname], space=space)
    out["interpret"] = DistributedEngine(ring_of_cliques(4, 5, device=dev), comm,
                                         DistConfig(**INTERPRET_CFG)).run(Q["q2"])

    for qname in ("q1", "q2"):
        q = Q[qname]
        eng = DistributedEngine(build_graph(base, 200, device=dev), comm,
                                DistConfig(batch_size=128))
        steps = [eng.run(q)]
        for chunk in chunks:
            applied = eng.apply_updates(GraphUpdateBatch(chunk))
            steps.append([*eng.run_delta(q), applied.num_new_edges])
        steps.append(DistributedEngine(eng.graph, comm, DistConfig(batch_size=128)).run(q))
        out[f"delta/{qname}"] = steps

    g = powerlaw_graph(220, 5.0, seed=4, device=dev)
    for kind, at_step, fused in CHAOS:
        fp = FaultPlan.single(kind, at_step=at_step, seed=SEED)
        eng = DistributedEngine(g, comm, DistConfig(batch_size=128, queue_capacity=1 << 14,
                                                    faults=fp, recover=True, fused=fused))
        out[f"chaos/{kind}"] = [*eng.run(Q["q1"]), fp.fired]
    fp = FaultPlan.single("join-overflow", at_step=SEED % 2, seed=SEED)
    eng = DistributedEngine(g, comm, DistConfig(batch_size=128, queue_capacity=1 << 14,
                                                join_out_capacity=1 << 18, faults=fp,
                                                recover=True))
    out["chaos/join-overflow"] = [*eng.run(Q["q3"], space="starjoin"), fp.fired]
    # JSON's view, as the reference's results arrive.
    return json.loads(json.dumps(out))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reference")
    base, chunks = delta_stream()
    spec = json.dumps({"ranks": RANKS, "seed": SEED, "fused_cases": FUSED_CASES,
                       "interpret_cfg": INTERPRET_CFG, "chaos": CHAOS,
                       "base": base.tolist(), "chunks": [c.tolist() for c in chunks]})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={RANKS}")
    with open(tmp / "ref.out", "w+") as out, open(tmp / "ref.err", "w+") as err:
        proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, spec, str(tmp / "cache")],
                                env=env, cwd=ROOT, stdout=out, stderr=err, text=True)
        ranks = dist_pt.run_ranks(port_side, RANKS, backend="gloo", device="cpu",
                                  timeout_s=600, args=(base, chunks))
        proc.wait(timeout=600)
        out.seek(0)
        err.seek(0)
        assert proc.returncode == 0, err.read()[-4000:]
        ref = json.loads(out.read().strip().splitlines()[-1])
    for r in ranks[1:]:
        assert r.value == ranks[0].value, f"rank {r.rank} disagrees with rank 0"
    return ref, ranks[0].value


def same_stats(ref_stats, port_stats):
    ref_stats, port_stats = dict(ref_stats), dict(port_stats)
    assert ref_stats.pop("engine") == "shard_map"
    assert port_stats.pop("engine") == "torch.distributed"
    return port_stats == ref_stats


@pytest.mark.parametrize("qname, space", FUSED_CASES, ids=lambda x: x)
def test_fused_equals_unfused_and_reference(both, qname, space):
    ref, port = both
    base_count, base_stats = port[f"{qname}/{space}/False"]
    fused_count, fused_stats = port[f"{qname}/{space}/True"]
    assert base_count == fused_count == ORACLE[qname]
    assert fused_stats == base_stats  # only the intersect differs
    for fused in (False, True):
        key = f"{qname}/{space}/{fused}"
        assert port[key][0] == ref[key][0]
        assert same_stats(ref[key][1], port[key][1]), key


def test_reference_interpret_mode_kernels_equal_plain_versions(both):
    ref, port = both
    assert port["interpret"][0] == ref["interpret"][0] == ORACLE["interpret"]
    assert same_stats(ref["interpret"][1], port["interpret"][1])


@pytest.mark.parametrize("qname", ["q1", "q2"])
def test_run_delta_batch_by_batch_equals_reference(both, qname):
    ref, port = both
    steps, ref_steps = port[f"delta/{qname}"], ref[f"delta/{qname}"]
    assert len(steps) == len(ref_steps) == 5
    for got, want in zip(steps, ref_steps):
        assert got[0] == want[0] and got[2:] == want[2:]
        assert same_stats(want[1], got[1])
    deltas = [s[0] for s in steps[1:-1]]
    assert sum(deltas) == steps[-1][0] - steps[0][0]
    assert all(s[1]["delta_flows"] == len(Q[qname].edges) for s in steps[1:-1])
    base, chunks = delta_stream()
    g = build_graph(np.concatenate([base, *chunks]), 200, device="cpu")
    assert steps[-1][0] == count_instances(g, list(Q[qname].edges))


@pytest.mark.parametrize("kind", ["queue-overflow", "shard-loss", "kernel-fail",
                                  "join-overflow"])
def test_chaos_matrix_equals_reference(both, kind):
    ref, port = both
    count, stats, fired = port[f"chaos/{kind}"]
    ref_count, ref_stats, ref_fired = ref[f"chaos/{kind}"]
    assert len(fired) == 1 and fired == ref_fired
    assert count == ref_count
    oracle = count_instances(powerlaw_graph(220, 5.0, seed=4, device="cpu"),
                             list(Q["q3" if kind == "join-overflow" else "q1"].edges))
    assert count == oracle
    counter = {"queue-overflow": "pressure_events", "shard-loss": "restarts",
               "kernel-fail": "kernel_fallbacks", "join-overflow": "pressure_events"}[kind]
    assert stats[counter] >= 1
    assert same_stats(ref_stats, stats)


def test_dist_hybrid_cli_on_cpu(tmp_path):
    from repro_torch.launch import dist_hybrid

    out = tmp_path / "dist.json"
    entries = dist_hybrid.main(["--ranks", "2", "--vertices", "64", "--device", "cpu",
                                "--out", str(out)])
    runs = [e for e in entries if not e["case"].startswith("eq3/")]
    assert len(runs) == 12 and {e["mode"] for e in runs} == {"fused", "unfused"}
    for qname in ("q1", "q2"):
        g = powerlaw_graph(64, 6.0, seed=7, device="cpu")
        want = count_instances(g, list(Q[qname].edges))
        assert {e["matches"] for e in runs if e["case"].endswith(qname)} == {want}
    assert any(e["joins"] > 0 for e in runs) and any(e["pulled_bytes"] > 0 for e in runs)
    assert all(e["ranks"] == 2 and e["device"] == "cpu" for e in entries)
    assert [e["case"] for e in entries if e["case"].startswith("eq3/")] == ["eq3/q1", "eq3/q2"]
    doc = json.loads(out.read_text())
    assert doc["bench"] == "torch_dist" and len(doc["entries"]) == len(entries)
