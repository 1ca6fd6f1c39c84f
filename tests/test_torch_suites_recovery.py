"""The port's chaos and streaming suites against the JAX package's, on the
CPU.

The reference's ``main()`` runs on ``powerlaw_graph(256, 5.0, seed=3)``
with its looked-up names wrapped (``suite_parity``; ``record_bench`` is
stubbed, so the repo's ``BENCH_chaos.json`` and ``BENCH_streaming.json`` are
not written), and the port's runner on the same graph: row names in order,
every engine run's deterministic fields (warm-up, baseline and recovered
runs; every delta and full re-enumeration) and the recorded entries' fired
faults, recovery counters and new matches must be equal.
"""
import pytest
import torch

from repro.graph import generators as gen_ref
from repro_torch.graph import generators as gen_pt
from suite_parity import assert_parity, port, reference

G = (256, 5.0, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def graphs():
    n, deg, seed = G
    return (gen_ref.powerlaw_graph(n, deg, seed=seed),
            gen_pt.powerlaw_graph(n, deg, seed=seed, device="cpu"))


def test_chaos_matches_the_reference(monkeypatch, graphs):
    g_ref, g_pt = graphs
    ref = reference(monkeypatch, "exp_chaos", g_ref, ["--queries", "q1"])
    got = port(monkeypatch, "exp_chaos", lambda mod: mod.chaos(g_pt, ["q1"]))
    assert_parity(ref, got)
    keys = ("case", "mode", "matches", "seed", "retries", "restarts", "pressure_events",
            "kernel_fallbacks")
    assert [{k: e[k] for k in keys} for e in got.entries] == \
        [{k: e[k] for k in keys} for e in ref.recorded]
    by = {e["case"]: e for e in got.entries}
    assert by["q1_kernel-fail"]["kernel_fallbacks"] == 1 and by["q1_kernel-fail"]["fused"]
    assert by["q1_shard-loss"]["restarts"] == 1
    assert by["q1_queue-overflow"]["pressure_events"] == 1
    assert all(e["baseline"]["matches"] == e["matches"] == 1268 for e in got.entries)


def test_streaming_matches_the_reference(monkeypatch, graphs):
    g_ref, g_pt = graphs
    ref = reference(monkeypatch, "exp_streaming", g_ref,
                    ["--vertices", "256", "--queries", "q1", "--batch-edges", "8",
                     "--batches", "2"])
    got = port(monkeypatch, "exp_streaming",
               lambda mod: mod.streaming(g_pt, ["q1"], [8], 2))
    assert_parity(ref, got)
    keys = ("case", "query", "batch_edges", "batches", "vertices", "new_matches")
    assert [{k: e[k] for k in keys} for e in got.entries] == \
        [{k: e[k] for k in keys} for e in ref.recorded]
    e = got.entries[0]
    assert e["new_matches"] == sum(d["matches"] for d in e["deltas"]) > 0
    assert len(e["fulls"]) == 2


def test_chaos_and_streaming_run_fused(graphs):
    """``--fused`` runs every session on the fused path; the counts and the
    recovery counters stay the plain runs'."""
    from repro_torch.launch import exp_chaos, exp_streaming

    g_pt = graphs[1]
    rows = exp_chaos.chaos(g_pt, ["q3"], fused=True)
    assert all(r["fused"] and r["matches"] == 29 for r in rows)
    assert [r["kernel_fallbacks"] for r in rows] == [0, 0, 1]
    plain = exp_streaming.streaming(g_pt, ["q3"], [8], 1)
    fused = exp_streaming.streaming(g_pt, ["q3"], [8], 1, fused=True)
    assert fused[0]["new_matches"] == plain[0]["new_matches"]
    assert fused[0]["deltas"] == plain[0]["deltas"]
