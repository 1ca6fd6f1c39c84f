"""The port's plan-space suites against the JAX package's, on the CPU:
Table 1 (communication modes), Exp-1 (plugged-in plans), Exp-9 (hybrid
plans) and Exp-10 (machine count), and the registry that runs them all.

Each reference suite's ``main()`` runs on a small graph with its looked-up
names wrapped (``suite_parity``); the port's runner runs on the same graph.
Row names in order, and every engine run's deterministic fields (counts,
bytes, cache hits and misses, peak queues, steps, result rows per machine,
recovery counters) must be equal; times are never compared.
"""
import json
import os

import pytest
import torch

import benchmarks.run as bench_run
from repro.graph import generators as gen_ref
from repro_torch.graph import generators as gen_pt
from repro_torch.launch import run as run_pt
from suite_parity import assert_parity, port, reference

G = (256, 5.0, 3)      # powerlaw_graph: q1 1268, q2 819, q3 29
G_EXP9 = (64, 4.0, 3)  # q7 and q8 at every plan space within seconds


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def graphs(args):
    n, deg, seed = args
    return (gen_ref.powerlaw_graph(n, deg, seed=seed),
            gen_pt.powerlaw_graph(n, deg, seed=seed, device="cpu"))


@pytest.mark.parametrize("name, fn, graph", [
    ("table1_comm_modes", "table1", G),
    ("exp1_plugin_plans", "exp1", G),
    ("exp10_scaling", "exp10", G),
    ("exp9_plans", "exp9", G_EXP9),
])
def test_suite_matches_the_reference(monkeypatch, name, fn, graph):
    g_ref, g_pt = graphs(graph)
    ref = reference(monkeypatch, name, g_ref)
    got = port(monkeypatch, name, lambda mod: getattr(mod, fn)(g_pt))
    assert_parity(ref, got)
    counts = {e["matches"] for e in got.entries if "matches" in e and e["name"].endswith("q1")}
    if graph == G:
        assert counts == {1268}
    by = {e["name"]: e for e in got.entries}
    if fn == "table1":  # HUGE's byte ratio against the better push system
        huge, push = by["table1/HUGE/q1"], [by["table1/SEED/q1"], by["table1/BiGJoin/q1"]]
        want = min(p["pulled_bytes"] + p["pushed_bytes"] for p in push) / (
            huge["pulled_bytes"] + huge["pushed_bytes"])
        assert by["table1/summary"]["huge_comm_vs_best_push"] == pytest.approx(want)
    if fn == "exp1":  # each row carries its native run, the run before it
        assert len(got.entries) == 8
        for i, e in enumerate(got.entries):
            native = {k: v for k, v in e["native"].items() if k != "wall_s"}
            assert native == got.runs[2 * i] and native["matches"] == e["matches"]


def test_registry_keys_equal_the_reference():
    assert set(run_pt.SUITES) == set(bench_run.SUITES)
    assert list(run_pt.SUITES) == list(bench_run.SUITES)
    assert run_pt.registry_problems() == []


def test_registry_lists_and_refuses_unknown_suites(capsys):
    assert run_pt.main(["--list"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == list(bench_run.SUITES)
    assert "repro_torch/launch/exp6_cache_design.py" in out[4]
    assert run_pt.main(["exp6", "nope"]) == 2
    assert "unknown suite(s): nope" in capsys.readouterr().err


def test_registry_refuses_an_unregistered_or_twice_registered_module(monkeypatch, capsys,
                                                                     tmp_path):
    suites = dict(run_pt.SUITES)
    monkeypatch.setattr(run_pt, "SUITES", {k: v for k, v in suites.items() if k != "exp7"})
    assert run_pt.main(["--list"]) == 2
    assert "exp7_scheduling.py is not registered" in capsys.readouterr().err
    monkeypatch.setattr(run_pt, "SUITES", {**suites, "exp6b": suites["exp6"]})
    assert run_pt.main(["--list"]) == 2
    assert "exp6_cache_design.py is registered 2 times" in capsys.readouterr().err
    monkeypatch.setattr(run_pt, "SUITES", suites)
    launch = os.path.dirname(run_pt.__file__)
    for f in os.listdir(launch):
        if f.endswith(".py"):
            (tmp_path / f).write_text("")
    assert run_pt.registry_problems(str(tmp_path)) == []
    (tmp_path / "exp11_new.py").write_text("")
    assert run_pt.registry_problems(str(tmp_path)) == [
        "repro_torch/launch/exp11_new.py is not registered in SUITES"]
    (tmp_path / "exp1_plugin_plans.py").unlink()
    assert "SUITES entry 'exp1_plugin_plans' has no repro_torch/launch/exp1_plugin_plans.py" \
        in run_pt.registry_problems(str(tmp_path))


def test_registry_runs_a_suite_and_records_it(monkeypatch, capsys, tmp_path):
    """``--out`` appends the suites' entries to one file, stamped with the
    git revision and the flowcheck's count; a failing suite prints its ERROR
    row, the next suite runs, and the status is 1."""
    from repro_torch.launch import exp6_cache_design

    real = exp6_cache_design.main

    def small(argv):
        return real(argv + ["--vertices", "128", "--avg-degree", "4.0", "--seed", "3"])

    def broken(argv):
        raise RuntimeError("boom")

    monkeypatch.setattr(exp6_cache_design, "main", small)
    monkeypatch.setattr(run_pt.SUITES["exp7"], "main", broken)
    out = tmp_path / "paper.json"
    assert run_pt.main(["exp7", "exp6", "--device", "cpu", "--out", str(out)]) == 1
    text = capsys.readouterr().out
    assert "exp7/ERROR,0.0,RuntimeError:boom" in text and "exp6/lru/q3," in text
    doc = json.loads(out.read_text())
    assert doc["bench"] == "torch_paper" and len(doc["entries"]) == 9
    for e in doc["entries"]:
        assert e["registry_suite"] == "exp6" and e["device"] == "cpu"
        assert e["flowcheck_rules"] == 0 and e["git"] and e["recorded"]
    assert run_pt.suite_argv("table4", "cuda", True) == ["--device", "cuda"]
    assert run_pt.suite_argv("exp6", "cpu", True) == ["--device", "cpu", "--fused"]
