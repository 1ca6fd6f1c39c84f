"""The port's analysis command line, source lint, enumeration config and
examples, against the JAX package's on the CPU.

``python -m repro_torch.analysis`` keeps ``python -m repro.analysis``'s
flags, exit codes (0 clean, 1 on a new error or after a fixture ran, 2 on a
usage error or a broken fixture), its baseline handling with the stale-entry
report, and its ``--list-rules``/``--fixture list`` output for the rules and
fixtures both packages have. Its source lint keeps the rules with a PyTorch
meaning; the port's tree passes ``--all`` with no baseline.
"""
import dataclasses
import importlib.util
import os

import pytest

from repro.analysis import __main__ as cli_ref
from repro.analysis import tracelint
from repro.configs import huge_enum as enum_ref
import repro.configs as configs_ref
from repro_torch.analysis import __main__ as cli_pt
from repro_torch.analysis import fixtures as fixtures_pt
from repro_torch.analysis import lint
import repro_torch.configs as configs_pt
from repro_torch.configs import huge_enum as enum_pt
from repro_torch.core.query import PAPER_QUERIES, clique
from repro_torch.graph import powerlaw_graph
from repro_torch.graph.oracle import count_instances

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "analysis", "baseline.txt")
# Rules whose description names each package's own twin and test file.
KERNEL_RULES = ("kernel-ref-missing", "kernel-test-missing")


def run(cli, argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


def test_list_rules_match_the_reference(capsys):
    rc_pt, out_pt = run(cli_pt, ["--list-rules"], capsys)
    rc_ref, out_ref = run(cli_ref, ["--list-rules"], capsys)
    assert rc_pt == rc_ref == 0
    lines_pt = {line.split()[0]: line for line in out_pt.splitlines()}
    lines_ref = {line.split()[0]: line for line in out_ref.splitlines()}
    assert set(lines_ref) - set(lines_pt) == {"host-sync", "traced-branch"}
    for rule in set(lines_ref) & set(lines_pt):
        if rule not in KERNEL_RULES:
            assert lines_pt[rule] == lines_ref[rule]
    assert set(KERNEL_RULES) | {"queue-dtype", "retry-slack"} <= set(lines_pt)
    assert list(lines_pt) == sorted(lines_pt)


def test_fixture_list_and_exit_codes_match_the_reference(capsys):
    rc_pt, out_pt = run(cli_pt, ["--fixture", "list"], capsys)
    rc_ref, out_ref = run(cli_ref, ["--fixture", "list"], capsys)
    assert rc_pt == rc_ref == 0
    names_pt = out_pt.strip().removeprefix("fixtures: ").split(", ")
    names_ref = out_ref.strip().removeprefix("fixtures: ").split(", ")
    assert names_pt == sorted(fixtures_pt.FIXTURES)
    assert [n for n in names_ref if n in names_pt] == [n for n in names_pt if n in names_ref]
    assert run(cli_pt, ["--fixture", "nope"], capsys)[0] == run(cli_ref, ["--fixture", "nope"],
                                                                 capsys)[0] == 2
    for name in ("pull-join", "retry-slack"):
        rc_pt, out_pt = run(cli_pt, ["--fixture", name], capsys)
        rc_ref, out_ref = run(cli_ref, ["--fixture", name], capsys)
        assert rc_pt == rc_ref == 1 and out_pt == out_ref
    for cli in (cli_pt, cli_ref):
        with pytest.raises(SystemExit) as ei:
            cli.main(["--no-such-flag"])
        assert ei.value.code == 2


@pytest.mark.parametrize("name", sorted(fixtures_pt.FIXTURES))
def test_every_fixture_fires_its_rules(capsys, name):
    rc, out = run(cli_pt, ["--fixture", name], capsys)
    _, expected = fixtures_pt.FIXTURES[name]
    assert rc == 1 and f"expected rule(s) {list(expected)} fired" in out
    for rule in expected:
        assert f"error: {rule} [" in out or f"warning: {rule} [" in out


def test_broken_fixture_exits_2(monkeypatch, capsys):
    runner, _ = fixtures_pt.FIXTURES["bad-queue-dtype"]
    monkeypatch.setitem(fixtures_pt.FIXTURES, "bad-queue-dtype", (runner, ("orphan-op",)))
    rc, out = run(cli_pt, ["--fixture", "bad-queue-dtype"], capsys)
    assert rc == 2 and "FIXTURE BROKEN: expected rule(s) ['orphan-op'] did not fire" in out


def test_all_passes_on_the_ports_tree(capsys):
    rc, out = run(cli_pt, ["--all"], capsys)
    assert rc == 0, out
    assert "flowcheck: 64 query×space cases, 0 finding(s)" in out
    assert "tracelint: scanned" in out and "result: 0 new error(s), 0 new warning(s)" in out
    assert run(cli_pt, ["--flowcheck"], capsys)[0] == 0
    rc, out = run(cli_pt, ["--tracelint"], capsys)
    assert rc == 0 and "flowcheck:" not in out


def test_baseline_suppresses_and_reports_stale_entries(tmp_path, capsys):
    """A finding listed in the baseline is suppressed (exit 0), an unlisted
    one fails (exit 1), and a listed key that no longer fires is reported
    stale, as the reference does; the reference's own baseline names a JAX
    file, so on the port's tree its one entry is stale."""
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "queues.py").write_text(fixtures_pt.BAD_QUEUE_SOURCE)
    rc, out = run(cli_pt, ["--tracelint", "--root", str(tree)], capsys)
    assert rc == 1 and "result: 2 new error(s)" in out
    base = tmp_path / "baseline.txt"
    base.write_text("queue-dtype|queues.py::make_queue::buf  # justified\n"
                    "queue-dtype|queues.py::gone::buf  # fixed since\n")
    rc, out = run(cli_pt, ["--tracelint", "--root", str(tree), "--baseline", str(base)], capsys)
    assert rc == 1 and "baseline: suppressed 1 known finding(s)" in out
    assert "(prune them): queue-dtype|queues.py::gone::buf" in out
    rc, out = run(cli_pt, ["--all", "--baseline", BASELINE], capsys)
    rc_ref, out_ref = run(cli_ref, ["--all", "--baseline", BASELINE], capsys)
    assert rc == rc_ref == 0
    assert "baseline: 1 stale entr(y/ies) no longer firing (prune them): kernel-ref-missing|" \
           "kernels/flash_attention/flash_attention.py::flash_attention_kernel::ref" in out


def test_queue_dtype_rule_matches_the_reference():
    """The same buffers, written for each package, fire at the same keys."""
    src_pt = ("def f(cap, w):\n"
              "    buf = torch.full((cap, w), INVALID)\n"
              "    queue = torch.full((cap, w), INVALID, dtype=torch.int64)\n"
              "    ok_buf = torch.full((cap, w), INVALID, dtype=torch.int32)\n"
              "    other = torch.full((cap, w), INVALID)\n")
    src_ref = src_pt.replace("torch.full", "jnp.full").replace("torch.int", "jnp.int")
    got = lint.lint_source(src_pt, "m.py")
    want = tracelint.lint_source(src_ref, "m.py")
    assert [d.key() for d in got] == [d.key() for d in want] == [
        "queue-dtype|m.py::f::buf", "queue-dtype|m.py::f::queue"]


def test_kernel_twin_rule_covers_every_kernel_op():
    kernels = os.path.join(ROOT, "src", "repro_torch", "kernels")
    ops = {name: lint.kernel_ops(os.path.join(kernels, name, "ops.py"))
           for name in ("intersect", "rwkv6", "flash_attention", "ssm_scan")}
    assert ops == {"intersect": ["multiway_membership", "fused_extend", "fused_verify",
                                 "lex_bounds"],
                   "rwkv6": ["rwkv6", "rwkv6_bwd"],
                   "flash_attention": ["attention", "attention_bwd"],
                   "ssm_scan": ["ssm_scan", "ssm_scan_bwd"]}
    tests = os.path.join(ROOT, "tests", "test_torch_gpu.py")
    assert lint.check_kernel_twins(kernels, tests) == []
    diags, _ = fixtures_pt.run_fixture("bad-kernel-twins")
    assert [d.key() for d in diags] == ["kernel-ref-missing|kernels/demo/ops.py::demo_op::ref",
                                        "kernel-test-missing|kernels/demo/ops.py::demo_op::test"]


def test_enum_config_equals_the_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(enum_pt.EnumConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(enum_ref.EnumConfig)]
    assert dataclasses.asdict(enum_pt.smoke()) == dataclasses.asdict(enum_ref.smoke())
    assert dataclasses.asdict(enum_pt.config().scaled(query="q3")) == \
        dataclasses.asdict(enum_ref.config().scaled(query="q3"))
    assert configs_pt.get_config("huge-enum") == enum_pt.EnumConfig()
    assert configs_pt.smoke_config("huge-enum") == enum_pt.smoke()
    assert "huge-enum" in configs_pt.ARCH_MODULES and "huge-enum" not in configs_pt.ARCH_NAMES


def test_all_cells_equal_the_references_on_the_ports_architectures():
    """The port registers every architecture of the reference, so its grid
    is the reference's whole 40-cell grid, in the reference's order."""
    mine = list(configs_pt.all_cells())
    assert configs_pt.ARCH_NAMES == configs_ref.ARCH_NAMES
    assert mine == list(configs_ref.all_cells()) and len(mine) == 40
    for arch, shape, _ in mine:
        assert configs_pt.shape_skip_reason(arch, shape) == \
            configs_ref.shape_skip_reason(arch, shape)


def _example(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_run_on_the_cpu(capsys):
    g = powerlaw_graph(256, 6.0, seed=0, device="cpu")
    counts = _example("torch_quickstart").main(["--device", "cpu", "--vertices", "256"])
    assert counts == {"square": count_instances(g, list(PAPER_QUERIES["q1"].edges)),
                      "4-clique": count_instances(g, list(clique(4).edges))}
    out = capsys.readouterr().out
    assert out.startswith("graph: |V|=256") and "4-clique" in out
    counts = _example("torch_compare_plans").main(["--device", "cpu", "--vertices", "128",
                                                   "--query", "q3"])
    g = powerlaw_graph(128, 8.0, seed=7, device="cpu")
    assert set(counts) == {"starjoin", "seed", "bigjoin", "benu", "rads", "huge"}
    assert set(counts.values()) == {count_instances(g, list(PAPER_QUERIES["q3"].edges))}
