"""The PyTorch port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports ``jax``, ``repro``, ``benchmarks`` or ``ml_dtypes`` (the machine
with the card has none), and its entry points refuse to run silently on the CPU when the
caller did not ask for it."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _port_modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return sorted(names)


def test_port_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.core.engine" in mods and "repro_torch.kernels.intersect.ops" in mods
    for m in ("repro_torch.kernels.rwkv6.ops", "repro_torch.kernels.flash_attention.ops",
              "repro_torch.configs.granite_3_8b", "repro_torch.kernels.build",
              "repro_torch.models.transformer", "repro_torch.models.convert",
              "repro_torch.serve.engine", "repro_torch.launch.serve", "repro_torch.configs",
              "repro_torch.analysis", "repro_torch.analysis.diagnostics",
              "repro_torch.analysis.flowcheck", "repro_torch.analysis.fixtures",
              "repro_torch.analysis.corpus", "repro_torch.core.paths",
              "repro_torch.core.hybrid_comm", "repro_torch.core.faults",
              "repro_torch.launch.table4", "repro_torch.serve.graph_service",
              "repro_torch.launch.service_load", "repro_torch.core.distributed",
              "repro_torch.graph.partition", "repro_torch.launch.dist_hybrid",
              "repro_torch.launch.common", "repro_torch.launch.run",
              "repro_torch.launch.table1_comm_modes", "repro_torch.launch.exp1_plugin_plans",
              "repro_torch.launch.exp4_batching", "repro_torch.launch.exp5_cache",
              "repro_torch.launch.exp6_cache_design", "repro_torch.launch.exp7_scheduling",
              "repro_torch.launch.exp9_plans", "repro_torch.launch.exp10_scaling",
              "repro_torch.launch.exp_chaos", "repro_torch.launch.exp_streaming",
              "repro_torch.analysis.__main__", "repro_torch.analysis.lint",
              "repro_torch.configs.huge_enum", "repro_torch.models.moe",
              "repro_torch.configs.qwen3_moe_30b_a3b", "repro_torch.configs.arctic_480b",
              "repro_torch.kernels.ssm_scan.ops", "repro_torch.kernels.ssm_scan.ref",
              "repro_torch.configs.jamba_v01_52b", "repro_torch.train.data",
              "repro_torch.train.optimizer", "repro_torch.train.train_step",
              "repro_torch.train.checkpoint", "repro_torch.train.elastic",
              "repro_torch.train.compress", "repro_torch.core.adaptive_schedule",
              "repro_torch.launch.train"):
        assert m in mods, m
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro', 'benchmarks', 'ml_dtypes'):\n"
        "    sys.modules[name] = None  # any import of them now raises\n"
        f"sys.path[:0] = [{SRC!r}, {ROOT!r}]\n"
        "import importlib\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'benchmarks', 'ml_dtypes'))]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("first", [
    "repro_torch.kernels.build", "repro_torch.kernels.rwkv6.ops",
    "repro_torch.kernels.flash_attention.ops", "repro_torch.kernels.ssm_scan.ops",
    "repro_torch.kernels.intersect.ops", "repro_torch.models.transformer",
    "repro_torch.serve.engine", "repro_torch.analysis.flowcheck", "repro_torch.analysis",
    "repro_torch.core.paths", "repro_torch.launch.table4",
    "repro_torch.serve.graph_service", "repro_torch.launch.service_load",
    "repro_torch.core.distributed", "repro_torch.graph.partition",
    "repro_torch.launch.dist_hybrid", "repro_torch.launch.run",
    "repro_torch.analysis.__main__", "repro_torch.train.train_step",
    "repro_torch.train.checkpoint", "repro_torch.launch.train",
    "repro_torch.core.adaptive_schedule",
])
def test_each_entry_module_imports_first(first):
    """No import cycle bites a program whose first import is this module."""
    proc = subprocess.run([sys.executable, "-c", f"import {first}"], capture_output=True,
                          text=True, cwd=ROOT, timeout=300,
                          env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    from repro_torch.core.engine import EngineConfig, HugeEngine, enumerate_query
    from repro_torch.core.query import PAPER_QUERIES
    from repro_torch.graph import build_graph, powerlaw_graph
    from repro_torch.launch import enumerate as cli

    g = powerlaw_graph(64, 4.0, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        HugeEngine(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        HugeEngine(g, EngineConfig(fused=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        enumerate_query(g, PAPER_QUERIES["q3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        powerlaw_graph(64, 4.0, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_graph([[0, 1]], 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--query", "q3", "--vertices", "64"])
    from repro_torch.launch import table4
    with pytest.raises(RuntimeError, match="CUDA"):
        table4.main(["--vertices", "64"])


def _never_called(comm):
    raise AssertionError("no rank may start")


def test_distributed_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    import multiprocessing

    from repro_torch.core.distributed import (
        Comm,
        DistributedEngine,
        process_group,
        run_ranks,
    )
    from repro_torch.graph import powerlaw_graph
    from repro_torch.launch import dist_hybrid

    g = powerlaw_graph(64, 4.0, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_ranks(_never_called, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_ranks(_never_called, 2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        with process_group("gloo"):
            pass
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedEngine(g, Comm(0, 1, torch.device("cuda"), "gloo"))
    with pytest.raises(RuntimeError, match="CUDA"):
        dist_hybrid.main(["--ranks", "2", "--vertices", "64"])
    # NCCL is never chosen for the caller, and never given more ranks than GPUs.
    with pytest.raises(ValueError, match="nccl"):
        run_ranks(_never_called, 2, backend="nccl", device="cpu")
    assert multiprocessing.active_children() == []


def test_lm_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve as cli
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import BatchedServer, ServeConfig

    for arch in ("rwkv6-7b", "jamba-v0.1-52b"):
        cfg = smoke_config(arch)
        params = T.init_params(cfg, seed=0, device="cpu")
        batch = {"tokens": [[1, 2, 3]]}
        for call in (
            lambda: T.init_params(cfg, seed=0),
            lambda: T.forward(cfg, params, batch),
            lambda: T.loss_fn(cfg, params, batch),
            lambda: T.prefill(cfg, params, batch, 8),
            lambda: T.init_cache(cfg, 1, 8),
            lambda: BatchedServer(cfg, params, ServeConfig()),
            lambda: cli.main(["lm", "--arch", arch, "--smoke", "--requests", "1"]),
        ):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
        # Given the CPU, the same calls run.
        assert T.forward(cfg, params, batch, device="cpu").shape == (1, 3, cfg.vocab_padded)
        BatchedServer(cfg, params, ServeConfig(), device="cpu")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_paper_suites_raise_without_cuda(capsys):
    """Every suite of the registry runs on the card unless asked for the CPU;
    the registry prints a suite's failure as its ERROR row and exits 1."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    from repro_torch.launch import run

    new = [k for k in run.SUITES if k not in ("table4", "exp_service_load", "exp_dist_hybrid")]
    assert len(new) == 10
    for name in new:
        with pytest.raises(RuntimeError, match="CUDA"):
            run.SUITES[name].main([])
    assert run.main(["exp6", "table1"]) == 1
    out = capsys.readouterr().out
    assert "exp6/ERROR,0.0,RuntimeError:repro_torch runs on a CUDA device" in out
    assert "table1/ERROR,0.0,RuntimeError" in out


def test_train_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train as cli
    from repro_torch.train.train_step import TrainConfig, init_all

    cfg = smoke_config("granite-3-8b")
    for call in (lambda: init_all(cfg, TrainConfig()),
                 lambda: cli.train(cfg, steps=1, global_batch=2, seq_len=8),
                 lambda: cli.main(["--smoke", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
