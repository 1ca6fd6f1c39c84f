"""The PyTorch port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports ``jax`` or ``repro``, and its entry points refuse
to run silently on the CPU when the caller did not ask for it."""
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
              "repro_torch.launch.service_load"):
        assert m in mods, m
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None  # any import of them now raises\n"
        f"sys.path[:0] = [{SRC!r}, {ROOT!r}]\n"
        "import importlib\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m.split('.')[0] in ('jax', 'jaxlib', 'repro'))]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("first", [
    "repro_torch.kernels.build", "repro_torch.kernels.rwkv6.ops",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.intersect.ops", "repro_torch.models.transformer",
    "repro_torch.serve.engine", "repro_torch.analysis.flowcheck", "repro_torch.analysis",
    "repro_torch.core.paths", "repro_torch.launch.table4",
    "repro_torch.serve.graph_service", "repro_torch.launch.service_load",
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


def test_lm_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve as cli
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import BatchedServer, ServeConfig

    cfg = smoke_config("rwkv6-7b")
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": [[1, 2, 3]]}
    for call in (
        lambda: T.init_params(cfg, seed=0),
        lambda: T.forward(cfg, params, batch),
        lambda: T.loss_fn(cfg, params, batch),
        lambda: T.prefill(cfg, params, batch, 8),
        lambda: T.init_cache(cfg, 1, 8),
        lambda: BatchedServer(cfg, params, ServeConfig()),
        lambda: cli.main(["lm", "--smoke", "--requests", "1"]),
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
