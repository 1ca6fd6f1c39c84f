"""The port's training driver and its distributed pieces: the driver's
crash and resume on the CPU (the counterpart of the reference's restart
test), a data-parallel step on two gloo ranks against one rank on the whole
batch, elastic resume of a two-rank run's checkpoint on one rank, and the
int8 compressed mean against the reference's ``compressed_psum_mean`` (run
over two forced host devices in a subprocess).

Tolerances: data-parallel against one rank on the whole batch, loss 1e-5
relative and parameters mean |diff| 1e-6, max 2e-4 (one step: the ranks'
float32 gradient mean against one rank's sum, AdamW's per-entry division);
the resumed run's losses 1e-4 relative of the uninterrupted run's; the
compressed mean 1e-6 of the reference's on the same inputs, and within its
two int8 roundings (2 x (max|x| + max|y|) / 127) of the exact mean.
"""
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.distributed import run_ranks
from repro_torch.launch.train import train
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data
from repro_torch.train import train_step as PS
from repro_torch.train.compress import compress_gradients, compressed_psum_mean

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



def test_train_driver_crash_and_resume_on_cpu(tmp_path):
    """The counterpart of the reference's restart test, on the port's CLI."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    d = str(tmp_path / "ck")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite-3-8b",
           "--smoke", "--steps", "8", "--ckpt-dir", d, "--ckpt-every", "2",
           "--global-batch", "4", "--seq-len", "16", "--log-every", "5", "--device", "cpu"]
    r1 = subprocess.run(cmd + ["--fail-at", "6"], env=env, cwd=ROOT, capture_output=True,
                        text=True, timeout=300)
    assert r1.returncode == 42 and "injected failure at step 6" in r1.stdout, r1.stderr
    assert ckpt.latest_step(d) is not None
    r2 = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0, r2.stderr
    assert "resuming from valid checkpoint step" in r2.stdout
    assert "done: final loss" in r2.stdout and ckpt.latest_step(d) == 8


def _f32_smoke():
    return smoke_config("granite-3-8b").scaled(dtype="float32")


def _dp_rank(comm, tokens):
    """One data-parallel step on this rank's half of ``tokens``; then the
    same step with ``compress_pods``, the group as its pod axis (the
    gradients' mean int8 on the wire, not the float32 all-reduce)."""
    cfg = _f32_smoke()
    half = tokens.shape[0] // comm.world_size
    out = []
    for compress in (False, True):
        tc = PS.TrainConfig(compress_pods=compress)
        lm, state = PS.init_all(cfg, tc, seed=3, device="cpu")
        step = PS.make_train_step(cfg, tc, comm=None if compress else comm,
                                  pod_comm=comm if compress else None)
        _, state, m = step(lm, state,
                           {"tokens": tokens[comm.rank * half:(comm.rank + 1) * half]})
        out.append((float(m["loss"]), [p.detach().numpy().copy() for p in lm.parameters()],
                    len(state.get("err") or [])))
    return out


def test_data_parallel_step_matches_one_rank_on_the_whole_batch():
    tokens = data.synth_batch(data.DataConfig(vocab_size=256, seq_len=16, global_batch=4,
                                              seed=6), 0)["tokens"]
    ranks = run_ranks(_dp_rank, 2, backend="gloo", device="cpu", args=(tokens,))
    cfg = _f32_smoke()
    lm, state = PS.init_all(cfg, PS.TrainConfig(), seed=3, device="cpu")
    _, _, m = PS.make_train_step(cfg, PS.TrainConfig())(lm, state, {"tokens": tokens})
    plain, packed = [r.value[0] for r in ranks], [r.value[1] for r in ranks]
    for loss, params, _ in plain:
        assert abs(loss - float(m["loss"])) <= 1e-5 * float(m["loss"])
        for got, p in zip(params, lm.parameters()):
            d = np.abs(got - p.detach().numpy())
            assert d.mean() <= 1e-6 and d.max() <= 2e-4
    assert all(np.array_equal(a, b) for a, b in zip(plain[0][1], plain[1][1]))
    # TrainConfig.compress_pods: every rank applies the same int8-reduced
    # gradients, and keeps a residual for each parameter.
    assert packed[0][2] == packed[1][2] == len(list(lm.parameters()))
    assert all(np.array_equal(a, b) for a, b in zip(packed[0][1], packed[1][1]))


def _elastic_rank(comm, ckpt_dir):
    return train(_f32_smoke(), steps=4, global_batch=4, seq_len=16, ckpt_dir=ckpt_dir,
                 ckpt_every=2, device="cpu", comm=comm, log=lambda m: None)["loss"]


def test_elastic_resume_from_two_ranks_onto_one(tmp_path):
    d = str(tmp_path / "two")
    run_ranks(_elastic_rank, 2, backend="gloo", device="cpu", args=(d,))
    assert ckpt.latest_step(d) == 4
    lines = []
    resumed = train(_f32_smoke(), steps=6, global_batch=4, seq_len=16, ckpt_dir=d,
                    ckpt_every=2, device="cpu", log=lines.append)
    assert "[train] resuming from valid checkpoint step 4" in lines
    whole = train(_f32_smoke(), steps=6, global_batch=4, seq_len=16,
                  ckpt_dir=str(tmp_path / "one"), ckpt_every=2, device="cpu",
                  log=lambda m: None)
    for got, want in zip(resumed["history"], whole["history"][4:]):
        assert abs(got["loss"] - want["loss"]) <= 1e-4 * want["loss"]


# ---------------------------------------------------------------------------
# Int8 compressed mean
# ---------------------------------------------------------------------------

_JAX_COMPRESS = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.train.compress import compressed_psum_mean
mesh = jax.make_mesh((2,), ("pod",))
x = np.load(sys.argv[1])
np.save(sys.argv[2], np.asarray(compressed_psum_mean(jnp.asarray(x), "pod", mesh)))
"""


def _compress_rank(comm, xs):
    out = compressed_psum_mean(torch.from_numpy(xs[comm.rank]), comm)
    grads, err = compress_gradients([torch.from_numpy(xs[comm.rank]).view(-1, 10)], comm)
    return out.numpy(), grads[0].numpy(), err[0].float().numpy()


def test_compressed_mean_matches_reference(tmp_path):
    """The reference reduces its (replicated) input over a pod axis of two
    devices; the port's two gloo ranks given that input give its output.
    Given different inputs, the ranks agree on a mean within the two int8
    roundings, and the error feedback is what the rounding lost."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(1000) * np.linspace(0.1, 3, 1000)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, "-c", _JAX_COMPRESS, str(tmp_path / "x.npy"),
                           str(tmp_path / "y.npy")], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = np.load(tmp_path / "y.npy")
    same = run_ranks(_compress_rank, 2, backend="gloo", device="cpu", args=([x, x],))
    for r in same:
        assert np.allclose(r.value[0], want, rtol=0, atol=1e-6)
    y = (rng.standard_normal(1000)).astype(np.float32)
    mixed = run_ranks(_compress_rank, 2, backend="gloo", device="cpu", args=([x, y],))
    mean = (x + y) / 2
    bound = 2 * (np.abs(x).max() + np.abs(y).max()) / 127
    for r in mixed:
        assert np.array_equal(r.value[0], mixed[0].value[0])
        assert np.abs(r.value[0] - mean).max() <= bound
        assert np.allclose(r.value[1].reshape(-1), r.value[0], atol=1e-6)
    for r, mine in zip(mixed, (x, y)):  # residual = own gradient - reduced (in bf16)
        assert np.allclose(r.value[2].reshape(-1), mine - r.value[0],
                           atol=1e-2 * np.abs(mine).max())
