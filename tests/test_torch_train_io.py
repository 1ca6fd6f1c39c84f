"""The port's training substrate around the step, against the JAX package's:
the data stream (bit for bit), AdamW (float32 and bfloat16 state, the weight
decay of stacked leaves), the microbatch decisions, the parameter layout
(``convert.to_jax_params``) and checkpoints (round trip, corruption, async,
and files that interchange with the reference's both ways). The driver and
the distributed pieces are in ``test_torch_train_dist.py``.

Tolerances: AdamW in float32 1e-6 of each leaf's largest value (the same
float32 expression; ``b ** step`` and ``cos`` may round an ulp apart), and
with bfloat16 state one bf16 unit in the last place (2^-7 relative) of the
moments, whose rounding either side of a tie may differ; everything else is
exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke
from repro.core import adaptive_schedule as jax_sched
from repro.models import transformer as JT
from repro.train import checkpoint as jax_ckpt
from repro.train import data as jax_data
from repro.train import optimizer as jax_opt
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import adaptive_schedule as sched
from repro_torch.models import convert
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as PS


def _jax_params(cfg, seed):
    """The reference's ``init_params`` (jitted: eager, a big tree takes long)."""
    return jax.jit(lambda k: JT.init_params(cfg, k))(jax.random.key(seed))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """JAX's CPU thread pool and torch's intra-op threads contend in one
    process (a port step ran 100x slower after a JAX call): the port's side
    runs on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(microbatches=4), dict(frontend="audio", frontend_len=8, d_model=16),
    dict(frontend="vision", frontend_len=6, d_model=8, microbatches=2, zipf_a=1.1, seed=7),
])
def test_zipf_stream_is_the_reference_bit_for_bit(kw):
    cfg = dict(vocab_size=300, seq_len=24, global_batch=8, **kw)
    for step in (0, 1, 17):
        got = data.synth_batch(data.DataConfig(**cfg), step)
        want = jax_data.synth_batch(jax_data.DataConfig(**cfg), step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    loader = data.PrefetchLoader(data.DataConfig(**cfg), start_step=5)
    try:
        for step in range(5, 8):
            assert np.array_equal(next(loader)["tokens"],
                                  jax_data.synth_batch(jax_data.DataConfig(**cfg), step)["tokens"])
    finally:
        loader.close()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(state_dtype):
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 6), "b": (7,), "c": (2, 3, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5, state_dtype=state_dtype,
              grad_clip=0.5)
    jcfg, pcfg = jax_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jax_opt.init_state(jcfg, jp)
    pp = [torch.from_numpy(params[k].copy()) for k in sorted(shapes)]
    ps = opt.init_state(pcfg, pp)
    for _ in range(4):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jp, js, jm = jax_opt.apply_updates(jcfg, jp, js, {k: jnp.asarray(g) for k, g in
                                                          grads.items()})
        pm = opt.apply_updates(pcfg, pp, ps, [torch.from_numpy(grads[k]) for k in sorted(shapes)])
        for key in ("lr", "grad_norm"):
            assert abs(float(pm[key]) - float(jm[key])) <= 1e-6 * abs(float(jm[key])), key
    assert int(ps["step"]) == int(js["step"]) == 4
    ulp = 2.0 ** -7 if state_dtype == "bfloat16" else 1e-6
    for i, k in enumerate(sorted(shapes)):
        for got, want, tol in ((pp[i], jp[k], 1e-6 if state_dtype == "float32" else 1e-4),
                               (ps["m"][i], js["m"][k], ulp), (ps["v"][i], js["v"][k], ulp)):
            w = np.asarray(want, np.float32)
            assert str(got.dtype)[6:] == str(np.asarray(want).dtype).replace("bfloat16",
                                                                             "bfloat16")
            assert float(np.abs(got.float().numpy() - w).max()) <= tol * np.abs(w).max(), k


@pytest.mark.parametrize("arch", ["granite-3-8b", "rwkv6-7b", "jamba-v0.1-52b"])
def test_weight_decay_follows_the_stacked_jax_leaf(arch):
    """The reference decays every leaf of rank >= 2, and its per-layer vectors
    (norm gains, RWKV's u and mixes, Mamba's vectors) are stacked [G, ...]:
    the port decays them too, and only the top-level vectors not."""
    jcfg = jax_smoke(arch).scaled(dtype="float32")
    pcfg = smoke_config(arch).scaled(dtype="float32")
    params = _jax_params(jcfg, 1)
    lm = convert.from_jax_params(pcfg, jax.tree.map(np.asarray, params), device="cpu")
    flags = dict(zip([n for n, _ in lm.named_parameters()], opt.decay_flags(pcfg, lm)))
    assert flags["blocks.0.ln1"] and not flags["final_norm"]
    assert any(p.ndim == 1 and flags[n] for n, p in lm.named_parameters())
    rng = np.random.default_rng(2)
    jgrads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)
    cfg = dict(learning_rate=1e-2, weight_decay=0.5, warmup_steps=0)
    new, _, _ = jax.jit(lambda p, s, g: jax_opt.apply_updates(jax_opt.AdamWConfig(**cfg), p, s, g))(
        params, jax_opt.init_state(jax_opt.AdamWConfig(), params), jgrads)
    # The port's gradients: the JAX leaves' slices, by layer.
    glm = convert.from_jax_params(pcfg, jax.tree.map(np.asarray, jgrads), device="cpu")
    grads = [g.detach() for g in glm.parameters()]
    pp = list(lm.parameters())
    opt.apply_updates(opt.AdamWConfig(**cfg), pp, opt.init_state(opt.AdamWConfig(), pp), grads,
                      opt.decay_flags(pcfg, lm))
    got, want = _flat(convert.to_jax_params(pcfg, lm)), _flat(new)
    for path, w in want.items():
        assert float(np.abs(got[path] - w).max()) <= 1e-6 * max(np.abs(w).max(), 1.0), path


# ---------------------------------------------------------------------------
# Microbatch decisions and the parameter layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_choose_microbatches_matches_reference(arch):
    for cfgs in ((get_config(arch), jax_get_config(arch)),
                 (smoke_config(arch), jax_smoke(arch))):
        assert sched.estimate_activation_bytes(cfgs[0], 4096) == \
            jax_sched.estimate_activation_bytes(cfgs[1], 4096)
        for gb, sl, dev, budget in ((8, 128, 1, 4 << 30), (2, 4096, 1, 4 << 30),
                                    (64, 2048, 4, 8 << 30), (16, 512, 1, 1 << 20),
                                    (32, 1024, 2, 1 << 30), (12, 1024, 2, 16 << 30)):
            got = sched.choose_microbatches(cfgs[0], gb, sl, device_count=dev,
                                            budget_bytes=budget)
            want = jax_sched.choose_microbatches(cfgs[1], gb, sl, device_count=dev,
                                                 budget_bytes=budget)
            assert (got.num_microbatches, got.est_activation_bytes, got.budget_bytes,
                    got.note) == (want.num_microbatches, want.est_activation_bytes,
                                  want.budget_bytes, want.note)


def test_choose_microbatches_ends_where_no_power_of_two_fits():
    """A batch of 12 that needs more than its largest power-of-two divisor
    (4): the reference's loop never ends there; the port returns 4."""
    cfg = get_config("granite-3-8b")
    got = sched.choose_microbatches(cfg, 12, 4096, budget_bytes=1 << 20)
    assert got.num_microbatches == 4 and got.est_activation_bytes > got.budget_bytes
    assert got.est_activation_bytes == sched.estimate_activation_bytes(cfg, 3 * 4096)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_to_jax_params_inverts_from_jax_params(arch):
    cfg = jax_smoke(arch)
    tree = jax.tree.map(np.asarray, _jax_params(cfg, 3))
    back = convert.to_jax_params(smoke_config(arch), convert.from_jax_params(
        smoke_config(arch), tree, device="cpu"))
    want, got = jax.tree_util.tree_flatten_with_path(tree), \
        jax.tree_util.tree_flatten_with_path(back)
    assert want[1] == got[1]  # the same tree structure, keys and order
    for (_, w), (_, g) in zip(want[0], got[0]):
        assert g.shape == w.shape and np.array_equal(g, np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _model(arch="chatglm3-6b", seed=0):
    cfg = smoke_config(arch)
    lm, state = PS.init_all(cfg, PS.TrainConfig(), seed=seed, device="cpu")
    for t in state["m"] + state["v"]:
        t.normal_()
    state["step"] = torch.tensor(7, dtype=torch.int32)
    return cfg, lm, state


def test_checkpoint_round_trip_and_corruption(tmp_path):
    cfg, lm, state = _model()
    d = str(tmp_path)
    ckpt.save(d, 7, cfg, lm, state)
    assert ckpt.latest_step(d) == 7
    _, lm2, state2 = _model(seed=1)
    assert ckpt.load(d, 7, cfg, lm2, state2) == {}
    for a, b in zip(list(lm.parameters()) + state["m"] + state["v"],
                    list(lm2.parameters()) + state2["m"] + state2["v"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(state2["step"]) == 7 and state2["step"].dtype == torch.int32
    # corrupt → rejected; the older valid checkpoint wins; a partial one is skipped
    ckpt.save(d, 3, cfg, lm, state)
    npz = os.path.join(d, "step_00000007", "arrays.npz")
    size = os.path.getsize(npz)
    with open(npz, "r+b") as f:
        f.seek(size // 2)
        f.write(b"CORRUPTCORRUPT!!")
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.latest_step(d) == 3


def test_save_async_writes_off_the_caller(tmp_path):
    cfg, lm, state = _model()
    d = str(tmp_path)
    th = ckpt.save_async(d, 5, cfg, lm, state, extra={"note": "async"})
    with torch.no_grad():  # the host copy was taken before the thread started
        lm.embed.zero_()
    ckpt.wait_pending(d)
    assert not th.is_alive() and ckpt.latest_step(d) == 5
    _, lm2, state2 = _model(seed=1)
    assert ckpt.load(d, 5, cfg, lm2, state2) == {"note": "async"}
    assert lm2.embed.abs().max() > 0


@pytest.mark.parametrize("arch", ["granite-3-8b", "seamless-m4t-large-v2"])
def test_checkpoints_interchange_with_the_reference(tmp_path, arch):
    """A checkpoint the reference wrote loads into the port with equal values
    (bfloat16 weights, float32 moments), and one the port wrote loads into
    the reference."""
    jcfg, pcfg = jax_smoke(arch), smoke_config(arch)
    params = _jax_params(jcfg, 4)
    rng = np.random.default_rng(5)
    state = {"m": jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                               params),
             "v": jax.tree.map(lambda p: jnp.asarray(rng.random(p.shape), jnp.float32), params),
             "step": jnp.int32(11)}
    d = str(tmp_path)
    jax_ckpt.save(d, 11, params, state)
    assert ckpt.latest_step(d) == 11
    lm, pstate = PS.init_all(pcfg, PS.TrainConfig(), device="cpu")
    ckpt.load(d, 11, pcfg, lm, pstate)
    assert int(pstate["step"]) == 11
    got = _flat(convert.to_jax_params(pcfg, lm))
    for path, w in _flat(params).items():
        assert np.array_equal(got[path], np.asarray(w, np.float32)), path
    ckpt.save(d, 12, pcfg, lm, pstate)
    assert jax_ckpt.latest_step(d) == 12
    p2, s2, _ = jax_ckpt.load(d, 12, params, state)
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((p2, s2))):
        assert a.dtype == b.dtype and bool(jnp.all(a == b))
