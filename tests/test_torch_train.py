"""The port's train step against the JAX package's, on the smoke configs in
float32: the loss and every gradient leaf of one step (``jax.value_and_grad``
of the reference's ``_loss``, the MoE's router balance term included), then
three steps each (the port's ``make_train_step``; the reference's step for
one batch, ``value_and_grad`` of ``_loss`` then ``apply_updates``, jitted
apart so that the model compiles once): loss, grad norm and lr of each, and
every parameter after them; and 4 microbatches against the full batch. JAX's
parameters are carried over with ``convert.from_jax_params`` and the port's
compared in the JAX layout with ``convert.to_jax_params``; batches are the
reference's seeded Zipf stream (with frontend frames or patches where the
model takes them).

Tolerances, float32 throughout:
* loss 1e-5 relative, grad norm 1e-4 relative: the same expression in other
  summation orders;
* each gradient leaf 1e-4 of the leaf's largest value (a leaf's small
  entries carry the orders' error of its large ones);
* parameters after 3 AdamW steps at lr 1e-3: mean |diff| 1e-6 and at most
  1 in 1,000 entries off by more than 1e-5 (AdamW divides each entry's
  gradient by its own running magnitude, so an entry whose gradient is near
  0 turns a rounding difference into a step of up to lr; most entries agree
  to 1e-7), and none by more than 2 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import transformer as JT
from repro.train import train_step as JS
from repro.train.data import DataConfig, synth_batch
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import apply_updates
from repro.train.optimizer import init_state as jax_init_state
from repro_torch.configs import smoke_config
from repro_torch.models import convert
from repro_torch.train import train_step as PS
from repro_torch.train.optimizer import AdamWConfig, init_state

ARCHS = ["granite-3-8b", "gemma2-9b", "qwen3-moe-30b-a3b", "rwkv6-7b", "jamba-v0.1-52b",
         "seamless-m4t-large-v2", "phi-3-vision-4.2b"]
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """JAX's CPU thread pool and torch's intra-op threads contend in one
    process (a port step ran 100x slower after a JAX call): the port's side
    runs on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seq_len=32, batch=2, microbatches=1):
    jcfg = jax_smoke(arch).scaled(dtype="float32")
    pcfg = smoke_config(arch).scaled(dtype="float32")
    params = jax.jit(lambda k: JT.init_params(jcfg, k))(jax.random.key(0))
    lm = convert.from_jax_params(pcfg, jax.tree.map(np.asarray, params), device="cpu")
    dc = DataConfig(vocab_size=jcfg.vocab_size, seq_len=seq_len, global_batch=batch, seed=1,
                    microbatches=microbatches,
                    frontend=jcfg.frontend or ("audio" if jcfg.encoder_layers else None),
                    frontend_len=max(jcfg.frontend_len, 8), d_model=jcfg.d_model)
    return jcfg, pcfg, params, lm, dc


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _grads_by_leaf(pcfg, lm, grads):
    """The port's gradients (``lm.parameters()`` order) in the JAX layout."""
    by_id = {id(p): g for p, g in zip(lm.parameters(), grads)}
    out = {}
    for path, leaf in convert.jax_leaves(pcfg, lm).items():
        out[path] = (np.stack([by_id[id(t)].numpy() for t in leaf]) if isinstance(leaf, list)
                     else by_id[id(leaf)].numpy())
    return out


def _flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    jcfg, pcfg, params, lm, dc = _setup(arch)
    batch = synth_batch(dc, 0)
    # One step's loss and every gradient leaf.
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: JS._loss(jcfg, p, b, 0.01)))
    jloss, jgrads = grad_fn(params, _jbatch(batch))
    plist = [p.requires_grad_(True) for p in lm.parameters()]
    ploss = PS._loss(pcfg, lm, batch, 0.01)
    pgrads = torch.autograd.grad(ploss, plist, allow_unused=True, materialize_grads=True)
    assert abs(float(ploss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    got = _grads_by_leaf(pcfg, lm, pgrads)
    want = _flat(jgrads)
    assert got.keys() == want.keys()
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert got[path].shape == w.shape, path
        assert float(np.abs(got[path] - w).max()) <= 1e-4 * scale, path

    # Three steps each.
    adamw = dict(learning_rate=LR, warmup_steps=1)
    update = jax.jit(lambda p, s, g: apply_updates(JAdamW(**adamw), p, s, g))
    pstep = PS.make_train_step(pcfg, PS.TrainConfig(adamw=AdamWConfig(**adamw)))
    jopt = jax_init_state(JAdamW(), params)
    popt = init_state(AdamWConfig(), list(lm.parameters()))
    for i in range(3):
        b = synth_batch(dc, i)
        jloss, jgrads = grad_fn(params, _jbatch(b))
        params, jopt, jm = update(params, jopt, jgrads)
        jm["loss"] = jloss
        lm, popt, pm = pstep(lm, popt, b)
        for key, tol in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6)):
            assert abs(float(pm[key]) - float(jm[key])) <= tol * abs(float(jm[key])), (i, key)
    assert int(popt["step"]) == int(jopt["step"]) == 3
    got, want = _flat(convert.to_jax_params(pcfg, lm)), _flat(params)
    for path, w in want.items():
        d = np.abs(got[path] - w)
        assert d.mean() <= 1e-6 and (d > 1e-5).mean() <= 1e-3 and d.max() <= 2 * LR, path


def test_microbatches_match_full_batch():
    """4 microbatches of 2 against one batch of 8 (the same tokens): the
    same loss, grad norm and first moments (the mean of equal-size
    microbatches' float32-accumulated gradients is the full batch's
    gradient), and the reference's microbatched loss."""
    jcfg, pcfg, params, lm, dc = _setup("granite-3-8b", seq_len=16, batch=8)
    full = synth_batch(dc, 0)
    micro = {"tokens": full["tokens"].reshape(4, 2, 16)}
    adamw = AdamWConfig(learning_rate=1e-3, weight_decay=0.0, warmup_steps=1)
    runs = {}
    for n, batch in ((1, full), (4, micro)):
        lm_n = convert.from_jax_params(pcfg, jax.tree.map(np.asarray, params), device="cpu")
        opt = init_state(adamw, list(lm_n.parameters()))
        step = PS.make_train_step(pcfg, PS.TrainConfig(adamw=adamw, microbatches=n))
        _, opt, m = step(lm_n, opt, batch)
        runs[n] = (m, opt["m"])
    (m1, s1), (m4, s4) = runs[1], runs[4]
    assert abs(float(m1["loss"]) - float(m4["loss"])) <= 1e-5 * float(m1["loss"])
    assert abs(float(m1["grad_norm"]) - float(m4["grad_norm"])) <= 1e-4 * float(m1["grad_norm"])
    for a, b in zip(s1, s4):  # first moments: (1 - beta1) x the clipped gradients
        assert float((a - b).abs().max()) <= 1e-4 * max(float(a.abs().max()), 1e-30)
    # The reference's microbatched step agrees too.
    tc4 = JS.TrainConfig(adamw=JAdamW(learning_rate=1e-3, weight_decay=0.0, warmup_steps=1),
                         microbatches=4)
    _, _, jm = JS.make_train_step(jcfg, tc4)(params, jax_init_state(tc4.adamw, params),
                                             _jbatch(micro))
    assert abs(float(m4["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
