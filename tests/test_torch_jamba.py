"""The port's jamba-v0.1-52b (Mamba and attention layers 7:1, dense and MoE
MLPs in turn) against the JAX package's, on the CPU, at its ``smoke()``
widths (d 64, 4 experts top-2) cut to 16 layers: two groups of the 8-layer
period, so that the [G, ...] caches and the converter's group slice run
past G = 0, as on the card.

The JAX package's parameters (``init_params`` from a seed) are carried into
the port with ``convert.from_jax_params``; tokens are made with numpy from a
seed. Tolerances:

* float32: 1e-4 of the largest logit on the logits (summation order only,
  through 14 Mamba scans, 2 attention layers and 8 MoE layers), the same on
  the decode caches, 1e-5 on the loss; greedy tokens are equal.
* bfloat16 (the default dtype): at 16 layers the model is chaotic in
  bfloat16. JAX's own bfloat16 forward against its float32 forward of the
  same (widened) parameters differs by a mean 0.127 over the logits of 8 x
  128 tokens, and most positions move by more than 0.1: one rounding moves
  a token's top-2 experts, and the scans carry the change down the
  sequence. No max |diff| can hold the port there. So its bfloat16 forward
  is held by means over all logits: it lies closer to JAX's bfloat16
  forward than to the float32 one (0.79 and 1.12 times JAX's own distance:
  a port computing in float32 would read about 0 from the float32 one),
  and from the float32 one between 0.5 and 1.25 times JAX's own distance,
  which is asserted to lie between 0.05 and 0.16. Its loss lies within
  0.02 of JAX's bfloat16 loss (it reads 0.008; JAX's own bfloat16 and
  float32 losses differ by 0.011 on these tokens, so the loss alone would
  not tell a float32 port: the forward's means do). The Mamba block itself
  is held in bfloat16 to a unit in the last place
  (``tests/test_torch_mamba.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.serve.engine import BatchedServer as JaxServer
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.engine import BatchedServer, Request, ServeConfig

ARCH = "jamba-v0.1-52b"
LAYERS = 16
TOL_F32 = 1e-4
TOL_F32_LOSS = 1e-5
OWN_MEAN = (0.05, 0.16)   # where JAX's own bf16-vs-float32 mean |diff| must lie
OWN_BAND = (0.5, 1.25)  # the port's distance from float32, over JAX's own
TOL_BF16_LOSS = 0.02


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    """(JAX config, port config, JAX parameters as numpy, the port's LM)."""
    jcfg = jax_smoke_config(ARCH).scaled(num_layers=LAYERS, dtype=dtype)
    pcfg = smoke_config(ARCH).scaled(num_layers=LAYERS, dtype=dtype)
    jp = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(1)))
    return jcfg, pcfg, jp, from_jax_params(pcfg, jp, device="cpu")


def _jax(jp):
    return jax.tree.map(jnp.asarray, jp)


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b):
    """max |a - b| over max |b|."""
    a, b = _f(a), _f(b)
    return float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Config, parameters, converter, cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_equals_jax(which):
    jc = jax_get_config(ARCH) if which == "full" else jax_smoke_config(ARCH)
    pc = get_config(ARCH) if which == "full" else smoke_config(ARCH)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.param_count() == jc.param_count()
    assert pc.active_param_count() == jc.active_param_count()
    assert pc.num_groups == jc.num_groups and pc.period == jc.period == 8
    assert ARCH in ARCH_NAMES


def test_full_config_parameter_count():
    """param_count() of the full config is the reference's (103.0 GB in
    bf16); the card's cut to 16 layers holds 26.02 B of it (52.04 GB), and
    the port's module (on the meta device) holds those matrices, the norms
    and the Mamba leaves that param_count leaves out (conv_b, dt_proj,
    dt_bias, a_log, d_skip)."""
    cfg = get_config(ARCH)
    assert cfg.param_count() == 51_506_970_624
    cut = cfg.scaled(num_layers=LAYERS)
    assert cut.param_count() == 26_021_920_768 and cut.num_groups == 2
    lm = T.LM(cut, device="meta")
    di, rank, n = 2 * cfg.d_model, cfg.d_model // 16, cfg.ssm_state
    mambas = sum(cut.mixer_at(layer) == "mamba" for layer in range(LAYERS))
    assert mambas == 14
    extra = (2 * LAYERS + 1) * cfg.d_model + mambas * (3 * di + rank * di + di * n)
    assert sum(p.numel() for p in lm.parameters()) == cut.param_count() + extra
    blk = lm.blocks[0]
    assert blk.mixer == "mamba" and hasattr(blk, "mlp") and not hasattr(blk, "moe")
    assert lm.blocks[4].mixer == "attn" and hasattr(lm.blocks[1], "moe")
    assert tuple(blk.mamba.in_proj.shape) == (4096, 2 * di)
    assert tuple(blk.mamba.x_proj.shape) == (di, rank + 2 * n)
    assert blk.mamba.a_log.dtype == torch.float32 and blk.mamba.out_proj.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_carries_every_leaf_exactly(dtype):
    """Every leaf of the JAX tree, each Mamba leaf of both groups included,
    lands bit for bit in its layer of the port."""
    jcfg, pcfg, jp, lm = _pair(dtype)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    named = dict(lm.named_parameters())
    assert len(named) == sum(
        np.asarray(leaf).shape[0] if path[0].key == "blocks" else 1 for path, leaf in flat)
    assert {"blocks.8.mamba.a_log", "blocks.15.mamba.conv_w", "blocks.12.attn.wq"} <= set(named)
    for path, leaf in flat:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        arr = np.asarray(leaf)
        if keys[0] == "blocks":
            for g in range(arr.shape[0]):
                name = ".".join(["blocks", str(g * pcfg.period + keys[1])] + list(keys[2:]))
                _same(named[name], arr[g])
        else:
            _same(named[keys[0]], arr)


def _same(t, arr):
    want_dtype = torch.bfloat16 if arr.dtype == ml_dtypes.bfloat16 else torch.float32
    assert t.dtype == want_dtype and tuple(t.shape) == arr.shape
    assert np.array_equal(t.to(torch.float32).numpy(), arr.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_has_the_reference_layout(dtype):
    jcfg, pcfg, _, _ = _pair(dtype)
    want = JT.init_cache(jcfg, 3, 40)
    got = T.init_cache(pcfg, 3, 40, device="cpu")
    assert sorted(got) == sorted(want) == [f"pos{p}" for p in range(8)]
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    tflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(got)[0]}
    assert len(jflat) == len(tflat)
    for path, leaf in jflat:
        t = tflat[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
        assert not bool(t.any())
    assert tuple(got["pos0"]["mamba"][0].shape) == (2, 3, 3, 128)   # [G, B, K-1, Di]
    assert tuple(got["pos0"]["mamba"][1].shape) == (2, 3, 128, 16)  # [G, B, Di, N]
    assert got["pos0"]["mamba"][1].dtype == torch.float32


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def test_forward_and_loss_match_jax_float32():
    jcfg, pcfg, jp, lm = _pair("float32")
    toks = _tokens(0, 2, 128, pcfg.vocab_size)
    want = JT.forward(jcfg, _jax(jp), {"tokens": jnp.asarray(toks)})
    scan_ops.reset_launches()
    got = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    assert got.shape == (2, 128, pcfg.vocab_padded) and got.dtype == torch.float32
    assert _rel(got, want) < TOL_F32
    assert scan_ops.launches["ssm_scan"] == 0  # the CPU path never launches the kernel
    mask = (np.arange(128)[None] % 3 != 0).astype(np.int32).repeat(2, 0)
    for batch in ({"tokens": toks}, {"tokens": toks, "loss_mask": mask}):
        jl = float(JT.loss_fn(jcfg, _jax(jp), {k: jnp.asarray(v) for k, v in batch.items()}))
        tl = float(T.loss_fn(pcfg, lm, batch, device="cpu"))
        assert abs(jl - tl) < TOL_F32_LOSS


def test_forward_and_loss_bfloat16_at_jax_own_distance():
    jcfg, pcfg, jp, lm = _pair("bfloat16")
    toks = _tokens(1, 8, 128, pcfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks)}
    jbf16 = _f(JT.forward(jcfg, _jax(jp), batch))
    jwide = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    j32 = _f(JT.forward(jcfg.scaled(dtype="float32"), jwide, batch))
    got = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    own = float(np.abs(jbf16 - j32).mean())
    from_f32 = float(np.abs(_f(got) - j32).mean())
    from_bf16 = float(np.abs(_f(got) - jbf16).mean())
    assert OWN_MEAN[0] < own < OWN_MEAN[1], own
    assert OWN_BAND[0] * own < from_f32 < OWN_BAND[1] * own, (from_f32, own)
    assert from_bf16 < from_f32, (from_bf16, from_f32)
    jl = float(JT.loss_fn(jcfg, _jax(jp), batch))
    tl = float(T.loss_fn(pcfg, lm, {"tokens": toks}, device="cpu"))
    assert abs(jl - tl) < TOL_BF16_LOSS, (jl, tl)


def test_prefill_and_decode_match_jax():
    """A prompt of 125 tokens, then 3 decode steps: each step's logits and,
    at the end, every cache entry (Mamba's conv tails and states, the
    attention layers' KV and lengths) equal JAX's; the forward of the same
    128 tokens gives the same logits at those positions."""
    jcfg, pcfg, jp, lm = _pair("float32")
    s, extra, max_len = 125, 3, 136
    toks = _tokens(s, 2, s + extra, pcfg.vocab_size)
    jc, jlast = JT.prefill(jcfg, _jax(jp), {"tokens": jnp.asarray(toks[:, :s])}, max_len=max_len)
    tc, tlast = T.prefill(pcfg, lm, {"tokens": toks[:, :s]}, max_len, device="cpu")
    assert tlast.shape == (2, 1, pcfg.vocab_padded) and _rel(tlast, jlast) < TOL_F32
    steps = [tlast[:, 0]]
    for i in range(extra):
        step = toks[:, s + i : s + i + 1]
        jl, jc = JT.decode_step(jcfg, _jax(jp), jc, jnp.asarray(step), jnp.int32(s + i))
        tl, tc = T.decode_step(pcfg, lm, tc, step, s + i, device="cpu")
        assert _rel(tl, jl) < TOL_F32
        steps.append(tl[:, 0])
    for pos in range(pcfg.period):
        if pcfg.mixer_at(pos) == "mamba":
            for got, want in zip(tc[f"pos{pos}"]["mamba"], jc[f"pos{pos}"]["mamba"]):
                assert _rel(got, want) < TOL_F32, pos
        else:
            kv, jkv = tc[f"pos{pos}"]["attn"], jc[f"pos{pos}"]["attn"]
            assert kv["len"].tolist() == np.asarray(jkv["len"]).tolist() == [s + extra] * 2
            for name in ("k", "v"):
                assert _rel(kv[name], jkv[name]) < TOL_F32
    fwd = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    assert _rel(torch.stack(steps, 1), fwd[:, s - 1 :]) < TOL_F32


def test_greedy_server_tokens_equal_jax():
    """Ragged prompts right-aligned behind zero tokens by both servers, on
    fewer slots than requests: every group's prefill is a length the
    reference's scan takes (at most 128 tokens)."""
    jcfg, pcfg, jp, lm = _pair("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, pcfg.vocab_size, size=n).astype(np.int32)
               for n in (20, 17, 20, 9)]
    kw = dict(max_len=36, batch_slots=3, temperature=0.0, max_new_tokens=6, eos_token=-1)
    jreqs = [JaxRequest(prompt=p.copy()) for p in prompts]
    treqs = [Request(prompt=p.copy()) for p in prompts]
    jstats = JaxServer(jcfg, _jax(jp), JaxServeConfig(**kw)).run(jreqs)
    tstats = BatchedServer(pcfg, lm, ServeConfig(**kw), device="cpu").run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == 6 and r.done for r in treqs)
    for key in ("requests", "new_tokens"):
        assert tstats[key] == jstats[key]


def test_serve_cli_smoke_on_cpu(capsys):
    attn_ops.reset_launches()
    scan_ops.reset_launches()
    stats = serve_cli.main(["lm", "--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                            "3", "--prompt-len", "20", "--max-new", "4", "--slots", "2"])
    assert stats["requests"] == 3 and stats["new_tokens"] == 3 * 3
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} on cpu: 3 requests" in out
    assert attn_ops.launches["flash_attention"] == 0 and scan_ops.launches["ssm_scan"] == 0
