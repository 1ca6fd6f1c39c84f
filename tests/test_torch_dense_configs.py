"""The port's dense attention models (gemma2-9b, chatglm3-6b, command-r-35b)
against the JAX package's, on the CPU, at their ``smoke()`` sizes.

The JAX package's parameters (``init_params`` from a seed) are carried into
the port with ``convert.from_jax_params``; chatglm3's qkv biases, zero at
init, are given values first so that the bias is seen. Tokens are made with
numpy from a seed. gemma2's smoke config has a sliding window of 16 keys on
its local layers (pattern position 0), so every sequence here is longer
than the window. Tolerances:

* float32: 1e-4 on the logits and the KV caches (float32 summation order
  only), 1e-5 on the loss; greedy tokens are equal.
* bfloat16 (the default dtype): the two frameworks round at other places, so
  the bound on the logits is about five times the JAX package's own
  rounding, which ``test_bfloat16_bound_is_above_jax_own_rounding`` measures
  (its bf16 forward against its float32 forward of the same weights): 0.05
  for gemma2 and command-r (own rounding 0.010 and 0.011 on logits of at
  most 0.63 and 0.68), 0.15 for chatglm3 (own rounding 0.032: its untied
  lm_head gives logits up to 4.3); 0.02 on the loss.
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
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.engine import BatchedServer, Request, ServeConfig

ARCHS = ["gemma2-9b", "chatglm3-6b", "command-r-35b"]
# The reference's param_count() of each full config.
PARAMS = {"gemma2-9b": 9_241_100_288, "chatglm3-6b": 6_243_221_504,
          "command-r-35b": 30_282_874_880}
TOL_F32 = 1e-4
TOL_BF16_LOGITS = {"gemma2-9b": 0.05, "chatglm3-6b": 0.15, "command-r-35b": 0.05}
TOL_BF16_LOSS = 0.02


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype):
    """(JAX config, port config, JAX parameters as numpy, the port's LM)."""
    jcfg = jax_smoke_config(arch).scaled(dtype=dtype)
    pcfg = smoke_config(arch).scaled(dtype=dtype)
    jp = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(1)))
    if jcfg.qkv_bias:  # zero at init: give the biases values
        rng = np.random.default_rng(4)
        attn = jp["blocks"][0]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = (0.5 * rng.standard_normal(attn[name].shape)).astype(attn[name].dtype)
    return jcfg, pcfg, jp, from_jax_params(pcfg, jp, device="cpu")


def _jax(jp):
    return jax.tree.map(jnp.asarray, jp)


@functools.lru_cache(maxsize=None)
def _jax_bf16_forward(arch):
    """JAX's bf16 logits on the bf16 tests' tokens, and those tokens."""
    jcfg, pcfg, jp, _ = _pair(arch, "bfloat16")
    toks = _tokens(1, 2, 96, pcfg.vocab_size)
    return toks, _f(JT.forward(jcfg, _jax(jp), {"tokens": jnp.asarray(toks)}))


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(a, b):
    return float(np.max(np.abs(_f(a) - _f(b))))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Configs, parameters, converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch, which):
    jc = jax_get_config(arch) if which == "full" else jax_smoke_config(arch)
    pc = get_config(arch) if which == "full" else smoke_config(arch)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.param_count() == jc.param_count()
    assert pc.num_groups == jc.num_groups and pc.vocab_padded == jc.vocab_padded
    assert arch in ARCH_NAMES


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_count(arch):
    """param_count() of the full config is the reference's, and the port's
    module holds exactly those matrices plus the norms, the padded
    embedding rows and (chatglm3) the qkv biases, which param_count leaves
    out."""
    cfg = get_config(arch)
    assert cfg.param_count() == PARAMS[arch]
    lm = T.LM(cfg, device="meta")
    n = sum(p.numel() for p in lm.parameters())
    pad = (cfg.vocab_padded - cfg.vocab_size) * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    bias = cfg.num_layers * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.hd if cfg.qkv_bias else 0
    assert n == cfg.param_count() + pad + norms + bias
    mixers = [blk.mixer for blk in lm.blocks]
    if arch == "gemma2-9b":
        assert mixers == ["attn_local", "attn"] * 21 and cfg.local_window == 4096
        assert cfg.attn_spec(True).window == 4096 and cfg.attn_spec(False).window is None
    else:
        assert set(mixers) == {"attn"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_converter_carries_every_leaf_exactly(arch, dtype):
    """Every leaf of the JAX tree, of every pattern position (gemma2's local
    layers in ``blocks[0]``, its global ones in ``blocks[1]``) and chatglm3's
    qkv biases, lands bit for bit in its layer of the port."""
    jcfg, pcfg, jp, lm = _pair(arch, dtype)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    named = dict(lm.named_parameters())
    assert len(named) == sum(
        np.asarray(leaf).shape[0] if path[0].key == "blocks" else 1 for path, leaf in flat)
    assert len(jp["blocks"]) == pcfg.period == (2 if arch == "gemma2-9b" else 1)
    if pcfg.qkv_bias:
        assert {"blocks.0.attn.bq", "blocks.1.attn.bk", "blocks.1.attn.bv"} <= set(named)
        assert float(named["blocks.1.attn.bq"].abs().sum()) > 0
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


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax_float32(arch):
    jcfg, pcfg, jp, lm = _pair(arch, "float32")
    toks = _tokens(0, 2, 100, pcfg.vocab_size)  # > attn_chunk and > gemma2's window
    want = JT.forward(jcfg, _jax(jp), {"tokens": jnp.asarray(toks)})
    got = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    assert got.shape == (2, 100, pcfg.vocab_padded) and got.dtype == torch.float32
    assert _err(got, want) < TOL_F32
    mask = (np.arange(100)[None] % 3 != 0).astype(np.int32).repeat(2, 0)
    for batch in ({"tokens": toks}, {"tokens": toks, "loss_mask": mask}):
        jl = float(JT.loss_fn(jcfg, _jax(jp), {k: jnp.asarray(v) for k, v in batch.items()}))
        tl = float(T.loss_fn(pcfg, lm, batch, device="cpu"))
        assert abs(jl - tl) < 1e-5
    if pcfg.logit_softcap is not None:
        assert float(got.abs().max()) <= pcfg.logit_softcap
    if arch == "gemma2-9b":  # the window matters at this length: without it the logits move
        wcfg = pcfg.scaled(local_window=4096)  # a layer's spec is fixed when it is built
        lm_wide = T.LM(wcfg, "cpu")
        lm_wide.load_state_dict(lm.state_dict())
        wide = T.forward(wcfg, lm_wide, {"tokens": toks}, device="cpu")
        assert _err(wide, want) > 10 * TOL_F32


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax_bfloat16(arch):
    jcfg, pcfg, jp, lm = _pair(arch, "bfloat16")
    toks, want = _jax_bf16_forward(arch)
    got = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert _err(got, want) < TOL_BF16_LOGITS[arch]
    jl = float(JT.loss_fn(jcfg, _jax(jp), {"tokens": jnp.asarray(toks)}))
    tl = float(T.loss_fn(pcfg, lm, {"tokens": toks}, device="cpu"))
    assert abs(jl - tl) < TOL_BF16_LOSS


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_bound_is_above_jax_own_rounding(arch):
    """The bf16 bound's reason: JAX's bf16 forward against its float32 forward
    of the same parameters (the bf16 ones, widened) is a visible fraction of
    it, and the port's bf16 logits sit as close to that float32 forward."""
    jcfg, pcfg, jp, lm = _pair(arch, "bfloat16")
    toks, jbf16 = _jax_bf16_forward(arch)
    jwide = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    j32 = JT.forward(jcfg.scaled(dtype="float32"), jwide, {"tokens": jnp.asarray(toks)})
    own = _err(jbf16, j32)
    port = _err(T.forward(pcfg, lm, {"tokens": toks}, device="cpu"), j32)
    tol = TOL_BF16_LOGITS[arch]
    assert tol / 10 < own < tol and port < tol


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_past_the_window_match_jax(arch):
    """A prompt of 36 tokens, then 4 decode steps to position 39: past
    gemma2's smoke window of 16 in the prefill and in every step. Logits
    and both pattern positions' KV caches equal JAX's."""
    jcfg, pcfg, jp, lm = _pair(arch, "float32")
    s, extra, max_len = 36, 4, 48
    toks = _tokens(s, 2, s + extra, pcfg.vocab_size)
    jc, jlast = JT.prefill(jcfg, _jax(jp), {"tokens": jnp.asarray(toks[:, :s])}, max_len=max_len)
    tc, tlast = T.prefill(pcfg, lm, {"tokens": toks[:, :s]}, max_len, device="cpu")
    assert tlast.shape == (2, 1, pcfg.vocab_padded) and _err(tlast, jlast) < TOL_F32
    for i in range(extra):
        step = toks[:, s + i : s + i + 1]
        jl, jc = JT.decode_step(jcfg, _jax(jp), jc, jnp.asarray(step), jnp.int32(s + i))
        tl, tc = T.decode_step(pcfg, lm, tc, step, s + i, device="cpu")
        assert _err(tl, jl) < TOL_F32
    for pos in range(pcfg.period):
        kv, jkv = tc[f"pos{pos}"]["attn"], jc[f"pos{pos}"]["attn"]
        assert kv["k"].shape == (pcfg.num_groups, 2, max_len, pcfg.num_kv_heads, pcfg.hd)
        assert kv["len"].tolist() == np.asarray(jkv["len"]).tolist() == [s + extra] * pcfg.num_groups
        for name in ("k", "v"):
            assert _err(kv[name], jkv[name]) < TOL_F32


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_server_tokens_equal_jax(arch):
    """Ragged prompts longer than gemma2's smoke window, right-aligned behind
    zero tokens by both servers, on fewer slots than requests."""
    jcfg, pcfg, jp, lm = _pair(arch, "float32")
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_smoke_on_cpu(arch, capsys):
    attn_ops.reset_launches()
    stats = serve_cli.main(["lm", "--arch", arch, "--smoke", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "20", "--max-new", "4",
                            "--slots", "2"])
    assert stats["requests"] == 3 and stats["new_tokens"] == 3 * 3
    assert f"[serve] {arch} on cpu: 3 requests" in capsys.readouterr().out
    assert attn_ops.launches["flash_attention"] == 0  # the CPU path never launches the kernel
