"""The port's MoE models (qwen3-moe-30b-a3b: every layer's MLP is the MoE
layer; arctic-480b: a dense MLP and the MoE layer side by side) against the
JAX package's, on the CPU, at their ``smoke()`` sizes (d 64, 8 experts,
top-2, 2 layers).

The JAX package's parameters (``init_params`` from a seed) are carried into
the port with ``convert.from_jax_params``; tokens are made with numpy from a
seed. Tolerances:

* float32: 1e-4 on the logits and the KV caches (summation order only),
  1e-5 on the loss; greedy tokens are equal. One forward runs in the
  capacity regime that drops routed pairs (2 x 2,100 tokens: 8,400 pairs).
* bfloat16 (the default dtype): the routing is a discontinuous function of
  the hidden state, so a bf16 rounding that moves a token's k-th and
  (k+1)-th router probabilities past each other moves that token's output
  by the size of an expert's output (the JAX package's own bf16 forward
  against its float32 forward differs by up to 2.3 on logits of at most
  4.3 on the tokens here). The max |diff| cannot bound that; two readings
  do, each about three times the JAX package's own (measured by
  ``test_bfloat16_bound_is_above_jax_own_rounding``): the mean |diff| over
  all logits, 0.04 (own 0.013 and 0.017), and the share of positions whose
  logits move by more than 0.1 (a routing flip), 0.05 (own 0.016); 0.02 on
  the loss.
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
from repro_torch.models import moe as PM
from repro_torch.models import transformer as T
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.engine import BatchedServer, Request, ServeConfig

ARCHS = ["qwen3-moe-30b-a3b", "arctic-480b"]
# The reference's param_count() of each full config.
PARAMS = {"qwen3-moe-30b-a3b": 30_531_911_680, "arctic-480b": 476_849_766_400}
TOL_F32 = 1e-4
TOL_BF16_MEAN = 0.04
TOL_BF16_FLIPS = 0.05
FLIP = 0.1
TOL_BF16_LOSS = 0.02


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype):
    """(JAX config, port config, JAX parameters as numpy, the port's LM)."""
    jcfg = jax_smoke_config(arch).scaled(dtype=dtype)
    pcfg = smoke_config(arch).scaled(dtype=dtype)
    jp = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(1)))
    return jcfg, pcfg, jp, from_jax_params(pcfg, jp, device="cpu")


def _jax(jp):
    return jax.tree.map(jnp.asarray, jp)


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(a, b):
    return float(np.max(np.abs(_f(a) - _f(b))))


def _bf16_readings(a, b):
    """(mean |a - b| over all logits, the share of positions whose logits'
    max |a - b| exceeds FLIP)."""
    d = np.abs(_f(a) - _f(b))
    return float(d.mean()), float((d.max(-1) > FLIP).mean())


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_bf16_forward(arch):
    """JAX's bf16 logits on the bf16 tests' tokens, and those tokens."""
    jcfg, pcfg, jp, _ = _pair(arch, "bfloat16")
    toks = _tokens(1, 2, 96, pcfg.vocab_size)
    return toks, _f(JT.forward(jcfg, _jax(jp), {"tokens": jnp.asarray(toks)}))


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
    assert pc.active_param_count() == jc.active_param_count()
    assert pc.num_groups == jc.num_groups and pc.vocab_padded == jc.vocab_padded
    assert arch in ARCH_NAMES


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_count(arch):
    """param_count() of the full config is the reference's, and the port's
    module (on the meta device) holds exactly those matrices plus the norms;
    each layer's MLP is the MoE layer (qwen3) or a dense MLP beside it
    (arctic)."""
    cfg = get_config(arch)
    assert cfg.param_count() == PARAMS[arch]
    lm = T.LM(cfg, device="meta")
    n = sum(p.numel() for p in lm.parameters())
    assert cfg.vocab_padded == cfg.vocab_size
    assert n == cfg.param_count() + (2 * cfg.num_layers + 1) * cfg.d_model
    blk = lm.blocks[0]
    assert hasattr(blk, "moe") and hasattr(blk, "mlp") == (arch == "arctic-480b")
    assert tuple(blk.moe.w_gate.shape) == (cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    assert tuple(blk.moe.w_down.shape) == (cfg.num_experts, cfg.moe_d_ff, cfg.d_model)
    assert blk.moe.router.dtype == torch.float32 and blk.moe.w_up.dtype == torch.bfloat16
    if arch == "qwen3-moe-30b-a3b":
        assert cfg.active_param_count() == 3_352_821_760


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_converter_carries_every_leaf_exactly(arch, dtype):
    """Every leaf of the JAX tree, the MoE layer's router and experts
    included, lands bit for bit in its layer of the port."""
    jcfg, pcfg, jp, lm = _pair(arch, dtype)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    named = dict(lm.named_parameters())
    assert len(named) == sum(
        np.asarray(leaf).shape[0] if path[0].key == "blocks" else 1 for path, leaf in flat)
    assert {"blocks.0.moe.router", "blocks.1.moe.w_gate", "blocks.1.moe.w_down"} <= set(named)
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


@pytest.mark.parametrize("leaf", ["router", "w_gate", "w_down"])
def test_converter_names_a_moe_leaf_of_another_shape(leaf):
    jcfg, pcfg, jp, _ = _pair("qwen3-moe-30b-a3b", "float32")
    bad = jax.tree.map(lambda a: a, jp)
    bad["blocks"][0]["moe"][leaf] = bad["blocks"][0]["moe"][leaf][..., :-1]
    with pytest.raises(ValueError, match=rf"blocks\[0\]\[0\]\.moe\.{leaf}: JAX shape"):
        from_jax_params(pcfg, bad, device="cpu")
    dense = smoke_config("command-r-35b")
    with pytest.raises(ValueError, match=r"blocks\[0\]\[0\]\.moe: no such parameter"):
        from_jax_params(dense.scaled(d_ff=64, dtype="float32"), jp, device="cpu")


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [100, 2100], ids=["lossless", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax_float32(arch, s):
    """Both capacity regimes: 2 x 100 tokens (400 routed pairs, lossless)
    and 2 x 2,100 (8,400 pairs: cap 1,313 an expert, pairs dropped)."""
    jcfg, pcfg, jp, lm = _pair(arch, "float32")
    toks = _tokens(0, 2, s, pcfg.vocab_size)
    want = JT.forward(jcfg, _jax(jp), {"tokens": jnp.asarray(toks)})
    PM.stats = {}
    try:
        got = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
        st = PM.stats
    finally:
        PM.stats = None
    assert got.shape == (2, s, pcfg.vocab_padded) and got.dtype == torch.float32
    assert _err(got, want) < TOL_F32
    n = 2 * s * pcfg.experts_per_token
    assert st["routed"] == n * pcfg.num_layers
    assert (int(st["kept"]) < st["routed"]) == (s == 2100)
    if s == 2100:
        return
    mask = (np.arange(s)[None] % 3 != 0).astype(np.int32).repeat(2, 0)
    for batch in ({"tokens": toks}, {"tokens": toks, "loss_mask": mask}):
        jl = float(JT.loss_fn(jcfg, _jax(jp), {k: jnp.asarray(v) for k, v in batch.items()}))
        tl = float(T.loss_fn(pcfg, lm, batch, device="cpu"))
        assert abs(jl - tl) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax_bfloat16(arch):
    jcfg, pcfg, jp, lm = _pair(arch, "bfloat16")
    toks, want = _jax_bf16_forward(arch)
    got = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    mean, flips = _bf16_readings(got, want)
    assert mean < TOL_BF16_MEAN and flips < TOL_BF16_FLIPS
    jl = float(JT.loss_fn(jcfg, _jax(jp), {"tokens": jnp.asarray(toks)}))
    tl = float(T.loss_fn(pcfg, lm, {"tokens": toks}, device="cpu"))
    assert abs(jl - tl) < TOL_BF16_LOSS


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_bound_is_above_jax_own_rounding(arch):
    """The bf16 bounds' reason: JAX's bf16 forward against its float32
    forward of the same parameters (the bf16 ones, widened) reads a visible
    fraction of each, with routing flips among the positions, and the port's
    bf16 logits sit as close to that float32 forward."""
    jcfg, pcfg, jp, lm = _pair(arch, "bfloat16")
    toks, jbf16 = _jax_bf16_forward(arch)
    jwide = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    j32 = JT.forward(jcfg.scaled(dtype="float32"), jwide, {"tokens": jnp.asarray(toks)})
    own_mean, own_flips = _bf16_readings(jbf16, j32)
    assert TOL_BF16_MEAN / 10 < own_mean < TOL_BF16_MEAN
    assert 0 < own_flips < TOL_BF16_FLIPS and _err(jbf16, j32) > 1.0
    port_mean, port_flips = _bf16_readings(T.forward(pcfg, lm, {"tokens": toks}, device="cpu"),
                                           j32)
    assert port_mean < TOL_BF16_MEAN and port_flips < TOL_BF16_FLIPS


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """A prompt of 36 tokens, then 4 decode steps (each a lossless pass of
    2 tokens): logits and the KV caches equal JAX's."""
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
    kv, jkv = tc["pos0"]["attn"], jc["pos0"]["attn"]
    assert kv["len"].tolist() == np.asarray(jkv["len"]).tolist() == [s + extra] * pcfg.num_groups
    for name in ("k", "v"):
        assert _err(kv[name], jkv[name]) < TOL_F32
    # The lossless forward of the same tokens gives the same logits.
    fwd = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    assert _err(fwd[:, -1], tl[:, 0]) < TOL_F32


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_server_tokens_equal_jax(arch):
    """Ragged prompts right-aligned behind zero tokens by both servers, on
    fewer slots than requests: the pad tokens are routed, and take their
    experts' first slots, as in the reference."""
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
