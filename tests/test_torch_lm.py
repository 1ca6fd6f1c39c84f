"""The port's RWKV6 language model against the JAX package's, on the CPU.

The JAX package's parameters (``init_params`` from a seed) are carried into
the port with ``convert.from_jax_params``; tokens and activations are made
with numpy from a seed. Tolerances:

* float32 (``smoke_config("rwkv6-7b").scaled(dtype="float32")``): 1e-4 on
  logits of magnitude ~5 and on blocks, float32 summation order only; greedy
  tokens are equal.
* bfloat16 (the default dtype): the two frameworks round at other places, so
  the bound is 0.25 on the logits — on the same input the JAX package's own
  bfloat16 forward differs from its float32 one by 0.19 — and 0.02 on the loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.serve.engine import BatchedServer as JaxServer
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.convert import from_jax_params, to_tensor
from repro_torch.models.layers import rmsnorm
from repro_torch.serve.engine import BatchedServer, Request, ServeConfig

ARCH = "rwkv6-7b"
TOL_F32 = 1e-4
TOL_BF16_LOGITS = 0.25
TOL_BF16_LOSS = 0.02


def _pair(dtype):
    jcfg = jax_smoke_config(ARCH).scaled(dtype=dtype)
    pcfg = smoke_config(ARCH).scaled(dtype=dtype)
    jp = JT.init_params(jcfg, jax.random.key(1))
    return jcfg, pcfg, jp, from_jax_params(pcfg, jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def f32():
    return _pair("float32")


@pytest.fixture(scope="module")
def bf16():
    return _pair("bfloat16")


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(a, b):
    return float(np.max(np.abs(_f(a) - _f(b))))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Configs and the converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_equals_jax(which):
    jc = jax_get_config(ARCH) if which == "full" else jax_smoke_config(ARCH)
    pc = get_config(ARCH) if which == "full" else smoke_config(ARCH)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.param_count() == jc.param_count()
    assert pc.num_groups == jc.num_groups and pc.vocab_padded == jc.vocab_padded
    assert ARCH_NAMES == [ARCH, "granite-3-8b", "gemma2-9b", "chatglm3-6b", "command-r-35b",
                          "qwen3-moe-30b-a3b", "arctic-480b"]


def test_full_config_is_the_7b_model():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.hd, cfg.d_ff, cfg.vocab_size) == \
        (32, 4096, 64, 64, 14336, 65536)
    assert cfg.param_count() == 8_875_147_264


def test_unported_mixer_raises_by_name():
    jamba = T.ModelConfig(**dataclasses.asdict(jax_smoke_config("jamba-v0.1-52b")))
    with pytest.raises(NotImplementedError, match="'mamba'"):
        T.LM(jamba, device="cpu")
    with pytest.raises(NotImplementedError, match="'mamba'"):
        T.init_cache(jamba, 1, 8, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_carries_every_leaf_exactly(dtype, f32, bf16):
    jcfg, pcfg, jp, lm = f32 if dtype == "float32" else bf16
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    named = dict(lm.named_parameters())
    assert len(named) == sum(
        np.asarray(leaf).shape[0] if path[0].key == "blocks" else 1 for path, leaf in flat)
    for path, leaf in flat:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        arr = np.asarray(leaf)
        if keys[0] == "blocks":
            pos = keys[1]
            for g in range(arr.shape[0]):
                name = ".".join(["blocks", str(g * pcfg.period + pos)] + list(keys[2:]))
                _same(named[name], arr[g])
        else:
            _same(named[keys[0]], arr)


def _same(t, arr):
    want_dtype = torch.bfloat16 if arr.dtype == ml_dtypes.bfloat16 else torch.float32
    assert t.dtype == want_dtype and tuple(t.shape) == arr.shape
    assert np.array_equal(t.to(torch.float32).numpy(), arr.astype(np.float32))


def test_bfloat16_numpy_goes_through_float32():
    arr = np.array([1.5, -3.140625, 1e-3, 65280.0], dtype=ml_dtypes.bfloat16)
    with pytest.raises(TypeError):
        torch.from_numpy(arr)
    t = to_tensor(arr, torch.bfloat16, "cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.to(torch.float32).numpy(), arr.astype(np.float32))


# ---------------------------------------------------------------------------
# The RWKV6 block, its three branches
# ---------------------------------------------------------------------------

def _block_inputs(pcfg, jp, lm, s, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, s, pcfg.d_model)).astype(np.float32)
    xp = rng.standard_normal((2, pcfg.d_model)).astype(np.float32)
    hd = pcfg.d_model // pcfg.num_heads
    S = rng.standard_normal((2, pcfg.num_heads, hd, hd)).astype(np.float32)
    jparams = jax.tree.map(lambda a: a[1], jp["blocks"][0]["rwkv"])  # layer 1
    return x, xp, S, jparams, lm.blocks[1].rwkv


@pytest.mark.parametrize("branch,s", [("none", 64), ("prefill", 64), ("prefill", 37),
                                      ("decode", 1)])
def test_rwkv6_block_matches_jax(f32, branch, s):
    jcfg, pcfg, jp, lm = f32
    x, xp, S, jparams, mod = _block_inputs(pcfg, jp, lm, s, seed=s)
    jstate = None if branch == "none" else (jnp.asarray(xp), jnp.asarray(S))
    tstate = None if branch == "none" else (torch.from_numpy(xp), torch.from_numpy(S))
    jy, (jx, js) = jssm.rwkv6_block(jparams, jnp.asarray(x), pcfg.num_heads, jstate)
    ty, (tx, ts) = ssm.rwkv6_block(mod, torch.from_numpy(x), pcfg.num_heads, tstate)
    assert _err(ty, jy) < TOL_F32
    assert torch.equal(tx, torch.from_numpy(x[:, -1]))  # token shift carries x[:, -1]
    assert _err(tx, jx) == 0
    if branch == "none":
        assert js is None and ts is None
    else:
        assert ts.shape == S.shape and _err(ts, js) < TOL_F32


def test_rwkv6_block_bfloat16_rounds_like_jax(bf16, monkeypatch):
    """In bfloat16 the block rounds w to the activation dtype before the
    mixer and casts ln_out to it before the product, as the JAX package does;
    the group norm is an RMSNorm over hd with a zero gamma. With these the
    block stays within bfloat16 rounding of the JAX block."""
    jcfg, pcfg, jp, lm = bf16
    x, xp, S, jparams, mod = _block_inputs(pcfg, jp, lm, 64, seed=3)
    seen = {}
    real = rwkv_ops.rwkv6

    def spy(r, k, v, w, u, **kw):
        seen.update(r=r.dtype, w=w.dtype, u=u.dtype)
        return real(r, k, v, w, u, **kw)

    monkeypatch.setattr(rwkv_ops, "rwkv6", spy)
    jy, _ = jssm.rwkv6_block(jparams, jnp.asarray(x, jnp.bfloat16), pcfg.num_heads)
    ty, _ = ssm.rwkv6_block(mod, torch.from_numpy(x).to(torch.bfloat16), pcfg.num_heads)
    assert seen == {"r": torch.bfloat16, "w": torch.bfloat16, "u": torch.float32}
    assert ty.dtype == torch.bfloat16
    assert _err(ty, jy) <= 2 ** -4 * max(1.0, float(np.max(np.abs(_f(jy)))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_is_rmsnorm_with_zero_gamma(dtype):
    from repro.models.layers import rmsnorm as jax_rmsnorm

    x = np.random.default_rng(0).standard_normal((2, 5, 4, 16)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = rmsnorm(tx, torch.zeros(16))
    want = jax_rmsnorm(jx, jnp.zeros((16,), jnp.float32))
    assert got.dtype == tx.dtype
    assert _err(got, want) <= (1e-6 if dtype == "float32" else 2 ** -7 * 4)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def test_forward_and_loss_match_jax_float32(f32):
    jcfg, pcfg, jp, lm = f32
    toks = _tokens(0, 2, 64, pcfg.vocab_size)
    want = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    assert got.shape == (2, 64, pcfg.vocab_padded) and got.dtype == torch.float32
    assert _err(got, want) < TOL_F32
    mask = (np.arange(64)[None] % 3 != 0).astype(np.int32).repeat(2, 0)
    for batch in ({"tokens": toks}, {"tokens": toks, "loss_mask": mask}):
        jl = float(JT.loss_fn(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()}))
        tl = float(T.loss_fn(pcfg, lm, batch, device="cpu"))
        assert abs(jl - tl) < 1e-5


def test_forward_and_loss_match_jax_bfloat16(bf16):
    jcfg, pcfg, jp, lm = bf16
    toks = _tokens(1, 2, 64, pcfg.vocab_size)
    want = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert _err(got, want) < TOL_BF16_LOGITS
    jl = float(JT.loss_fn(jcfg, jp, {"tokens": jnp.asarray(toks)}))
    tl = float(T.loss_fn(pcfg, lm, {"tokens": toks}, device="cpu"))
    assert abs(jl - tl) < TOL_BF16_LOSS


@pytest.mark.parametrize("s", [37, 64])
def test_prefill_and_decode_match_jax(f32, s):
    jcfg, pcfg, jp, lm = f32
    extra = 3
    toks = _tokens(s, 2, s + extra, pcfg.vocab_size)
    jc, jlast = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :s])}, max_len=s + extra)
    tc, tlast = T.prefill(pcfg, lm, {"tokens": toks[:, :s]}, s + extra, device="cpu")
    assert tlast.shape == (2, 1, pcfg.vocab_padded) and _err(tlast, jlast) < TOL_F32
    assert _err(tc["pos0"]["rwkv"][0], jc["pos0"]["rwkv"][0]) < TOL_F32
    assert _err(tc["pos0"]["rwkv"][1], jc["pos0"]["rwkv"][1]) < TOL_F32
    for i in range(extra):
        step = toks[:, s + i : s + i + 1]
        jl, jc = JT.decode_step(jcfg, jp, jc, jnp.asarray(step), jnp.int32(s + i))
        tl, tc = T.decode_step(pcfg, lm, tc, step, s + i, device="cpu")
        assert _err(tl, jl) < TOL_F32
        assert _err(tc["pos0"]["rwkv"][1], jc["pos0"]["rwkv"][1]) < TOL_F32


def test_prefill_and_decode_match_the_forward_pass(bf16):
    """tests/test_models.py::test_prefill_decode_matches_forward, in the port."""
    jcfg, pcfg, jp, lm = bf16
    s, extra = 16, 3
    toks = _tokens(7, 2, s + extra, pcfg.vocab_size)
    full = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    cache, last = T.prefill(pcfg, lm, {"tokens": toks[:, :s]}, s + extra, device="cpu")
    assert _err(last[:, 0], full[:, s - 1]) < 0.05
    for i in range(extra):
        logits, cache = T.decode_step(pcfg, lm, cache, toks[:, s + i : s + i + 1], s + i,
                                      device="cpu")
        assert _err(logits[:, 0], full[:, s + i]) < 0.05


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _prompts(n, vocab, seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=lengths[i % len(lengths)]).astype(np.int32)
            for i in range(n)]


def test_greedy_server_tokens_equal_jax(f32):
    jcfg, pcfg, jp, lm = f32
    prompts = _prompts(5, pcfg.vocab_size, 0, [12, 9, 12])
    kw = dict(max_len=32, batch_slots=3, temperature=0.0, max_new_tokens=6, eos_token=-1)
    jreqs = [JaxRequest(prompt=p.copy()) for p in prompts]
    treqs = [Request(prompt=p.copy()) for p in prompts]
    jstats = JaxServer(jcfg, jp, JaxServeConfig(**kw)).run(jreqs)
    tstats = BatchedServer(pcfg, lm, ServeConfig(**kw), device="cpu").run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == 6 and r.done and r.latency_s > 0 for r in treqs)
    for key in ("requests", "new_tokens"):
        assert tstats[key] == jstats[key]


def test_server_stops_at_eos_and_samples_with_its_generator(f32):
    jcfg, pcfg, jp, lm = f32
    prompts = _prompts(4, pcfg.vocab_size, 1, [8])
    greedy = [Request(prompt=p.copy()) for p in prompts]
    BatchedServer(pcfg, lm, ServeConfig(max_len=24, batch_slots=4, max_new_tokens=5,
                                        eos_token=-1), device="cpu").run(greedy)
    eos = greedy[0].out_tokens[2]
    stopped = [Request(prompt=p.copy()) for p in prompts]
    BatchedServer(pcfg, lm, ServeConfig(max_len=24, batch_slots=4, max_new_tokens=5,
                                        eos_token=eos), device="cpu").run(stopped)
    assert stopped[0].out_tokens == greedy[0].out_tokens[:3]

    def sampled(seed):
        reqs = [Request(prompt=p.copy()) for p in prompts]
        scfg = ServeConfig(max_len=24, batch_slots=2, temperature=0.7, max_new_tokens=4,
                           eos_token=-1)
        stats = BatchedServer(pcfg, lm, scfg, device="cpu",
                              generator=torch.Generator().manual_seed(seed)).run(reqs)
        assert stats["requests"] == 4 and stats["tokens_per_s"] > 0
        assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
        return [r.out_tokens for r in reqs]

    assert sampled(5) == sampled(5)


def test_serve_cli_smoke_on_cpu(capsys):
    stats = serve_cli.main(["lm", "--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "8", "--max-new", "4",
                            "--slots", "2"])
    assert stats["requests"] == 3 and stats["new_tokens"] == 3 * 3
    assert "[serve] rwkv6-7b on cpu: 3 requests" in capsys.readouterr().out
    tickets = serve_cli.main(["graph", "--vertices", "64", "--tenants", "1", "--requests", "1",
                              "--device", "cpu"])
    assert [t.status for t in tickets] == ["done"]
