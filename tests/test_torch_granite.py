"""The port's granite-3-8b (GQA attention, KV cache) against the JAX
package's, on the CPU.

The JAX package's parameters (``init_params`` from a seed) are carried into
the port with ``convert.from_jax_params``; tokens and activations are made
with numpy from a seed. Tolerances:

* float32 (``smoke_config("granite-3-8b").scaled(dtype="float32")``): 1e-4
  on logits and blocks (float32 summation order only); greedy tokens are
  equal.
* bfloat16 (the default dtype): the two frameworks round at other places
  (the projections' bf16 products, RoPE's cast back, attention's output
  cast), so the bound on the logits is 0.05, about five times the JAX
  package's own rounding: on the same input its bfloat16 forward differs from
  its float32 one by 0.0105, on logits of at most 0.68
  (``test_bfloat16_bound_is_above_jax_own_rounding`` measures it); 0.02 on
  the loss.
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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve.engine import BatchedServer as JaxServer
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.engine import BatchedServer, Request, ServeConfig

ARCH = "granite-3-8b"
TOL_F32 = 1e-4
TOL_BF16_LOGITS = 0.05
TOL_BF16_LOSS = 0.02


def _pair(dtype, **overrides):
    jcfg = jax_smoke_config(ARCH).scaled(dtype=dtype, **overrides)
    pcfg = smoke_config(ARCH).scaled(dtype=dtype, **overrides)
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
# Config, parameters, converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_equals_jax(which):
    jc = jax_get_config(ARCH) if which == "full" else jax_smoke_config(ARCH)
    pc = get_config(ARCH) if which == "full" else smoke_config(ARCH)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.param_count() == jc.param_count()
    assert pc.num_groups == jc.num_groups and pc.vocab_padded == jc.vocab_padded
    assert ARCH in ARCH_NAMES


def test_full_config_is_the_8b_model():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab_size) == (40, 4096, 32, 8, 128, 12800, 49155)
    assert cfg.vocab_padded == 49216 and cfg.tie_embeddings and cfg.attn_softcap is None
    assert cfg.param_count() == 8_170_516_480
    attn = 4096 * (32 + 2 * 8) * 128 + 32 * 128 * 4096
    assert attn == 41_943_040 and 3 * 4096 * 12800 == 157_286_400
    # The module's parameters: embed (padded rows, tied) + 40 layers + final norm.
    lm = T.LM(cfg, device="meta")
    n = sum(p.numel() for p in lm.parameters())
    assert n == 49216 * 4096 + 40 * (attn + 157_286_400 + 2 * 4096) + 4096


def test_init_params_has_jax_shapes_dtypes_and_scales():
    cfg = smoke_config(ARCH).scaled(d_model=256, num_heads=8, num_kv_heads=2, head_dim=32)
    lm = T.init_params(cfg, seed=3, device="cpu")
    jshapes = JT.param_shapes(jax_smoke_config(ARCH).scaled(d_model=256, num_heads=8,
                                                            num_kv_heads=2, head_dim=32))
    flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    named = dict(lm.named_parameters())
    for path, leaf in flat:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[0] != "blocks":
            t = named[keys[0]]
            assert tuple(t.shape) == leaf.shape
            continue
        for g in range(leaf.shape[0]):
            t = named[".".join(["blocks", str(g * cfg.period + keys[1])] + list(keys[2:]))]
            assert tuple(t.shape) == leaf.shape[1:] and str(t.dtype)[6:] == str(leaf.dtype)
    wq = lm.blocks[1].attn.wq.float()
    assert abs(float(wq.std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert abs(float(lm.embed.float().std()) - 0.02) < 0.002
    assert not lm.blocks[0].ln1.any() and not lm.final_norm.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_carries_every_leaf_exactly(dtype, f32, bf16):
    jcfg, pcfg, jp, lm = f32 if dtype == "float32" else bf16
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    named = dict(lm.named_parameters())
    assert len(named) == sum(
        np.asarray(leaf).shape[0] if path[0].key == "blocks" else 1 for path, leaf in flat)
    assert {"blocks.1.attn.wq", "blocks.1.attn.wk", "blocks.1.attn.wv",
            "blocks.1.attn.wo"} <= set(named)
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


def test_qkv_bias_is_carried_and_applied():
    jcfg, pcfg, jp, lm = _pair("float32", qkv_bias=True)
    rng = np.random.default_rng(4)
    jp = jax.tree.map(np.asarray, jp)
    for name in ("bq", "bk", "bv"):  # zero at init: give them values
        jp["blocks"][0]["attn"][name] = rng.standard_normal(
            jp["blocks"][0]["attn"][name].shape).astype(np.float32)
    lm = from_jax_params(pcfg, jp, device="cpu")
    assert float(lm.blocks[1].attn.bq.abs().sum()) > 0
    toks = _tokens(4, 2, 24, pcfg.vocab_size)
    want = JT.forward(jcfg, jax.tree.map(jnp.asarray, jp), {"tokens": jnp.asarray(toks)})
    assert _err(T.forward(pcfg, lm, {"tokens": toks}, device="cpu"), want) < TOL_F32


# ---------------------------------------------------------------------------
# RoPE and the attention block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches_jax(fraction, dtype):
    """Interleaved pairs (x[..., 0::2], x[..., 1::2]), float32 math, cast back;
    a partial fraction leaves the tail dimensions as they are."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [40, 41, 42, 43, 44, 45, 46]], np.int32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = JL.apply_rope(jx, jnp.asarray(pos), 1e4, fraction)
    got = L.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos),
                       1e4, fraction)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    assert _err(got, want) <= (1e-6 if dtype == "float32" else 2 ** -7 * 4)
    if fraction < 1.0:
        assert torch.equal(got[..., 8:], torch.from_numpy(x).to(got.dtype)[..., 8:])


@pytest.mark.parametrize("branch", ["none", "prefill", "decode"])
def test_attention_block_matches_jax(f32, branch):
    jcfg, pcfg, jp, lm = f32
    spec = pcfg.attn_spec(False)
    jspec = jcfg.attn_spec(False)
    rng = np.random.default_rng(7)
    b, max_len = 2, 24
    s = 1 if branch == "decode" else 13
    start = 13 if branch == "decode" else 0
    x = rng.standard_normal((b, s, pcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(start, start + s)[None], (b, s)).astype(np.int32)
    jparams = jax.tree.map(lambda a: a[1], jp["blocks"][0]["attn"])  # layer 1
    jcache = tcache = None
    if branch != "none":
        kv0 = rng.standard_normal((2, b, max_len, pcfg.num_kv_heads, pcfg.hd)).astype(np.float32)
        kv0[:, :, start:] = 0.0
        jcache = {"k": jnp.asarray(kv0[0]), "v": jnp.asarray(kv0[1]), "len": jnp.int32(start)}
        tcache = {"k": torch.from_numpy(kv0[0].copy()), "v": torch.from_numpy(kv0[1].copy()),
                  "len": start}
    jy, jc = JL.attention_block(jparams, jnp.asarray(x), jspec, jnp.asarray(pos), jcache,
                                chunk=jcfg.attn_chunk)
    ty, tc = L.attention_block(lm.blocks[1].attn, torch.from_numpy(x), spec,
                               torch.from_numpy(pos), tcache, chunk=pcfg.attn_chunk)
    assert ty.shape == (b, s, pcfg.d_model) and _err(ty, jy) < TOL_F32
    if branch == "none":
        assert jc is None and tc is None
    else:
        assert tc["len"] == int(jc["len"]) == start + s
        assert tc["k"] is tcache["k"]  # written in place
        assert _err(tc["k"], jc["k"]) < TOL_F32 and _err(tc["v"], jc["v"]) < TOL_F32


@pytest.mark.parametrize("branch", ["none", "prefill", "decode"])
def test_local_attention_block_matches_jax(f32, branch):
    """granite's layer with a sliding window of 8 keys (gemma2's local
    layers' mask) against JAX's ``attention_block`` with the same window:
    a 13-token prompt, or one decode step at position 13 over a cache, both
    past the window; the window moves the output here."""
    jcfg, pcfg, jp, lm = f32
    spec = dataclasses.replace(pcfg.attn_spec(False), window=8)
    jspec = dataclasses.replace(jcfg.attn_spec(False), window=8)
    rng = np.random.default_rng(8)
    b, max_len = 2, 24
    s = 1 if branch == "decode" else 13
    start = 13 if branch == "decode" else 0
    x = rng.standard_normal((b, s, pcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(start, start + s)[None], (b, s)).astype(np.int32)
    jparams = jax.tree.map(lambda a: a[1], jp["blocks"][0]["attn"])  # layer 1
    jcache = tcache = None
    if branch != "none":
        kv0 = rng.standard_normal((2, b, max_len, pcfg.num_kv_heads, pcfg.hd)).astype(np.float32)
        kv0[:, :, start:] = 0.0
        jcache = {"k": jnp.asarray(kv0[0]), "v": jnp.asarray(kv0[1]), "len": jnp.int32(start)}
        tcache = {"k": torch.from_numpy(kv0[0].copy()), "v": torch.from_numpy(kv0[1].copy()),
                  "len": start}
    jy, jc = JL.attention_block(jparams, jnp.asarray(x), jspec, jnp.asarray(pos), jcache,
                                chunk=jcfg.attn_chunk)
    ty, tc = L.attention_block(lm.blocks[1].attn, torch.from_numpy(x), spec,
                               torch.from_numpy(pos), tcache, chunk=pcfg.attn_chunk)
    assert ty.shape == (b, s, pcfg.d_model) and _err(ty, jy) < TOL_F32
    if branch != "none":
        assert tc["len"] == int(jc["len"]) == start + s
        assert _err(tc["k"], jc["k"]) < TOL_F32 and _err(tc["v"], jc["v"]) < TOL_F32
        tcache["len"] = start  # the same call again without the window
    wide, _ = L.attention_block(lm.blocks[1].attn, torch.from_numpy(x), pcfg.attn_spec(False),
                                torch.from_numpy(pos), tcache, chunk=pcfg.attn_chunk)
    assert _err(wide, jy) > 10 * TOL_F32


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def test_forward_and_loss_match_jax_float32(f32):
    jcfg, pcfg, jp, lm = f32
    toks = _tokens(0, 2, 150, pcfg.vocab_size)  # > attn_chunk: several KV chunks
    want = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    assert got.shape == (2, 150, pcfg.vocab_padded) and got.dtype == torch.float32
    assert _err(got, want) < TOL_F32
    mask = (np.arange(150)[None] % 3 != 0).astype(np.int32).repeat(2, 0)
    for batch in ({"tokens": toks}, {"tokens": toks, "loss_mask": mask}):
        jl = float(JT.loss_fn(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()}))
        tl = float(T.loss_fn(pcfg, lm, batch, device="cpu"))
        assert abs(jl - tl) < 1e-5


def test_forward_and_loss_match_jax_bfloat16(bf16):
    jcfg, pcfg, jp, lm = bf16
    toks = _tokens(1, 2, 96, pcfg.vocab_size)
    want = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert _err(got, want) < TOL_BF16_LOGITS
    jl = float(JT.loss_fn(jcfg, jp, {"tokens": jnp.asarray(toks)}))
    tl = float(T.loss_fn(pcfg, lm, {"tokens": toks}, device="cpu"))
    assert abs(jl - tl) < TOL_BF16_LOSS


def test_bfloat16_bound_is_above_jax_own_rounding(f32, bf16):
    """The bf16 bound's reason: JAX's bf16 forward against its float32 forward
    of the same parameters (the bf16 ones, widened) is already a visible
    fraction of it, and the port's bf16 logits sit as close to JAX's."""
    jcfg, pcfg, jp, lm = bf16
    toks = _tokens(1, 2, 96, pcfg.vocab_size)
    jwide = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    j32 = JT.forward(jcfg.scaled(dtype="float32"), jwide, {"tokens": jnp.asarray(toks)})
    own = _err(JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)}), j32)
    port = _err(T.forward(pcfg, lm, {"tokens": toks}, device="cpu"), j32)
    assert 0.005 < own < TOL_BF16_LOGITS and port < TOL_BF16_LOGITS


@pytest.mark.parametrize("s", [16, 37])
def test_prefill_and_decode_match_jax(f32, s):
    jcfg, pcfg, jp, lm = f32
    extra, max_len = 3, s + 3 + 2
    toks = _tokens(s, 2, s + extra, pcfg.vocab_size)
    jc, jlast = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :s])}, max_len=max_len)
    tc, tlast = T.prefill(pcfg, lm, {"tokens": toks[:, :s]}, max_len, device="cpu")
    assert tlast.shape == (2, 1, pcfg.vocab_padded) and _err(tlast, jlast) < TOL_F32
    kv = tc["pos0"]["attn"]
    assert kv["k"].shape == (pcfg.num_groups, 2, max_len, pcfg.num_kv_heads, pcfg.hd)
    assert kv["len"].tolist() == np.asarray(jc["pos0"]["attn"]["len"]).tolist() == [s, s]
    for i in range(extra):
        step = toks[:, s + i : s + i + 1]
        jl, jc = JT.decode_step(jcfg, jp, jc, jnp.asarray(step), jnp.int32(s + i))
        tl, tc = T.decode_step(pcfg, lm, tc, step, s + i, device="cpu")
        assert _err(tl, jl) < TOL_F32
        assert int(tc["pos0"]["attn"]["len"][0]) == s + i + 1
    for name in ("k", "v"):
        assert _err(tc["pos0"]["attn"][name], jc["pos0"]["attn"][name]) < TOL_F32


def test_prefill_and_decode_match_the_forward_pass(bf16):
    """tests/test_models.py::test_prefill_decode_matches_forward, in the port."""
    jcfg, pcfg, jp, lm = bf16
    s, extra = 16, 3
    toks = _tokens(7, 2, s + extra, pcfg.vocab_size)
    full = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    cache, last = T.prefill(pcfg, lm, {"tokens": toks[:, :s]}, s + extra + 2, device="cpu")
    assert _err(last[:, 0], full[:, s - 1]) < 0.05
    for i in range(extra):
        logits, cache = T.decode_step(pcfg, lm, cache, toks[:, s + i : s + i + 1], s + i,
                                      device="cpu")
        assert _err(logits[:, 0], full[:, s + i]) < 0.05


def test_vocab_pad_mask_matches_jax():
    """A vocabulary that is not a multiple of 64 (granite's 49155 pads to
    49216): the padded logits are -1e30, as in the JAX package."""
    jcfg, pcfg, jp, lm = _pair("float32", vocab_size=250)
    assert pcfg.vocab_padded == 256
    toks = _tokens(2, 2, 20, 250)
    want = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got = T.forward(pcfg, lm, {"tokens": toks}, device="cpu")
    assert _err(got, want) < TOL_F32
    assert bool((got[..., 250:] == -1e30).all()) and bool((got[..., :250] > -1e29).all())
    jl = float(JT.loss_fn(jcfg, jp, {"tokens": jnp.asarray(toks)}))
    assert abs(float(T.loss_fn(pcfg, lm, {"tokens": toks}, device="cpu")) - jl) < 1e-5


def test_kv_cache_overflow_raises(f32):
    """jax.lax.dynamic_update_slice clamps a write past max_len to start at
    max_len − S; the port raises instead (ROADMAP Queue 3). The server sizes
    max_len so that neither happens."""
    jcfg, pcfg, jp, lm = f32
    toks = _tokens(3, 2, 10, pcfg.vocab_size)
    with pytest.raises(ValueError, match="KV cache overflow"):
        T.prefill(pcfg, lm, {"tokens": toks}, 8, device="cpu")
    cache, _ = T.prefill(pcfg, lm, {"tokens": toks}, 10, device="cpu")
    with pytest.raises(ValueError, match="KV cache overflow"):
        T.decode_step(pcfg, lm, cache, toks[:, :1], 10, device="cpu")


def test_decode_position_must_be_the_cache_length(f32):
    jcfg, pcfg, jp, lm = f32
    toks = _tokens(4, 2, 12, pcfg.vocab_size)
    cache, _ = T.prefill(pcfg, lm, {"tokens": toks}, 16, device="cpu")
    with pytest.raises(ValueError, match="position 11 is not the KV cache's length 12"):
        T.decode_step(pcfg, lm, cache, toks[:, :1], 11, device="cpu")
    assert int(cache["pos0"]["attn"]["len"][0]) == 12  # nothing was written
    a, _ = T.decode_step(pcfg, lm, cache, toks[:, :1], None, device="cpu")
    cache2, _ = T.prefill(pcfg, lm, {"tokens": toks}, 16, device="cpu")
    b, _ = T.decode_step(pcfg, lm, cache2, toks[:, :1], 12, device="cpu")
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _prompts(n, vocab, seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=lengths[i % len(lengths)]).astype(np.int32)
            for i in range(n)]


def test_greedy_server_tokens_equal_jax(f32):
    """Ragged prompts: the server right-aligns them behind zero tokens, which
    both attend to unmasked."""
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


def test_greedy_serving_matches_jax_in_bfloat16():
    """tests/test_serve.py::test_greedy_serving_matches_forward_argmax's
    setup (bf16, parameters from key 0): the port's tokens equal JAX's, and
    the first is the argmax of the port's own forward pass."""
    jcfg = jax_smoke_config(ARCH)
    pcfg = smoke_config(ARCH)
    jp = JT.init_params(jcfg, jax.random.key(0))
    lm = from_jax_params(pcfg, jax.tree.map(np.asarray, jp), device="cpu")
    prompt = np.random.default_rng(0).integers(2, pcfg.vocab_size, size=12).astype(np.int32)
    kw = dict(max_len=32, batch_slots=2, temperature=0.0, max_new_tokens=5, eos_token=-1)
    jreqs = [JaxRequest(prompt=prompt.copy()) for _ in range(2)]
    treqs = [Request(prompt=prompt.copy()) for _ in range(2)]
    JaxServer(jcfg, jp, JaxServeConfig(**kw)).run(jreqs)
    BatchedServer(pcfg, lm, ServeConfig(**kw), device="cpu").run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert treqs[0].out_tokens == treqs[1].out_tokens
    logits = T.forward(pcfg, lm, {"tokens": prompt[None]}, device="cpu")
    assert treqs[0].out_tokens[0] == int(torch.argmax(logits[0, -1].float()))


def test_serve_cli_smoke_on_cpu(capsys):
    stats = serve_cli.main(["lm", "--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "8", "--max-new", "4",
                            "--slots", "2"])
    assert stats["requests"] == 3 and stats["new_tokens"] == 3 * 3
    assert "[serve] granite-3-8b on cpu: 3 requests" in capsys.readouterr().out
    assert attn_ops.launches["flash_attention"] == 0


def test_entry_points_raise_without_cuda(f32):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    jcfg, pcfg, jp, lm = f32
    toks = _tokens(5, 1, 6, pcfg.vocab_size)
    cache, _ = T.prefill(pcfg, lm, {"tokens": toks}, 8, device="cpu")
    for call in (
        lambda: T.forward(pcfg, lm, {"tokens": toks}),
        lambda: T.prefill(pcfg, lm, {"tokens": toks}, 8),
        lambda: T.decode_step(pcfg, lm, cache, toks[:, :1], 6),
        lambda: T.init_cache(pcfg, 1, 8),
        lambda: serve_cli.main(["lm", "--arch", ARCH, "--smoke", "--requests", "1"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
