"""The port's encoder–decoder (seamless-m4t-large-v2) against the JAX
package's, on the CPU, at its ``smoke()`` size (2 encoder and 2 decoder
layers, d 64, 4 heads of 16, ``attn_chunk`` 64).

The JAX package's parameters (``init_params`` from a seed) are carried into
the port with ``convert.from_jax_params``; frames and tokens are made with
numpy from a seed. The encoder's frames (80) and the decoder's tokens (70)
are longer than ``attn_chunk``, so both self-attentions walk several chunks;
the cross-attention test's memory of 600 frames is longer than the 512-key
chunk the reference's ``_cross_attention`` walks. Tolerances:

* float32: 1e-4 on the logits, the encoder's output, the memory and the KV
  caches (float32 summation order only), 1e-5 on the loss.
* bfloat16 (the default dtype): the dense-config file's bound for an untied
  lm_head with logits up to about 4 (chatglm3's): 0.15 on the logits, 0.02
  on the loss; ``test_bfloat16_bound_is_above_jax_own_rounding`` measures
  JAX's own rounding (its bf16 forward against its float32 forward of the
  same weights) and holds the bound within ten times of it.
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
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.engine import BatchedServer, Request, ServeConfig

ARCH = "seamless-m4t-large-v2"
FRAMES, TEXT = 80, 70
TOL_F32 = 1e-4
TOL_BF16_LOGITS = 0.15
TOL_BF16_LOSS = 0.02


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    """(JAX config, port config, JAX parameters as numpy, the port's LM)."""
    jcfg = jax_smoke_config(ARCH).scaled(dtype=dtype)
    pcfg = smoke_config(ARCH).scaled(dtype=dtype)
    jp = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(1)))
    return jcfg, pcfg, jp, from_jax_params(pcfg, jp, device="cpu")


def _jax(jp):
    return jax.tree.map(jnp.asarray, jp)


def _batch(seed, b=2, frames=FRAMES, text=TEXT):
    rng = np.random.default_rng(seed)
    d = smoke_config(ARCH).d_model
    return {"tokens": rng.integers(0, 256, (b, text)).astype(np.int32),
            "frontend": rng.standard_normal((b, frames, d)).astype(np.float32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_bf16_forward():
    jcfg, _, jp, _ = _pair("bfloat16")
    batch = _batch(1)
    return batch, _f(JT.forward(jcfg, _jax(jp), _jbatch(batch)))


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(a, b):
    return float(np.max(np.abs(_f(a) - _f(b))))


def _frames(pcfg, batch):
    return torch.from_numpy(batch["frontend"]).to(T.dtype_of(pcfg.dtype))


# ---------------------------------------------------------------------------
# Config, parameters, converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_equals_jax(which):
    jc = jax_get_config(ARCH) if which == "full" else jax_smoke_config(ARCH)
    pc = get_config(ARCH) if which == "full" else smoke_config(ARCH)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.param_count() == jc.param_count()
    assert ARCH in ARCH_NAMES


def test_full_config_parameter_count():
    """The full model: 24 encoder and 24 decoder layers of d 1,024 and 16
    heads of 64; the module holds param_count()'s matrices (the decoder's,
    the encoder's, the cross-attentions') plus the norms and the padded
    embedding rows."""
    cfg = get_config(ARCH)
    assert (cfg.encoder_layers, cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size, cfg.frontend_len) == (24, 24, 1024, 16, 64, 8192,
                                                             256206, 0)
    assert cfg.param_count() == 2_034_659_328
    lm = T.LM(cfg, device="meta")
    n = sum(p.numel() for p in lm.parameters())
    pad = (cfg.vocab_padded - cfg.vocab_size) * cfg.d_model * 2
    norms = (2 * cfg.num_layers + 2 * cfg.encoder_layers + cfg.num_layers + 2) * cfg.d_model
    assert n == cfg.param_count() + pad + norms


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_carries_every_leaf_exactly(dtype):
    """Every leaf of the JAX tree lands bit for bit in the port: the
    decoder's ``blocks``, the encoder's layers (``encoder`` [E, ...]),
    ``enc_norm`` and each decoder layer's cross-attention (``cross`` [L,
    ...]), each under its JAX name."""
    jcfg, pcfg, jp, lm = _pair(dtype)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    named = dict(lm.named_parameters())
    stacked = ("blocks", "encoder", "cross")
    assert len(named) == sum(
        np.asarray(leaf).shape[0] if path[0].key in stacked else 1 for path, leaf in flat)
    assert {"encoder.1.attn.wk", "encoder.0.mlp.w_down", "enc_norm", "cross.1.ln",
            "cross.0.attn.wv"} <= set(named)
    for path, leaf in flat:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        arr = np.asarray(leaf)
        if keys[0] == "blocks":
            for g in range(arr.shape[0]):
                name = ".".join(["blocks", str(g * pcfg.period + keys[1])] + list(keys[2:]))
                _same(named[name], arr[g])
        elif keys[0] in ("encoder", "cross"):
            for i in range(arr.shape[0]):
                _same(named[".".join([keys[0], str(i)] + list(keys[1:]))], arr[i])
        else:
            _same(named[keys[0]], arr)


def _same(t, arr):
    want_dtype = torch.bfloat16 if arr.dtype == ml_dtypes.bfloat16 else torch.float32
    assert t.dtype == want_dtype and tuple(t.shape) == arr.shape
    assert np.array_equal(t.to(torch.float32).numpy(), arr.astype(np.float32))


def test_init_params_has_the_references_shapes_and_scales():
    """The port's own draw: the JAX tree's shapes and dtypes leaf for leaf,
    norms zero, projections of standard deviation fan_in ** -0.5."""
    _, pcfg, jp, ref = _pair("bfloat16")
    lm = T.init_params(pcfg, seed=3, device="cpu")
    drawn = dict(lm.named_parameters())
    assert drawn.keys() == dict(ref.named_parameters()).keys()
    for name, p in ref.named_parameters():
        assert drawn[name].shape == p.shape and drawn[name].dtype == p.dtype, name
    assert float(lm.enc_norm.abs().sum()) == 0 and float(lm.cross[1].ln.abs().sum()) == 0
    std = float(lm.encoder[0].attn.wq.float().std()) * pcfg.d_model ** 0.5
    assert 0.9 < std < 1.1


# ---------------------------------------------------------------------------
# The encoder, the memory, the cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    """``_encode`` (bidirectional self-attention with RoPE over the frames,
    the MLP, ``enc_norm``) against JAX's. In bf16 the output is normed to
    about 1: held to 0.05 (a few bf16 ulps of its largest values)."""
    jcfg, pcfg, jp, lm = _pair(dtype)
    batch = _batch(2)
    want = JT._encode(jcfg, _jax(jp), jnp.asarray(batch["frontend"]))
    got = T._encode(pcfg, lm, _frames(pcfg, batch))
    assert got.shape == (2, FRAMES, pcfg.d_model) and got.dtype == T.dtype_of(dtype)
    assert _err(got, want) < (TOL_F32 if dtype == "float32" else 0.05)


def test_encoder_is_bidirectional():
    """A change to the last frame moves the encoder's output at the first
    frame (a causal encoder would leave it), as it moves JAX's."""
    jcfg, pcfg, jp, lm = _pair("float32")
    batch = _batch(3)
    moved = dict(batch, frontend=batch["frontend"].copy())
    moved["frontend"][:, -1] += 1.0
    a = T._encode(pcfg, lm, _frames(pcfg, batch))
    b = T._encode(pcfg, lm, _frames(pcfg, moved))
    assert _err(a[:, 0], b[:, 0]) > 1e-3
    jb = JT._encode(jcfg, _jax(jp), jnp.asarray(moved["frontend"]))
    assert _err(b, jb) < TOL_F32


def test_memory_kv_and_cross_attention_match_jax():
    """Each decoder layer's memory (``enc_out @ wk``, ``enc_out @ wv``) and
    its cross-attention (``h @ wq`` over all 600 frames, non-causal, no
    RoPE) against JAX's ``_memory_kv`` and ``_cross_attention``."""
    jcfg, pcfg, jp, lm = _pair("float32")
    rng = np.random.default_rng(5)
    enc_out = rng.standard_normal((2, 600, pcfg.d_model)).astype(np.float32)
    h = rng.standard_normal((2, 9, pcfg.d_model)).astype(np.float32)
    jk, jv = JT._memory_kv(jcfg, _jax(jp)["cross"], jnp.asarray(enc_out))
    assert jk.shape == (pcfg.num_layers, 2, 600, pcfg.num_kv_heads, pcfg.hd)
    spec = dataclasses.replace(jcfg.attn_spec(False), causal=False)
    for layer, xa in enumerate(lm.cross):
        k, v = T._memory_kv(pcfg, xa, torch.from_numpy(enc_out))
        assert _err(k, jk[layer]) < TOL_F32 and _err(v, jv[layer]) < TOL_F32
        jattn = jax.tree.map(lambda t: jnp.asarray(t[layer]), jp["cross"]["attn"])
        want = JT._cross_attention(jattn, jnp.asarray(h), jk[layer], jv[layer], spec)
        got = T._cross_attention(pcfg, xa, torch.from_numpy(h), k, v)
        assert got.shape == (2, 9, pcfg.d_model) and _err(got, want) < TOL_F32


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def test_forward_and_loss_match_jax_float32():
    jcfg, pcfg, jp, lm = _pair("float32")
    batch = _batch(0)
    want = JT.forward(jcfg, _jax(jp), _jbatch(batch))
    got = T.forward(pcfg, lm, batch, device="cpu")
    assert got.shape == (2, TEXT, pcfg.vocab_padded) and got.dtype == torch.float32
    assert _err(got, want) < TOL_F32
    mask = (np.arange(TEXT)[None] % 3 != 0).astype(np.int32).repeat(2, 0)
    for b in (batch, dict(batch, loss_mask=mask)):
        jl = float(JT.loss_fn(jcfg, _jax(jp), _jbatch(b)))
        tl = float(T.loss_fn(pcfg, lm, b, device="cpu"))
        assert abs(jl - tl) < 1e-5


def test_forward_and_loss_match_jax_bfloat16():
    jcfg, pcfg, jp, lm = _pair("bfloat16")
    batch, want = _jax_bf16_forward()
    got = T.forward(pcfg, lm, batch, device="cpu")
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert _err(got, want) < TOL_BF16_LOGITS
    jl = float(JT.loss_fn(jcfg, _jax(jp), _jbatch(batch)))
    tl = float(T.loss_fn(pcfg, lm, batch, device="cpu"))
    assert abs(jl - tl) < TOL_BF16_LOSS


def test_bfloat16_bound_is_above_jax_own_rounding():
    jcfg, pcfg, jp, lm = _pair("bfloat16")
    batch, jbf16 = _jax_bf16_forward()
    jwide = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    j32 = JT.forward(jcfg.scaled(dtype="float32"), jwide, _jbatch(batch))
    own = _err(jbf16, j32)
    port = _err(T.forward(pcfg, lm, batch, device="cpu"), j32)
    assert TOL_BF16_LOGITS / 10 < own < TOL_BF16_LOGITS and port < TOL_BF16_LOGITS


def test_decoder_sees_every_frame():
    """Cross-attention is non-causal over the memory: a change to the last
    frame moves the first token's logits."""
    _, pcfg, _, lm = _pair("float32")
    batch = _batch(4)
    moved = dict(batch, frontend=batch["frontend"].copy())
    moved["frontend"][:, -1] += 1.0
    a = T.forward(pcfg, lm, batch, device="cpu")
    b = T.forward(pcfg, lm, moved, device="cpu")
    assert _err(a[:, 0], b[:, 0]) > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill of 80 frames and 66 tokens, then 3 decode steps: logits, the
    memory (the frames' keys and values, [L, B, 80, KV, hd]) and the KV
    caches against JAX's. bf16: the logits within the bf16 bound."""
    jcfg, pcfg, jp, lm = _pair(dtype)
    tol = TOL_F32 if dtype == "float32" else TOL_BF16_LOGITS
    batch = _batch(6)
    s, extra, max_len = TEXT - 4, 3, 80
    pre = {"tokens": batch["tokens"][:, :s], "frontend": batch["frontend"]}
    jc, jlast = JT.prefill(jcfg, _jax(jp), _jbatch(pre), max_len=max_len)
    tc, tlast = T.prefill(pcfg, lm, pre, max_len, device="cpu")
    assert tlast.shape == (2, 1, pcfg.vocab_padded) and _err(tlast, jlast) < tol
    mem = tc["memory"]
    assert mem["k"].shape == (pcfg.num_layers, 2, FRAMES, pcfg.num_kv_heads, pcfg.hd)
    for name in ("k", "v"):
        assert _err(mem[name], jc["memory"][name]) < (TOL_F32 if dtype == "float32" else 0.05)
    for i in range(extra):
        step = batch["tokens"][:, s + i : s + i + 1]
        jl, jc = JT.decode_step(jcfg, _jax(jp), jc, jnp.asarray(step), jnp.int32(s + i))
        tl, tc = T.decode_step(pcfg, lm, tc, step, s + i, device="cpu")
        assert _err(tl, jl) < tol
    kv, jkv = tc["pos0"]["attn"], jc["pos0"]["attn"]
    assert kv["len"].tolist() == np.asarray(jkv["len"]).tolist() == [s + extra] * pcfg.num_groups
    if dtype == "float32":
        for name in ("k", "v"):
            assert _err(kv[name], jkv[name]) < TOL_F32
        full = T.forward(pcfg, lm, {"tokens": batch["tokens"][:, : s + extra],
                                    "frontend": batch["frontend"]}, device="cpu")
        assert _err(tl[:, 0], full[:, -1]) < TOL_F32  # the steps equal the forward


def test_decode_from_a_fresh_cache_matches_jax():
    """``init_cache``'s memory is zeros of ``frontend_len or max_len`` frames
    (seamless: max_len); decode steps from it attend to all of them, in both
    packages."""
    jcfg, pcfg, jp, lm = _pair("float32")
    max_len = 12
    tc = T.init_cache(pcfg, 2, max_len, device="cpu")
    jc = JT.init_cache(jcfg, 2, max_len)
    assert tc["memory"]["k"].shape == (pcfg.num_layers, 2, max_len, pcfg.num_kv_heads, pcfg.hd)
    assert float(tc["memory"]["v"].abs().sum()) == 0
    toks = _batch(7)["tokens"]
    for i in range(3):
        step = toks[:, i : i + 1]
        jl, jc = JT.decode_step(jcfg, _jax(jp), jc, jnp.asarray(step), jnp.int32(i))
        tl, tc = T.decode_step(pcfg, lm, tc, step, i, device="cpu")
        assert _err(tl, jl) < TOL_F32


def test_missing_frames_raise():
    """An encoder–decoder pass without ``frontend`` raises ``ValueError``
    naming the frames (the JAX package fails by an ``AssertionError`` in
    ``forward`` and a ``KeyError`` in ``prefill``)."""
    jcfg, pcfg, jp, lm = _pair("float32")
    toks = {"tokens": _batch(8)["tokens"]}
    for fn in (lambda: T.forward(pcfg, lm, toks, device="cpu"),
               lambda: T.loss_fn(pcfg, lm, toks, device="cpu"),
               lambda: T.prefill(pcfg, lm, toks, 80, device="cpu")):
        with pytest.raises(ValueError, match="frontend"):
            fn()
    with pytest.raises(AssertionError, match="frontend"):
        JT.forward(jcfg, _jax(jp), _jbatch(toks))
    with pytest.raises(KeyError, match="frontend"):
        JT.prefill(jcfg, _jax(jp), _jbatch(toks), max_len=80)


def test_server_and_cli_refuse_seamless():
    """The server takes token prompts only (the JAX package's has no frames
    argument either): an encoder–decoder raises there, in both packages."""
    jcfg, pcfg, jp, lm = _pair("float32")
    prompt = np.arange(2, 10, dtype=np.int32)
    kw = dict(max_len=16, batch_slots=1, temperature=0.0, max_new_tokens=2, eos_token=-1)
    with pytest.raises(ValueError, match="frontend"):
        BatchedServer(pcfg, lm, ServeConfig(**kw), device="cpu").run([Request(prompt=prompt)])
    with pytest.raises(KeyError, match="frontend"):
        JaxServer(jcfg, _jax(jp), JaxServeConfig(**kw)).run([JaxRequest(prompt=prompt)])
    with pytest.raises(ValueError, match="frontend"):
        serve_cli.main(["lm", "--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "1",
                        "--prompt-len", "4", "--max-new", "2", "--slots", "1"])
