"""The port's vision-frontend model (phi-3-vision-4.2b) against the JAX
package's, on the CPU, at its ``smoke()`` size (2 layers, d 64, 4 heads of
16, 8 patch embeddings, ``attn_chunk`` 64).

The frontend is the JAX package's stub: ``batch["frontend"]`` holds
precomputed patch embeddings [B, F, d], put in front of the token
embeddings; positions run over F + S and ``loss_fn`` skips the patches'
logits. Served prompts are text only, as the JAX server serves them. The
JAX package's parameters are carried over with ``convert.from_jax_params``;
inputs come from numpy seeds. Tolerances: float32 1e-4 on the logits and KV
caches, 1e-5 on the loss; bfloat16 the dense-config file's bound for an
untied lm_head with logits up to about 4 (chatglm3's): 0.15 on the logits,
0.02 on the loss, held within ten times of JAX's own bf16 rounding.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
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

ARCH = "phi-3-vision-4.2b"
TEXT = 70
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


def _batch(seed, b=2, text=TEXT):
    cfg = smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, text)).astype(np.int32),
            "frontend": rng.standard_normal((b, cfg.frontend_len, cfg.d_model))
            .astype(np.float32)}


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


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_equals_jax(which):
    jc = jax_get_config(ARCH) if which == "full" else jax_smoke_config(ARCH)
    pc = get_config(ARCH) if which == "full" else smoke_config(ARCH)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.param_count() == jc.param_count()
    assert ARCH in ARCH_NAMES


def test_full_config_parameter_count():
    """32 layers of d 3,072, 32 heads of 96 (MHA), 256 patches; the module
    holds param_count()'s matrices plus the norms and the padded rows."""
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab_size, cfg.frontend_len) == (32, 3072, 32, 32, 96, 8192, 32064, 256)
    assert cfg.param_count() == 3_820_879_872
    lm = T.LM(cfg, device="meta")
    n = sum(p.numel() for p in lm.parameters())
    pad = (cfg.vocab_padded - cfg.vocab_size) * cfg.d_model * 2
    assert n == cfg.param_count() + pad + (2 * cfg.num_layers + 1) * cfg.d_model
    assert not hasattr(lm, "encoder")


def test_forward_and_loss_match_jax_float32():
    """Logits over F + S positions (the patches' first), and the loss over
    the text positions only, with and without a mask."""
    jcfg, pcfg, jp, lm = _pair("float32")
    batch = _batch(0)
    want = JT.forward(jcfg, _jax(jp), _jbatch(batch))
    got = T.forward(pcfg, lm, batch, device="cpu")
    assert got.shape == (2, pcfg.frontend_len + TEXT, pcfg.vocab_padded)
    assert _err(got, want) < TOL_F32
    mask = (np.arange(TEXT)[None] % 3 != 0).astype(np.int32).repeat(2, 0)
    for b in (batch, dict(batch, loss_mask=mask)):
        jl = float(JT.loss_fn(jcfg, _jax(jp), _jbatch(b)))
        tl = float(T.loss_fn(pcfg, lm, b, device="cpu"))
        assert abs(jl - tl) < 1e-5
    # The loss reads the text positions: the patches' logits do not enter it.
    text = got[:, pcfg.frontend_len : -1].double()
    nll = torch.logsumexp(text, -1) - torch.gather(
        text, -1, torch.from_numpy(batch["tokens"][:, 1:, None]).long())[..., 0]
    assert abs(float(nll.mean()) - float(T.loss_fn(pcfg, lm, batch, device="cpu"))) < 1e-5


def test_patches_come_first_and_move_every_text_position():
    """The patch embeddings sit at positions 0..F-1: a change to the first
    patch moves the first text token's logits; the same tokens without
    patches give the text-only forward (positions 0..S-1)."""
    jcfg, pcfg, jp, lm = _pair("float32")
    batch = _batch(2)
    moved = dict(batch, frontend=batch["frontend"].copy())
    moved["frontend"][:, 0] += 1.0
    a = T.forward(pcfg, lm, batch, device="cpu")
    b = T.forward(pcfg, lm, moved, device="cpu")
    assert _err(a[:, pcfg.frontend_len], b[:, pcfg.frontend_len]) > 1e-4
    text = {"tokens": batch["tokens"]}
    assert _err(T.forward(pcfg, lm, text, device="cpu"),
                JT.forward(jcfg, _jax(jp), _jbatch(text))) < TOL_F32


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill of 8 patches + 60 tokens (68 positions), then 4 decode steps
    at positions 68..71 (F + S on): logits and the KV cache against JAX's,
    and in float32 the last step against the forward of the same inputs."""
    jcfg, pcfg, jp, lm = _pair(dtype)
    tol = TOL_F32 if dtype == "float32" else TOL_BF16_LOGITS
    batch = _batch(3)
    f, s, extra, max_len = pcfg.frontend_len, 60, 4, 80
    pre = {"tokens": batch["tokens"][:, :s], "frontend": batch["frontend"]}
    jc, jlast = JT.prefill(jcfg, _jax(jp), _jbatch(pre), max_len=max_len)
    tc, tlast = T.prefill(pcfg, lm, pre, max_len, device="cpu")
    assert _err(tlast, jlast) < tol
    assert tc["pos0"]["attn"]["len"].tolist() == [f + s] * pcfg.num_groups
    for i in range(extra):
        step = batch["tokens"][:, s + i : s + i + 1]
        jl, jc = JT.decode_step(jcfg, _jax(jp), jc, jnp.asarray(step), jnp.int32(f + s + i))
        tl, tc = T.decode_step(pcfg, lm, tc, step, f + s + i, device="cpu")
        assert _err(tl, jl) < tol
    kv, jkv = tc["pos0"]["attn"], jc["pos0"]["attn"]
    assert kv["len"].tolist() == np.asarray(jkv["len"]).tolist() == [f + s + extra] * 2
    if dtype == "float32":
        for name in ("k", "v"):
            assert _err(kv[name], jkv[name]) < TOL_F32
        full = T.forward(pcfg, lm, {"tokens": batch["tokens"][:, : s + extra],
                                    "frontend": batch["frontend"]}, device="cpu")
        assert _err(tl[:, 0], full[:, -1]) < TOL_F32


def test_decode_after_patches_must_sit_at_f_plus_s():
    """A decode step after a vision prefill sits at F + S; the text length
    alone is not the cache's length and raises."""
    _, pcfg, _, lm = _pair("float32")
    batch = _batch(4)
    s = 20
    cache, _ = T.prefill(pcfg, lm, {"tokens": batch["tokens"][:, :s],
                                    "frontend": batch["frontend"]}, 40, device="cpu")
    with pytest.raises(ValueError, match="position 20"):
        T.decode_step(pcfg, lm, cache, batch["tokens"][:, s : s + 1], s, device="cpu")
    T.decode_step(pcfg, lm, cache, batch["tokens"][:, s : s + 1], pcfg.frontend_len + s,
                  device="cpu")


def test_greedy_server_tokens_equal_jax():
    """Text-only prompts (no patches), ragged and right-aligned, on fewer
    slots than requests: the port's greedy tokens are JAX's."""
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
    stats = serve_cli.main(["lm", "--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "20", "--max-new", "4",
                            "--slots", "2"])
    assert stats["requests"] == 3 and stats["new_tokens"] == 3 * 3
    assert f"[serve] {ARCH} on cpu: 3 requests" in capsys.readouterr().out
    assert attn_ops.launches["flash_attention"] == 0  # the CPU path never launches the kernel
