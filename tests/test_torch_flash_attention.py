"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs (seeded) go through the JAX package's
``attention_ref``, ``attention_chunked`` and
``flash_attention_kernel(interpret=True)`` and through the port's
``attention_ref``, ``attention_chunked`` and ``attention`` (whose CPU path is
``attention_chunked``). Shapes are those of ``tests/test_kernels.py``'s
flash attention test; the tolerances are its own: 2e-5 in float32 (another
summation order) and 2e-2 in bfloat16 (the output is rounded to bfloat16).
"""
import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_kernel as jax_kernel
from repro.kernels.flash_attention.ops import attention_chunked as jax_chunked
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref, expand_kv

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [  # bh, sq, sk, dh, causal, softcap, scale of q
    (2, 128, 128, 64, True, None, 1.0),
    (1, 256, 256, 128, True, None, 1.0),
    (2, 128, 256, 64, False, None, 1.0),
    (1, 128, 128, 64, True, 30.0, 1.0),
    (1, 64, 192, 64, True, None, 1.0),   # decode-like: q is a suffix of kv
    # Scores of standard deviation 20 reach the cap; at unit scale the cap
    # moves a score by about s³/(3·30²), too little for the tolerance to see.
    (1, 128, 128, 64, True, 30.0, 20.0),
]


def _inputs(seed, bhq, bhkv, sq, sk, dh, dtype):
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [rng.standard_normal(shape).astype(np_dt)
            for shape in ((bhq, sq, dh), (bhkv, sk, dh), (bhkv, sk, dh))]


def _torch(arrs, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return [torch.from_numpy(np.asarray(a, np.float32)).to(tdt) for a in arrs]


def _err(a, b):
    a = a.to(torch.float32).numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.to(torch.float32).numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)))


@functools.lru_cache(maxsize=None)
def _jax_outputs(case, dtype):
    """JAX's three versions on one case's inputs (computed once per case)."""
    bh, sq, sk, dh, causal, cap, scale = SHAPES[case]
    arrs = _inputs(case, bh, bh, sq, sk, dh, dtype)
    arrs[0] = (np.asarray(arrs[0], np.float32) * scale).astype(arrs[0].dtype)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    return arrs, {
        "ref": np.asarray(jax_ref(jq, jk, jv, causal=causal, softcap=cap).astype(jnp.float32)),
        "chunked": np.asarray(jax_chunked(jq, jk, jv, causal=causal, softcap=cap,
                                          chunk=96).astype(jnp.float32)),
        "kernel": np.asarray(jax_kernel(jq, jk, jv, causal=causal, softcap=cap, tq=64, tk=64,
                                        interpret=True).astype(jnp.float32)),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(SHAPES)))
@pytest.mark.parametrize("port", ["ref", "chunked", "attention"])
def test_port_matches_jax_versions(port, case, dtype):
    bh, sq, sk, dh, causal, cap, scale = SHAPES[case]
    arrs, want = _jax_outputs(case, dtype)
    q, k, v = _torch(arrs, dtype)
    fn = {"ref": attention_ref,
          "chunked": functools.partial(ops.attention_chunked, chunk=96),
          "attention": ops.attention}[port]
    got = fn(q, k, v, causal=causal, softcap=cap)
    assert got.dtype == q.dtype and got.shape == (bh, sq, dh)
    for name, w in want.items():
        assert _err(got, w) < TOL[dtype], name
    if cap is not None and scale > 1:  # the cap matters here: without it the output is far off
        assert _err(fn(q, k, v, causal=causal), want["ref"]) > 10 * TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_that_see_no_key_give_zero(dtype):
    """Sk < Sq under the causal mask: query rows i < Sq − Sk see no key. The
    chunked path gives 0 there, as the TPU kernel does; the materialised
    twins give the mean of v (a softmax of −1e30s), the port's like JAX's."""
    arrs = _inputs(5, 2, 2, 128, 64, 64, dtype)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    q, k, v = _torch(arrs, dtype)
    got = ops.attention(q, k, v, causal=True, chunk=48)
    assert not got[:, :64].any()
    jker = jax_kernel(jq, jk, jv, causal=True, tq=64, tk=64, interpret=True)
    assert _err(got, jker.astype(jnp.float32)) < TOL[dtype]
    assert _err(got, jax_chunked(jq, jk, jv, causal=True, chunk=48).astype(jnp.float32)) \
        < TOL[dtype]
    ref = attention_ref(q, k, v, causal=True)
    assert _err(ref, jax_ref(jq, jk, jv, causal=True).astype(jnp.float32)) < TOL[dtype]
    assert _err(ref[:, :64], v.float().mean(dim=1, keepdim=True).expand(2, 64, 64)) \
        < TOL[dtype]


@pytest.mark.parametrize("sq,sk,causal", [(48, 48, True), (1, 75, True), (20, 33, False)])
def test_grouped_query_heads_read_their_kv_row(sq, sk, causal):
    """BHkv divides BHq: query row bh reads KV row bh // (BHq // BHkv), the
    grouping of the JAX model's ``_sdpa`` with (batch, head) flattened
    batch-major. Held against JAX's reference on repeated KV."""
    arrs = _inputs(sq + sk, 8, 2, sq, sk, 32, "float32")
    q, k, v = _torch(arrs, "float32")
    rep = [arrs[0]] + [np.repeat(a, 4, axis=0) for a in arrs[1:]]
    want = jax_ref(*(jnp.asarray(a) for a in rep), causal=causal)
    for fn in (attention_ref, ops.attention_chunked, ops.attention):
        assert _err(fn(q, k, v, causal=causal), want) < TOL["float32"], fn.__name__
    k2, v2 = expand_kv(q, k, v)
    assert torch.equal(k2[5], k[1]) and torch.equal(v2[3], v[0])
    with pytest.raises(ValueError):
        expand_kv(q, k[:1].expand(3, -1, -1), v[:1].expand(3, -1, -1))


def test_four_dimensional_operands_equal_flattened():
    """[B, H, S, Dh] operands (the model passes transposed views) give the
    flattened call's result in the same shape."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 6, 9, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 14, 3, 16)).astype(np.float32))
    k, v = kv.transpose(1, 2), (kv * 0.5).transpose(1, 2)
    got = ops.attention(q, k, v, causal=True)
    want = ops.attention(q.reshape(12, 9, 16), k.reshape(6, 14, 16), v.reshape(6, 14, 16))
    assert got.shape == (2, 6, 9, 16) and torch.equal(got, want.reshape(2, 6, 9, 16))


def test_wrapper_checks_shapes_and_devices():
    q = torch.zeros((4, 8, 16))
    with pytest.raises(ValueError):
        ops.attention(q, torch.zeros((3, 8, 16)), torch.zeros((3, 8, 16)))
    with pytest.raises(ValueError):
        ops.attention(q, torch.zeros((4, 8, 8)), torch.zeros((4, 8, 8)))
    with pytest.raises(ValueError):
        ops.attention(q, q, q, softcap=0.0)
    with pytest.raises(ValueError):
        ops.attention(q, q, q.to("meta"))
    assert ops.launches["flash_attention"] == 0  # the CPU path never launches the kernel
