"""The flash attention backward's plain version (``ref.attention_bwd_ref``)
and the autograd path of ``ops.attention`` against JAX's gradients of the
reference's plain attention: ``jax.grad`` of ``kernels/flash_attention/ref.
attention_ref`` (causal or not, softcap, Sq != Sk, no GQA) and of the
models' ``_sdpa`` (grouped-query heads, the sliding window), at Dh 64, 96,
128 and 256. Inputs come from numpy with a seed; every comparison is in
float32 on the CPU.

Tolerance: 2e-5 of the largest gradient. The two compute the same float32
expression in other orders (the port from the saved log-sum-exp, JAX
through the softmax's own gradient), about 1e-6 of the largest value at
these sizes."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.layers import AttnSpec as JSpec
from repro.models.layers import _sdpa
from repro_torch.kernels.flash_attention import ops, ref

TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """JAX's CPU thread pool and torch's intra-op threads contend in one
    process (a port step ran 100x slower after a JAX call): the port's side
    runs on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _inputs(seed, bhq, bhkv, sq, sk, dh, cap):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bhq, sq, dh)).astype(np.float32) * (4.0 if cap else 1.0)
    k, v = (rng.standard_normal((bhkv, sk, dh)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((bhq, sq, dh)).astype(np.float32)
    return q, k, v, do


def _port_grads(q, k, v, do, **mask):
    """The twin's gradients from the port's forward (out and log-sum-exp)."""
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    lse = torch.empty(tq.shape[:-1])
    out = ops.attention(tq, tk, tv, lse=lse, chunk=16, **mask)
    return ref.attention_bwd_ref(tq, tk, tv, out, tdo, lse, **mask)


@pytest.mark.parametrize("sq,sk,dh,causal,cap", [
    (48, 48, 64, True, None), (40, 40, 96, True, None), (33, 33, 128, False, None),
    (24, 24, 256, True, 20.0), (17, 50, 64, True, None), (50, 17, 128, False, 30.0),
    (1, 40, 96, True, None),
])
def test_bwd_ref_matches_jax_grad_of_attention_ref(sq, sk, dh, causal, cap):
    q, k, v, do = _inputs(0, 3, 3, sq, sk, dh, cap)

    def f(q, k, v):
        return jnp.sum(jax_attention_ref(q, k, v, causal=causal, softcap=cap) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    got = _port_grads(q, k, v, do, causal=causal, softcap=cap)
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("h,kv,sq,sk,dh,causal,cap,window", [
    (4, 2, 40, 40, 64, True, None, None), (4, 1, 36, 36, 128, True, 20.0, None),
    (2, 2, 48, 48, 256, True, 50.0, 9), (6, 3, 40, 40, 96, True, None, 13),
    (4, 4, 20, 44, 64, False, None, None), (8, 2, 30, 30, 128, False, None, None),
])
def test_autograd_matches_jax_grad_of_sdpa(h, kv, sq, sk, dh, causal, cap, window):
    """``ops.attention`` on [B, H, S, Dh] views (as the model hands them over)
    with grad on: its backward against ``jax.grad`` of ``_sdpa``."""
    b = 2
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32) * (4.0 if cap else 1.0)
    k, v = (rng.standard_normal((b, sk, kv, dh)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    spec = JSpec(num_heads=h, num_kv_heads=kv, head_dim=dh, window=window,
                 attn_softcap=cap, causal=causal)
    pos = jnp.broadcast_to(jnp.arange(sk - sq, sk)[None], (b, sq))

    def f(q, k, v):
        return jnp.sum(_sdpa(q, k, v, spec, pos, chunk=16) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.attention(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                        causal=causal, softcap=cap, window=window, chunk=16)
    (out.transpose(1, 2) * torch.from_numpy(do)).sum().backward()
    for t, w in zip((tq, tk, tv), want):
        assert _rel(t.grad, w) < TOL


def test_lse_is_the_log_sum_exp_of_the_scores():
    """The forward's log-sum-exp: the float32 logsumexp of each row's scaled,
    soft-capped, masked scores; +inf for a row that sees no key."""
    q, k, v, _ = _inputs(2, 4, 2, 30, 30, 64, 10.0)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    lse = torch.empty(tq.shape[:-1])
    ops.attention(tq, tk, tv, softcap=10.0, window=7, lse=lse, chunk=8)
    s = torch.einsum("bqd,bkd->bqk", tq, tk.repeat_interleave(2, 0)) / 8.0
    s = 10.0 * torch.tanh(s / 10.0)
    mask = ref.visible(30, 30, torch.arange(30), True, 7)
    want = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    assert torch.allclose(lse, want, rtol=0, atol=1e-5)
    # Sq > Sk, causal: the first rows see no key (output 0, lse +inf, gradient 0).
    q, k, v, do = _inputs(3, 2, 2, 12, 5, 64, None)
    dq, dk, dv = _port_grads(q, k, v, do, causal=True)
    tq = torch.from_numpy(q)
    lse = torch.empty(tq.shape[:-1])
    out = ops.attention(tq, torch.from_numpy(k), torch.from_numpy(v), lse=lse)
    assert torch.isinf(lse[:, :7]).all() and torch.isfinite(lse[:, 7:]).all()
    assert (out[:, :7] == 0).all() and (dq[:, :7] == 0).all()


def test_lse_argument_is_checked():
    q, k, v, _ = _inputs(4, 2, 2, 8, 8, 16, None)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for bad in (torch.empty(2, 7), torch.empty(2, 8, dtype=torch.float64),
                torch.empty(8, 2).T):
        with pytest.raises(ValueError, match="lse"):
            ops.attention(tq, tk, tv, lse=bad)


def test_grad_free_calls_take_the_plain_path():
    """Without grad (or with inputs that need none) ``attention`` returns a
    plain tensor, no graph: serving never reaches the autograd Function."""
    q, k, v, _ = _inputs(5, 2, 2, 8, 8, 16, None)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        assert ops.attention(tq, tk, tv).grad_fn is None
    assert ops.attention(tq.detach(), tk.detach(), tv.detach()).grad_fn is None
    assert type(ops.attention(tq, tk, tv).grad_fn).__name__ == "_AttentionBackward"


# The float32 backward kernel's arithmetic (``ref.attention_bwd_tf32x3_ref``):
# each of the five products in split TF32 (3xTF32). Held to the plain
# float32 version and to JAX's gradient within 1e-5 of the largest gradient,
# the card's tolerance for the kernel (the split's representation error is
# about 2^-24 of each operand, as float32's rounding is); a single TF32
# product (10 mantissa bits) reads far above it.
TF32X3_TOL = 1e-5


@functools.cache
def _jax_ref_grads(group, causal, cap):
    """jax.grad of sum(attention_ref(q, k, v) * do) at (q, k, v), each KV row
    repeated for its group, jitted once per mask."""
    def f(q, k, v, do):
        ke, ve = (jnp.repeat(x, group, axis=0) for x in (k, v))
        return jnp.sum(jax_attention_ref(q, ke, ve, causal=causal, softcap=cap) * do)

    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))


@pytest.mark.parametrize("h,kv,sq,sk,dh,causal,cap,window", [
    (4, 2, 48, 48, 64, True, None, None), (2, 2, 40, 40, 96, True, None, None),
    (4, 1, 33, 33, 128, False, None, None), (2, 2, 24, 24, 256, True, 20.0, None),
    (2, 2, 17, 50, 64, True, None, None), (2, 2, 50, 17, 128, False, 30.0, None),
    (2, 2, 40, 40, 256, True, 50.0, 9), (6, 3, 36, 36, 40, True, None, 13),
])
def test_tf32x3_bwd_ref_matches_plain_and_jax_grad(h, kv, sq, sk, dh, causal, cap, window):
    """3xTF32 against ``attention_bwd_ref`` (the same forward and lse) and
    against ``jax.grad`` of the reference's ``attention_ref`` (grouped heads
    expanded, as the kernel sums dK and dV over each group; the window
    through ``_sdpa``'s mask as the port's ``visible``)."""
    q, k, v, do = _inputs(10 + sq + dh, h, kv, sq, sk, dh, cap)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    mask = dict(causal=causal, softcap=cap, window=window)
    lse = torch.empty(tq.shape[:-1])
    out = ops.attention(tq, tk, tv, lse=lse, chunk=16, **mask)
    got = ref.attention_bwd_tf32x3_ref(tq, tk, tv, out, tdo, lse, **mask)
    plain = ref.attention_bwd_ref(tq, tk, tv, out, tdo, lse, **mask)
    for g, p in zip(got, plain):
        assert g.dtype == torch.float32 and g.shape == p.shape
        assert _rel(g, p) < TF32X3_TOL
    if window is not None:
        return  # the reference's attention_ref has no window; plain is held to _sdpa above
    want = _jax_ref_grads(h // kv, causal, cap)(q, k, v, do)
    for g, w in zip(got, want):
        assert _rel(g, w) < TF32X3_TOL


def test_single_tf32_product_breaks_the_tolerance():
    """Without the split (each product one TF32 product) the same gradients
    read far above the float32 tolerance: the tensor cores carry the float32
    backward only split."""
    q, k, v, do = _inputs(21, 4, 2, 64, 64, 128, None)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    lse = torch.empty(tq.shape[:-1])
    out = ops.attention(tq, tk, tv, lse=lse)
    plain = ref.attention_bwd_ref(tq, tk, tv, out, tdo, lse)
    one = ref.attention_bwd_tf32x3_ref(tq, tk, tv, out, tdo, lse, terms=1)
    three = ref.attention_bwd_tf32x3_ref(tq, tk, tv, out, tdo, lse)
    assert min(_rel(g, p) for g, p in zip(one, plain)) > 10 * TF32X3_TOL
    assert max(_rel(g, p) for g, p in zip(three, plain)) < TF32X3_TOL


def test_tf32_rna_rounds_as_cvt_rna():
    """``ref.tf32_rna``: the 13 low bits rounded off to nearest, ties away
    from zero (both signs), a carry into the exponent, tf32 values kept."""
    bits = np.array([0x3F800000, 0x3F800FFF, 0x3F801000, 0x3F802FFF, 0x3F803000,
                     0xBF801000, 0xBF800FFF, 0x3FFFF000, 0x00001000], np.uint32)
    want = np.array([0x3F800000, 0x3F800000, 0x3F802000, 0x3F802000, 0x3F804000,
                     0xBF802000, 0xBF800000, 0x40000000, 0x00002000], np.uint32)
    x = torch.from_numpy(bits.view(np.float32).copy())
    got = ref.tf32_rna(x).numpy().view(np.uint32)
    assert np.array_equal(got, want), [hex(g) for g in got]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    big = ref.tf32_rna(y)
    assert torch.equal(ref.tf32_rna(big), big)
    assert not bool((big.view(torch.int32) & 0x1FFF).any())
    assert float(((y - big).abs() / y.abs()).max()) <= 2.0 ** -11
    with pytest.raises(TypeError, match="float32"):
        ref.attention_bwd_tf32x3_ref(*(torch.zeros(1, 2, 8, dtype=torch.bfloat16),) * 5,
                                     torch.zeros(1, 2))
