"""The port's Mamba mixer against the JAX package's, on the CPU.

The same numpy inputs (seeded) and the JAX package's parameters
(``mamba_init`` from a key, carried across leaf by leaf) go through the JAX
package's ``_ssm_scan_chunked``, ``_causal_conv`` and ``mamba_block`` and
through the port's ``ssm_scan_ref`` (the plain version of the selective-scan
kernel, which the CPU path runs), ``_causal_conv`` and ``mamba_block``.
Tolerances, each relative to the largest value compared (at least 1):

* the scan and float32 blocks: 1e-5, float32 in another summation order
  (the einsum over the states; the JAX scan's chunks group the same steps);
* bfloat16 blocks: 4e-3 on y, the state and the conv tail. The port rounds
  where the JAX package does: the conv's products in its order, and silu as
  XLA computes ``jax.nn.silu`` on bfloat16 (x times 1 / (1 + exp(-x)), each
  step rounded), so only the products' summation order differs, and an
  output may sit one unit in the last place (2^-8 of its binade) apart: the
  port reads at most 1.1e-3 against JAX. JAX's own bfloat16 block against
  its float32 block (the same parameters, widened) reads 8.5e-3 to 1.7e-2
  on y, above the bound, so a port that computed in float32 fails it
  (``test_bfloat16_bound_is_below_jax_own_rounding``). ``_causal_conv``'s
  own tail, a copy of its inputs, is equal.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import ssm
from repro_torch.models.convert import to_tensor

D_MODEL = 64          # di = 128, N = 16, dt_rank = 4, K = 4
TOL = 1e-5
TOL_BF16 = 4e-3


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(a, b):
    """max |a - b| relative to max(1, max |b|)."""
    a, b = _f(a), _f(b)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _scan_inputs(seed, b, t, di, n):
    """dt (softplus of a unit normal, as the block forms it), x, a (-(1..N)
    as ``mamba_init`` starts), B, C and a non-zero h0, float32 numpy."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, di)))).astype(np.float32)
    x = rng.standard_normal((b, t, di)).astype(np.float32)
    a = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (di, n)).copy()
    a *= rng.uniform(0.05, 1.0, (di, 1)).astype(np.float32)  # slower channels too
    bm, cm = (rng.standard_normal((b, t, n)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((b, di, n)).astype(np.float32)
    return dt, x, a, bm, cm, h0


@pytest.mark.parametrize("t", [1, 64, 256], ids=["T1", "T64", "T256-two-chunks"])
def test_scan_ref_matches_jax_chunked_scan(t):
    """The plain version against the reference's chunked scan fed the
    reference's decay and bx: y and the final state."""
    dt, x, a, bm, cm, h0 = _scan_inputs(t, 2, t, 24, 16)
    jdt = jnp.asarray(dt)
    decay = jnp.exp(jdt[..., None] * jnp.asarray(a))
    bx = (jdt * jnp.asarray(x))[..., None] * jnp.asarray(bm)[:, :, None, :]
    want_y, want_h = jssm._ssm_scan_chunked(decay, bx, jnp.asarray(cm), jnp.asarray(h0), 128)
    got_y, got_h = ssm_scan_ref(*(torch.from_numpy(v) for v in (dt, x, a, bm, cm, h0)))
    assert got_y.shape == (2, t, 24) and got_h.shape == (2, 24, 16)
    assert got_y.dtype == got_h.dtype == torch.float32
    assert _err(got_y, want_y) < TOL and _err(got_h, want_h) < TOL
    if t == 1:  # the reference's decode fast path computes the same step
        fast_h = decay[:, 0] * jnp.asarray(h0) + bx[:, 0]
        fast_y = jnp.einsum("bds,bs->bd", fast_h, jnp.asarray(cm)[:, 0])
        assert _err(got_y[:, 0], fast_y) < TOL and _err(got_h, fast_h) < TOL


def test_scan_dispatch_cpu_runs_the_plain_version_without_launching():
    """CPU tensors run ``ssm_scan_ref``, bfloat16 x/B/C and B/C as strided
    slices of one projection (as the block hands them over) included."""
    dt, x, a, bm, cm, h0 = (torch.from_numpy(v) for v in _scan_inputs(3, 2, 64, 24, 16))
    scan_ops.reset_launches()
    got = scan_ops.ssm_scan(dt, x, a, bm, cm, h0)
    want = ssm_scan_ref(dt, x, a, bm, cm, h0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    proj = torch.cat([torch.zeros(2, 64, 4), bm, cm], dim=-1).to(torch.bfloat16)
    bs, cs = proj[..., 4:20], proj[..., 20:]
    assert not bs.is_contiguous() and bs.stride() == (64 * 36, 36, 1)
    xb = x.to(torch.bfloat16)
    got = scan_ops.ssm_scan(dt, xb, a, bs, cs, h0)
    want = ssm_scan_ref(dt, xb, a, bs.contiguous(), cs.contiguous(), h0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert scan_ops.launches == {"ssm_scan": 0, "ssm_scan_bwd": 0}


def test_scan_dispatch_rejects_mixed_or_unsupported_devices():
    dt, x, a, bm, cm, h0 = (torch.from_numpy(v) for v in _scan_inputs(4, 1, 4, 8, 16))
    with pytest.raises(ValueError, match="several devices"):
        scan_ops.ssm_scan(dt, x, a, bm, cm, h0.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        scan_ops.ssm_scan(*(v.to("meta") for v in (dt, x, a, bm, cm, h0)))
    assert scan_ops.launches["ssm_scan"] == 0


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

def _pair(dtype, seed=0):
    """(JAX parameters, the port's Mamba holding them)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jp = jssm.mamba_init(jax.random.key(seed), D_MODEL, dtype=jdt)
    m = ssm.Mamba(D_MODEL, tdt, device="cpu")
    with torch.no_grad():
        for name, leaf in jp.items():
            dst = getattr(m, name)
            dst.copy_(to_tensor(np.asarray(leaf), dst.dtype, "cpu"))
    return jp, m


def _x(seed, b, s, dtype):
    x = np.random.default_rng(seed).standard_normal((b, s, D_MODEL)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _tol(dtype):
    return TOL if dtype == "float32" else TOL_BF16


def test_mamba_init_has_the_reference_shapes_dtypes_and_constants():
    jp = jssm.mamba_init(jax.random.key(0), D_MODEL, dtype=jnp.bfloat16)
    m = ssm.mamba_init(torch.Generator().manual_seed(0), D_MODEL, dtype=torch.bfloat16)
    assert m.dt_proj.shape[0] == max(1, D_MODEL // 16) == 4
    for name, leaf in jp.items():
        p = getattr(m, name)
        want = torch.bfloat16 if np.asarray(leaf).dtype == ml_dtypes.bfloat16 else torch.float32
        assert tuple(p.shape) == np.asarray(leaf).shape and p.dtype == want, name
    for name in ("conv_b", "dt_bias", "d_skip"):
        assert np.array_equal(_f(getattr(m, name)), _f(jp[name])), name
    assert _err(m.a_log, jp["a_log"]) < 1e-6  # log(1..N): each library's float32 log
    # fan-in scales: in_proj d^-0.5, x_proj and out_proj di^-0.5, dt_proj rank^-0.5, conv 0.5
    for name, scale in (("in_proj", 64 ** -0.5), ("x_proj", 128 ** -0.5),
                        ("out_proj", 128 ** -0.5), ("dt_proj", 4 ** -0.5), ("conv_w", 0.5)):
        std = float(getattr(m, name).float().std())
        assert 0.8 * scale < std < 1.2 * scale, (name, std, scale)
    assert ssm.mamba_state_shape(D_MODEL, 3) == jssm.mamba_state_shape(D_MODEL, 3)
    assert ssm.mamba_state_shape(4096, 8, conv_dim=4) == ((8, 3, 8192), (8, 8192, 16))


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_without_state_matches_jax(dtype, s):
    jp, m = _pair(dtype)
    jx, tx = _x(s, 2, s, dtype)
    jy, (jtail, jh) = jssm.mamba_block(jp, jx)
    with torch.inference_mode():
        ty, (ttail, th) = ssm.mamba_block(m, tx)
    assert ty.shape == (2, s, D_MODEL) and ty.dtype == tx.dtype
    assert ttail.dtype == tx.dtype and th.dtype == torch.float32
    assert _err(ty, jy) < _tol(dtype) and _err(th, jh) < _tol(dtype)
    assert _err(ttail, jtail) < _tol(dtype)  # in_proj's last outputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_prefill_with_state_then_decode_steps_match_jax(dtype):
    """A prefill of 128 tokens from a zero state, then 3 one-token steps,
    each fed the state the other side's own previous call returned."""
    jp, m = _pair(dtype, seed=1)
    jx, tx = _x(7, 2, 131, dtype)
    di, n = 2 * D_MODEL, 16
    jstate = (jnp.zeros((2, 3, di), jx.dtype), jnp.zeros((2, di, n), jnp.float32))
    tstate = (torch.zeros((2, 3, di), dtype=tx.dtype), torch.zeros((2, di, n)))
    for lo, hi in ((0, 128), (128, 129), (129, 130), (130, 131)):
        jy, jstate = jssm.mamba_block(jp, jx[:, lo:hi], jstate)
        with torch.inference_mode():
            ty, tstate = ssm.mamba_block(m, tx[:, lo:hi], tstate)
        assert _err(ty, jy) < _tol(dtype), (lo, hi)
        assert _err(tstate[1], jstate[1]) < _tol(dtype), (lo, hi)
        # The tail holds in_proj's outputs: the product's summation order.
        assert _err(tstate[0], jstate[0]) < _tol(dtype), (lo, hi)


@pytest.mark.parametrize("s", [1, 2], ids=["T1", "T2"])
def test_conv_tail_below_the_kernel_width(s):
    """With T < K-1 the new tail keeps rows of the old one, in both."""
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 8)).astype(np.float32)
    jy, jt = jssm._causal_conv(*(jnp.asarray(v) for v in (x, w, b, tail)))
    ty, tt = ssm._causal_conv(*(torch.from_numpy(v) for v in (x, w, b, tail)))
    assert _err(ty, jy) < TOL and np.array_equal(_f(tt), _f(jt))
    assert np.array_equal(_f(tt)[:, : 3 - s], tail[:, s:])  # rows of the old tail
    # And the block continues from a non-zero tail and state alike.
    jp, m = _pair("float32", seed=2)
    jx, tx = _x(11, 2, s, "float32")
    st = np.random.default_rng(5)
    tail0 = st.standard_normal((2, 3, 2 * D_MODEL)).astype(np.float32)
    h0 = st.standard_normal((2, 2 * D_MODEL, 16)).astype(np.float32)
    jy,(jt, jh) = jssm.mamba_block(jp, jx, (jnp.asarray(tail0), jnp.asarray(h0)))
    with torch.inference_mode():
        ty, (tt, th) = ssm.mamba_block(m, tx, (torch.from_numpy(tail0), torch.from_numpy(h0)))
    assert _err(ty, jy) < TOL and _err(th, jh) < TOL and _err(tt, jt) < TOL


@pytest.mark.parametrize("s", [200, 509])
def test_length_contract_matches_jax(s):
    """Past 128 tokens a multi-token pass must be a multiple of 128: JAX
    asserts it in its chunked scan, the port raises ValueError naming the
    length. 128 and 256 pass in both (tests above)."""
    jp, m = _pair("float32")
    jx, tx = _x(0, 1, s, "float32")
    with pytest.raises(AssertionError):
        jssm.mamba_block(jp, jx)
    with pytest.raises(ValueError, match=f"{s} tokens"):
        ssm.mamba_block(m, tx)


def test_bfloat16_bound_is_below_jax_own_rounding():
    """The bf16 bound's reason: JAX's bfloat16 block against its float32
    block of the same (widened) parameters and inputs reads above the bound
    (so a port computing in float32 would fail it), while the port's
    bfloat16 block sits within it of JAX's bfloat16 block."""
    jp, m = _pair("bfloat16")
    jx, tx = _x(128, 2, 128, "bfloat16")
    jy, (_, jh) = jssm.mamba_block(jp, jx)
    jwide = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), jp)
    j32, (_, jh32) = jssm.mamba_block(jwide, jnp.asarray(jx, jnp.float32))
    assert _err(jy, j32) > 2 * TOL_BF16
    with torch.inference_mode():
        ty, (_, th) = ssm.mamba_block(m, tx)
    assert _err(ty, jy) < TOL_BF16 and _err(th, jh) < TOL_BF16
    assert _err(ty, j32) > 2 * TOL_BF16  # the port rounds as JAX's bfloat16 block does
