"""The port's RWKV6 recurrence against the JAX package's, on the CPU.

The same numpy inputs (seeded) go through the JAX package's ``rwkv6_ref``,
``rwkv6_chunked``, ``rwkv6_kernel(interpret=True)`` and
``rwkv6_decode_step`` and through the port's plain version, chunked scan and
decode step. Everything computes in float32 (bfloat16 inputs are widened
exactly), so the tolerances are float32 rounding ones, relative to the
largest value compared (at least 1): 1e-5 for the same algorithm in another
summation order, and 1e-3, the bound of the JAX package's own tests, where a
chunked form is held against the sequential one. The CUDA kernel's own
arithmetic (``rwkv6_chunk_ref``: chunks of 16 steps, decay factors as
products anchored between the two steps, value columns in blocks of 32) is
held to 1e-5 of every other version, at the decays the model can produce
and past them.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6 import ops as jops
from repro.kernels.rwkv6.ref import rwkv6_ref as jax_rwkv6_ref
from repro.kernels.rwkv6.rwkv6 import rwkv6_kernel as jax_rwkv6_kernel
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import CHUNK, COLS, rwkv6_chunk_ref, rwkv6_ref

TOL = 1e-5        # same algorithm, float32, another summation order
TOL_FORM = 1e-3   # another algorithm (chunked / factored vs sequential)


def _inputs(seed, bh, t, kd, vd, dtype="float32", wlo=0.036):
    """r, k, v, w, u as numpy arrays; w in the model's decay range (0.036, 1).
    ``dtype="bfloat16"`` rounds r, k, v, w to bfloat16 (u stays float32)."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((bh, t, kd)) * 0.5
    k = rng.standard_normal((bh, t, kd)) * 0.5
    v = rng.standard_normal((bh, t, vd))
    w = rng.uniform(wlo, 0.999, (bh, t, kd))
    u = (rng.standard_normal((bh, kd)) * 0.3).astype(np.float32)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [a.astype(np_dt) for a in (r, k, v, w)] + [u]


def _torch(arrs, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return [torch.from_numpy(np.asarray(a, np.float32)).to(tdt) for a in arrs[:4]] + \
        [torch.from_numpy(arrs[4])]


def _err(a, b):
    """max |a - b| relative to max(1, max |b|)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,t,kd,vd", [(2, 1, 16, 16), (3, 37, 16, 8), (2, 64, 64, 64)])
def test_plain_version_matches_jax_ref(dtype, bh, t, kd, vd):
    arrs = _inputs(t, bh, t, kd, vd, dtype)
    want = np.asarray(jax_rwkv6_ref(*[jnp.asarray(a) for a in arrs]))
    got = rwkv6_ref(*_torch(arrs, dtype))
    assert got.dtype == torch.float32 and got.shape == (bh, t, vd)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,chunk", [(64, 16), (96, 32), (37, 1), (128, 64)])
def test_chunked_matches_jax_chunked(dtype, t, chunk):
    arrs = _inputs(chunk, 2, t, 16, 16, dtype)
    want_o, want_s = jops.rwkv6_chunked(*[jnp.asarray(a) for a in arrs], chunk=chunk,
                                        return_state=True)
    got_o, got_s = ops.rwkv6_chunked(*_torch(arrs, dtype), chunk=chunk, return_state=True)
    assert _err(got_o, want_o) < TOL and _err(got_s, want_s) < TOL
    plain_o, plain_s = rwkv6_ref(*_torch(arrs, dtype), return_state=True)
    assert _err(got_o, plain_o) < TOL_FORM and _err(got_s, plain_s) < TOL_FORM
    assert torch.equal(ops.rwkv6_chunked(*_torch(arrs, dtype), chunk=chunk), got_o)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_matches_jax_pallas_kernel_interpreted(dtype):
    arrs = _inputs(5, 2, 64, 16, 16, dtype)
    want = jax_rwkv6_kernel(*[jnp.asarray(a) for a in arrs], chunk=16, interpret=True)
    got = ops.rwkv6_chunked(*_torch(arrs, dtype), chunk=16)
    assert _err(got, want) < TOL_FORM
    assert _err(rwkv6_ref(*_torch(arrs, dtype)), want) < TOL_FORM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    bh, t, kd, vd = 2, 6, 16, 16
    arrs = _inputs(9, bh, t, kd, vd, dtype)
    js = jnp.asarray(np.random.default_rng(3).standard_normal((bh, kd, vd)), jnp.float32)
    ts = torch.from_numpy(np.array(js))
    tr, tk, tv, tw, tu = _torch(arrs, dtype)
    for i in range(t):
        js, jo = jops.rwkv6_decode_step(js, *[jnp.asarray(a[:, i]) for a in arrs[:4]],
                                        jnp.asarray(arrs[4]))
        ts, to = ops.rwkv6_decode_step(ts, tr[:, i], tk[:, i], tv[:, i], tw[:, i], tu)
        assert to.dtype == torch.float32 and ts.dtype == torch.float32
        assert _err(to, jo) < TOL and _err(ts, js) < TOL


@pytest.mark.parametrize("chunk", [8, 1])
def test_chunked_state_continues_into_decode(chunk):
    """The state the chunked scan returns carries on exactly in decode steps:
    the outputs equal those of the whole sequence (as in the JAX package)."""
    t, extra = 32, 4
    arrs = _torch(_inputs(11, 1, t + extra, 16, 16), "float32")
    full = rwkv6_ref(*arrs)
    r, k, v, w, u = arrs
    _, S = ops.rwkv6_chunked(r[:, :t], k[:, :t], v[:, :t], w[:, :t], u, chunk=chunk,
                             return_state=True)
    outs = []
    for i in range(t, t + extra):
        S, o = ops.rwkv6_decode_step(S, r[:, i], k[:, i], v[:, i], w[:, i], u)
        outs.append(o)
    assert _err(torch.stack(outs, 1), full[:, t:]) < TOL_FORM


def test_dispatch_cpu_runs_the_chunked_path_without_launching():
    arrs = _torch(_inputs(2, 2, 64, 16, 16), "float32")
    ops.reset_launches()
    out, state = ops.rwkv6(*arrs, chunk=16, return_state=True)
    want_o, want_s = ops.rwkv6_chunked(*arrs, chunk=16, return_state=True)
    assert torch.equal(out, want_o) and torch.equal(state, want_s)
    assert torch.equal(ops.rwkv6(*arrs, chunk=16), want_o)
    assert ops.launches == {"rwkv6": 0, "rwkv6_bwd": 0}


def test_dispatch_rejects_mixed_or_unsupported_devices():
    r, k, v, w, u = _torch(_inputs(2, 1, 4, 16, 16), "float32")
    with pytest.raises(ValueError, match="several devices"):
        ops.rwkv6(r, k, v, w, u.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rwkv6(*(x.to("meta") for x in (r, k, v, w, u)))
    assert ops.launches["rwkv6"] == 0


def test_chunked_path_needs_whole_chunks_like_jax():
    arrs = _torch(_inputs(2, 1, 67, 16, 16), "float32")
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.rwkv6(*arrs, chunk=64)


# Decays at and past the model's edges: w = exp(-exp(logdecay)) with
# logdecay clamped to [-8, 1.2] by the model, w = 1.0 exactly (what bf16
# rounding makes of exp(-exp(-8))), w at the kernel's clamp 1e-12, and all of
# them mixed with the model's typical range.
DECAY_EDGES = {
    "logdecay -8": lambda rng, shape: np.full(shape, np.exp(-np.exp(-8.0))),
    "logdecay 1.2": lambda rng, shape: np.full(shape, np.exp(-np.exp(1.2))),
    "w 1.0": lambda rng, shape: np.ones(shape),
    "w 1e-12": lambda rng, shape: np.full(shape, 1e-12),
    "mixed": lambda rng, shape: rng.choice(
        [np.exp(-np.exp(-8.0)), np.exp(-np.exp(1.2)), 1.0, 1e-12, 0.5], shape),
}


def _edge_inputs(seed, bh, t, kd, vd, edge, dtype="float32"):
    arrs = _inputs(seed, bh, t, kd, vd)
    rng = np.random.default_rng(seed + 1)
    arrs[3] = DECAY_EDGES[edge](rng, (bh, t, kd))
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [np.asarray(a, np.float32).astype(np_dt) for a in arrs[:4]] + [arrs[4]]


@pytest.mark.parametrize("edge", list(DECAY_EDGES))
@pytest.mark.parametrize("t", [1, CHUNK - 1, CHUNK, CHUNK + 1, 37])
def test_kernel_arithmetic_matches_jax_and_sequential(edge, t):
    """The kernel's arithmetic in plain PyTorch against JAX's ``rwkv6_ref``
    and the port's sequential ``rwkv6_ref``: outputs and the final state, at
    the decay edges, with T below, at and past one chunk and ragged."""
    arrs = _edge_inputs(t, 3, t, 16, 40, edge)
    want = np.asarray(jax_rwkv6_ref(*[jnp.asarray(a) for a in arrs]))
    got_o, got_s = rwkv6_chunk_ref(*_torch(arrs, "float32"), return_state=True)
    assert got_o.dtype == torch.float32 and got_o.shape == (3, t, 40)
    assert _err(got_o, want) < TOL
    plain_o, plain_s = rwkv6_ref(*_torch(arrs, "float32"), return_state=True)
    assert _err(got_o, plain_o) < TOL and _err(got_s, plain_s) < TOL


@pytest.mark.parametrize("edge", list(DECAY_EDGES))
def test_kernel_arithmetic_matches_jax_pallas_kernel_interpreted(edge):
    """Against the TPU kernel itself (interpret mode) at its chunk of 16,
    which it needs T to be a multiple of. bf16 inputs: w = 1.0 exactly where
    bf16 rounds exp(-exp(-8))."""
    arrs = _edge_inputs(7, 2, 2 * CHUNK, 16, 16, edge, "bfloat16")
    want = jax_rwkv6_kernel(*[jnp.asarray(a) for a in arrs], chunk=CHUNK, interpret=True)
    got = rwkv6_chunk_ref(*_torch(arrs, "bfloat16"))
    assert np.isfinite(np.asarray(want)).all()
    assert _err(got, want) < TOL


@pytest.mark.parametrize("vd", [64, 40, 33])
def test_kernel_column_split_reproduces_the_whole(vd):
    """Value columns in blocks of 32, as the kernel's column groups take
    them: outputs and state equal the sequential form's over all columns at
    once, and each block computed alone equals its columns of the whole."""
    arrs = _torch(_edge_inputs(4, 2, 37, 24, vd, "mixed"), "float32")
    got_o, got_s = rwkv6_chunk_ref(*arrs, return_state=True)
    want_o, want_s = rwkv6_ref(*arrs, return_state=True)
    assert _err(got_o, want_o) < TOL and _err(got_s, want_s) < TOL
    for c0 in range(0, vd, COLS):
        part = [*arrs[:2], arrs[2][..., c0 : c0 + COLS], *arrs[3:]]
        part_o, part_s = rwkv6_chunk_ref(*part, return_state=True)
        assert _err(part_o, got_o[..., c0 : c0 + COLS]) < TOL
        assert _err(part_s, got_s[..., c0 : c0 + COLS]) < TOL


def test_chunked_path_overflows_at_the_decay_bound_where_the_kernel_arithmetic_does_not():
    """Every decay at the model's bound (logdecay 1.2, w = 0.036) over a
    64-step chunk: the factored form's centring at c_C/2 needs e^106, past
    float32, in the JAX package's ``rwkv6_chunked`` (the model's CPU path,
    chunk 64) and in the port's copy of it alike; the kernel's products of
    decays and the sequential form stay finite and agree."""
    arrs = _edge_inputs(8, 2, 64, 16, 16, "logdecay 1.2")
    jax_out = np.asarray(jops.rwkv6_chunked(*[jnp.asarray(a) for a in arrs], chunk=64))
    port_out = ops.rwkv6_chunked(*_torch(arrs, "float32"), chunk=64)
    assert not np.isfinite(jax_out).all() and not torch.isfinite(port_out).all()
    got = rwkv6_chunk_ref(*_torch(arrs, "float32"))
    want = rwkv6_ref(*_torch(arrs, "float32"))
    assert torch.isfinite(got).all() and _err(got, want) < TOL
