"""The plain backwards of the port's two recurrences (``rwkv6.ref.
rwkv6_bwd_ref``, ``ssm_scan.ref.ssm_scan_bwd_ref``) and the autograd
Functions that run them on the CPU (``rwkv6.ops._RWKV6``, ``ssm_scan.ops.
_SsmScan``), against ``torch.autograd`` of their forward twins and against
``jax.grad`` of the JAX package's functions, taken as its model takes them:
``kernels/rwkv6/ops.rwkv6_chunked`` and ``kernels/rwkv6/ref.rwkv6_ref``;
for the scan, decay and bx formed as ``models/ssm.py`` forms them (l.
106-107), then ``_ssm_scan_chunked``. Inputs come from numpy with a seed;
every comparison is in float32 on the CPU, at the edges the kernels must
take: w = 1 exactly and w at the model's clamp (0.036 a step), decays near
0 and near 1, non-zero h0, dS_T and dh_T.

Tolerance: max |port - other| / max |other| of each gradient, 1e-5 against
a sequential form (the same float32 expressions in other orders: 2e-7 to
7e-7 read here), 3e-5 against a chunked form of RWKV6, whose factored
decays exp(c_t - z) * exp(z - c_j) reach e^±61 at the clamp and round each
pair term once more (up to 6.8e-6 read here, at the clamp; 1.2e-6 at the
model's decays)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ops import rwkv6_chunked as jax_rwkv6_chunked
from repro.kernels.rwkv6.ref import rwkv6_ref as jax_rwkv6_ref
from repro.models.ssm import _ssm_scan_chunked
from repro_torch.kernels.rwkv6 import ops as rk
from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref, rwkv6_ref
from repro_torch.kernels.ssm_scan import ops as sk
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

SEQ_TOL = 1e-5
CHUNKED_TOL = 3e-5
CLAMP_W = float(np.exp(-np.exp(1.2)))  # the model's smallest decay, 0.036


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """JAX's CPU thread pool and torch's intra-op threads contend in one
    process: the port's side runs on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = (np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x,
                            np.float32) for x in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _rwkv_inputs(seed, t, w_edge=None, bh=3, kd=16, vd=16):
    """r, k, v, w, u, dout, dS_T as numpy float32: w from the model's decay
    formula around its w0 = -2, or every w set to ``w_edge``."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((bh, t, kd)).astype(np.float32) * 0.5 for _ in range(2))
    v = rng.standard_normal((bh, t, vd)).astype(np.float32)
    logdecay = np.clip(-2.0 + rng.standard_normal((bh, t, kd)), -8.0, 1.2)
    w = np.exp(-np.exp(logdecay)).astype(np.float32) if w_edge is None else \
        np.full((bh, t, kd), w_edge, np.float32)
    u = rng.standard_normal((bh, kd)).astype(np.float32) * 0.3
    do = rng.standard_normal((bh, t, vd)).astype(np.float32)
    ds = rng.standard_normal((bh, kd, vd)).astype(np.float32)
    return r, k, v, w, u, do, ds


@functools.cache
def _jax_rwkv_grads(chunk):
    """jax.grad of sum(out * dout) (+ sum(S_T * dS_T) through the chunked
    form) at (r, k, v, w, u), jitted once per chunk length (0: the
    sequential ``rwkv6_ref``, which returns no state)."""
    def loss(r, k, v, w, u, do, ds):
        if chunk == 0:
            return jnp.sum(jax_rwkv6_ref(r, k, v, w, u) * do)
        out, s = jax_rwkv6_chunked(r, k, v, w, u, chunk=chunk, return_state=True)
        return jnp.sum(out * do) + jnp.sum(s * ds)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))


def _port_rwkv(inputs, with_ds=True):
    r, k, v, w, u, do, ds = (torch.from_numpy(x) for x in inputs)
    return rwkv6_bwd_ref(r, k, v, w, u, do, ds if with_ds else None)


@pytest.mark.parametrize("w_edge", [None, 1.0, CLAMP_W], ids=["model", "w=1", "w=clamp"])
@pytest.mark.parametrize("t", [37, 64])
def test_rwkv6_bwd_ref_matches_torch_autograd_of_both_forms(t, w_edge):
    """Against autograd of the sequential form (``rwkv6_ref``, out and S_T)
    and of the port's chunked form (``rwkv6_chunked``, chunks of 16 steps)."""
    inputs = _rwkv_inputs(t, t, w_edge)
    got = _port_rwkv(inputs)
    do, ds = (torch.from_numpy(x) for x in inputs[5:])
    for form, tol in ((lambda *a: rwkv6_ref(*a, return_state=True), SEQ_TOL),
                      (lambda *a: rk.rwkv6_chunked(*a, chunk=16 if t % 16 == 0 else t,
                                                   return_state=True), CHUNKED_TOL)):
        xs = [torch.from_numpy(x).requires_grad_() for x in inputs[:5]]
        out, s = form(*xs)
        ((out * do).sum() + (s * ds).sum()).backward()
        for g, x in zip(got, xs):
            assert _rel(g, x.grad) < tol


@pytest.mark.parametrize("w_edge", [None, 1.0, CLAMP_W], ids=["model", "w=1", "w=clamp"])
@pytest.mark.parametrize("t", [37, 64])
def test_rwkv6_bwd_ref_matches_jax_grad(t, w_edge):
    """Against jax.grad of the reference's chunked scan (with dS_T, chunks of
    16 steps or the whole sequence) and of its sequential oracle (no
    state, so dS_T = 0)."""
    inputs = _rwkv_inputs(100 + t, t, w_edge)
    chunk = 16 if t % 16 == 0 else t
    want = _jax_rwkv_grads(chunk)(*inputs)
    for g, w in zip(_port_rwkv(inputs), want):
        assert _rel(g, w) < CHUNKED_TOL
    want = _jax_rwkv_grads(0)(*inputs)
    for g, w in zip(_port_rwkv(inputs, with_ds=False), want):
        assert _rel(g, w) < SEQ_TOL


def test_rwkv6_bwd_ref_zeroes_dw_below_the_clamp():
    """Below the kernels' clamp (1e-12) w has no gradient, as torch.clamp's
    is; at it and above it has."""
    inputs = list(_rwkv_inputs(7, 37))
    inputs[3][0, 5] = 1e-13
    inputs[3][1, 6] = 1e-12
    dw = _port_rwkv(inputs)[3]
    assert not bool(dw[0, 5].any()) and bool(dw[1, 6].any())


def test_rwkv6_function_dispatch_on_cpu():
    """``rk.rwkv6`` with grad on runs ``_RWKV6`` on the CPU: bf16 inputs get
    bf16 gradients (``rwkv6_bwd_ref``'s, rounded once), u expanded over the
    batch (as ``rwkv6_block`` does) gets du summed over it, and inputs that
    need no grad get none; with no grad it is the plain chunked form."""
    b, h, t, hd = 2, 3, 32, 16
    r, k, v, w, _, do, _ = _rwkv_inputs(3, t, bh=b * h, kd=hd, vd=hd)
    u0 = np.random.default_rng(4).standard_normal((h, hd)).astype(np.float32)
    tr, tk, tv, tw = (torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v, w))
    tr.requires_grad_()
    tw.requires_grad_()
    tu = torch.from_numpy(u0).requires_grad_()
    ub = tu[None].expand(b, h, hd).reshape(b * h, hd)
    out = rk.rwkv6(tr, tk, tv, tw, ub, chunk=16)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_RWKV6Backward"
    (out * torch.from_numpy(do)).sum().backward()
    assert tk.grad is None and tv.grad is None
    assert tr.grad.dtype == tw.grad.dtype == torch.bfloat16 and tr.grad.shape == tr.shape
    assert tu.grad.dtype == torch.float32 and tu.grad.shape == (h, hd)
    dr, _, _, dw, du = rwkv6_bwd_ref(tr.detach(), tk, tv, tw.detach(), ub.detach(),
                                     torch.from_numpy(do))
    assert torch.equal(tr.grad, dr) and torch.equal(tw.grad, dw)
    assert _rel(tu.grad, du.reshape(b, h, hd).sum(0)) < SEQ_TOL
    with torch.no_grad():
        plain = rk.rwkv6(tr, tk, tv, tw, ub, chunk=16)
    assert torch.equal(plain, rk.rwkv6_chunked(tr.detach(), tk, tv, tw.detach(),
                                               ub.detach(), chunk=16))


# ---------------------------------------------------------------------------
# The selective scan
# ---------------------------------------------------------------------------

def _scan_inputs(seed, t, n, dt_scale=None, b=2, di=16):
    """dt (softplus of a normal, or ``dt_scale`` times a uniform draw), x, a
    = -(1..N) times a per-channel rate, B, C, a non-zero h0, dy and dh_T as
    numpy float32."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, di)))) if dt_scale is None else \
        rng.random((b, t, di)) * dt_scale
    x = rng.standard_normal((b, t, di))
    a = -np.arange(1, n + 1) * (rng.random((di, 1)) * 0.95 + 0.05)
    bm, cm = (rng.standard_normal((b, t, n)) for _ in range(2))
    h0 = rng.standard_normal((b, di, n))
    dy, dh = rng.standard_normal((b, t, di)), rng.standard_normal((b, di, n))
    return tuple(z.astype(np.float32) for z in (dt, x, a, bm, cm, h0, dy, dh))


@functools.cache
def _jax_scan_grads():
    """jax.grad of sum(y * dy) + sum(h_T * dh_T) at (dt, x, a, B, C, h0),
    decay and bx formed as the reference's ``mamba_block`` forms them and
    scanned by its ``_ssm_scan_chunked`` in its chunks of 128 steps."""
    def loss(dt, x, a, bm, cm, h0, dy, dh):
        decay = jnp.exp(dt[..., None] * a)
        bx = (dt * x)[..., None] * bm[:, :, None, :]
        y, h = _ssm_scan_chunked(decay, bx, cm, h0, min(128, dt.shape[1]))
        return jnp.sum(y * dy) + jnp.sum(h * dh)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5)))


SCAN_CASES = [(64, 4, None), (256, 16, None), (64, 16, 200.0), (256, 4, 1e-4)]
SCAN_IDS = ["T64-N4", "T256-N16", "decay near 0", "decay near 1"]


@pytest.mark.parametrize("t,n,dt_scale", SCAN_CASES, ids=SCAN_IDS)
def test_ssm_scan_bwd_ref_matches_torch_autograd(t, n, dt_scale):
    inputs = _scan_inputs(t + n, t, n, dt_scale)
    got = ssm_scan_bwd_ref(*(torch.from_numpy(z) for z in inputs))
    xs = [torch.from_numpy(z).requires_grad_() for z in inputs[:6]]
    y, h = ssm_scan_ref(*xs)
    dy, dh = (torch.from_numpy(z) for z in inputs[6:])
    ((y * dy).sum() + (h * dh).sum()).backward()
    for g, x in zip(got, xs, strict=True):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert _rel(g, x.grad) < SEQ_TOL


@pytest.mark.parametrize("t,n,dt_scale", SCAN_CASES, ids=SCAN_IDS)
def test_ssm_scan_bwd_ref_matches_jax_grad(t, n, dt_scale):
    inputs = _scan_inputs(200 + t + n, t, n, dt_scale)
    got = ssm_scan_bwd_ref(*(torch.from_numpy(z) for z in inputs))
    for g, w in zip(got, _jax_scan_grads()(*inputs), strict=True):
        assert _rel(g, w) < SEQ_TOL


def test_ssm_scan_function_dispatch_on_cpu():
    """``sk.ssm_scan`` with grad on runs ``_SsmScan`` on the CPU: B and C as
    slices of one projection (``mamba_block``'s) get their gradients into
    it, bf16 x gets a bf16 gradient, and h0 without grad (training's zero
    state) gets none; with no grad it is ``ssm_scan_ref``."""
    dt, x, a, bm, cm, _, dy, dh = _scan_inputs(5, 64, 16)
    proj = torch.from_numpy(np.concatenate([bm, cm], -1)).to(torch.bfloat16).requires_grad_()
    tdt, ta = torch.from_numpy(dt).requires_grad_(), torch.from_numpy(a).requires_grad_()
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    h0 = torch.zeros((2, 16, 16))
    y, h = sk.ssm_scan(tdt, tx, ta, proj[..., :16], proj[..., 16:], h0)
    assert type(y.grad_fn).__name__ == "_SsmScanBackward"
    ((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum()).backward()
    assert h0.grad is None
    assert tx.grad.dtype == proj.grad.dtype == torch.bfloat16
    assert tdt.grad.dtype == ta.grad.dtype == torch.float32 and proj.grad.shape == proj.shape
    want = ssm_scan_bwd_ref(tdt.detach(), tx.detach(), ta.detach(), proj[..., :16].detach(),
                            proj[..., 16:].detach(), h0, torch.from_numpy(dy),
                            torch.from_numpy(dh))
    for g, w in ((tdt.grad, want[0]), (tx.grad, want[1]), (ta.grad, want[2]),
                 (proj.grad, torch.cat(want[3:5], -1))):
        assert torch.equal(g, w)
    with torch.no_grad():
        plain = sk.ssm_scan(tdt, tx, ta, proj[..., :16], proj[..., 16:], h0)
    assert all(torch.equal(p, q) for p, q in zip(plain, ssm_scan_ref(
        tdt, tx, ta, proj[..., :16], proj[..., 16:], h0)))
