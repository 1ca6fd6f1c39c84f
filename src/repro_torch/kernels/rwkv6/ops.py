"""Public RWKV6 entry points: the kernel wrapper ``rwkv6``, the chunked scan
that is its CPU path, and the one-token step of the decode path.

``rwkv6`` dispatches on the device of its inputs, with no flag:

* every input on the CPU → ``rwkv6_chunked``, as the JAX package runs off the
  TPU;
* every input on one CUDA device → the hand-written kernel
  (``csrc/rwkv6.cu``, built by :mod:`repro_torch.kernels.build`), or
  :class:`KernelFault`; there is no fallback;
* inputs on several devices → ``ValueError``.

Where grad mode is on and an input requires grad, ``rwkv6`` is ``_RWKV6``:
the same forward, and ``rwkv6_bwd`` as its backward (on the CPU
``ref.rwkv6_bwd_ref``, on the card ``csrc/rwkv6_bwd.cu``).

``launches["rwkv6"]`` and ``launches["rwkv6_bwd"]`` count the kernels'
launches (``reset_launches`` zeroes them), so a run can show that it went
through the kernels.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.core.faults import KernelFault
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref

MAX_DIM = 64  # the kernel keeps K x V <= 64 x 64 of state per head


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rwkv6_launch.argtypes = [p] * 7 + [i64, i64, i32, i32, i32, p]
    lib.rwkv6_launch.restype = ctypes.c_int


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rwkv6_bwd_launch.argtypes = [p] * 13 + [i64, i64, i32, i32, i32, p]
    lib.rwkv6_bwd_launch.restype = ctypes.c_int


_CSRC = Path(__file__).resolve().parent / "csrc"
LIB = CudaLibrary("rwkv6", _CSRC / "rwkv6.cu", _declare)
BWD_LIB = CudaLibrary("rwkv6_bwd", _CSRC / "rwkv6_bwd.cu", _declare_bwd)
BWD_CHUNK = 8  # steps between the backward kernel's saved states (csrc: kChunk)

launches: Dict[str, int] = {"rwkv6": 0, "rwkv6_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def rwkv6_chunked(r, k, v, w, u, *, chunk: int = 32, return_state: bool = False):
    """Chunked scan, vectorised over BH and walked over chunks of ``chunk``
    steps (``T`` must be a multiple of it once it is cut to ``T``).

    The intra-chunk pair term is the JAX package's stable factored product,
    ``A[t,j] = (r_t ⊙ e^{c_{t-1}−z})·(k_j ⊙ e^{z−c_j})`` with ``z = c_C/2``
    and ``c`` the cumulative log-decay: exact for any normaliser, and within
    float32 range for the decays the model produces (|log w| ≤ e^1.2 a
    step). Returns out float32 [BH, T, V] and, with ``return_state``, the
    final state [BH, K, V]."""
    bh, t, kd = r.shape
    vd = v.shape[-1]
    chunk = min(chunk, t)
    if chunk < 1 or t % chunk:
        raise ValueError(f"rwkv6_chunked: T={t} is not a multiple of chunk={chunk}")
    n = t // chunk
    f32 = torch.float32
    dev = r.device

    def resh(x, d):
        return x.to(f32).reshape(bh, n, chunk, d).transpose(0, 1)  # [n, BH, C, d]

    rc, kc, wc, vc = resh(r, kd), resh(k, kd), resh(w, kd), resh(v, vd)
    uf = u.to(f32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev), diagonal=-1)
    eye = torch.eye(chunk, dtype=f32, device=dev)
    S = torch.zeros((bh, kd, vd), dtype=f32, device=dev)
    outs = []
    for c in range(n):
        rb, kb, vb, wb = rc[c], kc[c], vc[c], wc[c]           # [BH, C, ·]
        logw = torch.log(torch.clamp(wb, min=1e-12))
        cum = torch.cumsum(logw, dim=1)
        cum_prev = cum - logw
        z = cum[:, -1:, :] * 0.5                              # per-channel centre
        r_z = rb * torch.exp(cum_prev - z)
        k_z = kb * torch.exp(z - cum)
        a = torch.where(tri[None], torch.einsum("bti,bji->btj", r_z, k_z), 0.0)
        a = a + (rb * uf[:, None, :] * kb).sum(-1)[..., None] * eye[None]
        out = torch.einsum("bti,biv->btv", rb * torch.exp(cum_prev), S) + torch.einsum(
            "btj,bjv->btv", a, vb)
        k_dec = kb * torch.exp(cum[:, -1:, :] - cum)
        S = torch.exp(cum[:, -1])[:, :, None] * S + torch.einsum("bji,bjv->biv", k_dec, vb)
        outs.append(out)
    out = torch.stack(outs, dim=1).reshape(bh, t, vd)
    return (out, S) if return_state else out


def rwkv6_decode_step(S, r, k, v, w, u):
    """One token with carried state S [BH, K, V] → (S', out [BH, V]), float32."""
    f32 = torch.float32
    r, k, v, w, u = (x.to(f32) for x in (r, k, v, w, u))
    kv = k[:, :, None] * v[:, None, :]
    out = torch.einsum("bi,biv->bv", r, S + u[:, :, None] * kv)
    S = w[:, :, None] * S + kv
    return S, out


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on one CUDA device, False if all are on the
    CPU; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"rwkv6: inputs on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"rwkv6: unsupported device {dev}")
    return True


class _RWKV6(torch.autograd.Function):
    """``rwkv6`` with its backward ``rwkv6_bwd``; the forward saves its inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk, return_state):
        res = rwkv6(r, k, v, w, u, chunk=chunk, return_state=return_state)
        ctx.save_for_backward(r, k, v, w, u)
        return res

    @staticmethod
    def backward(ctx, dout, ds=None):
        r, k, v, w, u = ctx.saved_tensors  # read once: checkpoint's unpack allows no more
        grads = rwkv6_bwd(r, k, v, w, u, dout, ds)
        grads = grads[:4] + (grads[4].to(u.dtype),)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def _check(r, k, v, w, u) -> None:
    bh, t, kd = r.shape
    vd = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:2] != (bh, t) \
            or u.shape != (bh, kd) or v.ndim != 3:
        raise ValueError(f"rwkv6: shapes r={tuple(r.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)} w={tuple(w.shape)} u={tuple(u.shape)}")
    if bh < 1 or t < 1:
        raise ValueError(f"rwkv6: needs BH >= 1 and T >= 1, got BH={bh} T={t}")
    if not (1 <= kd <= MAX_DIM and 1 <= vd <= MAX_DIM):
        raise KernelFault(f"rwkv6 kernel takes K, V <= {MAX_DIM}, got K={kd} V={vd}",
                          op="rwkv6")
    dtypes = {x.dtype for x in (r, k, v, w)}
    if len(dtypes) != 1 or r.dtype not in _DTYPE_CODE:
        raise TypeError(f"rwkv6: r, k, v, w must share float32 or bfloat16, got {dtypes}")


def rwkv6(r, k, v, w, u, *, chunk: int = 64, return_state: bool = False):
    """The RWKV6 recurrence over whole sequences, from a zero state.

    r, k, w [BH, T, K], v [BH, T, V] (float32 or bfloat16, one dtype), u
    [BH, K] → out float32 [BH, T, V], and with ``return_state`` the final
    state float32 [BH, K, V]. ``chunk`` is the CPU path's chunk length; the
    kernel takes any T >= 1. Differentiable where grad mode is on and an
    input requires grad (``_RWKV6``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u)):
        return _RWKV6.apply(r, k, v, w, u, chunk, return_state)
    if not _on_cuda(r, k, v, w, u):
        return rwkv6_chunked(r, k, v, w, u, chunk=chunk, return_state=return_state)
    _check(r, k, v, w, u)
    bh, t, kd = r.shape
    vd = v.shape[-1]
    # heads() hands over transposed views; the kernel reads dense rows.
    r, k, v, w = (x.contiguous() for x in (r, k, v, w))
    u = u.to(torch.float32).contiguous()
    out = torch.empty((bh, t, vd), dtype=torch.float32, device=r.device)
    state = torch.empty((bh, kd, vd), dtype=torch.float32, device=r.device) \
        if return_state else None
    rc = LIB.load().rwkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), 0 if state is None else state.data_ptr(),
        bh, t, kd, vd, _DTYPE_CODE[r.dtype], torch.cuda.current_stream(r.device).cuda_stream,
    )
    if rc != 0:
        raise KernelFault(f"rwkv6 launch failed: cudaError {rc}", op="rwkv6")
    launches["rwkv6"] += 1
    return (out, state) if return_state else out


def rwkv6_bwd(r, k, v, w, u, dout, ds=None):
    """The gradients (dr, dk, dv, dw, du) of ``rwkv6`` (out, and the final
    state where ``ds`` is given) at r, k, v, w, u, from dout float32 [BH, T,
    V] and ds float32 [BH, K, V] or None (zero). dr, dk, dv, dw come back in
    the inputs' dtype, du float32 [BH, K]. On the CPU
    ``ref.rwkv6_bwd_ref``; on the card the backward kernel, or
    :class:`KernelFault`."""
    if not _on_cuda(r, k, v, w, u, dout, *(() if ds is None else (ds,))):
        return rwkv6_bwd_ref(r, k, v, w, u, dout, ds)
    _check(r, k, v, w, u)
    bh, t, kd = r.shape
    vd = v.shape[-1]
    f32 = torch.float32
    if dout.shape != (bh, t, vd) or (ds is not None and ds.shape != (bh, kd, vd)):
        raise ValueError(f"rwkv6_bwd: dout {tuple(dout.shape)} and ds "
                         f"{None if ds is None else tuple(ds.shape)} do not fit r "
                         f"{tuple(r.shape)}, v {tuple(v.shape)}")
    r, k, v, w = (x.contiguous() for x in (r, k, v, w))
    u, dout = u.to(f32).contiguous(), dout.to(f32).contiguous()
    ds = None if ds is None else ds.to(f32).contiguous()
    dr, dk, dw = (torch.empty_like(r) for _ in range(3))
    dv = torch.empty_like(v)
    du = torch.empty((bh, kd), dtype=f32, device=r.device)
    # The state before every chunk of BWD_CHUNK steps but the first, written
    # by the kernel's forward walk and read back by its backward walk.
    chunks = -(-t // BWD_CHUNK)
    scratch = torch.empty((bh, max(chunks - 1, 1), MAX_DIM * MAX_DIM), dtype=f32,
                          device=r.device)
    rc = BWD_LIB.load().rwkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), dout.data_ptr(),
        0 if ds is None else ds.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dw.data_ptr(), du.data_ptr(), scratch.data_ptr(), bh, t, kd, vd,
        _DTYPE_CODE[r.dtype], torch.cuda.current_stream(r.device).cuda_stream,
    )
    if rc != 0:
        raise KernelFault(f"rwkv6_bwd launch failed: cudaError {rc}", op="rwkv6_bwd")
    launches["rwkv6_bwd"] += 1
    return dr, dk, dv, dw, du
