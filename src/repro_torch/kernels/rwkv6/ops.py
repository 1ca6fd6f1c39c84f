"""Public RWKV6 entry points: the kernel wrapper ``rwkv6``, the chunked scan
that is its CPU path, and the one-token step of the decode path.

``rwkv6`` dispatches on the device of its inputs, with no flag:

* every input on the CPU → ``rwkv6_chunked``, as the JAX package runs off the
  TPU;
* every input on one CUDA device → the hand-written kernel
  (``csrc/rwkv6.cu``, built by :mod:`repro_torch.kernels.build`), or
  :class:`KernelFault`; there is no fallback;
* inputs on several devices → ``ValueError``.

``launches["rwkv6"]`` counts the kernel's launches (``reset_launches`` zeroes
it), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.core.faults import KernelFault
from repro_torch.kernels.build import CudaLibrary

MAX_DIM = 64  # the kernel keeps K x V <= 64 x 64 of state per head


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rwkv6_launch.argtypes = [p] * 7 + [i64, i64, i32, i32, i32, p]
    lib.rwkv6_launch.restype = ctypes.c_int


LIB = CudaLibrary("rwkv6", Path(__file__).resolve().parent / "csrc" / "rwkv6.cu", _declare)

launches: Dict[str, int] = {"rwkv6": 0}

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


def rwkv6(r, k, v, w, u, *, chunk: int = 64, return_state: bool = False):
    """The RWKV6 recurrence over whole sequences, from a zero state.

    r, k, w [BH, T, K], v [BH, T, V] (float32 or bfloat16, one dtype), u
    [BH, K] → out float32 [BH, T, V], and with ``return_state`` the final
    state float32 [BH, K, V]. ``chunk`` is the CPU path's chunk length; the
    kernel takes any T >= 1. On the card an input that requires grad (grad
    mode on) raises ``NotImplementedError``: there is no backward kernel yet."""
    if not _on_cuda(r, k, v, w, u):
        return rwkv6_chunked(r, k, v, w, u, chunk=chunk, return_state=return_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u)):
        raise NotImplementedError(
            "rwkv6: the rwkv6 kernel has no backward kernel yet, so it cannot train on the "
            "card (the CPU path differentiates its plain version)")
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
