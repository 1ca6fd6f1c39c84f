"""Public entry point of Mamba's selective scan: the kernel wrapper ``ssm_scan``.

``ssm_scan`` dispatches on the device of its inputs, with no flag:

* every input on the CPU → ``ref.ssm_scan_ref``, the plain step loop;
* every input on one CUDA device → the hand-written kernel
  (``csrc/ssm_scan.cu``, built by :mod:`repro_torch.kernels.build`), or
  :class:`KernelFault`; there is no fallback;
* inputs on several devices → ``ValueError``.

Where grad mode is on and an input requires grad, ``ssm_scan`` is
``_SsmScan``: the same forward (on the card it also keeps h at the kernel's
tile boundaries), and ``ssm_scan_bwd`` as its backward (on the CPU
``ref.ssm_scan_bwd_ref``, on the card ``csrc/ssm_scan_bwd.cu``).

``launches["ssm_scan"]`` and ``launches["ssm_scan_bwd"]`` count the kernels'
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
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

MAX_STATE = 16  # the kernel keeps N <= 16 states of a channel on 8 lanes
TILE = 32       # steps a tile of both kernels (csrc: kTile)


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ssm_scan_launch.argtypes = [p] * 9 + [i64, i64, i64, i32, i64, i64, i64, i64, i32, p]
    lib.ssm_scan_launch.restype = ctypes.c_int


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ssm_scan_bwd_launch.argtypes = [p] * 14 + [i64, i64, i64, i32, i64, i64, i64, i64,
                                                   i32, p]
    lib.ssm_scan_bwd_launch.restype = ctypes.c_int


_CSRC = Path(__file__).resolve().parent / "csrc"
LIB = CudaLibrary("ssm_scan", _CSRC / "ssm_scan.cu", _declare)
BWD_LIB = CudaLibrary("ssm_scan_bwd", _CSRC / "ssm_scan_bwd.cu", _declare_bwd)

launches: Dict[str, int] = {"ssm_scan": 0, "ssm_scan_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on one CUDA device, False if all are on the
    CPU; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"ssm_scan: inputs on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {dev}")
    return True


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its last axis has unit stride (the model's slices
    of x_proj's output do), else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


class _SsmScan(torch.autograd.Function):
    """``ssm_scan`` with its backward ``ssm_scan_bwd``: the forward saves its
    inputs and, on the card, h at the start of each tile."""

    @staticmethod
    def forward(ctx, dt, x, a, bmat, cmat, h0):
        y, h_t, hb = _scan(dt, x, a, bmat, cmat, h0, tile_states=True)
        ctx.save_for_backward(dt, x, a, bmat, cmat, h0, *(() if hb is None else (hb,)))
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dh_t):
        dt, x, a, bmat, cmat, h0, *hb = ctx.saved_tensors  # read once (checkpoint)
        grads = ssm_scan_bwd(dt, x, a, bmat, cmat, h0, dy, dh_t, hb=hb[0] if hb else None)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def _check(dt, x, a, bmat, cmat, h0) -> None:
    bsz, t, di = dt.shape
    n = a.shape[-1]
    if x.shape != dt.shape or a.shape != (di, n) or bmat.shape != (bsz, t, n) \
            or cmat.shape != (bsz, t, n) or h0.shape != (bsz, di, n):
        raise ValueError(f"ssm_scan: shapes dt={tuple(dt.shape)} x={tuple(x.shape)} "
                         f"a={tuple(a.shape)} bmat={tuple(bmat.shape)} "
                         f"cmat={tuple(cmat.shape)} h0={tuple(h0.shape)}")
    if bsz < 1 or t < 1 or di < 1:
        raise ValueError(f"ssm_scan: needs B, T, Di >= 1, got B={bsz} T={t} Di={di}")
    if not 1 <= n <= MAX_STATE:
        raise KernelFault(f"ssm_scan kernel takes 1 <= N <= {MAX_STATE}, got N={n}",
                          op="ssm_scan")
    f32 = torch.float32
    if dt.dtype != f32 or a.dtype != f32 or h0.dtype != f32:
        raise TypeError(f"ssm_scan: dt, a and h0 must be float32, got "
                        f"{dt.dtype}, {a.dtype}, {h0.dtype}")
    if len({x.dtype, bmat.dtype, cmat.dtype}) != 1 or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssm_scan: x, bmat and cmat must share float32 or bfloat16, got "
                        f"{x.dtype}, {bmat.dtype}, {cmat.dtype}")


def ssm_scan(dt, x, a, bmat, cmat, h0):
    """The selective scan over whole sequences from the state ``h0``.

    dt float32 [B, T, Di], x [B, T, Di], a float32 [Di, N], bmat and cmat
    [B, T, N] (x's dtype, float32 or bfloat16; any batch and time strides),
    h0 float32 [B, Di, N] → (y float32 [B, T, Di], h_T float32 [B, Di, N]).
    T = 1 is one decode step. Differentiable where grad mode is on and an
    input requires grad (``_SsmScan``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, x, a, bmat, cmat, h0)):
        return _SsmScan.apply(dt, x, a, bmat, cmat, h0)
    return _scan(dt, x, a, bmat, cmat, h0)[:2]


def _scan(dt, x, a, bmat, cmat, h0, *, tile_states: bool = False):
    """(y, h_T, hb): hb float32 [B, ceil(T / TILE), Di, N] holds h at the
    start of each tile where ``tile_states`` is asked on the card, else None."""
    if not _on_cuda(dt, x, a, bmat, cmat, h0):
        return (*ssm_scan_ref(dt, x, a, bmat, cmat, h0), None)
    _check(dt, x, a, bmat, cmat, h0)
    bsz, t, di = dt.shape
    n = a.shape[-1]
    f32 = torch.float32
    dt, x, a, h0 = (v.contiguous() for v in (dt, x, a, h0))
    bmat, cmat = _unit_last(bmat), _unit_last(cmat)
    y = torch.empty((bsz, t, di), dtype=f32, device=dt.device)
    h_t = torch.empty((bsz, di, n), dtype=f32, device=dt.device)
    hb = torch.empty((bsz, -(-t // TILE), di, n), dtype=f32, device=dt.device) \
        if tile_states else None
    rc = LIB.load().ssm_scan_launch(
        dt.data_ptr(), x.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h_t.data_ptr(), 0 if hb is None else hb.data_ptr(),
        bsz, t, di, n, bmat.stride(0), bmat.stride(1), cmat.stride(0), cmat.stride(1),
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(dt.device).cuda_stream,
    )
    if rc != 0:
        raise KernelFault(f"ssm_scan launch failed: cudaError {rc}", op="ssm_scan")
    launches["ssm_scan"] += 1
    return y, h_t, hb


def ssm_scan_bwd(dt, x, a, bmat, cmat, h0, dy, dh_t, *, hb=None):
    """The gradients (ddt, dx, da, dB, dC, dh0) of ``ssm_scan``'s (y, h_T) at
    its inputs, from dy float32 [B, T, Di] and dh_t float32 [B, Di, N] (zero
    where h_T is unused), each in its input's dtype and shape (dB and dC
    contiguous). On the CPU ``ref.ssm_scan_bwd_ref``; on the card the
    backward kernel, or :class:`KernelFault`, from ``hb``: h at the start of
    each tile, as ``_scan(..., tile_states=True)`` keeps it (the card needs
    it; the CPU ignores it)."""
    if not _on_cuda(dt, x, a, bmat, cmat, h0, dy, dh_t):
        return ssm_scan_bwd_ref(dt, x, a, bmat, cmat, h0, dy, dh_t)
    _check(dt, x, a, bmat, cmat, h0)
    bsz, t, di = dt.shape
    n = a.shape[-1]
    f32 = torch.float32
    tiles = -(-t // TILE)
    if dy.shape != (bsz, t, di) or dh_t.shape != (bsz, di, n) or hb is None or \
            hb.shape != (bsz, tiles, di, n):
        raise ValueError(f"ssm_scan_bwd: dy {tuple(dy.shape)}, dh_t {tuple(dh_t.shape)}, hb "
                         f"{None if hb is None else tuple(hb.shape)} do not fit dt "
                         f"{tuple(dt.shape)}, N={n}")
    dt, x, a = (v.contiguous() for v in (dt, x, a))
    dy, dh_t, hb = (v.to(f32).contiguous() for v in (dy, dh_t, hb))
    bmat, cmat = _unit_last(bmat), _unit_last(cmat)
    ddt = torch.empty_like(dt)
    dx = torch.empty_like(x)
    dh0 = torch.empty((bsz, di, n), dtype=f32, device=dt.device)
    # Summed over channels (dB, dC) and over rows and steps (da) by atomic adds.
    dbc = torch.zeros((2, bsz, t, n), dtype=f32, device=dt.device)
    da = torch.zeros((di, n), dtype=f32, device=dt.device)
    rc = BWD_LIB.load().ssm_scan_bwd_launch(
        dt.data_ptr(), x.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        hb.data_ptr(), dy.data_ptr(), dh_t.data_ptr(), ddt.data_ptr(), dx.data_ptr(),
        da.data_ptr(), dbc[0].data_ptr(), dbc[1].data_ptr(), dh0.data_ptr(), bsz, t, di, n,
        bmat.stride(0), bmat.stride(1), cmat.stride(0), cmat.stride(1), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(dt.device).cuda_stream,
    )
    if rc != 0:
        raise KernelFault(f"ssm_scan_bwd launch failed: cudaError {rc}", op="ssm_scan_bwd")
    launches["ssm_scan_bwd"] += 1
    return ddt, dx, da, dbc[0].to(bmat.dtype), dbc[1].to(cmat.dtype), dh0
