"""Public entry point of Mamba's selective scan: the kernel wrapper ``ssm_scan``.

``ssm_scan`` dispatches on the device of its inputs, with no flag:

* every input on the CPU → ``ref.ssm_scan_ref``, the plain step loop;
* every input on one CUDA device → the hand-written kernel
  (``csrc/ssm_scan.cu``, built by :mod:`repro_torch.kernels.build`), or
  :class:`KernelFault`; there is no fallback;
* inputs on several devices → ``ValueError``.

``launches["ssm_scan"]`` counts the kernel's launches (``reset_launches``
zeroes it), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.core.faults import KernelFault
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

MAX_STATE = 16  # the kernel keeps N <= 16 states of a channel on 8 lanes


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ssm_scan_launch.argtypes = [p] * 8 + [i64, i64, i64, i32, i64, i64, i64, i64, i32, p]
    lib.ssm_scan_launch.restype = ctypes.c_int


LIB = CudaLibrary("ssm_scan", Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu",
                  _declare)

launches: Dict[str, int] = {"ssm_scan": 0}

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


def ssm_scan(dt, x, a, bmat, cmat, h0):
    """The selective scan over whole sequences from the state ``h0``.

    dt float32 [B, T, Di], x [B, T, Di], a float32 [Di, N], bmat and cmat
    [B, T, N] (x's dtype, float32 or bfloat16; any batch and time strides),
    h0 float32 [B, Di, N] → (y float32 [B, T, Di], h_T float32 [B, Di, N]).
    T = 1 is one decode step. On the card an input that requires grad (grad
    mode on) raises ``NotImplementedError``: there is no backward kernel yet."""
    if not _on_cuda(dt, x, a, bmat, cmat, h0):
        return ssm_scan_ref(dt, x, a, bmat, cmat, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, x, a, bmat, cmat, h0)):
        raise NotImplementedError(
            "ssm_scan: the ssm_scan kernel has no backward kernel yet, so it cannot train on the "
            "card (the CPU path differentiates its plain version)")
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
    dt, x, a, h0 = (v.contiguous() for v in (dt, x, a, h0))
    bmat, cmat = _unit_last(bmat), _unit_last(cmat)
    y = torch.empty((bsz, t, di), dtype=f32, device=dt.device)
    h_t = torch.empty((bsz, di, n), dtype=f32, device=dt.device)
    rc = LIB.load().ssm_scan_launch(
        dt.data_ptr(), x.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h_t.data_ptr(), bsz, t, di, n,
        bmat.stride(0), bmat.stride(1), cmat.stride(0), cmat.stride(1),
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(dt.device).cuda_stream,
    )
    if rc != 0:
        raise KernelFault(f"ssm_scan launch failed: cudaError {rc}", op="ssm_scan")
    launches["ssm_scan"] += 1
    return y, h_t
