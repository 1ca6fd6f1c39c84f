"""Public wrappers of the intersect kernels.

Dispatch is by the device of the input tensors, with no flag:

* every input on the CPU  → the plain PyTorch version (``ref.py``);
* every input on a CUDA device → the hand-written CUDA kernel
  (``csrc/intersect.cu``, built by :mod:`repro_torch.kernels.build`), or an
  exception; there is no fallback.

Each wrapper checks device, dtype (int32), shape and contiguity, allocates
its outputs with ``torch.empty``, launches on the current stream, and raises
:class:`KernelFault` if the launch reports an error. ``launches`` counts the
kernel launches of each wrapper (plain integers; ``reset_launches`` zeroes
them), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.core.faults import KernelFault
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.intersect.ref import (
    fused_extend_ref,
    fused_verify_ref,
    lex_bounds_ref,
    multiway_membership_ref,
)


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
    lib.fused_extend_launch.argtypes = [p] * 8 + [i64, i32, i32, i64, u32, u32, p]
    lib.fused_verify_launch.argtypes = [p] * 7 + [i64, i32, i32, i64, i32, p]
    lib.lex_bounds_launch.argtypes = [p] * 4 + [i32, i32, i64, i32, p]
    lib.multiway_membership_launch.argtypes = [p] * 3 + [i64, i32, i64, p]
    for fn in (lib.fused_extend_launch, lib.fused_verify_launch,
               lib.lex_bounds_launch, lib.multiway_membership_launch):
        fn.restype = ctypes.c_int


LIB = CudaLibrary("intersect", Path(__file__).resolve().parent / "csrc" / "intersect.cu",
                  _declare)

launches: Dict[str, int] = {
    "fused_extend": 0,
    "fused_verify": 0,
    "lex_bounds": 0,
    "multiway_membership": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True if every tensor is on one CUDA device, False if all are on the
    CPU; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
    return True


def _check(rc: int, name: str) -> None:
    launches[name] += 1
    if rc != 0:
        raise KernelFault(f"{name} launch failed: cudaError {rc}", op=name)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_slabs(name, tab0, tab1, idx, sel, ok, rows) -> Tuple[int, int, int, int]:
    b, k = rows.shape
    e = idx.shape[2]
    d = tab0.shape[1]
    if tab1.shape[1] != d or idx.shape != (2, b, e) or sel.shape != (b, e) \
            or ok.shape != (b, e) or tab0.ndim != 2 or tab1.ndim != 2:
        raise ValueError(
            f"{name}: shapes tab0={tuple(tab0.shape)} tab1={tuple(tab1.shape)} "
            f"idx={tuple(idx.shape)} sel={tuple(sel.shape)} ok={tuple(ok.shape)} "
            f"rows={tuple(rows.shape)} break the slab contract"
        )
    if e < 1 or k > 32:
        raise ValueError(f"{name}: needs 1 <= E and K <= 32, got E={e} K={k}")
    return b, e, k, d


def _bits(positions: Tuple[int, ...], k: int) -> int:
    out = 0
    for p in positions:
        if not 0 <= p < k:
            raise ValueError(f"order position {p} outside rows of width {k}")
        out |= 1 << p
    return out


def multiway_membership(cands: torch.Tensor, others: torch.Tensor) -> torch.Tensor:
    """Batched Eq.-2 membership: cands[B, D] ∈ ∩ others[B, E, D] (sorted rows)."""
    if not _on_cuda("multiway_membership", cands, others):
        return multiway_membership_ref(cands, others)
    b, d = cands.shape
    e = others.shape[1]
    if others.shape != (b, e, d):
        raise ValueError(f"multiway_membership: others {tuple(others.shape)} vs cands {(b, d)}")
    out = torch.empty((b, d), dtype=torch.bool, device=cands.device)
    if b == 0 or d == 0:
        return out
    rc = LIB.load().multiway_membership_launch(
        cands.data_ptr(), others.data_ptr(), out.data_ptr(), b, e, d, _stream()
    )
    _check(rc, "multiway_membership")
    return out


def fused_extend(
    tab0: torch.Tensor,
    tab1: torch.Tensor,
    idx: torch.Tensor,
    sel: torch.Tensor,
    ok: torch.Tensor,
    rows: torch.Tensor,
    *,
    lt: Tuple[int, ...] = (),
    gt: Tuple[int, ...] = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab gather → multiway intersect → injectivity/order filters.
    Returns (cands[B, D], mask[B, D]); row validity is not applied. Slab rows
    must be sorted ascending and INVALID-padded (the kernel reads only their
    valid prefixes)."""
    if not _on_cuda("fused_extend", tab0, tab1, idx, sel, ok, rows):
        return fused_extend_ref(tab0, tab1, idx, sel, ok, rows, lt=lt, gt=gt)
    b, e, k, d = _check_slabs("fused_extend", tab0, tab1, idx, sel, ok, rows)
    cands = torch.empty((b, d), dtype=torch.int32, device=rows.device)
    mask = torch.empty((b, d), dtype=torch.bool, device=rows.device)
    if b == 0 or d == 0:
        return cands, mask
    rc = LIB.load().fused_extend_launch(
        tab0.data_ptr(), tab1.data_ptr(), idx.data_ptr(), sel.data_ptr(),
        ok.data_ptr(), rows.data_ptr(), cands.data_ptr(), mask.data_ptr(),
        b, e, k, d, _bits(lt, k), _bits(gt, k), _stream(),
    )
    _check(rc, "fused_extend")
    return cands, mask


def fused_verify(
    tab0: torch.Tensor,
    tab1: torch.Tensor,
    idx: torch.Tensor,
    sel: torch.Tensor,
    ok: torch.Tensor,
    rows: torch.Tensor,
    *,
    vpos: int,
) -> torch.Tensor:
    """Fused VERIFY: rows[:, vpos] member of every gathered slab. bool[B]."""
    if not _on_cuda("fused_verify", tab0, tab1, idx, sel, ok, rows):
        return fused_verify_ref(tab0, tab1, idx, sel, ok, rows, vpos=vpos)
    b, e, k, d = _check_slabs("fused_verify", tab0, tab1, idx, sel, ok, rows)
    if not 0 <= vpos < k:
        raise ValueError(f"fused_verify: vpos={vpos} outside rows of width {k}")
    out = torch.empty((b,), dtype=torch.bool, device=rows.device)
    if b == 0:
        return out
    rc = LIB.load().fused_verify_launch(
        tab0.data_ptr(), tab1.data_ptr(), idx.data_ptr(), sel.data_ptr(),
        ok.data_ptr(), rows.data_ptr(), out.data_ptr(), b, e, k, d, vpos, _stream(),
    )
    _check(rc, "fused_verify")
    return out


def lex_bounds(sorted_keys: torch.Tensor, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equal-range (lo, hi) of queries[B, KK] in sorted_keys[CAP, KK], which
    must be sorted lexicographically; a bound equal to CAP reads as the plain
    version's fixed-count halving gives it (CAP or CAP + 1, by CAP alone)."""
    if not _on_cuda("lex_bounds", sorted_keys, queries):
        return lex_bounds_ref(sorted_keys, queries)
    cap, kk = sorted_keys.shape
    b = queries.shape[0]
    if queries.shape != (b, kk) or kk < 1 or not 0 < cap < 2**30:
        raise ValueError(
            f"lex_bounds: keys {tuple(sorted_keys.shape)} queries {tuple(queries.shape)}"
        )
    lo = torch.empty((b,), dtype=torch.int32, device=queries.device)
    hi = torch.empty((b,), dtype=torch.int32, device=queries.device)
    if b == 0:
        return lo, hi
    rc = LIB.load().lex_bounds_launch(
        sorted_keys.data_ptr(), queries.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        cap, kk, b, max(1, cap.bit_length()), _stream(),
    )
    _check(rc, "lex_bounds")
    return lo, hi
