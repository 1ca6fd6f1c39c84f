"""Plain PyTorch versions of the intersect kernels (binary-search membership,
slab-gathered fused extend/verify, lexicographic equal-range bounds).

Same signatures and results as the JAX package's ``kernels/intersect/ref.py``.
The wrappers in ``ops.py`` run these for tensors on the CPU, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.graph.storage import INVALID


def multiway_membership_ref(cands: torch.Tensor, others: torch.Tensor) -> torch.Tensor:
    """cands[B, D] present in every others[B, e, :]. ``others`` rows must be
    sorted ascending (INVALID-padded) — the engine's adjacency invariant."""
    d = cands.shape[1]
    cands = cands.contiguous()
    acc = cands != INVALID
    for i in range(others.shape[1]):
        row = others[:, i, :].contiguous()
        idx = torch.searchsorted(row, cands).clamp_(max=d - 1)
        acc &= row.gather(1, idx) == cands
    return acc


def gather_slabs(
    tab0: torch.Tensor, tab1: torch.Tensor, idx: torch.Tensor,
    sel: torch.Tensor, ok: torch.Tensor,
) -> torch.Tensor:
    """Materialise the [B, E, D] slab tensor of the fused-kernel contract:
    slab[b, e] = (tab0 if sel else tab1)[idx[·, b, e]], INVALID where ~ok."""
    s0 = tab0[idx[0].long()]  # [B, E, D]
    s1 = tab1[idx[1].long()]
    slabs = torch.where((sel == 1)[:, :, None], s0, s1)
    return torch.where((ok == 1)[:, :, None], slabs, INVALID)


def fused_extend_ref(
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
    """Plain version of the fused extend kernel: (cands[B, D], mask[B, D])."""
    slabs = gather_slabs(tab0, tab1, idx, sel, ok)
    cands = slabs[:, 0, :]
    if slabs.shape[1] > 1:
        mask = multiway_membership_ref(cands, slabs[:, 1:, :])
    else:
        mask = cands != INVALID
    for col in range(rows.shape[1]):
        mask &= cands != rows[:, col : col + 1]
    for p in lt:
        mask &= cands < rows[:, p : p + 1]
    for p in gt:
        mask &= cands > rows[:, p : p + 1]
    return cands, mask


def fused_verify_ref(
    tab0: torch.Tensor,
    tab1: torch.Tensor,
    idx: torch.Tensor,
    sel: torch.Tensor,
    ok: torch.Tensor,
    rows: torch.Tensor,
    *,
    vpos: int,
) -> torch.Tensor:
    """Plain version of the fused verify kernel: bool[B], rows[:, vpos]
    present in every gathered slab."""
    slabs = gather_slabs(tab0, tab1, idx, sel, ok)
    target = rows[:, vpos]
    acc = target != INVALID
    for e in range(slabs.shape[1]):
        acc &= (slabs[:, e, :] == target[:, None]).any(dim=1)
    return acc


def _lex_cmp(lrows: torch.Tensor, r: torch.Tensor):
    """Lexicographic comparison: returns (lt, eq) of lrows[i] vs r[i]."""
    neq = lrows != r
    first = neq.to(torch.int32).argmax(dim=-1, keepdim=True)
    any_neq = neq.any(dim=-1)
    val_l = lrows.gather(-1, first)[..., 0]
    val_r = r.gather(-1, first)[..., 0]
    return any_neq & (val_l < val_r), ~any_neq


def lex_bounds_ref(sorted_keys: torch.Tensor, queries: torch.Tensor):
    """Lower/upper bounds of each query key in the lexicographically sorted
    key table, by a fixed-iteration binary search."""
    cap = sorted_keys.shape[0]
    bq = queries.shape[0]
    iters = max(1, cap.bit_length())
    dev = queries.device

    def search(upper: bool):
        lo = torch.zeros((bq,), dtype=torch.int32, device=dev)
        hi = torch.full((bq,), cap, dtype=torch.int32, device=dev)
        for _ in range(iters):
            mid = (lo + hi) // 2
            lrows = sorted_keys[mid.clamp(0, cap - 1).long()]
            lt, eq = _lex_cmp(lrows, queries)
            go_right = (lt | eq) if upper else lt
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(go_right, hi, mid)
        return lo

    return search(False), search(True)
