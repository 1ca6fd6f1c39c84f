"""Vectorised PyTorch implementations of the primitive operators (paper §4.2-4.4).

Batches of partial matches are dense int32 tensors ``rows[B, K]`` with a valid
count ``n`` (rows ≥ n are ignored). Queues are fixed-capacity stacks
``(buf[CAP, K], n)`` — enumeration has set semantics, so LIFO order is
irrelevant and a pop is a slice.

Every function computes what its namesake in the JAX package's
``core/operators.py`` computes, bit for bit, on tensors of one device. Where
the reference leans on a ``mode="drop"`` scatter, the port either writes
through a spare dump slot that is sliced off, or selects the kept rows with
``nonzero``. The latter waits for the device; the counts it returns are host
integers, which is what the engine needs next anyway (it syncs on every
count, as the reference does).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.graph.storage import INVALID
from repro_torch.kernels.intersect import ops as ik
from repro_torch.kernels.intersect.ref import lex_bounds_ref

_INT32_MAX = INVALID


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


# ---------------------------------------------------------------------------
# Small utilities
# ---------------------------------------------------------------------------

def row_membership(sorted_rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """queries[b, j] ∈ sorted_rows[b, :] (rows sorted ascending, INVALID-padded)."""
    sorted_rows = sorted_rows.contiguous()
    queries = queries.contiguous()
    idx = torch.searchsorted(sorted_rows, queries).clamp_(max=sorted_rows.shape[-1] - 1)
    found = sorted_rows.gather(-1, idx)
    return (found == queries) & (queries != INVALID)


def compact(rows: torch.Tensor, mask: torch.Tensor, out_cap: int) -> Tuple[torch.Tensor, int]:
    """Pack masked rows to the front of a fresh INVALID ``[out_cap, K]``
    buffer. ``n`` is the number of masked rows (it may exceed ``out_cap``;
    rows past the capacity are dropped)."""
    keep = mask.nonzero().squeeze(1)
    n = keep.numel()
    take = min(n, out_cap)
    out = torch.full((out_cap, rows.shape[-1]), INVALID, dtype=torch.int32, device=rows.device)
    out[:take] = rows[keep[:take]]
    return out, n


def _expand_compact(rows: torch.Tensor, cands: torch.Tensor, mask: torch.Tensor,
                    out_cap: int) -> Tuple[torch.Tensor, int]:
    """``compact`` of the expanded rows ``[rows[b] ++ cands[b, j]]`` over
    ``mask[b, j]``, without materialising the ``[B*D, K+1]`` expansion."""
    b, k = rows.shape
    d = cands.shape[1]
    keep = mask.reshape(-1).nonzero().squeeze(1)
    n = keep.numel()
    keep = keep[: min(n, out_cap)]
    out = torch.full((out_cap, k + 1), INVALID, dtype=torch.int32, device=rows.device)
    out[: keep.numel(), :k] = rows[keep // d]
    out[: keep.numel(), k] = cands.reshape(-1)[keep]
    return out, n


def dedup_pad(vids: torch.Tensor) -> torch.Tensor:
    """Unique valid vertex ids packed to the front, INVALID-padded to the input
    length (the merged-RPC dedup; also the precondition of the LRBU value-cache
    insert)."""
    n = vids.shape[0]
    v = torch.where((vids >= 0) & (vids != INVALID), vids, INVALID)
    s = torch.sort(v).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    keep = (s != INVALID) & first
    tgt = torch.where(keep, torch.cumsum(keep, 0) - 1, n)
    out = torch.full((n + 1,), INVALID, dtype=torch.int32, device=vids.device)
    out[tgt] = s  # every dropped item lands in the spare slot n
    return out[:n]


def lexsort_rows(cols: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic argsort by columns of ``cols[N, C]`` (col 0 primary)."""
    order = _arange(cols.shape[0], cols)
    for c in range(cols.shape[1] - 1, -1, -1):
        perm = torch.argsort(cols[order, c], stable=True)
        order = order[perm]
    return order


# ---------------------------------------------------------------------------
# Queue (fixed-capacity stack)
# ---------------------------------------------------------------------------

def queue_append(buf: torch.Tensor, n: int, rows: torch.Tensor, m: int):
    """Append the first ``m`` rows at ``buf[n:]``, dropping what does not fit.
    Updates ``buf`` in place (the reference donates it) and returns it with
    the new count ``min(n + m, CAP)``."""
    n, m = int(n), int(m)
    cap = buf.shape[0]
    take = max(0, min(m, cap - n, rows.shape[0]))
    if take:
        buf[n : n + take] = rows[:take]
    return buf, min(n + m, cap)


def queue_pop(buf: torch.Tensor, n: int, batch: int):
    """Pop up to ``batch`` rows off the top. Returns ``(rows[batch, K], take,
    n - take)``; ``rows`` is a view of ``buf`` (valid until the next append)
    whose rows ≥ ``take`` are stale. The window start is clamped into the
    buffer as ``lax.dynamic_slice`` clamps it."""
    n = int(n)
    cap = buf.shape[0]
    if batch > cap:
        raise ValueError(f"queue_pop batch {batch} > capacity {cap}")
    take = min(n, batch)
    start = min(max(n - take, 0), cap - batch)
    return buf[start : start + batch], take, n - take


def partition_rows_by_key(rows: torch.Tensor, valid: torch.Tensor, key: torch.Tensor,
                          num_shards: int) -> torch.Tensor:
    """Group rows by destination shard ``key % num_shards``.

    Returns ``send[P, B, K]`` (INVALID-padded): ``send[d]`` holds the rows
    destined to shard ``d``, packed to the front in their original order."""
    b, k = rows.shape
    dest = torch.where(valid, key % num_shards, num_shards)
    order = torch.argsort(dest, stable=True)
    sdest = dest[order].long()
    srows = rows[order]
    cnt = torch.bincount(sdest, minlength=num_shards + 1)[:num_shards]
    offs_ext = torch.zeros(num_shards + 1, dtype=torch.int64, device=rows.device)
    offs_ext[:num_shards] = torch.cumsum(cnt, 0) - cnt
    slot = _arange(b, rows) - offs_ext[sdest.clamp(max=num_shards)]
    ok = sdest < num_shards
    send = torch.full((num_shards + 1, b + 1, k), INVALID, dtype=torch.int32,
                      device=rows.device)
    send[torch.where(ok, sdest, num_shards), torch.where(ok, slot, b)] = srows
    return send[:num_shards, :b].contiguous()


# ---------------------------------------------------------------------------
# SCAN
# ---------------------------------------------------------------------------

def scan_batch(src: torch.Tensor, dst: torch.Tensor, cursor: int, total: int,
               batch: int, lt: Tuple[int, ...], gt: Tuple[int, ...]):
    """Emit one batch of directed-edge matches [batch, 2] starting at cursor.

    ``src``/``dst`` must be padded to a multiple of ``batch`` (the engine does
    this) so the window never clamps; ``total`` is the true edge count."""
    cursor, total = int(cursor), int(total)
    start = min(max(cursor, 0), src.shape[0] - batch)
    rows = torch.stack([src[start : start + batch], dst[start : start + batch]], dim=1)
    mask = (cursor + _arange(batch, src)) < total
    for p in lt:  # col0 < col(p): only p=1 arises for scans
        mask = mask & (rows[:, 0] < rows[:, p])
    for p in gt:
        mask = mask & (rows[:, 0] > rows[:, p])
    rows = torch.where(mask[:, None], rows, INVALID)
    return compact(rows, mask, batch)


# ---------------------------------------------------------------------------
# PULL-EXTEND / VERIFY — intersect stage (Eq. 2). On a single device all
# adjacency is local; the fetch stage's accounting lives in the engine.
# ---------------------------------------------------------------------------

def _nbr_rows(adj: torch.Tensor, rows: torch.Tensor, col: int) -> torch.Tensor:
    v = adj.shape[0]
    vids = rows[:, col]
    r = adj[vids.clamp(0, v - 1).long()]
    ok = (vids >= 0) & (vids < v)
    return torch.where(ok[:, None], r, INVALID)


def extend_batch(
    adj: torch.Tensor,         # int32[V, D] padded sorted adjacency
    rows: torch.Tensor,        # int32[B, K]
    n,
    ext: Tuple[int, ...],
    lt: Tuple[int, ...],
    gt: Tuple[int, ...],
    out_cap: int,
    use_kernel: bool = False,
):
    b, k = rows.shape
    valid_row = _arange(b, rows) < n
    cands = _nbr_rows(adj, rows, ext[0])  # [B, D]
    mask = (cands != INVALID) & valid_row[:, None]
    if len(ext) > 1:
        if use_kernel:
            others = torch.stack([_nbr_rows(adj, rows, d) for d in ext[1:]], dim=1)
            mask &= ik.multiway_membership(cands, others)
        else:
            for d in ext[1:]:
                mask &= row_membership(_nbr_rows(adj, rows, d), cands)
    # Isomorphism (injectivity) check — Alg. 4 line 19.
    for col in range(k):
        mask &= cands != rows[:, col : col + 1]
    # Symmetry-breaking partial orders.
    for p in lt:
        mask &= cands < torch.where(valid_row, rows[:, p], -1)[:, None]
    for p in gt:
        mask &= cands > torch.where(valid_row, rows[:, p], INVALID)[:, None]
    return _expand_compact(rows, cands, mask, out_cap)


def verify_batch(
    adj: torch.Tensor,
    rows: torch.Tensor,
    n,
    ext: Tuple[int, ...],
    verify_pos: int,
    out_cap: int,
):
    """Pulling-hash 'hint' (§5.2): keep rows whose f(root) ∈ ∩ N(f(ext))."""
    b = rows.shape[0]
    target = rows[:, verify_pos : verify_pos + 1]  # [B, 1]
    mask = _arange(b, rows) < n
    for d in ext:
        mask = mask & row_membership(_nbr_rows(adj, rows, d), target)[:, 0]
    return compact(rows, mask, out_cap)


# ---------------------------------------------------------------------------
# Fused hot path: the engine computes the cache-probe addressing as a small
# [B, E] prologue; slab gather, Eq.-2 intersection, injectivity and order
# filters run in one kernel (or its plain version on the CPU).
# ---------------------------------------------------------------------------

def fused_extend_batch(
    tab0: torch.Tensor,   # int32[R0, D] probe source (cache slabs)
    tab1: torch.Tensor,   # int32[R1, D] fallback (padded adjacency)
    idx: torch.Tensor,    # int32[2, B, E]
    sel: torch.Tensor,    # int32[B, E]
    ok: torch.Tensor,     # int32[B, E]
    rows: torch.Tensor,   # int32[B, K]
    n,
    lt: Tuple[int, ...],
    gt: Tuple[int, ...],
    out_cap: int,
):
    b = rows.shape[0]
    cands, mask = ik.fused_extend(tab0, tab1, idx, sel, ok, rows, lt=lt, gt=gt)
    mask &= (_arange(b, rows) < n)[:, None]
    return _expand_compact(rows, cands, mask, out_cap)


def fused_verify_batch(
    tab0: torch.Tensor,
    tab1: torch.Tensor,
    idx: torch.Tensor,
    sel: torch.Tensor,
    ok: torch.Tensor,
    rows: torch.Tensor,
    n,
    vpos: int,
    out_cap: int,
):
    b = rows.shape[0]
    keep = ik.fused_verify(tab0, tab1, idx, sel, ok, rows, vpos=vpos)
    return compact(rows, keep & (_arange(b, rows) < n), out_cap)


# ---------------------------------------------------------------------------
# PUSH-JOIN — buffered hash join (§4.3). The left side is sorted by key once;
# right batches then probe it with a lexicographic equal-range search and the
# per-key cross products are emitted.
# ---------------------------------------------------------------------------

def join_prepare(lbuf: torch.Tensor, ln, key_cols: Tuple[int, ...]):
    """Sort the fully-buffered left side by its join key (invalid rows last)."""
    valid = _arange(lbuf.shape[0], lbuf) < ln
    keys = torch.where(valid[:, None], lbuf[:, list(key_cols)], INVALID)
    order = lexsort_rows(keys)
    return keys[order], lbuf[order]


def _filter_cross(out, valid, cross_neq, cross_lt):
    for a, c in cross_neq:
        valid = valid & (out[:, a] != out[:, c])
    for a, c in cross_lt:
        valid = valid & (out[:, a] < out[:, c])
    return torch.where(valid[:, None], out, INVALID), valid


def join_probe(
    sorted_keys: torch.Tensor,   # [CAP, kk] left keys, sorted, INVALID-padded
    sorted_buf: torch.Tensor,    # [CAP, KL] left rows in the same order
    rrows: torch.Tensor,         # [B, KR]
    rn,
    key_right: Tuple[int, ...],
    right_extra: Tuple[int, ...],
    cross_neq: Tuple[Tuple[int, int], ...],
    cross_lt: Tuple[Tuple[int, int], ...],
    out_cap: int,
    use_kernel: bool = False,
):
    """Probe one right batch against the sorted left side. Returns
    ``(out[out_cap, KL+|extra|], n, overflow)``; ``overflow`` means the
    batch produced more than ``out_cap`` pairs (results were lost)."""
    b = rrows.shape[0]
    rvalid = _arange(b, rrows) < rn
    # Invalid queries are INVALID-1 so they never equal an INVALID pad row.
    rkeys = torch.where(rvalid[:, None], rrows[:, list(key_right)], INVALID - 1).contiguous()
    if use_kernel:
        lo, hi = ik.lex_bounds(sorted_keys, rkeys)
    else:
        lo, hi = lex_bounds_ref(sorted_keys, rkeys)
    cnt = torch.where(rvalid, hi - lo, 0).long()
    ends = torch.cumsum(cnt, 0)
    off = ends - cnt
    total = ends[-1]

    o = _arange(out_cap, rrows)
    g = torch.searchsorted(ends, o, right=True).clamp_(0, b - 1)
    lpos = (lo.long()[g] + (o - off[g])).clamp_(0, sorted_buf.shape[0] - 1)
    out = sorted_buf[lpos]
    if right_extra:
        out = torch.cat([out, rrows[g][:, list(right_extra)]], dim=1)
    out, valid = _filter_cross(out, o < total, cross_neq, cross_lt)
    out2, nout = compact(out, valid, out_cap)
    return out2, nout, bool(total > out_cap)


def join_batch(
    lbuf: torch.Tensor,  # [NL, KL]
    ln,
    rbuf: torch.Tensor,  # [NR, KR]
    rn,
    key_left: Tuple[int, ...],
    key_right: Tuple[int, ...],
    right_extra: Tuple[int, ...],
    cross_neq: Tuple[Tuple[int, int], ...],
    cross_lt: Tuple[Tuple[int, int], ...],
    out_cap: int,
):
    """Single-shot group join of two buffers (sort both sides together by
    key, then emit each key group's left × right cross product)."""
    nl = lbuf.shape[0]
    nr = rbuf.shape[0]
    nn = nl + nr
    dev = lbuf.device
    lkeys = torch.where((_arange(nl, lbuf) < ln)[:, None], lbuf[:, list(key_left)], INVALID)
    rkeys = torch.where((_arange(nr, rbuf) < rn)[:, None], rbuf[:, list(key_right)], INVALID)
    keys = torch.cat([lkeys, rkeys], dim=0)
    side = torch.cat([torch.zeros(nl, dtype=torch.int32, device=dev),
                      torch.ones(nr, dtype=torch.int32, device=dev)])
    orig = torch.cat([_arange(nl, lbuf), _arange(nr, rbuf)])

    order = lexsort_rows(torch.cat([keys, side[:, None]], dim=1))
    sk, ss, so = keys[order], side[order], orig[order]
    newgrp = torch.ones(nn, dtype=torch.bool, device=dev)
    newgrp[1:] = (sk[1:] != sk[:-1]).any(dim=1)
    gid = torch.cumsum(newgrp, 0) - 1
    ar = _arange(nn, lbuf)
    gstart = torch.full((nn,), _INT32_MAX, dtype=torch.int64, device=dev).scatter_reduce(
        0, gid, ar, "amin", include_self=False)
    lcnt = torch.zeros(nn, dtype=torch.int64, device=dev).scatter_add(0, gid, (ss == 0).long())
    rcnt = torch.zeros(nn, dtype=torch.int64, device=dev).scatter_add(0, gid, (ss == 1).long())
    gkey0 = torch.full((nn,), INVALID, dtype=torch.int32, device=dev).scatter_reduce(
        0, gid, sk[:, 0], "amin", include_self=True)
    pairs = torch.where(gkey0 == INVALID, 0, lcnt * rcnt)
    ends = torch.cumsum(pairs, 0)
    out_off = ends - pairs
    total = ends[-1]

    o = _arange(out_cap, lbuf)
    g = torch.searchsorted(ends, o, right=True).clamp_(0, nn - 1)
    local = o - out_off[g]
    rc = rcnt[g].clamp(min=1)
    gs = gstart[g]
    lpos = (gs + local // rc).clamp(0, nn - 1)
    rpos = (gs + lcnt[g] + local % rc).clamp(0, nn - 1)
    lrows = lbuf[so[lpos].clamp(0, nl - 1)]
    rrows = rbuf[so[rpos].clamp(0, nr - 1)]
    out = torch.cat([lrows, rrows[:, list(right_extra)]], dim=1) if right_extra else lrows
    out, valid = _filter_cross(out, o < total, cross_neq, cross_lt)
    out2, nout = compact(out, valid, out_cap)
    return out2, nout, bool(total > out_cap)
