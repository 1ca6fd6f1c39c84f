"""LRBU cache — least-recent-batch-used (paper Alg. 3) as an epoch-sealed,
set-associative table, in PyTorch.

  * ``Seal(v)``   → touched entries get ``epoch = current_epoch`` and are never
                    evicted within the batch (eviction picks the min-epoch way
                    and masks out current-epoch ways);
  * ``Release()`` → ``current_epoch += 1``;
  * a vertex may live only in set ``vid % num_sets``.

Two variants: a *stats* cache (keys only — the engine's per-machine
communication accounting) and a *value* cache (keys + adjacency slabs — the
source the fused kernels read).

Every update is written for a stack of ``M`` independent caches (leading
axis), which is how the engine keeps one cache per simulated machine; the
single-cache functions below add and drop that axis. The state tensors are
updated in place.

Duplicate targets. With more than ``W`` misses in one set, two inserts can
target the same ``(set, way)``. The JAX reference then lets the last writer
win (its CPU scatter runs in order); a CUDA scatter would pick an arbitrary
writer, possibly a different one per tensor, pairing a key with another
vertex's slab. So the winner of each slot is resolved once — the last
occurrence, as in the reference — and every state tensor is written from that
one winner.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.graph.storage import INVALID

_INT32_MAX = INVALID


@dataclasses.dataclass
class LRBUState:
    keys: torch.Tensor           # int32[(M,) S, W] vertex ids (INVALID = empty)
    epoch: torch.Tensor          # int32[(M,) S, W] last batch the entry was sealed
    current_epoch: torch.Tensor  # int32[(M,)]
    values: Optional[torch.Tensor] = None  # int32[S, W, D] adjacency slabs
    degs: Optional[torch.Tensor] = None    # int32[S, W]

    @property
    def num_sets(self) -> int:
        return self.keys.shape[-2]

    @property
    def num_ways(self) -> int:
        return self.keys.shape[-1]


def make_cache(capacity: int, ways: int = 4, d_pad: int | None = None,
               device: str | torch.device | None = None) -> LRBUState:
    """One cache; ``d_pad`` adds the value slabs. ``device``: as
    :func:`repro_torch.device.resolve_device` (``None`` is the card)."""
    device = resolve_device(device)
    sets = max(1, capacity // ways)
    values = degs = None
    if d_pad is not None:
        values = torch.full((sets, ways, d_pad), INVALID, dtype=torch.int32, device=device)
        degs = torch.zeros((sets, ways), dtype=torch.int32, device=device)
    return LRBUState(
        keys=torch.full((sets, ways), INVALID, dtype=torch.int32, device=device),
        epoch=torch.full((sets, ways), -1, dtype=torch.int32, device=device),
        current_epoch=torch.zeros((), dtype=torch.int32, device=device),
        values=values,
        degs=degs,
    )


def make_stacked_cache(num_caches: int, capacity: int, ways: int,
                       device: str | torch.device | None = None) -> LRBUState:
    """``num_caches`` independent stats caches (one per simulated machine);
    ``device`` as in :func:`make_cache`."""
    device = resolve_device(device)
    sets = max(1, capacity // ways)
    return LRBUState(
        keys=torch.full((num_caches, sets, ways), INVALID, dtype=torch.int32, device=device),
        epoch=torch.full((num_caches, sets, ways), -1, dtype=torch.int32, device=device),
        current_epoch=torch.zeros((num_caches,), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Stacked kernels of the cache ops: keys/epoch [M, S, W], vids [M, N]
# ---------------------------------------------------------------------------

def _locate(keys: torch.Tensor, vids: torch.Tensor):
    """(set index, way index or -1, hit) of each request vid."""
    s = keys.shape[1]
    sets = torch.where(vids >= 0, vids % s, 0).long()
    k = torch.gather(keys, 1, sets[:, :, None].expand(-1, -1, keys.shape[2]))  # [M, N, W]
    hit_ways = k == vids[:, :, None]
    way = hit_ways.to(torch.int32).argmax(dim=2)
    hit = hit_ways.any(dim=2) & (vids != INVALID) & (vids >= 0)
    return sets, torch.where(hit, way, -1), hit


def _collision_rank(sets: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Rank of each active item among same-set items of its row (0, 1, 2, …)
    so that several same-batch inserts into one set land in distinct ways."""
    n = sets.shape[1]
    key = torch.where(active, sets, _INT32_MAX)
    order = torch.argsort(key, dim=1, stable=True)
    sk = torch.gather(key, 1, order)
    ar = torch.arange(n, device=sets.device).expand_as(sk)
    new = torch.ones_like(sk, dtype=torch.bool)
    new[:, 1:] = sk[:, 1:] != sk[:, :-1]
    start = torch.where(new, ar, 0).cummax(dim=1).values
    return torch.zeros_like(order).scatter_(1, order, ar - start)


def _seal_hits(epoch, cur, sets, way, hit):
    """Seal: bump the epoch of every hit entry to the current batch."""
    m, s, w = epoch.shape
    flat = sets * w + torch.where(hit, way, 0)
    val = torch.where(hit, cur[:, None], -1)
    epoch.view(m, s * w).scatter_reduce_(1, flat, val, "amax", include_self=True)


def _victims(epoch, cur, sets, miss, lru: bool):
    """Way each miss inserts into: the min-epoch way of its set, skipping ways
    sealed this batch (LRBU), or plainly the min-epoch way (LRU)."""
    w = epoch.shape[2]
    set_epochs = torch.gather(epoch, 1, sets[:, :, None].expand(-1, -1, w))  # [M, N, W]
    if lru:
        victim = set_epochs.argmin(dim=2)
    else:
        sealed = set_epochs >= cur[:, None, None]
        masked = torch.where(sealed, _INT32_MAX, set_epochs)
        victim = masked.argmin(dim=2)
        # Every way sealed: bounded overflow into way 0 (paper's one-batch bound).
        victim = torch.where(sealed.all(dim=2), 0, victim)
        victim = (victim + _collision_rank(sets, miss)) % w
    return victim


def _insert(state_tensors, srcs, slots, miss):
    """Write item ``i``'s source into slot ``slots[i]`` of each state tensor
    for every miss, the last occurrence winning a slot.

    ``state_tensors[j]`` is viewed as ``[M*S*W, ...]``; ``slots`` are flat
    indices into it. ``srcs[j]`` is a ``(table, ids)`` pair: item ``i``'s
    value is ``table[ids[i]]``, or ``table[i]`` where ``ids`` is None; each
    item's row is gathered once, straight from the table, by its slot's
    winner. Items that do not insert are pointed at slot 0 with slot 0's
    winner's value, so every slot has one value among its writers and the
    single scatter per tensor is deterministic. Where slot 0 has no winner
    they write item 0's value, and slot 0 then gets its old value back."""
    total = state_tensors[0].shape[0]
    item = torch.arange(slots.numel(), device=slots.device)
    winner = torch.full((total,), -1, dtype=torch.int64, device=slots.device)
    winner.scatter_reduce_(0, torch.where(miss, slots, 0), torch.where(miss, item, -1),
                           "amax", include_self=True)
    tgt = torch.where(miss, slots, 0)
    src_item = winner[tgt]  # a miss is its slot's winner or loses to a later one
    src_item = src_item.clamp(min=0)
    for dst, (table, ids) in zip(state_tensors, srcs):
        old0 = dst[0].clone()
        dst[tgt] = table[src_item if ids is None else ids[src_item]]
        dst[0] = torch.where(winner[0] < 0, old0, dst[0])


def _fetch_update(state: LRBUState, vids: torch.Tensor, values=None,
                  lru: bool = False) -> torch.Tensor:
    """Stacked fetch stage: seal hits, insert misses, Release. In place.
    ``values``: the value cache's ``(slabs, degrees)`` sources, each a
    ``(table, ids)`` pair over the flattened ``vids`` (see :func:`_insert`)."""
    m, s, w = state.keys.shape
    sets, way, hit = _locate(state.keys, vids)
    cur = state.current_epoch
    _seal_hits(state.epoch, cur, sets, way, hit)
    miss = (~hit) & (vids != INVALID) & (vids >= 0)
    victim = _victims(state.epoch, cur, sets, miss, lru)
    base = torch.arange(m, device=vids.device)[:, None] * (s * w)
    slots = (base + sets * w + victim).reshape(-1)
    n = vids.shape[1]
    dsts = [state.keys.view(m * s * w), state.epoch.view(m * s * w)]
    srcs = [(vids.reshape(-1), None), (cur[:, None].expand(m, n).reshape(-1), None)]
    if values is not None:
        d = state.values.shape[-1]
        dsts += [state.values.view(m * s * w, d), state.degs.view(m * s * w)]
        srcs += list(values)
    _insert(dsts, srcs, slots, miss.reshape(-1))
    state.current_epoch += 1  # Release(): the next batch outranks everything
    return hit


def fetch_update_stacked(state: LRBUState, vids: torch.Tensor, policy: str = "lrbu"):
    """The per-machine stats caches' fetch stage: ``vids[M, N]`` against the
    stacked ``state`` (``[M, S, W]``). Returns ``(state, hit[M, N])``."""
    if policy == "direct":
        return _fetch_update_direct(state, vids)
    return state, _fetch_update(state, vids, lru=policy == "lru")


def _fetch_update_direct(state: LRBUState, vids: torch.Tensor):
    s = state.keys.shape[1]
    keys0 = state.keys[:, :, 0]
    sets = torch.where(vids >= 0, vids % s, 0).long()
    valid = (vids != INVALID) & (vids >= 0)
    hit = (torch.gather(keys0, 1, sets) == vids) & valid
    miss = (~hit) & valid
    m = keys0.shape[0]
    slots = (torch.arange(m, device=vids.device)[:, None] * s + sets).reshape(-1)
    flat_keys = keys0.contiguous().view(-1)
    _insert([flat_keys], [(vids.reshape(-1), None)], slots, miss.reshape(-1))
    state.keys[:, :, 0] = flat_keys.view(m, s)
    state.current_epoch += 1
    return state, hit


def _stack(state: LRBUState) -> LRBUState:
    return LRBUState(
        keys=state.keys[None], epoch=state.epoch[None],
        current_epoch=state.current_epoch.view(1),
        values=None if state.values is None else state.values[None],
        degs=None if state.degs is None else state.degs[None],
    )


# ---------------------------------------------------------------------------
# Single-cache ops (vectorised over a request batch)
# ---------------------------------------------------------------------------

def fetch_update(state: LRBUState, vids: torch.Tensor):
    """The fetch stage of Alg. 4 against the cache, for a deduplicated batch of
    requested vertices: seal hits, insert misses (LRBU eviction), and advance
    the epoch (Release). Returns (state, hit_mask); ``state`` is updated in
    place."""
    hit = _fetch_update(_stack(state), vids[None])
    return state, hit[0]


def fetch_update_values(state: LRBUState, vids: torch.Tensor, rows: torch.Tensor,
                        degs: torch.Tensor):
    """Value-cache variant: also store the fetched adjacency slabs of misses
    (``rows[N, D]``, ``degs[N]``, one per requested vid)."""
    d = rows.shape[-1]
    hit = _fetch_update(_stack(state), vids[None],
                        ((rows.reshape(-1, d), None), (degs.reshape(-1), None)))
    return state, hit[0]


def fetch_update_adjacency(state: LRBUState, vids: torch.Tensor, adj: torch.Tensor,
                           deg: torch.Tensor):
    """:func:`fetch_update_values` with each miss's slab and degree read
    straight from the padded adjacency ``adj[V, D]`` and ``deg[V]`` by its
    vertex id (clamped into the table, as the engine clamps it): the slabs
    are gathered once, for the inserts alone, not first for every request."""
    ids = vids.clamp(0, adj.shape[0] - 1).long()
    hit = _fetch_update(_stack(state), vids[None], ((adj, ids), (deg, ids)))
    return state, hit[0]


def fetch_update_lru(state: LRBUState, vids: torch.Tensor):
    """Classic LRU baseline: every hit refreshes recency and eviction ignores
    sealing."""
    hit = _fetch_update(_stack(state), vids[None], lru=True)
    return state, hit[0]


def fetch_update_direct(state: LRBUState, vids: torch.Tensor):
    """Direct-mapped (1-way) baseline: always evict the colliding slot."""
    _, hit = _fetch_update_direct(_stack(state), vids[None])
    return state, hit[0]


def probe_indices(state: LRBUState, vids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read-only probe for the fused kernels: flat slab index of each vid into
    ``state.values.reshape(S*W, D)`` plus the hit mask. Misses return index 0
    with hit=False — the kernels' select mask routes them to the fallback
    table, so the placeholder row is never read."""
    sets, way, hit = _locate(state.keys[None], vids[None])
    flat = sets[0] * state.num_ways + torch.where(hit[0], way[0], 0)
    return torch.where(hit[0], flat, 0).to(torch.int32), hit[0]


def cache_lookup_values(state: LRBUState, vids: torch.Tensor):
    """Read-only Get(): pure gather, no state mutation.
    Returns (rows[N, D], deg[N], hit[N])."""
    sets, way, hit = _locate(state.keys[None], vids[None])
    sets, hit = sets[0], hit[0]
    safe_way = torch.where(hit, way[0], 0).long()
    rows = torch.where(hit[:, None], state.values[sets, safe_way], INVALID)
    degs = torch.where(hit, state.degs[sets, safe_way], 0)
    return rows, degs, hit
