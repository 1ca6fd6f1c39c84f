"""Mixture-of-Experts layer with HUGE's push/pull dispatch, in PyTorch.

The JAX package's ``models/moe.py``: top-k routing, a sort-based,
capacity-bounded dispatch into ``[E, cap, d]`` buckets, the experts' SwiGLU
FFN as batched products, and a combine that sums each token's k gated
outputs. Across ranks (``comm``: a :class:`repro_torch.core.distributed.Comm`,
whose group plays the JAX ``data`` axis) the join between routed tokens and
expert weights runs in one of two collective schedules:

  push  shuffle the routed tokens onto the ranks that own their experts with
        ``Comm.a2a`` and back (the paper's pushing hash join);
  pull  ``Comm.all_gather`` the expert weights onto every rank and compute
        locally (PULL-EXTEND's fetch: bounded by the weights, not the tokens).

``core.hybrid_comm.moe_dispatch_mode`` picks between them
(``transformer._moe_comm_mode``). The tensor-parallel ``model`` axis and its
``psum`` are not ported: the port has no TP axis.

Semantics held to the reference, bit for bit where the arithmetic allows:

* ``_route``: ties in top-k take the lower expert first, as
  ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` promises
  no order among equal values).
* ``_capacity``: lossless (cap = routed pairs) up to 8,192 routed pairs, else
  ``int(n * 1.25 / E) + 1``, a pair dropped by its stable rank in token
  order; so what drops depends on how many tokens one call holds.
* ``_combine_local``: each token's k pairs are added in order in the model
  dtype, one rounding per addition, which is what the reference's
  scatter-add computes (its pairs of a token sit side by side); a fixed
  order, so the card's result does not vary from run to run.

``moe_block`` under a group takes the global ``x`` and the whole parameters
on every rank, as the port's LM holds them (no sharded forward yet): each
rank takes its token rows and its expert rows as views, runs the push or
pull body (the reference's ``shard_map`` body), and the rows are put back
together by an all-gather of the outputs, where the reference returns a
sharded global array. ``_moe_push``/``_moe_pull`` are the bodies, on one
rank's shards.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers import dense_init, empty_param

# Dispatch statistics, off unless a caller sets a dict: each dispatch then
# adds its routed pairs and bucket slots (host ints) and its kept pairs (a
# device scalar, read when the caller reads it, so no sync here). Where the
# dict holds a list under "routes", each routing appends its choice (idx)
# and each token's margin: its k-th router probability less its (k+1)-th.
stats: Optional[Dict] = None


class MoE(nn.Module):
    """router [d, E] float32; w_gate, w_up [E, d, ff]; w_down [E, ff, d]."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.router = empty_param((d_model, num_experts), torch.float32, device)
        self.w_gate = empty_param((num_experts, d_model, d_ff), dtype, device)
        self.w_up = empty_param((num_experts, d_model, d_ff), dtype, device)
        self.w_down = empty_param((num_experts, d_ff, d_model), dtype, device)


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, num_experts: int,
             dtype: torch.dtype) -> MoE:
    """``dense_init``'s rule on every leaf; the expert weights' fan-in is
    their leading dimension, E, as in the reference."""
    m = MoE(d_model, d_ff, num_experts, dtype, gen.device)
    m.router.copy_(dense_init(gen, (d_model, num_experts), torch.float32))
    for name in ("w_gate", "w_up", "w_down"):
        w = getattr(m, name)
        w.copy_(dense_init(gen, tuple(w.shape), dtype))
    return m


def _route(xt: torch.Tensor, router: torch.Tensor, experts_per_token: int):
    """Top-k routing. Returns (gates [T, K] float32, idx [T, K] int64). The
    top k as ``jax.lax.top_k`` takes them: a stable descending sort puts the
    lower expert first among equal probabilities."""
    logits = xt.to(torch.float32) @ router
    probs = torch.softmax(logits, dim=-1)
    k = experts_per_token
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :k], order[..., :k]
    if stats is not None and "routes" in stats and k < probs.shape[-1]:
        stats["routes"].append((idx, vals[..., k - 1] - vals[..., k]))
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def _positions_by_expert(idx_flat: torch.Tensor, num_experts: int) -> torch.Tensor:
    """pos[i] = rank of pair i within its expert, stable in token order."""
    n = idx_flat.shape[0]
    order = torch.argsort(idx_flat, stable=True)
    sorted_e = idx_flat[order]
    experts = torch.arange(num_experts, dtype=idx_flat.dtype, device=idx_flat.device)
    start = torch.searchsorted(sorted_e, experts)
    rank = torch.arange(n, device=idx_flat.device) - start[sorted_e]
    pos = torch.empty_like(rank)
    pos[order] = rank
    return pos


def _capacity(n_routed: int, e: int, capacity_factor: float) -> int:
    """Per-expert capacity: lossless up to 8,192 routed pairs (decode, small
    batches), the capacity-factor bound above."""
    if n_routed <= 8192:
        return n_routed
    return max(1, int(n_routed * capacity_factor / e) + 1)


def _expert_ffn(ex: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """ex [E, C, d] through each expert's SwiGLU FFN → [E, C, d], in the
    model dtype. Outside a graph ``silu`` and the gate product run in place:
    the same roundings, two [E, C, ff] temporaries fewer."""
    gate = torch.bmm(ex, wg)
    if gate.requires_grad:  # their backward reads the inputs an in-place step would overwrite
        return torch.bmm(torch.nn.functional.silu(gate) * torch.bmm(ex, wu), wd)
    h = torch.nn.functional.silu(gate, inplace=True)
    h.mul_(torch.bmm(ex, wu))
    return torch.bmm(h, wd)


def _dispatch_local(xt: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor, cap: int,
                    num_experts: int):
    """[E, cap, d] buckets and the combine's bookkeeping (idx_flat, slot,
    keep, tok). A dropped pair's write goes to one spare row past the
    buckets (the reference drops the out-of-bounds write)."""
    t, k = idx.shape
    d = xt.shape[-1]
    idx_flat = idx.reshape(-1)
    pos = _positions_by_expert(idx_flat, num_experts)
    keep = pos < cap
    slot = torch.where(keep, pos, cap)
    tok = torch.arange(t, device=xt.device).repeat_interleave(k)
    rows = torch.where(keep, idx_flat * cap + pos, num_experts * cap)
    flat = torch.zeros((num_experts * cap + 1, d), dtype=xt.dtype, device=xt.device)
    flat[rows] = xt[tok]
    if stats is not None:
        stats["routed"] = stats.get("routed", 0) + t * k
        stats["slots"] = stats.get("slots", 0) + num_experts * cap
        stats["kept"] = stats.get("kept", 0) + keep.sum()
    return flat[: num_experts * cap].view(num_experts, cap, d), (idx_flat, slot, keep, tok)


def _combine_local(expert_out: torch.Tensor, gates: torch.Tensor, book, t: int) -> torch.Tensor:
    """Each pair's expert output times its gate (zero where dropped), summed
    over a token's k pairs in order, in the output's dtype."""
    idx_flat, slot, keep, tok = book
    vals = expert_out[idx_flat, torch.clamp(slot, 0, expert_out.shape[1] - 1)]
    vals = vals * (gates.reshape(-1)[:, None] * keep[:, None]).to(vals.dtype)
    vals = vals.view(t, -1, vals.shape[-1])
    out = vals[:, 0].clone()
    for j in range(1, vals.shape[1]):
        out += vals[:, j]
    return out


def _moe_tokens(xt: torch.Tensor, router: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor, experts_per_token: int, capacity_factor: float) -> torch.Tensor:
    """The layer on tokens xt [T, d] with the whole weights, capacity from
    their own routed pairs → [T, d]."""
    t = xt.shape[0]
    gates, idx = _route(xt, router, experts_per_token)
    cap = _capacity(t * experts_per_token, router.shape[1], capacity_factor)
    buckets, book = _dispatch_local(xt, gates, idx, cap, router.shape[1])
    out = _expert_ffn(buckets, wg, wu, wd)
    del buckets
    return _combine_local(out, gates, book, t)


def _moe_local(params: MoE, x: torch.Tensor, experts_per_token: int,
               capacity_factor: float) -> torch.Tensor:
    b, s, d = x.shape
    return _moe_tokens(x.reshape(b * s, d), params.router, params.w_gate, params.w_up,
                       params.w_down, experts_per_token, capacity_factor).reshape(b, s, d)


# -- across ranks ------------------------------------------------------------

def _ep_axes(e: int, world_size: int) -> Tuple[Tuple[str, ...], int]:
    """The reference's largest suffix of (pod, data) whose size divides E,
    with the group as the one ``data`` axis: the experts shard over the
    group where E divides by its size, else over nothing (pull without a
    gather, every rank holding every expert)."""
    if e % world_size == 0:
        return ("data",), world_size
    return (), 1


def _moe_push(xt: torch.Tensor, router: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, experts_per_token: int, capacity_factor: float,
              comm) -> torch.Tensor:
    """One rank's push body: xt [T_loc, d] its tokens, wg/wu/wd its E/P
    experts (rank r holds experts r·E/P ...). Capacity comes from the rank's
    own routed pairs. Returns the rank's [T_loc, d]."""
    t_loc, d = xt.shape
    e = router.shape[1]
    ep = comm.world_size
    e_loc = e // ep
    gates, idx = _route(xt, router, experts_per_token)
    cap = _capacity(t_loc * experts_per_token, e, capacity_factor)
    send, book = _dispatch_local(xt, gates, idx, cap, e)
    # [E, cap, d] → [EP, E_loc, cap, d]: block i to expert owner i.
    recv = comm.a2a(send.reshape(ep, e_loc, cap, d))
    ex = recv.transpose(0, 1).reshape(e_loc, ep * cap, d)
    out = _expert_ffn(ex, wg, wu, wd)
    back = out.reshape(e_loc, ep, cap, d).transpose(0, 1)
    got = comm.a2a(back).reshape(e, cap, d)
    return _combine_local(got, gates, book, t_loc)


def _moe_pull(xt: torch.Tensor, router: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, experts_per_token: int, capacity_factor: float, comm,
              gather: bool = True) -> torch.Tensor:
    """One rank's pull body: the rank's expert rows are all-gathered into
    the whole weights first (``gather``; without it they are whole already),
    then the rank's tokens run as ``_moe_local`` runs them."""
    if gather:
        wg, wu, wd = comm.all_gather(wg), comm.all_gather(wu), comm.all_gather(wd)
    return _moe_tokens(xt, router, wg, wu, wd, experts_per_token, capacity_factor)


def moe_block(params: MoE, x: torch.Tensor, *, experts_per_token: int,
              capacity_factor: float = 1.25, comm_mode: str = "auto",
              comm=None) -> torch.Tensor:
    """x [B, S, d] → [B, S, d]. Without a group (or a group of one, or
    ``comm_mode="local"``): ``_moe_local``. Under a group of P ranks, every
    rank passing the same x and parameters: tokens that do not split into P
    equal shards stay whole on every rank and the weights are pulled;
    otherwise ``"pull"`` pulls and anything else pushes, as in the
    reference."""
    b, s, d = x.shape
    ep = 1 if comm is None else comm.world_size
    if ep == 1 or comm_mode == "local":
        return _moe_local(params, x, experts_per_token, capacity_factor)
    e = params.router.shape[1]
    axes, ep_size = _ep_axes(e, ep)
    e_loc = e // ep_size
    rows = slice(comm.rank * e_loc, (comm.rank + 1) * e_loc) if axes else slice(None)
    ws = (params.w_gate[rows], params.w_up[rows], params.w_down[rows])
    args = (experts_per_token, capacity_factor, comm)
    xt = x.reshape(b * s, d)
    if (b * s) % ep != 0:
        return _moe_pull(xt, params.router, *ws, *args, gather=bool(axes)).reshape(b, s, d)
    t_loc = b * s // ep
    mine = xt[comm.rank * t_loc : (comm.rank + 1) * t_loc]
    if comm_mode == "pull" or not axes:
        out = _moe_pull(mine, params.router, *ws, *args, gather=bool(axes))
    else:
        out = _moe_push(mine, params.router, *ws, *args)
    return comm.all_gather(out).reshape(b, s, d)


def router_aux_loss(params: MoE, x: torch.Tensor, experts_per_token: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (float32 scalar)."""
    d = x.shape[-1]
    logits = x.reshape(-1, d).to(torch.float32) @ params.router
    probs = torch.softmax(logits, dim=-1)
    e = probs.shape[-1]
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :experts_per_token]
    frac_tokens = torch.nn.functional.one_hot(idx, e).to(torch.float32).sum(1).mean(0)
    frac_probs = probs.mean(0)
    return e * torch.sum(frac_tokens * frac_probs)
