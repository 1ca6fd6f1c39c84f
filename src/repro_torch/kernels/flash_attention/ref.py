"""Plain PyTorch version of flash attention: materialised-scores softmax
attention, the JAX package's ``kernels/flash_attention/ref.py``.

q [BHq, Sq, Dh], k and v [BHkv, Sk, Dh] with BHkv dividing BHq (grouped-query
attention: query row ``bh`` reads KV row ``bh // (BHq // BHkv)``) → out
[BHq, Sq, Dh] in q's dtype. Scores are ``(q·k)/√Dh`` in float32, optionally
soft-capped, and under ``causal`` query i sees key j iff ``i + Sk − Sq ≥ j``.
A query row that sees no key gets the softmax of a row of −1e30s here (the
mean of v), as in the JAX twin; the kernel and the chunked path give 0 there.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def expand_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """k, v with each KV row repeated for its group of query rows."""
    bhq, bhkv = q.shape[0], k.shape[0]
    if bhkv < 1 or bhq % bhkv or v.shape[0] != bhkv:
        raise ValueError(f"attention: {bhkv} KV rows do not divide {bhq} query rows")
    if bhq == bhkv:
        return k, v
    groups = bhq // bhkv
    return k.repeat_interleave(groups, dim=0), v.repeat_interleave(groups, dim=0)


def attention_ref(q, k, v, *, causal: bool = True, softcap: float | None = None):
    dh = q.shape[-1]
    k, v = expand_kv(q, k, v)
    f32 = torch.float32
    s = torch.einsum("bqd,bkd->bqk", q.to(f32), k.to(f32))
    s = s / (dh ** 0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(f32)).to(q.dtype)
