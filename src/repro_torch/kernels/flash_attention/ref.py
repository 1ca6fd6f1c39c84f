"""Plain PyTorch version of flash attention: materialised-scores softmax
attention, the JAX package's ``kernels/flash_attention/ref.py``.

q [BHq, Sq, Dh], k and v [BHkv, Sk, Dh] with BHkv dividing BHq (grouped-query
attention: query row ``bh`` reads KV row ``bh // (BHq // BHkv)``) → out
[BHq, Sq, Dh] in q's dtype. Scores are ``(q·k)/√Dh`` in float32, optionally
soft-capped; under ``causal`` query i sees key j iff ``i + Sk − Sq ≥ j``, and
under a sliding ``window`` also iff ``i + Sk − Sq − j < window`` (the JAX
model's ``_sdpa`` mask ``q_pos − k_pos < window`` with q_pos = i + Sk − Sq).
A query row that sees no key gets the softmax of a row of −1e30s here (the
mean of v), as in the JAX twin; the kernel and the chunked path give 0 there.

``attention_split_ref`` is the plain version of the kernel's decode form:
partial (m, l, acc) per split of the keys, merged by log-sum-exp. It gives 0
on a row that sees no key, as the kernel does.

``attention_bwd_ref`` is the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``): the gradients of q, k and v from the
forward's output, its log-sum-exp per row and the output's gradient, written
out rather than taken through autograd. ``attention_bwd_tf32x3_ref`` is the
same with the float32 kernel's arithmetic: each of its five products taken
in split TF32 on the tensor cores.
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


def visible(sq: int, sk: int, k_pos: torch.Tensor, causal: bool, window: int | None):
    """[Sq, len(k_pos)] mask: query i sees key k_pos[j]."""
    ahead = torch.arange(sq, device=k_pos.device)[:, None] + (sk - sq) - k_pos[None, :]
    mask = torch.ones(ahead.shape, dtype=torch.bool, device=k_pos.device)
    if causal:
        mask = mask & (ahead >= 0)
    if window is not None:
        mask = mask & (ahead < window)
    return mask


def attention_ref(q, k, v, *, causal: bool = True, softcap: float | None = None,
                  window: int | None = None):
    dh = q.shape[-1]
    k, v = expand_kv(q, k, v)
    f32 = torch.float32
    s = torch.einsum("bqd,bkd->bqk", q.to(f32), k.to(f32))
    s = s / (dh ** 0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal or window is not None:
        sq, sk = s.shape[-2:]
        mask = visible(sq, sk, torch.arange(sk, device=s.device), causal, window)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(f32)).to(q.dtype)


def attention_split_ref(q, k, v, split: int, *, causal: bool = True,
                        softcap: float | None = None, window: int | None = None):
    """Attention over the keys cut into splits of ``split`` keys (the last
    may be shorter): each split's row max m, sum l = Σ exp(s − m) and
    acc = Σ exp(s − m)·v in float32, then out = Σ w·acc / Σ w·l with
    w = exp(m − max m). A split in which a row sees no key has m = −1e30 and
    l = 0, so it weighs nothing; a row that sees no key at all gives 0."""
    if split < 1:
        raise ValueError(f"attention_split_ref: split must be positive, got {split}")
    dh = q.shape[-1]
    k, v = expand_kv(q, k, v)
    f32 = torch.float32
    sq, sk = q.shape[1], k.shape[1]
    qf = q.to(f32) / (dh ** 0.5)
    parts = []
    for k0 in range(0, sk, split):
        kb, vb = k[:, k0 : k0 + split].to(f32), v[:, k0 : k0 + split].to(f32)
        s = torch.einsum("bqd,bkd->bqk", qf, kb)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = visible(sq, sk, k0 + torch.arange(kb.shape[1], device=q.device), causal, window)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        parts.append((m, p.sum(dim=-1, keepdim=True), torch.einsum("bqk,bkd->bqd", p, vb)))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    den = torch.zeros_like(m_all)
    acc = torch.zeros(q.shape, dtype=f32, device=q.device)
    for m, l, a in parts:
        w = torch.exp(m - m_all)
        den = den + w * l
        acc = acc + w * a
    return (acc / torch.clamp(den, min=1e-30)).to(q.dtype)


def attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                      softcap: float | None = None, window: int | None = None):
    """(dq, dk, dv) of ``attention`` at q [BHq, Sq, Dh], k and v [BHkv, Sk, Dh]
    with output o and its gradient ``do`` [BHq, Sq, Dh], and ``lse``
    [BHq, Sq] float32, the natural-log log-sum-exp of each row's (soft-capped)
    scores (+inf for a row that sees no key). In float32:

        P = exp(s − lse) where the row sees the key, else 0
        dV = Pᵀ dO,  dP = dO Vᵀ,  D = rowsum(dO ∘ O)
        dS = P ∘ (dP − D) ∘ (1 − tanh²) · scale   (the tanh factor with a softcap only)
        dQ = dS K,  dK = dSᵀ Q

    dK and dV are summed over each KV row's group of query rows. The results
    take the inputs' dtypes."""
    dh = q.shape[-1]
    bhq, bhkv = q.shape[0], k.shape[0]
    ke, ve = expand_kv(q, k, v)
    f32 = torch.float32
    scale = dh ** -0.5
    qf, kf, vf, of, gf = (x.to(f32) for x in (q, ke, ve, o, do))
    x = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if softcap is not None:
        t = torch.tanh(x / softcap)
        x = softcap * t
    sq, sk = x.shape[-2:]
    mask = visible(sq, sk, torch.arange(sk, device=q.device), causal, window)
    p = torch.where(mask, torch.exp(x - lse.to(f32)[..., None]), 0.0)
    dv = torch.einsum("bqk,bqd->bkd", p, gf)
    dp = torch.einsum("bqd,bkd->bqk", gf, vf)
    ds = p * (dp - torch.sum(gf * of, dim=-1, keepdim=True))
    if softcap is not None:
        ds = ds * (1 - t * t)
    ds = ds * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, kf)
    dk = torch.einsum("bqk,bqd->bkd", ds, qf)
    group = bhq // bhkv
    dk = dk.view(bhkv, group, sk, dh).sum(1)
    dv = dv.view(bhkv, group, sk, dh).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero: the bits ``cvt.rna.tf32.f32`` gives (the kernel's add
    and mask)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the float32 backward kernel takes it on the
    tensor cores: a = a_big + a_small with a_big = tf32(a), a_small =
    tf32(a - a_big) (likewise b), then a_small·b_big + a_big·b_small +
    a_big·b_big in float32 sums (``terms`` = 3, 3xTF32), or a_big·b_big alone
    (``terms`` = 1, one TF32 product)."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    out = torch.einsum(eq, a_big, b_big)
    if terms == 1:
        return out
    if terms != 3:
        raise ValueError(f"tf32_product: terms must be 1 or 3, got {terms}")
    a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
    return torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small) + out


def attention_bwd_tf32x3_ref(q, k, v, o, do, lse, *, causal: bool = True,
                             softcap: float | None = None, window: int | None = None,
                             terms: int = 3):
    """``attention_bwd_ref`` with the float32 backward kernel's arithmetic:
    each of the five products (S = Q Kᵀ, dP = dO Vᵀ, dV = Pᵀ dO, dK = dSᵀ Q,
    dQ = dS K) is ``tf32_product`` of its two float32 operands, split when
    the kernel loads them, but S under a softcap, which the kernel takes in
    plain float32 (its scores reach the cap, where P carries their rounding
    whole); the softmax and dS in float32 between them, as
    ``attention_bwd_ref`` takes them. ``terms`` = 1 takes each product in one
    TF32 product instead (what the tensor cores give without the split).
    The sums are plain float32 ones: the kernel takes them in short partials
    (the tensor cores truncate as they accumulate) added in float32. Float32
    operands only; same signature and result otherwise."""
    if q.dtype != torch.float32:
        raise TypeError(f"attention_bwd_tf32x3_ref: float32 only, got {q.dtype}")
    dh = q.shape[-1]
    bhq, bhkv = q.shape[0], k.shape[0]
    ke, ve = expand_kv(q, k, v)
    scale = dh ** -0.5
    x = (torch.einsum("bqd,bkd->bqk", q, ke) if softcap is not None
         else tf32_product("bqd,bkd->bqk", q, ke, terms)) * scale
    if softcap is not None:
        t = torch.tanh(x / softcap)
        x = softcap * t
    sq, sk = x.shape[-2:]
    mask = visible(sq, sk, torch.arange(sk, device=q.device), causal, window)
    p = torch.where(mask, torch.exp(x - lse[..., None]), 0.0)
    dv = tf32_product("bqk,bqd->bkd", p, do, terms)
    dp = tf32_product("bqd,bkd->bqk", do, ve, terms)
    ds = p * (dp - torch.sum(do * o, dim=-1, keepdim=True))
    if softcap is not None:
        ds = ds * (1 - t * t)
    ds = ds * scale
    dq = tf32_product("bqk,bkd->bqd", ds, ke, terms)
    dk = tf32_product("bqk,bqd->bkd", ds, q, terms)
    group = bhq // bhkv
    dk = dk.view(bhkv, group, sk, dh).sum(1)
    dv = dv.view(bhkv, group, sk, dh).sum(1)
    return dq, dk, dv
