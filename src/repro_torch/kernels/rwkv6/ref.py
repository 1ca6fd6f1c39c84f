"""Plain PyTorch version of the RWKV6 (Finch) recurrence: the sequential form.

Per head with key width K and value width V, at each step t:

    out_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t   = diag(w_t) S_{t-1} + k_t v_tᵀ,        S_0 = 0

with data-dependent decay w_t ∈ (0, 1) and per-head bonus u. Shapes: r/k/w
[BH, T, K], v [BH, T, V], u [BH, K] → out float32 [BH, T, V] and, with
``return_state``, the final S float32 [BH, K, V]. The CUDA kernel
(``csrc/rwkv6.cu``) is held against this function; the CPU path of the model
runs the chunked form in ``ops.py`` instead, as the JAX package does off
the TPU.

``rwkv6_bwd_split_ref`` is the plain version of the backward kernel's
arithmetic (``csrc/rwkv6_bwd.cu``): boundary states a chunk at a time, then
a step-by-step walk per chunk from them.

``rwkv6_chunk_ref`` is the plain version of the kernel's own arithmetic: the
TPU kernel's chunked matrix form, per chunk of ``CHUNK`` steps

    out = (r ⊙ W_{0,t}) S + A v,     S ← W_{0,C} ⊙ S + (k ⊙ W_{j+1,C})ᵀ v

with ``W_{a,b} = Π_{a≤s<b} w_s`` (= e^{c_{b−1} − c_{a−1}} in the TPU kernel's
cumulative log-decays) and ``A[t,j] = Σ_i r[t,i] k[j,i] W_{j+1,t}[i]`` for
j < t, ``A[t,t] = r_t·(u ⊙ k_t)``. Every decay factor is a product of decays
taken from an anchor that lies between the two steps, so none exceeds 1,
whatever w ≤ 1: below the diagonal sub-chunk of ``SUB`` steps, A is
``(r_t ⊙ W_{a,t}) · (k_j ⊙ W_{j+1,a})`` with ``a`` the start of t's
sub-chunk; inside it, pairwise. Decays are clamped at ``W_MIN`` (the TPU
kernel clamps log w at log 1e-12), the steps past T of the last chunk carry
w = 1 and r = k = v = 0, and the value columns go in blocks of ``COLS``, each
on its own (column j of S and out needs only column j of v), as the
kernel's blocks take them.
"""
from __future__ import annotations

import torch

BWD_CHUNK = 32  # steps a chunk of the backward kernel: its boundary states (rwkv6_bwd.cu: kChunk)


def rwkv6_ref(r, k, v, w, u, *, return_state: bool = False):
    f32 = torch.float32
    r, k, v, w, u = (x.to(f32) for x in (r, k, v, w, u))
    bh, t, kd = r.shape
    vd = v.shape[-1]
    S = torch.zeros((bh, kd, vd), dtype=f32, device=r.device)
    out = torch.empty((bh, t, vd), dtype=f32, device=r.device)
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]                    # [BH, K, V]
        out[:, i] = (r[:, i, :, None] * (S + u[:, :, None] * kv)).sum(1)
        S = w[:, i, :, None] * S + kv
    return (out, S) if return_state else out


def rwkv6_bwd_ref(r, k, v, w, u, dout, ds=None, *, chunk: int = 64):
    """The gradients of ``rwkv6_ref``'s (out, final S) at r, k, v, w, u, from
    dout [BH, T, V] and the final state's gradient ``ds`` [BH, K, V] (None:
    zero). With G_t = ∂L/∂S_t (G_T = ds), walking t from T down to 1:

        dr_t = S_{t-1} do_t + (u ⊙ k_t)(v_t·do_t)
        dk_t = G_t v_t + (u ⊙ r_t)(v_t·do_t)
        dv_t = G_tᵀ k_t + (r_t·(u ⊙ k_t)) do_t
        dw_t = Σ_j G_t[:, j] ⊙ S_{t-1}[:, j]
        du   = Σ_t (r_t ⊙ k_t)(v_t·do_t)
        G_{t-1} = diag(w_t) G_t + r_t do_tᵀ

    S_{t-1} is recomputed forward from states kept every ``chunk`` steps (S
    is never run backwards: that would divide by w). Decays are clamped at
    ``W_MIN`` as the kernels clamp them; below it dw is 0, as the clamp's
    gradient is. Returns (dr, dk, dv, dw) in the inputs' dtypes and du
    float32 [BH, K]."""
    f32 = torch.float32
    dtypes = (r.dtype, k.dtype, v.dtype, w.dtype)
    r, k, v, w, u, do = (x.to(f32) for x in (r, k, v, w, u, dout))
    bh, t, kd = r.shape
    vd = v.shape[-1]
    weff = w.clamp_min(W_MIN)
    S = torch.zeros((bh, kd, vd), dtype=f32, device=r.device)
    starts = []
    for c0 in range(0, t, chunk):  # the state before each chunk
        starts.append(S)
        for i in range(c0, min(c0 + chunk, t)):
            S = weff[:, i, :, None] * S + k[:, i, :, None] * v[:, i, None, :]
    G = torch.zeros_like(S) if ds is None else ds.to(f32).clone()
    vdo = (v * do).sum(-1)                                          # [BH, T]
    ruk = (r * u[:, None] * k).sum(-1)                              # [BH, T]
    dr, dk, dw = (torch.empty((bh, t, kd), dtype=f32, device=r.device) for _ in range(3))
    dv = torch.empty((bh, t, vd), dtype=f32, device=r.device)
    for c, c0 in reversed(list(enumerate(range(0, t, chunk)))):
        S, prev = starts[c], []
        for i in range(c0, min(c0 + chunk, t)):
            prev.append(S)                                          # S_{i-1}
            S = weff[:, i, :, None] * S + k[:, i, :, None] * v[:, i, None, :]
        for i in reversed(range(c0, min(c0 + chunk, t))):
            sp = prev[i - c0]
            dr[:, i] = torch.einsum("bkv,bv->bk", sp, do[:, i]) + u * k[:, i] * vdo[:, i, None]
            dk[:, i] = torch.einsum("bkv,bv->bk", G, v[:, i]) + u * r[:, i] * vdo[:, i, None]
            dv[:, i] = torch.einsum("bkv,bk->bv", G, k[:, i]) + ruk[:, i, None] * do[:, i]
            dw[:, i] = (G * sp).sum(-1)
            G = weff[:, i, :, None] * G + r[:, i, :, None] * do[:, i, None, :]
    dw = torch.where(w >= W_MIN, dw, 0.0)
    du = (r * k * vdo[..., None]).sum(1)
    return (*(g.to(dt) for g, dt in zip((dr, dk, dv, dw), dtypes)), du)


def rwkv6_bwd_split_ref(r, k, v, w, u, dout, ds=None, *, chunk: int = BWD_CHUNK):
    """``rwkv6_bwd_ref``'s gradients by the backward kernel's arithmetic
    (``csrc/rwkv6_bwd.cu``), T split into chunks of ``chunk`` steps:

    1. the boundary states, a chunk at a time in matrix form: S at each
       chunk's start c0, ``S_{c1} = D S_{c0} + Σ_s (k_s ⊙ Π_{s<u<c1} w_u)
       v_sᵀ``, and G at each chunk's end c1, ``G_{c0} = D G_{c1} + Σ_s (r_s ⊙
       Π_{c0≤u<s} w_u) do_sᵀ`` from G_T = ds, with D = Π w over the chunk:
       every decay product anchored at the chunk's end or start, none above
       1, nothing divided by w;
    2. each chunk's gradients, walked step by step from its own S_{c0} and
       G_{c1} as ``rwkv6_bwd_ref`` walks them;
    3. du as each chunk's partial sum, then their sum over the chunks in
       order.

    Same signature and result as ``rwkv6_bwd_ref``."""
    f32 = torch.float32
    dtypes = (r.dtype, k.dtype, v.dtype, w.dtype)
    r, k, v, w, u, do = (x.to(f32) for x in (r, k, v, w, u, dout))
    bh, t, kd = r.shape
    vd = v.shape[-1]
    weff = w.clamp_min(W_MIN)
    bounds = [(c0, min(c0 + chunk, t)) for c0 in range(0, t, chunk)]
    one = torch.ones((bh, 1, kd), dtype=f32, device=r.device)
    S = torch.zeros((bh, kd, vd), dtype=f32, device=r.device)
    starts = []
    for c0, c1 in bounds:
        starts.append(S)
        wc = weff[:, c0:c1]
        suffix = torch.flip(torch.cumprod(torch.flip(wc, [1]), 1), [1])   # Π_{u≥s} w_u
        after = torch.cat([suffix[:, 1:], one], 1)                          # Π_{u>s} w_u
        S = suffix[:, 0, :, None] * S + torch.einsum("bsi,bsj->bij", k[:, c0:c1] * after,
                                                     v[:, c0:c1])
    G = torch.zeros_like(S) if ds is None else ds.to(f32).clone()
    ends = [G] * len(bounds)
    for c in reversed(range(len(bounds))):
        c0, c1 = bounds[c]
        ends[c] = G
        prefix = torch.cumprod(weff[:, c0:c1], 1)                           # Π_{u≤s} w_u
        before = torch.cat([one, prefix[:, :-1]], 1)                        # Π_{u<s} w_u
        G = prefix[:, -1, :, None] * G + torch.einsum("bsi,bsj->bij", r[:, c0:c1] * before,
                                                      do[:, c0:c1])
    vdo = (v * do).sum(-1)                                          # [BH, T]
    ruk = (r * u[:, None] * k).sum(-1)                              # [BH, T]
    dr, dk, dw = (torch.empty((bh, t, kd), dtype=f32, device=r.device) for _ in range(3))
    dv = torch.empty((bh, t, vd), dtype=f32, device=r.device)
    du = torch.zeros((bh, kd), dtype=f32, device=r.device)
    for (c0, c1), S, G in zip(bounds, starts, ends):
        prev = []
        for i in range(c0, c1):
            prev.append(S)                                          # S_i, the state before step i
            S = weff[:, i, :, None] * S + k[:, i, :, None] * v[:, i, None, :]
        for i in reversed(range(c0, c1)):
            sp = prev[i - c0]
            dr[:, i] = torch.einsum("bkv,bv->bk", sp, do[:, i]) + u * k[:, i] * vdo[:, i, None]
            dk[:, i] = torch.einsum("bkv,bv->bk", G, v[:, i]) + u * r[:, i] * vdo[:, i, None]
            dv[:, i] = torch.einsum("bkv,bk->bv", G, k[:, i]) + ruk[:, i, None] * do[:, i]
            dw[:, i] = (G * sp).sum(-1)
            G = weff[:, i, :, None] * G + r[:, i, :, None] * do[:, i, None, :]
        du = du + (r[:, c0:c1] * k[:, c0:c1] * vdo[:, c0:c1, None]).sum(1)
    dw = torch.where(w >= W_MIN, dw, 0.0)
    return (*(g.to(dt) for g, dt in zip((dr, dk, dv, dw), dtypes)), du)


CHUNK = 16     # steps a chunk (csrc: kChunk)
SUB = 4        # steps a sub-chunk: the anchors below A's diagonal blocks (csrc: kSub)
COLS = 32      # value columns a block (csrc: kCols)
W_MIN = 1e-12  # decays are clamped here (csrc: kWMin)


def _chunk(r, k, v, w, u, S):
    """One chunk [BH, C, ·] of the kernel's arithmetic from the state S
    [BH, K, cols] → (out [BH, C, cols], the state after the chunk)."""
    bh, c, _ = r.shape
    one = torch.ones_like(w[:, :1])
    rdec = r * torch.cat([one, torch.cumprod(w[:, :-1], 1)], 1)  # r_t ⊙ W_{0,t}

    def k_factor(a):  # k_j ⊙ W_{j+1,a} for j < a
        suffix = torch.flip(torch.cumprod(torch.flip(w[:, 1:a], [1]), 1), [1])
        return k[:, :a] * torch.cat([suffix, one], 1)

    a_mat = torch.zeros((bh, c, c), dtype=r.dtype, device=r.device)
    for a in range(0, c, SUB):
        rows = slice(a, a + SUB)
        if a > 0:  # below the diagonal block, anchored at the start a of t's sub-chunk
            rs = r[:, rows] * torch.cat([one, torch.cumprod(w[:, a : a + SUB - 1], 1)], 1)
            a_mat[:, rows, :a] = torch.einsum("bti,bji->btj", rs, k_factor(a))
        for j in range(a, a + SUB):  # the diagonal block, pairwise: kd = k_j ⊙ W_{j+1,t}
            a_mat[:, j, j] = (r[:, j] * (u * k[:, j])).sum(-1)
            kd = k[:, j]
            for t in range(j + 1, a + SUB):
                a_mat[:, t, j] = (r[:, t] * kd).sum(-1)
                kd = w[:, t] * kd
    out = torch.einsum("bti,biv->btv", rdec, S) + torch.einsum("btj,bjv->btv", a_mat, v)
    decay = torch.prod(w, 1)  # W_{0,C}
    return out, decay[:, :, None] * S + torch.einsum("bji,bjv->biv", k_factor(c), v)


def rwkv6_chunk_ref(r, k, v, w, u, *, return_state: bool = False):
    """The kernel's arithmetic in plain PyTorch, vectorised over BH: chunks
    of ``CHUNK`` steps (the last one padded), value columns in blocks of
    ``COLS``. Same signature and result as ``rwkv6_ref``."""
    f32 = torch.float32
    r, k, v, w, u = (x.to(f32) for x in (r, k, v, w, u))
    bh, t, kd = r.shape
    vd = v.shape[-1]
    pad = -t % CHUNK
    r, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (r, k, v))
    w = torch.nn.functional.pad(w.clamp_min(W_MIN), (0, 0, 0, pad), value=1.0)
    outs, states = [], []
    for c0 in range(0, vd, COLS):  # each block of value columns on its own
        S = torch.zeros((bh, kd, min(COLS, vd - c0)), dtype=f32, device=r.device)
        chunks = []
        for t0 in range(0, t + pad, CHUNK):
            step = slice(t0, t0 + CHUNK)
            o, S = _chunk(r[:, step], k[:, step], v[:, step, c0 : c0 + COLS], w[:, step], u, S)
            chunks.append(o)
        outs.append(torch.cat(chunks, 1)[:, :t])
        states.append(S)
    out = torch.cat(outs, -1)
    return (out, torch.cat(states, -1)) if return_state else out
