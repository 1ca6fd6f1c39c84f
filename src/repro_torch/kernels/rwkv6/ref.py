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
"""
from __future__ import annotations

import torch


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
