"""Plain PyTorch version of Mamba's selective scan.

Per batch row b, channel d and state n, at each step t:

    h_t[n] = exp(dt_t[d] · a[d, n]) · h_{t-1}[n] + dt_t[d] · x_t[d] · B_t[n]
    y_t[d] = Σ_n h_t[n] · C_t[n],        h_0 = h0[b, d, :]

Shapes: dt float32 [B, T, Di] (after the softplus), x [B, T, Di], a float32
[Di, N], bmat and cmat [B, T, N], h0 float32 [B, Di, N] → y float32
[B, T, Di] (without the ``d_skip`` term) and the final h float32
[B, Di, N]. ``decay`` and ``bx`` are formed as the JAX package's
``mamba_block`` forms them (``src/repro/models/ssm.py``, l. 101-107), and the
steps walk time as its ``_ssm_scan_chunked`` does: grouping the steps into
chunks changes no value, so one loop over the steps is that function. The
CUDA kernel (``csrc/ssm_scan.cu``) is held against this function, and the
model's CPU path runs it.
"""
from __future__ import annotations

import torch


def ssm_scan_ref(dt, x, a, bmat, cmat, h0):
    f32 = torch.float32
    decay = torch.exp(dt[..., None] * a)                                    # [B, T, Di, N]
    bx = (dt * x.to(f32))[..., None] * bmat.to(f32)[:, :, None, :]          # [B, T, Di, N]
    c = cmat.to(f32)
    h = h0
    ys = []
    for t in range(dt.shape[1]):
        h = decay[:, t] * h + bx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h
