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
    h = h0
    ys = []
    # unbind, not indexing: its gradient is one stack, where T indexings'
    # would each fill a [B, T, Di, N] tensor of zeros (minutes at jamba's
    # full width on the card).
    for dec, b_x, c in zip(decay.unbind(1), bx.unbind(1), cmat.to(f32).unbind(1)):
        h = dec * h + b_x
        ys.append(torch.einsum("bdn,bn->bd", h, c))
    return torch.stack(ys, dim=1), h


def ssm_scan_bwd_ref(dt, x, a, bmat, cmat, h0, dy, dh_t):
    """The gradients of ``ssm_scan_ref``'s (y, h_T) at (dt, x, a, bmat, cmat,
    h0) from dy float32 [B, T, Di] and dh_t float32 [B, Di, N]. With decay_t
    = exp(dt_t a) and g_t = ∂L/∂h_t = dy_t C_t + decay_{t+1} ⊙ g_{t+1} (the
    carry into the last step is dh_t):

        dC_t[n]  = Σ_d dy_t[d] h_t[d, n]
        dB_t[n]  = Σ_d g_t[d, n] dt_t[d] x_t[d]
        dx_t[d]  = dt_t[d] Σ_n g_t[d, n] B_t[n]
        ddt_t[d] = Σ_n g_t[d, n] (a[d, n] decay_t[d, n] h_{t-1}[d, n] + x_t[d] B_t[n])
        da[d, n] = Σ_{b, t} g_t[d, n] dt_t[d] decay_t[d, n] h_{t-1}[d, n]
        dh0      = decay_1 ⊙ g_1

    Every h_t is kept from a forward walk (h is never run backwards: that
    would divide by decays that underflow to 0). Returns (ddt, dx, da, dB,
    dC, dh0), each in its input's dtype and shape (dB, dC contiguous)."""
    f32 = torch.float32
    xf, bf, cf = x.to(f32), bmat.to(f32), cmat.to(f32)
    dtx = dt * xf                                                           # [B, T, Di]
    hs, h = [h0.to(f32)], h0.to(f32)
    for t in range(dt.shape[1]):
        h = torch.exp(dt[:, t, :, None] * a) * h + dtx[:, t, :, None] * bf[:, t, None, :]
        hs.append(h)
    # The products and sums are grouped as autograd of ssm_scan_ref groups
    # them, so that on the CPU this gives its bits: p = g h_{t-1} decay is
    # the gradient of dt a, g B that of dt x, dC is the product's bmm, and da
    # one sum over (b, t) of p dt (kept as [B, T, Di, N]).
    g = dh_t.to(f32).clone()
    decay_next = torch.ones_like(g)
    ddt, dx = torch.empty_like(dtx), torch.empty_like(dtx)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    pdt = torch.empty((*dt.shape, a.shape[-1]), dtype=f32, device=dt.device)
    for t in reversed(range(dt.shape[1])):
        decay = torch.exp(dt[:, t, :, None] * a)                            # [B, Di, N]
        g = dy[:, t, :, None] * cf[:, t, None, :] + decay_next * g
        p = g * hs[t] * decay                                               # ∂L/∂(dt a)
        gb = (g * bf[:, t, None, :]).sum(-1)                                # ∂L/∂(dt x)
        dc[:, t] = torch.bmm(hs[t + 1].transpose(1, 2), dy[:, t, :, None])[..., 0]
        db[:, t] = (g * dtx[:, t, :, None]).sum(1)
        dx[:, t] = gb * dt[:, t]
        ddt[:, t] = (p * a).sum(-1) + gb * xf[:, t]
        pdt[:, t] = p * dt[:, t, :, None]
        decay_next = decay
    return (ddt.to(dt.dtype), dx.to(x.dtype), pdt.sum((0, 1)).to(a.dtype), db.to(bmat.dtype),
            dc.to(cmat.dtype), (decay_next * g).to(h0.dtype))
