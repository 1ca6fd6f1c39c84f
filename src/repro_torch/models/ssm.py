"""The RWKV6 (Finch) token mixer: parameters, init and the block, with its
three branches (no state, prefill with state, one-token decode).

Mamba comes with the hybrid slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.models.layers import dense_init, empty_param, rmsnorm

RWKV_LORA = 64


class RWKV6(nn.Module):
    """Parameters of one RWKV6 mixer, named and shaped as in the JAX package:
    token-shift mixes ``mix_*`` [d] f32, projections ``wr, wk, wv, wg, wo``
    [d, d], the decay's base ``w0`` [d] f32 and LoRA ``w_a`` [d, lora],
    ``w_b`` [lora, d], the bonus ``u`` [heads, hd] f32, ``ln_out`` [d] f32."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype,
                 lora: int = RWKV_LORA, device=None):
        super().__init__()
        f32 = torch.float32
        d, hd = d_model, d_model // num_heads
        for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g"):
            setattr(self, name, empty_param((d,), f32, device))
        for name in ("wr", "wk", "wv", "wg"):
            setattr(self, name, empty_param((d, d), dtype, device))
        self.w0 = empty_param((d,), f32, device)
        self.w_a = empty_param((d, lora), dtype, device)
        self.w_b = empty_param((lora, d), dtype, device)
        self.u = empty_param((num_heads, hd), f32, device)
        self.ln_out = empty_param((d,), f32, device)
        self.wo = empty_param((d, d), dtype, device)


def rwkv6_init(gen: torch.Generator, d_model: int, num_heads: int,
               dtype: torch.dtype = torch.bfloat16, lora: int = RWKV_LORA) -> RWKV6:
    m = RWKV6(d_model, num_heads, dtype, lora, gen.device)
    d, hd = d_model, d_model // num_heads
    for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g"):
        getattr(m, name).fill_(0.5)
    for name in ("wr", "wk", "wv", "wg"):
        getattr(m, name).copy_(dense_init(gen, (d, d), dtype))
    m.w0.fill_(-2.0)
    m.w_a.copy_(dense_init(gen, (d, lora), dtype, scale=0.01))
    m.w_b.copy_(dense_init(gen, (lora, d), dtype, scale=0.01))
    m.u.copy_(dense_init(gen, (num_heads, hd), torch.float32, scale=0.3))
    m.ln_out.fill_(1.0)
    m.wo.copy_(dense_init(gen, (d, d), dtype))
    return m


def rwkv6_block(p: RWKV6, x: torch.Tensor, num_heads: int,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, chunk: int = 64):
    """x [B, S, d] → (y [B, S, d], (x_prev [B, d], S [B, H, hd, hd] or None)).

    ``state`` = (x_prev, S) selects the branch: None → the whole sequence from
    a zero state (the kernel, no state out); S == 1 → one decode step from
    the carried state; otherwise prefill, which starts from a zero S (as the
    JAX package does) and returns the final one."""
    b, s, d = x.shape
    hd = d // num_heads
    x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device) if state is None else state[0]
    xs = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)  # token shift

    def mix(mu):
        return x + mu.to(x.dtype) * (xs - x)

    r = mix(p.mix_r) @ p.wr
    k = mix(p.mix_k) @ p.wk
    v = mix(p.mix_v) @ p.wv
    g = mix(p.mix_g) @ p.wg
    xw = mix(p.mix_w)
    # Data-dependent decay: per-channel LoRA, clamped as in the JAX package.
    logdecay = p.w0 + (torch.tanh(xw @ p.w_a) @ p.w_b).to(torch.float32)
    # Rounded to the activation dtype before the mixer, as the JAX package does.
    w = torch.exp(-torch.exp(torch.clamp(logdecay, -8.0, 1.2))).to(x.dtype)

    def heads(t):  # [B, S, d] -> [B*H, S, hd]
        return t.reshape(b, s, num_heads, hd).transpose(1, 2).reshape(b * num_heads, s, hd)

    u = p.u[None].expand(b, num_heads, hd).reshape(b * num_heads, hd)
    if s == 1 and state is not None:
        s_in = state[1].reshape(b * num_heads, hd, hd)
        s_out, o = rwkv_ops.rwkv6_decode_step(
            s_in, heads(r)[:, 0], heads(k)[:, 0], heads(v)[:, 0], heads(w)[:, 0], u)
        o = o[:, None]
        new_s = s_out.reshape(b, num_heads, hd, hd)
    elif state is not None:
        ck = chunk if s % chunk == 0 else 1  # the CPU path's chunk; the kernel takes any S
        o, s_fin = rwkv_ops.rwkv6(heads(r), heads(k), heads(v), heads(w), u,
                                  chunk=ck, return_state=True)
        new_s = s_fin.reshape(b, num_heads, hd, hd)
    else:
        o = rwkv_ops.rwkv6(heads(r), heads(k), heads(v), heads(w), u, chunk=chunk)
        new_s = None
    o = o.reshape(b, num_heads, s, hd).transpose(1, 2).reshape(b, s, d)
    # per-head group norm: RMSNorm over hd with a zero gamma
    o = rmsnorm(o.reshape(b, s, num_heads, hd),
                torch.zeros((hd,), dtype=torch.float32, device=x.device)).reshape(b, s, d)
    o = (o.to(x.dtype) * torch.nn.functional.silu(g)) * p.ln_out.to(x.dtype)
    return o @ p.wo, (x[:, -1], new_s)
