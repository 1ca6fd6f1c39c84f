"""The attention-free token mixers: Mamba (jamba's 7 of 8 layers) and RWKV6
(Finch), each with its parameters, init and block.

Mamba's block takes no state (the whole sequence from a zero state) or its
decode state (conv tail, h), and returns the new one either way; its scan
runs in ``kernels.ssm_scan``. RWKV6's block has three branches (no state,
prefill with state, one-token decode).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models.layers import dense_init, empty_param, rmsnorm

RWKV_LORA = 64
MAMBA_CHUNK = 128  # the JAX package's scan chunk, which sets the length contract


# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------

class Mamba(nn.Module):
    """Parameters of one Mamba mixer, named and shaped as in the JAX package,
    with ``di = expand * d_model`` and ``dt_rank = max(1, d_model // 16)``:
    ``in_proj`` [d, 2 di], the depthwise conv ``conv_w`` [K, di] and
    ``conv_b`` [di], ``x_proj`` [di, dt_rank + 2 N], ``dt_proj`` [dt_rank,
    di], ``dt_bias`` [di] f32, ``a_log`` [di, N] f32, ``d_skip`` [di] f32,
    ``out_proj`` [di, d]."""

    def __init__(self, d_model: int, dtype: torch.dtype, *, expand: int = 2, state: int = 16,
                 conv_dim: int = 4, device=None):
        super().__init__()
        f32 = torch.float32
        di, rank = expand * d_model, max(1, d_model // 16)
        self.in_proj = empty_param((d_model, 2 * di), dtype, device)
        self.conv_w = empty_param((conv_dim, di), dtype, device)
        self.conv_b = empty_param((di,), dtype, device)
        self.x_proj = empty_param((di, rank + 2 * state), dtype, device)
        self.dt_proj = empty_param((rank, di), dtype, device)
        self.dt_bias = empty_param((di,), f32, device)
        self.a_log = empty_param((di, state), f32, device)
        self.d_skip = empty_param((di,), f32, device)
        self.out_proj = empty_param((di, d_model), dtype, device)


def mamba_init(gen: torch.Generator, d_model: int, *, expand: int = 2, state: int = 16,
               conv_dim: int = 4, dtype: torch.dtype = torch.bfloat16) -> Mamba:
    """The JAX package's scales: fan-in for the projections, 0.5 for the conv,
    zero biases, ``a_log = log(1..N)`` on every channel, ``d_skip = 1``."""
    m = Mamba(d_model, dtype, expand=expand, state=state, conv_dim=conv_dim, device=gen.device)
    di, rank = expand * d_model, max(1, d_model // 16)
    m.in_proj.copy_(dense_init(gen, (d_model, 2 * di), dtype))
    m.conv_w.copy_(dense_init(gen, (conv_dim, di), dtype, scale=0.5))
    m.conv_b.zero_()
    m.x_proj.copy_(dense_init(gen, (di, rank + 2 * state), dtype))
    m.dt_proj.copy_(dense_init(gen, (rank, di), dtype))
    m.dt_bias.zero_()
    m.a_log.copy_(torch.log(torch.arange(1, state + 1, dtype=torch.float32,
                                         device=gen.device)).expand(di, state))
    m.d_skip.fill_(1.0)
    m.out_proj.copy_(dense_init(gen, (di, d_model), dtype))
    return m


def _causal_conv(x, w, b, tail=None):
    """x [B, S, Di], w [K, Di]: the depthwise causal conv, its K products
    summed in the JAX package's order. ``tail`` [B, K-1, Di] carries the
    decode state (zeros if None) → (y, new tail): the last K-1 rows of
    tail ++ x, so that for S < K-1 some of them come from the old tail."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)
    y = sum(xp[:, i : i + x.shape[1]] * w[i] for i in range(k))
    new_tail = xp[:, -(k - 1):] if k > 1 else tail
    return y + b, new_tail


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    with no switch to x above a threshold, as torch's softplus has."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _silu(x):
    """``jax.nn.silu``: x * logistic(x), the logistic as 1 / (1 + exp(-x)),
    each step rounded to x's dtype, as XLA computes it (in bfloat16 it
    differs from torch's silu, which rounds once, by a unit in the last
    place at about a third of the inputs)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def mamba_block(p: Mamba, x: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                chunk: int = MAMBA_CHUNK):
    """x [B, S, d] → (y [B, S, d], (conv tail [B, K-1, Di], h [B, Di, N] f32)).

    ``state`` = (conv tail, h) continues a sequence (None: from zeros). The
    JAX package scans S > 1 tokens in chunks of ``min(chunk, S)`` and asserts
    that they divide S; the port keeps that contract and raises
    ``ValueError`` on such an S (e.g. 200), though its kernel needs none."""
    b, s, _ = x.shape
    if s > 1 and s % min(chunk, s):
        raise ValueError(f"mamba_block: a sequence of {s} tokens is not a multiple of the "
                         f"scan chunk {min(chunk, s)} (the JAX package rejects it too)")
    d_inner = p.in_proj.shape[1] // 2
    nstate = p.a_log.shape[1]
    f32 = torch.float32
    x1, z = torch.split(x @ p.in_proj, d_inner, dim=-1)
    x1, new_tail = _causal_conv(x1, p.conv_w, p.conv_b, None if state is None else state[0])
    x1 = _silu(x1)

    proj = x1 @ p.x_proj
    rank = p.dt_proj.shape[0]
    dt, bmat, cmat = torch.split(proj, [rank, nstate, nstate], dim=-1)  # views
    dt = _softplus((dt @ p.dt_proj).to(f32) + p.dt_bias)                 # [B, S, Di]
    a = -torch.exp(p.a_log)                                              # [Di, N]
    h0 = torch.zeros((b, d_inner, nstate), dtype=f32, device=x.device) if state is None \
        else state[1]
    y, new_h = scan_ops.ssm_scan(dt, x1, a, bmat, cmat, h0)
    y = y + p.d_skip * x1.to(f32)
    y = y.to(x.dtype) * _silu(z)
    return y @ p.out_proj, (new_tail, new_h)


def mamba_state_shape(cfg_d_model: int, batch: int, *, expand=2, state=16, conv_dim=4):
    """((conv tail), (h)) shapes of one layer's decode state."""
    d_inner = expand * cfg_d_model
    return (
        (batch, conv_dim - 1, d_inner),   # conv tail
        (batch, d_inner, state),          # h
    )


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


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
