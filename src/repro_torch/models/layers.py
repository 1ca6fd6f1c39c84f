"""Model layers the ported paths need: dtypes, init, RMSNorm, RoPE, GQA
attention with its KV cache, the SwiGLU MLP.

The same arithmetic as the JAX package's ``models/layers.py``, in the same
dtypes: weights are ``x @ W`` matrices of shape [d_in, d_out], norms and
RoPE compute in float32 and return the input's dtype. Parameters live in
``nn.Module``s, made with ``requires_grad=False``; the trainer
(``train/train_step.py``) switches them on. The JAX
package's sharding annotations are the identity off a mesh and are dropped.
Attention runs the flash attention kernel (``kernels/flash_attention``) on
the card, a local layer's sliding window (``AttnSpec.window``) inside it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as attn_ops


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    rope_fraction: float = 1.0
    window: Optional[int] = None        # local (sliding-window) attention
    attn_softcap: Optional[float] = None
    bias: bool = False
    causal: bool = True


def empty_param(shape, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    """Normal(0, 1) * scale (default fan_in ** -0.5) drawn in float32 on the
    generator's device, then cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    nrm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (nrm * (1.0 + gamma.to(torch.float32))).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard, partial-dim for chatglm's 2d variant)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0, device=None):
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x [..., S, H, Dh]; positions [..., S] (broadcastable). Rotates the
    interleaved pairs (x[..., 0::2], x[..., 1::2]) of the first ``rot``
    dimensions, in float32, and casts back."""
    dh = x.shape[-1]
    inv, rot = rope_freqs(dh, theta, fraction, x.device)
    ang = positions[..., :, None].to(torch.float32) * inv   # [..., S, rot/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot].to(torch.float32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).flatten(-2)
    if rot == dh:
        return rotated.to(x.dtype)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """wq [d, H·hd], wk, wv [d, KV·hd], wo [H·hd, d], and the biases bq, bk,
    bv when ``spec.bias``."""

    def __init__(self, d_model: int, spec: AttnSpec, dtype: torch.dtype, device=None):
        super().__init__()
        h, kv, dh = spec.num_heads, spec.num_kv_heads, spec.head_dim
        self.wq = empty_param((d_model, h * dh), dtype, device)
        self.wk = empty_param((d_model, kv * dh), dtype, device)
        self.wv = empty_param((d_model, kv * dh), dtype, device)
        self.wo = empty_param((h * dh, d_model), dtype, device)
        if spec.bias:
            self.bq = empty_param((h * dh,), dtype, device)
            self.bk = empty_param((kv * dh,), dtype, device)
            self.bv = empty_param((kv * dh,), dtype, device)


def attn_init(gen: torch.Generator, d_model: int, spec: AttnSpec, dtype: torch.dtype) -> Attention:
    a = Attention(d_model, spec, dtype, gen.device)
    h, kv, dh = spec.num_heads, spec.num_kv_heads, spec.head_dim
    for name, shape in (("wq", (d_model, h * dh)), ("wk", (d_model, kv * dh)),
                        ("wv", (d_model, kv * dh)), ("wo", (h * dh, d_model))):
        getattr(a, name).copy_(dense_init(gen, shape, dtype))
    if spec.bias:
        for name in ("bq", "bk", "bv"):
            getattr(a, name).zero_()
    return a


def _qkv(p: Attention, x: torch.Tensor, spec: AttnSpec):
    b, s, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if spec.bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.view(b, s, spec.num_heads, spec.head_dim),
            k.view(b, s, spec.num_kv_heads, spec.head_dim),
            v.view(b, s, spec.num_kv_heads, spec.head_dim))


def attention_block(p: Attention, x: torch.Tensor, spec: AttnSpec, positions: torch.Tensor,
                    cache: Optional[dict] = None, chunk: int = 512):
    """x [B, S, d] → (out [B, S, d], new_cache or None).

    ``cache`` = {"k", "v": [B, max_len, KV, hd], "len": int}: the S new keys
    and values are written in place at ``len``, and attention reads the valid
    prefix ``[:len + S]``. Causality comes from the kernel's diagonal offset
    (query i is key position ``len + i``), which equals the JAX package's
    position mask because the caller's ``positions`` are ``len + arange(S)``
    (``transformer.decode_step`` checks it); so does the sliding window of a
    local layer (``spec.window``), which the kernel applies on the same
    diagonal. Unlike ``jax.lax.
    dynamic_update_slice``, which clamps the write start to ``max_len − S``, a
    write past ``max_len`` raises."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, spec)
    q = apply_rope(q, positions, spec.rope_theta, spec.rope_fraction)
    k = apply_rope(k, positions, spec.rope_theta, spec.rope_fraction)
    new_cache = None
    if cache is not None:
        kc, vc, insert = cache["k"], cache["v"], int(cache["len"])
        if insert + s > kc.shape[1]:
            raise ValueError(f"KV cache overflow: {insert} cached + {s} new tokens > "
                             f"max_len {kc.shape[1]}")
        kc[:, insert : insert + s] = k
        vc[:, insert : insert + s] = v
        k, v = kc[:, : insert + s], vc[:, : insert + s]
        new_cache = {"k": kc, "v": vc, "len": insert + s}
    # [B, S, H, hd] → [B, H, S, hd] views; the kernel reads them through strides.
    out = attn_ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=spec.causal, softcap=spec.attn_softcap, chunk=chunk,
                             window=spec.window)
    out = out.transpose(1, 2).reshape(b, s, spec.num_heads * spec.head_dim)
    return out @ p.wo, new_cache


class MLP(nn.Module):
    """Gated MLP (SwiGLU): w_gate, w_up [d_model, d_ff], w_down [d_ff, d_model]."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.w_gate = empty_param((d_model, d_ff), dtype, device)
        self.w_up = empty_param((d_model, d_ff), dtype, device)
        self.w_down = empty_param((d_ff, d_model), dtype, device)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> MLP:
    m = MLP(d_model, d_ff, dtype, gen.device)
    for name, shape in (("w_gate", (d_model, d_ff)), ("w_up", (d_model, d_ff)),
                        ("w_down", (d_ff, d_model))):
        getattr(m, name).copy_(dense_init(gen, shape, dtype))
    return m


def mlp_block(p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down
