"""Model layers the ported paths need: dtypes, init, RMSNorm, the SwiGLU MLP.

The same arithmetic as the JAX package's ``models/layers.py``, in the same
dtypes: weights are ``x @ W`` matrices of shape [d_in, d_out], norms compute
in float32 and return the input's dtype. Parameters live in ``nn.Module``s
(never trained here: ``requires_grad=False``). RoPE and attention come with
the attention slice; the JAX package's sharding annotations are the identity
off a mesh and are dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn


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
