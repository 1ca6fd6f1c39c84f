"""AdamW from scratch, with configurable optimizer-state dtype: the JAX
package's ``train/optimizer.py`` on lists of tensors.

State dtype matters at scale: fp32 (m, v) for a 480B-param model is 3.8 TB,
so arctic-class models run with bf16 state (quantise-on-write, fp32 math).

The update runs in place under ``torch.no_grad()``, leaf by leaf, with the
math in float32 and the step's ``lr``, ``corr1`` and ``corr2`` computed in
float32 as the reference computes them. Weight decay follows the reference's
rule ``p.ndim >= 2`` on the *JAX* leaf: the reference stacks each pattern
position's layers (``[n_groups, ...]``), so every per-layer vector (norm
gains, biases, RWKV's ``u`` and ``mix_*``, Mamba's vectors) is decayed there
and only the top-level vectors (``final_norm``, ``enc_norm``) are not. The
port's layers are unstacked: :func:`decay_flags` gives the reference's
decision for each parameter of an ``LM``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.models.convert import jax_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"      # "float32" | "bfloat16"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def init_state(cfg: AdamWConfig, params: Sequence[torch.Tensor]) -> Dict:
    """{"m": [...], "v": [...] (zeros of each parameter's shape in the state
    dtype, on its device), "step": int32 scalar 0}."""
    dt = _state_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": [zeros(p) for p in params], "v": [zeros(p) for p in params],
            "step": torch.zeros((), dtype=torch.int32)}


def decay_flags(cfg_model, lm) -> List[bool]:
    """For each parameter of ``lm`` (``lm.parameters()`` order): whether the
    reference decays its JAX leaf, whose rank is the parameter's plus one
    where the leaf stacks layers."""
    stacked = {id(t) for leaf in jax_leaves(cfg_model, lm).values() if isinstance(leaf, list)
               for t in leaf}
    return [p.ndim + (id(p) in stacked) >= 2 for p in lm.parameters()]


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup then cosine decay, in float32 (``step`` a float32 scalar)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), f32(1.0))
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(f32(math.pi) * prog))
    return cfg.learning_rate * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32 (a scalar on
    the tensors' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32))) for t in tensors))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Sequence[torch.Tensor], state: Dict,
                  grads: Sequence[torch.Tensor],
                  decay: Optional[Sequence[bool]] = None) -> Dict[str, torch.Tensor]:
    """One AdamW step, in place: ``params``, ``state["m"]``, ``state["v"]``
    and ``state["step"]`` are updated. ``decay[i]``: whether parameter i
    takes weight decay (default ``p.ndim >= 2``; an LM's from
    :func:`decay_flags`). Returns {"lr", "grad_norm"} float32 scalars."""
    if decay is None:
        decay = [p.ndim >= 2 for p in params]
    step = state["step"] + 1
    stepf = step.to(torch.float32)
    lr = _schedule(cfg, stepf)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    corr1 = 1 - torch.tensor(b1, dtype=torch.float32) ** stepf
    corr2 = 1 - torch.tensor(b2, dtype=torch.float32) ** stepf
    dev = gnorm.device  # the scalars, once on the parameters' device
    lr_d, corr1, corr2 = lr.to(dev), corr1.to(dev), corr2.to(dev)
    for p, m, v, g, wd in zip(params, state["m"], state["v"], grads, decay):
        gf = g.to(torch.float32) * scale
        mf = b1 * m.to(torch.float32) + (1 - b1) * gf
        vf = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        delta = (mf / corr1) / (torch.sqrt(vf / corr2) + cfg.eps)
        if wd:  # decoupled weight decay on the reference's matrices
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr_d * delta)
        m.copy_(mf)
        v.copy_(vf)
    state["step"] = step
    return {"lr": lr, "grad_norm": gnorm}
