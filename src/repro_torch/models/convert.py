"""Carry the JAX package's parameters across to the port.

``from_jax_params`` takes the tree that the JAX package's
``transformer.init_params`` returns, with every leaf turned into a numpy
array (``np.asarray``), and fills an :class:`LM` with it. The JAX tree keeps
the layers of each pattern position stacked (``blocks[pos]`` leaves are
``[n_groups, ...]``); layer ``g * period + pos`` of the port takes slice
``g``. This module imports neither JAX nor the JAX package: it reads plain
numpy arrays.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import LM, ModelConfig


def to_tensor(a: Any, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy (or array-like) → tensor of ``dtype``. A bfloat16 numpy array
    (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects) goes through
    float32, which holds every bfloat16 value exactly."""
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    a = np.array(a, dtype=np.float32 if bf16 else a.dtype, order="C")  # a writable copy
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _copy(dst: torch.Tensor, src: Any, where: str) -> None:
    t = to_tensor(src, dst.dtype, dst.device)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: JAX shape {tuple(t.shape)} != port shape {tuple(dst.shape)}")
    dst.copy_(t)


def _copy_tree(module: torch.nn.Module, tree: Mapping, group: int, where: str) -> None:
    """Each leaf of ``tree`` into the attribute of ``module`` of its name
    (the MoE layer's ``router``, ``w_gate``, ``w_up`` and ``w_down`` too);
    a leaf the port has no place for, or of another shape, raises naming it."""
    for name, leaf in tree.items():
        if not hasattr(module, name):
            raise ValueError(f"{where}.{name}: no such parameter in the port's "
                             f"{type(module).__name__}")
        if isinstance(leaf, Mapping):
            _copy_tree(getattr(module, name), leaf, group, f"{where}.{name}")
        else:
            _copy(getattr(module, name), np.asarray(leaf)[group], f"{where}.{name}")


def from_jax_params(cfg: ModelConfig, tree: Mapping, *, device=None) -> LM:
    """The JAX parameter tree (numpy leaves) → an :class:`LM` on ``device``."""
    lm = LM(cfg, resolve_device(device))
    if len(tree["blocks"]) != cfg.period:
        raise ValueError(f"{len(tree['blocks'])} pattern positions, config has {cfg.period}")
    with torch.no_grad():
        _copy(lm.embed, tree["embed"], "embed")
        _copy(lm.final_norm, tree["final_norm"], "final_norm")
        if not cfg.tie_embeddings:
            _copy(lm.lm_head, tree["lm_head"], "lm_head")
        for layer, blk in enumerate(lm.blocks):
            g, pos = divmod(layer, cfg.period)
            _copy_tree(blk, tree["blocks"][pos], g, f"blocks[{pos}][{g}]")
    return lm
