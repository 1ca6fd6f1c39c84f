"""Carry the JAX package's parameters across to the port.

``from_jax_params`` takes the tree that the JAX package's
``transformer.init_params`` returns, with every leaf turned into a numpy
array (``np.asarray``), and fills an :class:`LM` with it. The JAX tree keeps
the layers of each pattern position stacked (``blocks[pos]`` leaves are
``[n_groups, ...]``); layer ``g * period + pos`` of the port takes slice
``g``. An encoder–decoder's ``encoder`` leaves are stacked ``[encoder_layers,
...]`` and its ``cross`` leaves ``[num_layers, ...]``: encoder layer i and
the cross-attention of decoder layer l take slices i and l. This module imports neither JAX nor the JAX package: it reads plain
numpy arrays.

``to_jax_params`` is the inverse: an :class:`LM` → the JAX tree of numpy
arrays, the layers of each pattern position stacked again (bfloat16
parameters come as float32 arrays, which hold them exactly: numpy has no
bfloat16). ``jax_leaves`` names every leaf of that tree by its path (the
checkpoint's keys, ``blocks/0/attn/wq``) with the port tensors it is made
of: the training checkpoint and the optimizer's weight-decay rule (by the
rank of the JAX leaf, stacked or not) are written on it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Union

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
        if cfg.encoder_layers:
            _copy(lm.enc_norm, tree["enc_norm"], "enc_norm")
            for name in ("encoder", "cross"):
                for i, module in enumerate(getattr(lm, name)):
                    _copy_tree(module, tree[name], i, f"{name}[{i}]")
    return lm


STACKED = ("blocks", "encoder", "cross")  # the JAX tree's stacked subtrees


def jax_leaves(cfg: ModelConfig, lm: LM) -> Dict[str, Union[torch.Tensor, List[torch.Tensor]]]:
    """Every leaf of the JAX parameter tree by its path (keys joined by
    ``/``, tuple positions as numbers): a top-level leaf's port tensor, or a
    stacked leaf's list of port tensors in stacking order (group g of
    pattern position p is layer ``g * period + p``; encoder layer i; the
    cross-attention of decoder layer l)."""
    out: Dict[str, Union[torch.Tensor, List[torch.Tensor]]] = {"embed": lm.embed,
                                                               "final_norm": lm.final_norm}
    if not cfg.tie_embeddings:
        out["lm_head"] = lm.lm_head

    def stack(prefix: str, modules) -> None:
        for module in modules:
            for name, t in module.named_parameters():
                out.setdefault(f"{prefix}/{name.replace('.', '/')}", []).append(t)

    for pos in range(cfg.period):
        stack(f"blocks/{pos}", lm.blocks[pos::cfg.period])
    if cfg.encoder_layers:
        out["enc_norm"] = lm.enc_norm
        stack("encoder", lm.encoder)
        stack("cross", lm.cross)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def to_jax_params(cfg: ModelConfig, lm: LM) -> Dict[str, Any]:
    """An :class:`LM` → the JAX package's parameter tree (nested dicts, a
    tuple of pattern positions under ``blocks``) of numpy arrays, bfloat16
    parameters as float32."""
    tree: Dict[str, Any] = {}
    for path, leaf in jax_leaves(cfg, lm).items():
        arr = np.stack([_numpy(t) for t in leaf]) if isinstance(leaf, list) else _numpy(leaf)
        *parents, last = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = arr
    tree["blocks"] = tuple(tree["blocks"][str(pos)] for pos in range(cfg.period))
    return tree
