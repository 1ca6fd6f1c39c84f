"""Fault-tolerant checkpointing: atomic, digest-verified, async, in the JAX
package's on-disk format (``train/checkpoint.py``), so checkpoints
interchange both ways.

Layout:  <dir>/step_<N>/
            manifest.json    {step, digest, keys, dtypes, extra}
            arrays.npz       one entry per leaf (flattened path key)

The keys are the reference's, in the JAX layout (``convert.jax_leaves``):
``params/<path>`` with each pattern position's layers stacked per group
(``params/blocks/0/attn/wq`` is [n_groups, d, H·hd]), ``opt/m/<path>``,
``opt/v/<path>`` and ``opt/step``. numpy's npz cannot hold bfloat16, so a
bfloat16 array is stored as its bits in ``uint16`` with ``"bfloat16"`` in the
manifest: encoded through ``tensor.view(torch.int16)``, which needs no
bfloat16 type in numpy. The digest is the reference's: sha256 over each
encoded array's first MiB, keys in sorted order.

Writes go to ``step_<N>.tmp`` and are atomically renamed: a crash mid-write
never corrupts the latest checkpoint. ``latest_step`` skips entries whose
digest fails, so restart survives partially-written or corrupted
directories. ``save_async`` copies to the host on the caller and writes on a
daemon thread, off the training critical path.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import jax_leaves
from repro_torch.models.transformer import LM, ModelConfig


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor in numpy on the host (never a view: the caller goes
    on training while a thread writes it), a bfloat16 one as its uint16 bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(cfg: ModelConfig, lm: LM, opt_state: Dict) -> Dict[str, torch.Tensor]:
    """Every array of a checkpoint by its key, as tensors (stacked leaves
    stacked, on the model's device)."""
    index = {id(p): i for i, p in enumerate(lm.parameters())}
    out: Dict[str, torch.Tensor] = {}
    stack = lambda leaf, pick: torch.stack([pick(t) for t in leaf]) if isinstance(leaf, list) \
        else pick(leaf)
    for path, leaf in jax_leaves(cfg, lm).items():
        out[f"params/{path}"] = stack(leaf, lambda t: t.detach())
        for name in ("m", "v"):
            out[f"opt/{name}/{path}"] = stack(leaf, lambda t: opt_state[name][index[id(t)]])
    out["opt/step"] = torch.as_tensor(opt_state["step"], dtype=torch.int32)
    return out


def _encode(arrays: Dict[str, torch.Tensor]) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    enc, dtypes = {}, {}
    for k, t in arrays.items():
        dtypes[k] = "bfloat16" if t.dtype == torch.bfloat16 else str(
            torch.empty((), dtype=t.dtype).numpy().dtype)
        enc[k] = _host(t)
    return enc, dtypes


def _digest(arrays: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes()[: 1 << 20])
    return h.hexdigest()


def _write(ckpt_dir: str, step: int, enc: Dict[str, np.ndarray], dtypes: Dict[str, str],
           extra: Optional[Dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **enc)
    manifest = {
        "step": step,
        "digest": _digest(enc),
        "keys": sorted(enc.keys()),
        "dtypes": dtypes,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, cfg: ModelConfig, lm: LM, opt_state: Dict,
         extra: Optional[Dict] = None) -> str:
    """Write checkpoint ``step`` of the model and its AdamW state (``m``,
    ``v``, ``step``; ``train.optimizer.init_state``'s layout)."""
    enc, dtypes = _encode(_flatten(cfg, lm, opt_state))
    return _write(ckpt_dir, step, enc, dtypes, extra)


_pending: Dict[str, threading.Thread] = {}


def save_async(ckpt_dir: str, step: int, cfg: ModelConfig, lm: LM, opt_state: Dict,
               extra: Optional[Dict] = None) -> threading.Thread:
    """``save`` with the device→host copy on the caller and the write on a
    daemon thread; ``wait_pending`` joins it."""
    enc, dtypes = _encode(_flatten(cfg, lm, opt_state))
    th = threading.Thread(target=_write, args=(ckpt_dir, step, enc, dtypes, extra), daemon=True)
    th.start()
    _pending[ckpt_dir] = th
    return th


def wait_pending(ckpt_dir: str):
    th = _pending.get(ckpt_dir)
    if th is not None:
        th.join()


def _verify(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        if sorted(arrays.keys()) != manifest["keys"]:
            return False
        return _digest(arrays) == manifest["digest"]
    except Exception:
        return False


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Largest step with a *valid* checkpoint (corrupt/partial ones skipped)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    for step in sorted(steps, reverse=True):
        if _verify(os.path.join(ckpt_dir, f"step_{step:08d}")):
            return step
    return None


def _decode(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


@torch.no_grad()
def load(ckpt_dir: str, step: int, cfg: ModelConfig, lm: LM, opt_state: Dict) -> Dict:
    """Restore checkpoint ``step`` into ``lm`` and ``opt_state`` (made with
    this ``cfg``; their devices and dtypes are kept: a bfloat16 array loads
    into a bfloat16 tensor as its bits). Returns the manifest's ``extra``."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    index = {id(p): i for i, p in enumerate(lm.parameters())}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        def fill(key: str, leaf, pick) -> None:
            arr = _decode(z[key], dtypes.get(key, str(z[key].dtype)))
            for i, t in enumerate(leaf if isinstance(leaf, list) else [leaf]):
                dst = pick(t)
                src = arr[i] if isinstance(leaf, list) else arr
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)} != "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src.to(dst.dtype))

        for p, leaf in jax_leaves(cfg, lm).items():
            fill(f"params/{p}", leaf, lambda t: t)
            for name in ("m", "v"):
                fill(f"opt/{name}/{p}", leaf, lambda t: opt_state[name][index[id(t)]])
        opt_state["step"] = _decode(z["opt/step"], "int32").to(torch.int32).reshape(())
    return manifest.get("extra", {})
