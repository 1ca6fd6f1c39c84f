"""Architecture registry (``--arch <id>``) and the input-shape grid.

The registry lists only the architectures the port can run; each later slice
of the port adds its own. ``ShapeSpec``/``SHAPES`` are the JAX package's
shape grid, copied as they are.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

ARCH_MODULES: Dict[str, str] = {
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
}

ARCH_NAMES = list(ARCH_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def get_config(name: str):
    mod = importlib.import_module(ARCH_MODULES[name])
    return mod.config()


def smoke_config(name: str):
    mod = importlib.import_module(ARCH_MODULES[name])
    return mod.smoke()
