"""Architecture registry (``--arch <id>``) and the input-shape grid.

The registry lists only the architectures the port can run, plus the
paper-native ``huge-enum`` workload (kept out of ``ARCH_NAMES``, as the JAX
package keeps it); each later slice of the port adds its own.
``ShapeSpec``/``SHAPES``, ``shape_skip_reason`` and ``all_cells`` are the
JAX package's, over the port's architectures.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

ARCH_MODULES: Dict[str, str] = {
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "huge-enum": "repro_torch.configs.huge_enum",
}

ARCH_NAMES = [a for a in ARCH_MODULES if a != "huge-enum"]


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


def shape_skip_reason(arch: str, shape: str) -> Optional[str]:
    """None if the (arch × shape) cell runs; else the documented skip."""
    if shape == "long_500k":
        cfg = get_config(arch)
        if not getattr(cfg, "sub_quadratic", False):
            return "SKIP(full-attn): 500k-context needs sub-quadratic attention"
    return None


def all_cells():
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            yield arch, shape, shape_skip_reason(arch, shape)
