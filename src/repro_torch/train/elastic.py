"""Elastic scaling: resume any checkpoint on whatever group exists now, the
JAX package's ``train/elastic.py``.

Checkpoints store logically-global arrays (group-agnostic). The port's
data parallelism replicates the parameters and the optimizer state on every
rank, so resharding onto a group of 1..N ranks is a load of the whole
checkpoint on each rank's device: shrink (a lost rank) and grow reduce to
the same operation. The training driver calls ``reshard_checkpoint`` at
startup with whatever ranks it finds.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import TrainConfig, init_all


def reshard_checkpoint(ckpt_dir: str, step: int, cfg_model: T.ModelConfig,
                       cfg_train: TrainConfig, *, device=None) -> Tuple[T.LM, Dict, Dict]:
    """Load checkpoint ``step`` onto this rank's ``device`` (any group
    size): (lm, opt_state, extra)."""
    lm, opt_state = init_all(cfg_model, cfg_train, device=device)
    extra = ckpt.load(ckpt_dir, step, cfg_model, lm, opt_state)
    return lm, opt_state, extra
