"""Synthetic deterministic data pipeline with prefetch + straggler backup.

The JAX package's ``train/data.py``, copied whole (it is numpy only), so the
port's token stream equals the reference's bit for bit.

Tokens are Zipf-distributed (vocab skew like natural text) and fully
determined by (seed, step), so restart-resume reproduces the exact stream —
the property checkpoint/restart tests rely on. A prefetch thread keeps
``depth`` batches ready; if the pipeline ever stalls past ``timeout_s`` the
loader re-serves the last good batch (backup-batch straggler mitigation) and
counts the event.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    microbatches: int = 1
    seed: int = 0
    zipf_a: float = 1.3
    frontend_len: int = 0
    d_model: int = 0
    frontend: Optional[str] = None
    prefetch_depth: int = 2
    timeout_s: float = 30.0


def synth_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    shape = (cfg.global_batch, cfg.seq_len)
    toks = rng.zipf(cfg.zipf_a, size=shape).astype(np.int64)
    toks = np.clip(toks - 1, 0, cfg.vocab_size - 1).astype(np.int32)
    if cfg.microbatches > 1:
        toks = toks.reshape(cfg.microbatches, cfg.global_batch // cfg.microbatches, cfg.seq_len)
    batch = {"tokens": toks}
    if cfg.frontend:
        fshape = (cfg.global_batch, cfg.frontend_len, cfg.d_model)
        if cfg.microbatches > 1:
            fshape = (cfg.microbatches, cfg.global_batch // cfg.microbatches,
                      cfg.frontend_len, cfg.d_model)
        batch["frontend"] = rng.standard_normal(fshape).astype(np.float32) * 0.02
    return batch


class PrefetchLoader:
    """Background-thread prefetch with backup-batch fallback."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        self.q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch_depth)
        self.stalls = 0
        self._stop = threading.Event()
        self._backup = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        step = self.step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        try:
            step, batch = self.q.get(timeout=self.cfg.timeout_s)
            self._backup = batch
            return batch
        except queue.Empty:
            # Straggler mitigation: don't block the synchronous step — reuse
            # the last good batch and record the stall.
            self.stalls += 1
            if self._backup is None:
                return synth_batch(self.cfg, self.step)
            return self._backup

    def __iter__(self) -> Iterator:
        return self

    def close(self):
        self._stop.set()
