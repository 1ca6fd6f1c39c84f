"""Restart-safe training driver, the JAX package's ``launch/train.py``.

``python -m repro_torch.launch.train --arch granite-3-8b --smoke --steps 50 --device cpu``

Fault tolerance: resumes from the latest *valid* checkpoint (corrupt or
partial ones are digest-rejected); checkpoints are written asynchronously off
the step path; ``--fail-at N`` injects a hard crash (exit 42) after step N
for the restart tests. Elastic: under a ``torch.distributed`` group (``comm``
of :func:`train`) the driver is data-parallel over its ranks, each taking its
slice of the global batch, and a checkpoint is resumed onto whatever ranks
exist (``train/elastic.py``); rank 0 writes the checkpoints. The BFS/DFS-
adaptive rule (``core/adaptive_schedule.py``) picks the microbatch count
under ``--memory-budget-gb``. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.core.adaptive_schedule import choose_microbatches
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, PrefetchLoader
from repro_torch.train.elastic import reshard_checkpoint
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.train_step import TrainConfig, init_all, make_train_step


def _rank_slice(batch: Dict, rank: int, ranks: int, micro: int) -> Dict:
    """This rank's share of the global batch: its slice of the batch axis
    (axis 1 under microbatches)."""
    if ranks == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = v.shape[1 if micro > 1 else 0] // ranks
        out[k] = v[:, rank * n:(rank + 1) * n] if micro > 1 else v[rank * n:(rank + 1) * n]
    return out


def train(cfg: T.ModelConfig, *, steps: int, global_batch: int = 8, seq_len: int = 128,
          lr: float = 3e-4, ckpt_dir: Optional[str] = None, ckpt_every: int = 25,
          memory_budget_gb: float = 4.0, fail_at: int = -1, seed: int = 0,
          log_every: int = 10, device=None, comm=None, lm: Optional[T.LM] = None,
          log: Callable[[str], None] = print) -> Dict:
    """Train ``cfg`` for ``steps`` steps on the seeded Zipf stream (resuming
    from ``ckpt_dir``'s latest valid checkpoint if any; else from ``lm`` if
    given, else ``init_params`` from ``seed``). Returns {"loss": final loss,
    "history": [per-step metrics as floats, with the step's wall time
    "step_s"], "tokens_per_s", "decision" (the microbatch choice), "lm"}."""
    dev = resolve_device(device)
    ranks, rank = (1, 0) if comm is None else (comm.world_size, comm.rank)
    decision = choose_microbatches(cfg, global_batch, seq_len, device_count=ranks,
                                   budget_bytes=int(memory_budget_gb * (1 << 30)))
    micro = min(decision.num_microbatches, max(1, global_batch // ranks))
    tc = TrainConfig(adamw=AdamWConfig(learning_rate=lr, warmup_steps=10, total_steps=steps),
                     microbatches=micro)
    log(f"[train] {cfg.name}: {decision.note}, microbatches={micro}, group={{'data': {ranks}}}")

    start_step = 0
    latest = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
    if latest is not None:
        log(f"[train] resuming from valid checkpoint step {latest}")
        lm, opt_state, _ = reshard_checkpoint(ckpt_dir, latest, cfg, tc, device=dev)
        start_step = latest
    elif lm is not None:
        opt_state = init_state(tc.adamw, list(lm.parameters()))
    else:
        lm, opt_state = init_all(cfg, tc, seed=seed, device=dev)
    log(f"[train] params: {sum(p.numel() for p in lm.parameters()):,}")

    step_fn = make_train_step(cfg, tc, comm=comm)
    dc = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
        microbatches=micro, seed=seed,
        frontend=cfg.frontend or ("audio" if cfg.encoder_layers else None),
        frontend_len=max(cfg.frontend_len, 8), d_model=cfg.d_model,
    )
    loader = PrefetchLoader(dc, start_step=start_step)
    history: List[Dict[str, float]] = []
    t0 = time.time()
    tokens_done = 0
    metrics = None
    try:
        for step in range(start_step, steps):
            t_step = time.time()
            batch = _rank_slice(next(loader), rank, ranks, micro)
            lm, opt_state, metrics = step_fn(lm, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
            metrics["step_s"] = time.time() - t_step
            history.append(metrics)
            tokens_done += global_batch * seq_len
            if (step + 1) % log_every == 0 or step == start_step:
                dt = time.time() - t0
                log(f"step {step + 1:5d} loss={metrics['loss']:.4f} "
                    f"gnorm={metrics['grad_norm']:.3f} "
                    f"lr={metrics['lr']:.2e} tok/s={tokens_done / max(dt, 1e-9):,.0f} "
                    f"stalls={loader.stalls}")
            if ckpt_dir and rank == 0 and (step + 1) % ckpt_every == 0:
                ckpt.save_async(ckpt_dir, step + 1, cfg, lm, opt_state)
            if fail_at >= 0 and step + 1 >= fail_at:
                log(f"[train] injected failure at step {step + 1}")
                os._exit(42)
    finally:
        loader.close()
    wall = time.time() - t0
    if ckpt_dir and rank == 0:
        ckpt.wait_pending(ckpt_dir)
        if ckpt.latest_step(ckpt_dir) != steps:
            ckpt.save(ckpt_dir, steps, cfg, lm, opt_state)
    loss = metrics["loss"] if metrics else float("nan")
    log(f"[train] done: final loss {loss:.4f}")
    return {"loss": loss, "history": history, "tokens_per_s": tokens_done / max(wall, 1e-9),
            "decision": decision, "lm": lm}


def main(argv=None, comm=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--memory-budget-gb", type=float, default=4.0)
    ap.add_argument("--fail-at", type=int, default=-1, help="inject crash after step N")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    out = train(cfg, steps=args.steps, global_batch=args.global_batch, seq_len=args.seq_len,
                lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                memory_budget_gb=args.memory_budget_gb, fail_at=args.fail_at, seed=args.seed,
                log_every=args.log_every, device=args.device, comm=comm,
                log=lambda m: print(m, flush=True))
    return out["loss"]


if __name__ == "__main__":
    main()
