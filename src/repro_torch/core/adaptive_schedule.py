"""BFS/DFS-adaptive scheduling applied to training microbatches (paper §5.2).

The paper bounds enumeration memory with fixed-capacity operator queues: run
BFS-style (max parallelism) while the queue has room, fall back to DFS-style
when it fills. For training, the analogue is the gradient-accumulation
microbatch count: one big batch (BFS — best utilisation, max live activation
bytes) vs many microbatches (DFS — minimum memory, some step overhead). We
pick the smallest microbatch count whose estimated live activation bytes fit
the configured queue capacity — the same "as-BFS-as-memory-allows" rule as
Algorithm 5. The JAX package's ``core/adaptive_schedule.py`` on the port's
``ModelConfig`` (the same config, copied), with the same decisions.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class MicrobatchDecision:
    num_microbatches: int
    est_activation_bytes: int
    budget_bytes: int
    note: str


def estimate_activation_bytes(cfg: ModelConfig, tokens: int, *, bytes_per_elem: int = 2) -> int:
    """Live activation bytes for one microbatch of ``tokens`` under per-group
    remat: scan saves the block-boundary residual stream per group, plus one
    group's working set (attention q/k/v + mlp hidden)."""
    d = cfg.d_model
    boundaries = cfg.num_groups * tokens * d * bytes_per_elem
    working = tokens * bytes_per_elem * (
        # qkv + attention accumulators (+ mamba/rwkv inner streams ≈ 2·d·expand)
        3 * cfg.num_heads * cfg.hd
        + 2 * max(cfg.d_ff, cfg.moe_d_ff * max(1, cfg.experts_per_token))
        + 4 * d
    ) * cfg.period
    return int(boundaries + working)


def choose_microbatches(
    cfg: ModelConfig,
    global_batch: int,
    seq_len: int,
    *,
    device_count: int = 1,
    budget_bytes: int = 8 << 30,
) -> MicrobatchDecision:
    """Smallest power-of-two microbatch count whose activations fit the queue
    capacity (per device). Where none that divides the batch fits, the
    largest that divides it: the reference never returns there (past its
    largest power-of-two divisor no count divides a batch that is not a
    power of two, and its loop goes on doubling); everywhere else the two
    decide alike."""
    n, last = 1, None
    while True:
        if global_batch % n:
            if n > global_batch:
                return last
            n *= 2
            continue
        tokens_per_dev = (global_batch // n) * seq_len // max(1, device_count)
        est = estimate_activation_bytes(cfg, max(1, tokens_per_dev))
        note = "BFS (single batch)" if n == 1 else f"DFS fallback ({n} microbatches)"
        last = MicrobatchDecision(n, est, budget_bytes, note)
        if est <= budget_bytes or n >= global_batch:
            return last
        n *= 2
