"""Training step factory: loss and gradients, microbatch accumulation, the
data-parallel mean, AdamW: the JAX package's ``train/train_step.py``.

The step updates the model in place and returns ``(lm, opt_state,
metrics)``, as the reference returns new ones. Gradients come from
``torch.autograd.grad`` in the parameters' dtypes, as ``jax.grad`` gives
them; with microbatches (``batch["tokens"]`` [n_micro, B_micro, S], the
BFS/DFS-adaptive count of ``core.adaptive_schedule``) each microbatch's
gradients are accumulated in float32, divided by the count, and the loss is
the microbatches' mean. Each layer's activations are recomputed in the
backward (``models.transformer.forward``), the reference's
``jax.checkpoint`` of a layer group.

Distribution: under a group (``comm``, the reference's ``data`` axis) each
rank runs its slice of the global batch and the gradients and the loss are
mean all-reduced (in float32) before the update, so every rank applies the
same one. ``TrainConfig.compress_pods`` reduces them over a second group
(``pod_comm``, the reference's ``pod`` axis) by int8 error feedback
(``train/compress.py``); the residuals live in ``opt_state["err"]``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.models import transformer as T
from repro_torch.models.layers import dtype_of
from repro_torch.models.moe import router_aux_loss
from repro_torch.train.compress import compress_gradients
from repro_torch.train.optimizer import AdamWConfig, apply_updates, decay_flags, init_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    moe_aux_weight: float = 0.01
    compress_pods: bool = False   # int8 error-feedback cross-pod grad exchange


def _loss(cfg_model: T.ModelConfig, lm: T.LM, batch: Dict, aux_weight: float) -> torch.Tensor:
    """The LM loss, plus ``aux_weight`` times the router balance loss of the
    first MoE pattern position's group-0 layer, on the raw embeddings of the
    (clipped) tokens, as the reference computes it."""
    loss = T.loss_fn(cfg_model, lm, batch, device=lm.device)
    if cfg_model.num_experts and aux_weight:
        tokens = torch.as_tensor(batch["tokens"], device=lm.device).to(torch.int64)
        x = lm.embed[torch.clamp(tokens, 0, cfg_model.vocab_size - 1)]
        x = x.to(dtype_of(cfg_model.dtype))
        for pos in range(cfg_model.period):
            if cfg_model.mlp_at(pos) in ("moe", "moe_dense"):
                loss = loss + aux_weight * router_aux_loss(
                    lm.blocks[pos].moe, x, cfg_model.experts_per_token)
                break
    return loss


def _mean_all_reduce(tensors, comm) -> list:
    """Each tensor's mean over the ranks of ``comm``, reduced in float32 and
    returned in its dtype."""
    out = []
    for t in tensors:
        tf = t.to(torch.float32)
        dist.all_reduce(tf, group=comm.group)
        out.append((tf / comm.world_size).to(t.dtype))
    return out


def make_train_step(cfg_model: T.ModelConfig, cfg: TrainConfig, *, comm=None, pod_comm=None):
    """Returns train_step(lm, opt_state, batch) → (lm, opt_state, metrics).

    batch["tokens"]: [B, S] when microbatches == 1 else [n_micro, B_micro, S]
    (numpy or tensors; ``frontend`` likewise with a leading microbatch
    axis). metrics: {"loss", "grad_norm", "lr"} float32 scalars."""

    def loss_and_grads(lm, params, mb):
        loss = _loss(cfg_model, lm, mb, cfg.moe_aux_weight)
        # A parameter the pass does not read (a cross-attention's biases) gets
        # zeros, as jax.grad gives it.
        return loss.detach(), torch.autograd.grad(loss, params, allow_unused=True,
                                                  materialize_grads=True)

    def train_step(lm: T.LM, opt_state: Dict, batch: Dict):
        params = list(lm.parameters())
        for p in params:
            p.requires_grad_(True)
        if cfg.microbatches == 1:
            loss, grads = loss_and_grads(lm, params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
            losses = []
            for i in range(cfg.microbatches):
                l, g = loss_and_grads(lm, params, {k: v[i] for k, v in batch.items()})
                for acc, gg in zip(grads, g):
                    acc.add_(gg.to(torch.float32))
                losses.append(l)
                del g
            grads = [g / cfg.microbatches for g in grads]
            loss = torch.mean(torch.stack(losses))
        if comm is not None and comm.world_size > 1:
            *grads, loss = _mean_all_reduce([*grads, loss], comm)
        if cfg.compress_pods:
            grads, opt_state["err"] = compress_gradients(grads, pod_comm, opt_state.get("err"))
        metrics = apply_updates(cfg.adamw, params, opt_state, grads, decay_flags(cfg_model, lm))
        metrics["loss"] = loss
        return lm, opt_state, metrics

    return train_step


def init_all(cfg_model: T.ModelConfig, cfg: TrainConfig, *, seed: int = 0, device=None):
    """(lm, opt_state): ``init_params`` from ``seed`` and zero AdamW state."""
    lm = T.init_params(cfg_model, seed=seed, device=device)
    return lm, init_state(cfg.adamw, list(lm.parameters()))
