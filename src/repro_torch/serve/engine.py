"""Batched serving: fixed slot batches over prefill and one-token decode steps.

The JAX package's ``serve/engine.py`` in PyTorch. Requests are served in
groups of ``batch_slots``: the group's prompts are right-aligned into one
batch and prefilled together, then every slot decodes one token a step until
each has ``max_new_tokens`` or has emitted ``eos_token``. Sampling is greedy
(the JAX server's tokens, for the same parameters) or by temperature from an
explicit ``torch.Generator`` (its draws differ from ``jax.random``'s). Each
step's tokens reach the host once, as one list.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 1024
    batch_slots: int = 8
    temperature: float = 0.0
    eos_token: int = 1
    max_new_tokens: int = 64


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # [S] int32
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    latency_s: float = 0.0


class BatchedServer:
    def __init__(self, cfg: T.ModelConfig, params: T.LM, scfg: ServeConfig, *,
                 device=None, generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.device = T.params_device(params, device)
        self.gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        logits = logits[:, -1, :].to(torch.float32)
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0]

    @torch.inference_mode()
    def run(self, requests: List[Request]) -> Dict:
        """Serve a list of requests in slot batches; returns throughput stats.
        A request's latency runs from its group's start (all requests arrive
        at once in this offline driver) to its last token on the host."""
        scfg, cfg, dev = self.scfg, self.cfg, self.device
        t0 = time.perf_counter()
        total_new = 0
        for base in range(0, len(requests), scfg.batch_slots):
            group = requests[base : base + scfg.batch_slots]
            b = len(group)
            g0 = time.perf_counter()
            plen = max(len(r.prompt) for r in group)
            toks = np.zeros((b, plen), np.int64)
            for i, r in enumerate(group):
                toks[i, plen - len(r.prompt):] = r.prompt
            cache, logits = T.prefill(cfg, self.params, {"tokens": torch.from_numpy(toks)},
                                      scfg.max_len, device=dev)
            pos = plen
            cur = self._sample(logits)
            live = np.ones(b, bool)
            for i, tok in enumerate(cur.tolist()):
                group[i].out_tokens.append(tok)
            for _ in range(scfg.max_new_tokens - 1):
                logits, cache = T.decode_step(cfg, self.params, cache, cur[:, None], pos,
                                              device=dev)
                cur = self._sample(logits)
                pos += 1
                for i, tok in enumerate(cur.tolist()):
                    r = group[i]
                    if live[i]:
                        r.out_tokens.append(tok)
                        total_new += 1
                        if tok == scfg.eos_token or len(r.out_tokens) >= scfg.max_new_tokens:
                            live[i] = False
                            r.done = True
                            r.latency_s = time.perf_counter() - g0
                if not live.any():
                    break
            for r in group:
                if not r.done:
                    r.latency_s = time.perf_counter() - g0
                r.done = True
        dt = time.perf_counter() - t0
        return {
            "requests": len(requests),
            "new_tokens": total_new,
            "wall_s": dt,
            "tokens_per_s": total_new / max(dt, 1e-9),
        }
