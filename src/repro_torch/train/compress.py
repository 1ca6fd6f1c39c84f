"""Int8 error-feedback gradient compression for the cross-pod data-parallel
exchange: the JAX package's ``train/compress.py`` over ``torch.distributed``.

At 512+ chips the inter-pod links are the slowest hop, so the cross-pod
gradient all-reduce dominates the collective term. We compress it: per-chunk
int8 quantisation with error feedback (the quantisation residual is added
back into the next step's gradient, preserving convergence in expectation).
The reduce happens as reduce-scatter(int8) → local fp32 sum →
all-gather(int8): the bytes on the wire drop 2× vs bf16 / 4× vs fp32, and
the reduction math stays fp32. The reference's shard_map collectives over
the ``pod`` axis become a :class:`repro_torch.core.distributed.Comm` over a
pod group: its tiled all-to-all is the reduce-scatter's exchange and its
tiled all-gather the gather.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.distributed import Comm


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_mean(flat: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Mean of a flat fp32 vector over the ranks of ``comm``, int8 on the
    wire: padded to a multiple of 128 · ranks, each rank's chunk r quantised
    and sent to rank r, summed there in fp32, re-quantised and gathered."""
    n = comm.world_size
    size = flat.shape[0]
    pad = (-size) % (n * 128)
    xp = torch.nn.functional.pad(flat, (0, pad)).reshape(n, -1, 128)
    q, s = _quant(xp)                                    # int8 + f32 scale/row
    q_r, s_r = comm.a2a(q), comm.a2a(s)                  # my chunk from every rank
    part = torch.sum(_dequant(q_r, s_r).reshape(n, -1, 128), dim=0) / n
    q2, s2 = _quant(part)
    full = _dequant(comm.all_gather(q2), comm.all_gather(s2)).reshape(-1)
    return full[:size]


def compress_gradients(grads: Sequence[torch.Tensor], comm: Optional[Comm],
                       error_state: Optional[Sequence[torch.Tensor]] = None
                       ) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
    """The compressed cross-pod mean of every gradient, with error feedback
    (``error_state``: last step's bf16 residuals, or None). Returns (the
    reduced gradients in their dtypes, the new residuals). Without a group of
    more than one rank, the gradients and the state as they are."""
    if comm is None or comm.world_size == 1:
        return list(grads), None if error_state is None else list(error_state)
    errs = list(error_state) if error_state is not None else [None] * len(grads)
    out, new_err = [], []
    for g, e in zip(grads, errs):
        gf = g.to(torch.float32)
        if e is not None:
            gf = gf + e.to(torch.float32)
        red = compressed_psum_mean(gf.reshape(-1), comm).reshape(g.shape)
        new_err.append((gf - red).to(torch.bfloat16))  # residual feedback
        out.append(red.to(g.dtype))
    return out, new_err
