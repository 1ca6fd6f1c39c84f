"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (each prints its results; any failure exits non-zero):

1. set-up: the card's name and power limit, versions, the seven kernel
   libraries' builds and the probe's (one nvcc per source, started
   together);
2. each intersect kernel against its plain PyTorch version, on the card, at
   the shapes of the full-width run (bit-equal outputs), with device times
   (``queued_ms``: median and spread of 5 windows of calls queued behind a
   sleep kernel), CUDA-event call times and the byte bound of each
   configuration, the latency floors of lex_bounds and fused_verify, and
   beside fused_extend and multiway_membership a plain write (``fill_``)
   and a ``torch.ne`` over their bytes; then untimed at the edges of the
   redesigned kernels (the graph's longest rows as slabs, cands and other
   rows, unpadded key tables);
3. the table4 workload through ``repro_torch.launch.table4``: q1-q3 under
   ``huge`` on powerlaw_graph(4096, 8.0, seed=7), plain then fused, with the
   reference's match counts and the result rows per simulated machine;
4. verify and join: q3/rads, q1/seed, q2/seed (fused) and q3/huge through the
   membership kernel on powerlaw_graph(512, 6.0, seed=0);
5. full width: q3 under ``huge`` on a 875,713-vertex power-law graph shaped
   like web-Google, fused against plain, plus a profiled window of the fused
   run;
5e. the paper's suites (``launch/table1_comm_modes`` ... ``exp_streaming``),
   each fused with its own asserts: on phase 4's graph, Exp-9 on
   powerlaw_graph(128, 6.0, seed=0), chaos and streaming at their smoke
   sizes (every suite launches fused_extend; Table 1's and Exp-1's seed
   rows lex_bounds; chaos's kernel-fail case one fallback); then Exp-6 at
   full width: q3 under ``huge``, fused, with the direct-mapped cache
   beside phase 5's LRBU run (44 matches each), hit rates, pulled bytes,
   walls and steps side by side;
5d. the distributed engine (``core/distributed.py``): q3 under ``huge``,
   fused, at full width on a world of one rank over NCCL in this process
   (44 matches, every lookup local); then four ranks on the one card over
   gloo (``run_ranks``; gloo stages its all-to-alls through host memory,
   and four processes share one GPU, so no multi-GPU time) on the table4 graph: q2 and q3 under ``huge``
   and q3 under ``rads`` (PUSH-JOIN: ``lex_bounds``; VERIFY:
   ``fused_verify``) fused, and q3 under ``huge`` unfused, whose
   schedule and traffic must equal the fused run's; the ranks' kernel
   launches count on the main path; then, in the same ranks, one MoE layer
   at qwen3-moe-30b-a3b's widths (32 of its 128 experts a rank): its push
   (all-to-all) and pull (all-gather) bodies at 64 tokens a rank (lossless)
   and 2,048 (pairs dropped) against ``_moe_local`` on each rank's tokens,
   with the bytes each moved beside ``moe_dispatch_mode``'s model;
5c. the multi-tenant graph service (``serve/graph_service.py``), every
   session fused: ``launch/service_load`` at its defaults, unfused then
   fused (59,500 matches, appended to BENCH_torch_service.json); four
   tenants on the table4 graph (q1/huge, q2/seed, q3/rads, q3/huge) with a
   lease-oom at admission and a queue-overflow under per-tick checkpoints,
   then standing triangle and q2 over a batch of inserts (the full-width
   leg, ``phase_service_full``, runs as a card test in
   ``tests/test_torch_gpu.py``);
5b. the engine's other paths: every injected fault kind recovered on the
   table4 graph (the kernels launching again after the restore),
   ``shortest_path_length`` at full width against scipy, and batches of
   inserts at full width through a fused and a plain engine's
   ``apply_updates`` and ``run_delta`` (triangle), the deltas summed
   against full counts; with the pre-flight's time in every
   ``prepare`` of phases 5 and 5b;
6. the RWKV6 kernel against its plain version at the LM path's shapes
   (forward, serve prefill with the state, a ragged tail), with its times and
   its bound, then untimed at the decay edges;
7. rwkv6-7b at full width: ``loss_fn`` and ``forward`` on 4 x 4096 tokens
   (32 kernel launches a pass), a profiled forward, and ``prefill`` +
   ``decode_step`` against the forward's logits, in bf16 and with the
   parameters widened to float32;
8. rwkv6-7b serving: ``BatchedServer``, greedy, 16 requests of 512 prompt
   tokens and 32 new tokens on 8 slots;
9. the flash attention kernel against its plain version at granite's
   forward, serve-prefill and decode shapes, gemma2's softcap branch (bf16,
   scores scaled to reach the cap), the float32 check's prefill and
   decode shapes, gemma2's local (4,096-key sliding window) prefill,
   decode and float32 shapes and its global (unwindowed) prefill and decode
   shapes, chatglm3's decode and forward (16 query heads on a KV head) and
   command-r's forward (8) and qwen3-moe's decode step (8), seamless-m4t's
   non-causal shapes (its encoder over 2,048 frames, its cross-attention's
   509, 32 and 1 queries over 2,048 and 1,024 frames; Dh 64, one query
   head a KV head) and phi-3-vision's Dh-96 forward and decode, over all outputs
   and row by row, with the readings of faults put
   into the plain version (to show the check can fail: the last key tile
   lost, the softcap or the window dropped), the kernel form that ran, its
   times, achieved TFLOP/s and GB/s, its bound, and SDPA's time (none at the
   softcap and window shapes, where no library call computes the same
   function); then the serve-prefill
   and decode shapes (the latter at Dh = 36) on views off 16 bytes, which the
   wrapper copies aligned for the bf16 forms;
10. granite-3-8b at full width, as phase 7 (40 kernel launches a pass and a
   decode step, each pass in the form its shape names);
11. granite-3-8b serving, as phase 8 (prefill and decode forms counted);
12. gemma2-9b at full width (local layers with a 4,096-key window, softcaps
   50 and 30) on sequences longer than the window: ``loss_fn`` and
   ``forward`` on 2 x 8192 tokens, a profiled forward, ``prefill`` of 4,608
   tokens + 3 decode steps against the forward (bf16 and float32), then 16
   served requests of 4,160 + 32 tokens on 8 slots, each pass in the form
   its shape names;
13. chatglm3-6b (GQA 32:2, half-width RoPE, qkv bias) and command-r-35b
   (60.6 GB of weights: B=1, no float32 leg) at full width, as phase 12 at
   4,096 tokens, with one served group of 8 requests of 512 + 32 tokens;
14. qwen3-moe-30b-a3b at full width and depth (every layer's MLP the MoE
   layer: 128 experts, top-8; 61.06 GB of weights): ``loss_fn`` and
   ``forward`` on 2 x 4096 tokens (pairs dropped: cap 641), a profiled
   forward, ``prefill`` of 2 x 509 tokens + 3 decode steps against a
   lossless forward of 2 x 512 tokens, one served group of 8 requests of
   512 + 32 tokens, each pass's dropped pairs and bucket fill logged; then,
   the bf16 model freed, a float32 leg on 16 of its layers (prefill of
   2 x 253 + 3 decode steps against a forward of 2 x 256);
15. Mamba's selective-scan kernel against its plain version at jamba's
   shapes (forward B=2 x 4,096, served prefill B=8 x 512, a decode step from
   a non-zero state; Di 8,192, N 16), with its times and bound, then
   untimed at the decay edges (underflow to 0; about 1 over 4,096 steps)
   and against two faults put into the plain version; then jamba-v0.1-52b
   at full width cut to 16 of its 32 layers (14 Mamba, 2 attention, 8 MoE;
   52.04 GB of weights): ``loss_fn`` and ``forward`` on 2 x 4096 tokens (14
   scan and 2 flash launches a pass), a profiled forward, ``prefill`` of 2 x
   512 tokens + 3 decode steps against a lossless forward of 2 x 640, one
   served group of 8 requests of 512 + 32 tokens, and, the bf16 model
   freed, a float32 leg on 8 of its layers (prefill of 2 x 128 + 3 decode
   steps against a forward of 2 x 256);
16. seamless-m4t-large-v2 (24 encoder and 24 decoder layers, d 1,024, 16
   heads of 64, vocab 256,206; 4.07 GB) at full width and depth:
   ``loss_fn`` and ``forward`` on B=2 x (2,048 frames + 2,048 tokens), 72
   flash launches a pass (24 in the encoder and 24 in the
   cross-attentions, non-causal, asserted) and 48 a decode step, a
   profiled forward, ``prefill`` of 2 x (2,048 frames + 509 tokens) + 3
   decode steps against the forward (bf16 and float32), and a greedy loop
   of 8 requests of 1,024 frames + 32 prompt tokens + 32 new tokens
   through ``prefill`` and ``decode_step``; then phi-3-vision-4.2b (32
   layers, d 3,072, 32 heads of 96; 7.64 GB) at full width and depth:
   ``loss_fn`` and ``forward`` on 2 x (256 patches + 3,840 tokens), prefill
   of the patches + 509 tokens and decode steps at positions 765-767
   against the forward (bf16 and float32), one served group of text-only
   prompts through ``BatchedServer``;
17. the flash attention backward kernel against its plain version
   (``ref.attention_bwd_ref``) at the training shapes: granite's (B=2, 32/8
   heads, 4,096 tokens, Dh 128, causal), gemma2's local and global layers
   (Dh 256, softcap 50, window 4,096, 4,608 tokens), seamless's encoder and
   cross-attention (Dh 64, non-causal, 2,048 and 509 x 2,048), phi-3-vision's
   Dh 96 and one float32 shape, with times, bound and SDPA's backward;
18. granite-3-8b training at full width, cut to 20 of its 40 layers
   (4.19 B parameters, B=2 x 4,096): one step's loss, grad norm and five
   leaves' gradients on the flash kernels against plain attention's
   autograd, then 3 steps through ``launch.train.train`` (adaptive
   microbatches, AdamW) with tokens/s, step times, peak memory and both
   kernels' launches, then the comparison in float32 at 2 layers;
19. the training driver at the smoke size on the card: ``--fail-at`` (exit
   42), then a resume from the latest valid checkpoint to the end;
20. the backward kernels of RWKV6 and the scan against their plain versions
   (``rwkv6_bwd_ref``, ``ssm_scan_bwd_ref``) at the training shapes
   (rwkv6-7b's BH=128 x 4,096, K=V=64, bf16; jamba's B=2 x 4,096, Di 8,192,
   N 16, bf16) and a float32 shape each, with times and bound; untimed at
   the decay edges (w = 1, the model's clamp, mixed; decays underflowing
   to 0 and about 1 over 4,096 steps) and against a fault put into each
   plain version (u's terms dropped, dh_T ignored);
21. rwkv6-7b training at full width: one step's loss, grad norm and five
   leaves' gradients on the kernels against the plain chunked scan's
   autograd at 2 layers in bf16 (deeper, the random model's gradients are
   chaotic in the forward's rounding), then, cut to 16 of its 32 layers
   (4.71 B parameters, B=2 x 4,096), 3 steps through ``launch.train.train``
   with tokens/s, step times, peak memory and both kernels' launches (2
   and 1 a layer a step), then the comparison in float32 at 2 layers; and
   jamba's Mamba mixer at full width as a layer (d_model 4,096, Di 8,192,
   N 16): one forward and backward at B=2 x 4,096 on the scan kernels
   against the plain scan's autograd, every parameter's gradient and the
   input's, in bf16 and float32.

The line before the last holds the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. It imports torch, numpy and the port only.

``python3 chip_smoke.py --rwkv-depth-witness`` runs none of the phases: it
prints how far rwkv6-7b's float32 gradients part by depth under a change of
the forward's rounding alone (``rwkv_depth_witness``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Tuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 peak outside the tensor cores (data sheet)
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 dense tensor-core peak (data sheet)
SECTOR = 32  # bytes: the unit in which the card fetches a scattered load
INVALID = 2**31 - 1
CU_SOURCE = "src/repro_torch/kernels/intersect/csrc/intersect.cu"
RWKV_SOURCE = "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu"
RWKV_REPLACES = "src/repro/kernels/rwkv6/rwkv6.py:74"
RWKV_TOL = 1e-4  # kernel vs plain, max |diff| / max |plain|: float32, another summation order
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:89"
# Flash kernel vs plain, two readings, each held to its tolerance:
# - max |diff| over all outputs, on unit-normal inputs: the JAX package's
#   tolerances for its kernel;
# - the worst query row's max |diff| over that row's max |plain|. A row's
#   output shrinks as it attends more keys (about 0.03 at row 2048 of 4096),
#   so only this reading sees a fault confined to late rows or late keys. In
#   bf16, 2e-2 of the row's largest value is 2.5 units in the last place
#   there: both round the output to bf16 (up to 1 unit apart) and the kernel
#   also rounds the probabilities to bf16 before the product with V (the TPU
#   kernel keeps them in float32), about 0.002 of a row's largest value. In
#   float32 the summation orders differ by about 1e-6 absolute in every row
#   while a row's largest value falls to about 0.1 at S = 512: 1e-4.
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
FLASH_ROW_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# q is scaled by this in the softcap shape, so the scores (standard deviation
# 20) reach the cap of 50 and the check sees the softcap branch: at unit
# scale 50·tanh(s/50) moves a score by about s³/7500, too little to see.
SOFTCAP_Q_SCALE = 20.0
# prefill + decode vs the forward pass, max |diff| / max |forward logits|. In
# float32 the two paths differ only in summation order. In bf16 the logits
# carry bf16's own rounding: at full width the bf16 forward differs from the
# float32 forward of the same weights by about 0.06, and from a bf16 forward
# of the same tokens in another batch shape by as much.
LOGITS_TOL_F32 = 1e-3
LOGITS_TOL_BF16 = 0.10
# The LM phases' sizes: the kernel's (what, BH, T, state out) at the LM path's
# shapes; forward (B, S, prefill length, decode steps); serving (requests,
# prompt length, new tokens, slots).
RWKV_SHAPES = (("forward B=4", 4 * 64, 4096, False),
               ("serve prefill B=8", 8 * 64, 512, True),
               ("ragged tail B=8", 8 * 64, 37, True))
# Decays at and past the model's edges, held untimed in phase 6 at the
# serve-prefill shape: w = exp(-exp(logdecay)) at the model's clamp bounds
# of logdecay, w = 1.0 exactly (bf16's rounding of exp(-exp(-8))), w = 1e-12
# (the kernel's clamp), and all of them mixed.
RWKV_EDGES = {"logdecay -8": math.exp(-math.exp(-8.0)), "logdecay 1.2": math.exp(-math.exp(1.2)),
              "w 1.0": 1.0, "w 1e-12": 1e-12, "mixed": None}
LM_FORWARD = (4, 4096, 512, 3)
LM_SERVE = (16, 512, 32, 8)
# gemma2-9b's: every sequence longer than its 4,096-key window (at S <= 4,096
# the window masks nothing). B=2 is the most that fits the loss: the f32
# logits and their logsumexp temporary take about 34 GB beside 18.5 GB of
# weights.
GEMMA2_FORWARD = (2, 8192, 4608, 3)
GEMMA2_SERVE = (16, 4160, 32, 8)
# Phase 13: chatglm3-6b and command-r-35b, one served group each; command-r's
# 60.6 GB of weights leave room for a B=1 loss (about 71 GB) and not for its
# float32 copy (121 GB).
DENSE_FORWARD = {"chatglm3-6b": (4, 4096, 512, 3), "command-r-35b": (1, 4096, 512, 3)}
DENSE_SERVE = (8, 512, 32, 8)
# Phase 14: qwen3-moe-30b-a3b. Its 61.06 GB of bf16 weights leave room for a
# B=2 loss (its float32 logits about 10 GB more); the B x S passes route
# 65,536 pairs (cap 641 an expert: pairs drop), so prefill of 2 x 509 tokens
# and 3 decode steps are held to a forward of 2 x 512 tokens (8,192 routed
# pairs: lossless). A float32 copy at full depth (122 GB) does not fit: the
# float32 leg runs after the bf16 model is freed, on 16 of the 48 layers
# (42.4 GB), prefill of 2 x 253 tokens + 3 decode steps against a forward of
# 2 x 256 tokens. Serving takes DENSE_SERVE (its prefill routes 32,768 pairs:
# cap 321).
QWEN3_FORWARD = (2, 4096, 509, 3)
QWEN3_F32 = (16, 253, 3, 256)
# Phase 15: jamba-v0.1-52b cut to 16 of its 32 layers (two groups of its
# 8-layer period: 14 Mamba and 2 attention layers, 8 dense and 8 MoE MLPs;
# 52.04 GB of bf16 weights; the whole takes 103.0 GB). Its Mamba layers take
# a multi-token pass only at 128 tokens or fewer or at a multiple of 128
# (the JAX package's scan chunk). The B x S passes route 16,384 pairs (cap
# 1,281 an expert, 1.25x the mean load); prefill of 2 x 512 tokens and 3
# decode steps are held to a lossless forward of 2 x 640 tokens (2,560
# routed pairs) at positions 511-514 where no routing leaves it, the
# prefill to the forward of its own 512 tokens. A float32 copy does not fit: the
# float32 leg runs after the bf16 model is freed, on 8 of its layers (53.1
# GB), prefill of 2 x 128 + 3 decode steps against a forward of 2 x 256.
# Serving takes DENSE_SERVE.
JAMBA_LAYERS = 16
JAMBA_FORWARD = (2, 4096, 512, 3)
JAMBA_REF_LEN = 640
JAMBA_F32 = (8, 128, 3, 256)
# The selective-scan kernel's shapes: (what, B, T, non-zero h0, dtype of x,
# B and C) at jamba's inner width, states and dt rank: phase 15's forward,
# its served prefill, a decode step (bf16) and the float32 leg's forward
# (the kernel's float32 build). The kernel against its plain version,
# max |diff| over max |plain| (y and h_T): float32 throughout, another
# summation order over the states and fused multiply-adds, over up to 4,096
# dependent steps, as RWKV_TOL.
# Phase 16: seamless-m4t-large-v2 and phi-3-vision-4.2b at full width and
# depth (4.07 and 7.64 GB of bf16 weights; their float32 copies fit beside
# them). seamless takes the reference's enc-dec layout (its input specs: half
# of a sequence frames, half tokens): B=2 x (2,048 frames + 2,048 tokens),
# prefill of 2 x (2,048 frames + 509 tokens) + 3 decode steps against that
# forward; its served requests are 8 x (1,024 frames + 32 prompt tokens + 32
# new tokens) on 8 slots. phi-3-vision: B=2 x (256 patches + 3,840 tokens),
# prefill of 256 patches + 509 tokens + 3 decode steps at positions 765-767,
# one served group of text-only prompts (DENSE_SERVE).
SEAMLESS_FORWARD = (2, 2048, 509, 3)
SEAMLESS_FRAMES = (2048, 1024)
SEAMLESS_SERVE = (8, 32, 32, 8)
PHI3V_FORWARD = (2, 3840, 509, 3)
PHI3V_PATCHES = (256, 0)
SCAN_SOURCE = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
SCAN_REPLACES = "src/repro/models/ssm.py:54"  # _ssm_scan_chunked: plain JAX, no TPU kernel
SCAN_DI, SCAN_N, SCAN_RANK = 8192, 16, 256
SCAN_SHAPES = (("forward B=2", 2, 4096, False, "bfloat16"),
               ("serve prefill B=8", 8, 512, False, "bfloat16"),
               ("decode B=8", 8, 1, True, "bfloat16"),
               ("float32 leg forward B=2", 2, 256, True, "float32"))
SCAN_TOL = 1e-4
SFU_EXP_PER_CLOCK = 16  # exponentials an SM issues a clock on its special-function units
# One of jamba's Mamba layers at full width (random weights) in bf16 and
# float32, outside the model, so that no MoE routing lies between the two
# sides: (rows, prefill length, decode steps, pass length) -- prefill from
# zero, then one-token steps through the returned conv tail and state,
# against one pass over the rows' 640 tokens at positions 511-514. In bf16
# the prefill's and the pass's products have other shapes (1,024 and 1,280
# rows), which may round an output of in_proj or x_proj an ulp (2^-8) apart,
# and the state carries such a change into the next steps: MAMBA_TOL_BF16 is
# 5 ulps of the largest output, max |diff| over max |pass|. In float32 they
# differ in summation order only (LOGITS_TOL_F32). A decode step from a lost
# state or a lost conv tail must read above the bound.
MAMBA_CACHE = (2, 512, 3, 640)
MAMBA_TOL_BF16 = 2e-2
# The flash kernel's shapes: (what, B, Hq, Hkv, Sq, Sk, Dh, softcap, dtype,
# sliding window, causal), q scaled by SOFTCAP_Q_SCALE where there is a
# softcap; the first is the JSON line's headline. gemma2's local shapes are
# those of phase 12's local layers: a sequence of the forward (8,192), a
# decode step after a 4,608-token prompt and 31 new tokens, the float32
# prefill of 4,608 (one row of two); its global shapes are those of the same
# passes' global layers (no window, the same softcap). chatglm3's and
# command-r's prefill shapes are phase 13's forwards (groups of 16 and 8);
# qwen3's decode shape is phase 14's served decode step (8 query heads a KV
# head, 512 + 32 keys). seamless-m4t's (phase 16) are non-causal, one query
# head a KV head at Dh 64: its encoder over 2,048 frames, which is also the
# forward's cross-attention (2,048 tokens over 2,048 frames: the same
# function at the same shape), the prefill's 509 tokens over 2,048 frames,
# and a served group's prefill (32 tokens; the decode form) and decode step
# over 1,024 frames. phi-3-vision's (phase 16) are its forward over 256
# patches + 3,840 tokens and a served decode step (512 + 32 keys) at Dh 96,
# which the bf16 forms run in their 128-wide template.
FLASH_SHAPES = (
    ("granite forward B=4", 4, 32, 8, 4096, 4096, 128, None, torch.bfloat16, None, True),
    ("granite serve prefill B=8", 8, 32, 8, 512, 512, 128, None, torch.bfloat16, None, True),
    ("granite decode B=8", 8, 32, 8, 1, 544, 128, None, torch.bfloat16, None, True),
    ("gemma2 softcap B=4", 4, 16, 8, 2048, 2048, 256, 50.0, torch.bfloat16, None, True),
    ("granite float32 check B=2", 2, 32, 8, 512, 512, 128, None, torch.float32, None, True),
    ("granite float32 decode B=8", 8, 32, 8, 1, 544, 128, None, torch.float32, None, True),
    ("gemma2 local prefill B=1", 1, 16, 8, 8192, 8192, 256, 50.0, torch.bfloat16, 4096, True),
    ("gemma2 local decode B=8", 8, 16, 8, 1, 4640, 256, 50.0, torch.bfloat16, 4096, True),
    ("gemma2 local float32 B=1", 1, 16, 8, 4608, 4608, 256, 50.0, torch.float32, 4096, True),
    ("gemma2 global prefill B=1", 1, 16, 8, 8192, 8192, 256, 50.0, torch.bfloat16, None, True),
    ("gemma2 global decode B=8", 8, 16, 8, 1, 4640, 256, 50.0, torch.bfloat16, None, True),
    ("chatglm3 decode B=8", 8, 32, 2, 1, 544, 128, None, torch.bfloat16, None, True),
    ("chatglm3 forward B=4", 4, 32, 2, 4096, 4096, 128, None, torch.bfloat16, None, True),
    ("command-r forward B=1", 1, 64, 8, 4096, 4096, 128, None, torch.bfloat16, None, True),
    ("qwen3 decode B=8", 8, 32, 4, 1, 544, 128, None, torch.bfloat16, None, True),
    ("seamless encoder and cross-attention B=2", 2, 16, 16, 2048, 2048, 64, None,
     torch.bfloat16, None, False),
    ("seamless prefill cross-attention B=2", 2, 16, 16, 509, 2048, 64, None, torch.bfloat16,
     None, False),
    ("seamless served prefill cross-attention B=8", 8, 16, 16, 32, 1024, 64, None,
     torch.bfloat16, None, False),
    ("seamless decode cross-attention B=8", 8, 16, 16, 1, 1024, 64, None, torch.bfloat16, None,
     False),
    ("phi-3-vision forward B=2", 2, 32, 32, 4096, 4096, 96, None, torch.bfloat16, None, True),
    ("phi-3-vision decode B=8", 8, 32, 32, 1, 544, 96, None, torch.bfloat16, None, True),
)
# Shapes that reach the bf16 forms through the wrapper's aligned copy: (what,
# B, Hq, Hkv, Sq, Sk, Dh), causal, every operand read through a view one
# element (2 bytes) off 16 bytes.
FLASH_UNALIGNED = (
    ("granite serve prefill B=8, views off 16 bytes", 8, 32, 8, 512, 512, 128),
    ("granite decode B=8, Dh=36, views off 16 bytes", 8, 32, 8, 1, 544, 36),
)
# The flash kernel's form on each pass of the granite phases, by (pass kind,
# dtype): the model's calls take the form their shape names and nothing else.
GRANITE_FORMS = {("forward", "bfloat16"): {"prefill"}, ("prefill", "bfloat16"): {"prefill"},
                 ("decode", "bfloat16"): {"decode"}, ("forward", "float32"): {"f32"},
                 ("prefill", "float32"): {"f32"}, ("decode", "float32"): {"f32"}}
# gemma2's passes take the same forms, its local layers' as its global ones';
# so do chatglm3's (16 query heads a KV head: a decode step packs 16 rows)
# and command-r's, which has no float32 leg.
GEMMA2_FORMS = GRANITE_FORMS
DENSE_FORMS = {"chatglm3-6b": GRANITE_FORMS,
               "command-r-35b": {k: v for k, v in GRANITE_FORMS.items() if k[1] == "bfloat16"}}
DEV = "cuda"
# Phase 17: the flash backward kernel against its plain version
# (ref.attention_bwd_ref) at the training shapes: (what, B, Hq, Hkv, Sq, Sk,
# Dh, softcap, dtype, window, causal). Held by max |kernel - plain| / max
# |plain| of each of dq, dk, dv. Both sum in float32 from the same inputs
# and round the results to the inputs' dtype (2^-9 of the largest value in
# bf16); in bf16 the kernel also rounds P and dS to bf16 for its tensor-core
# products, as the forward rounds P (3.1e-3 to 5.8e-3 at these shapes on an
# H100 80GB HBM3). In float32 only the summation orders differ (the
# kernel's dq by atomic adds; below 1e-5).
FLASH_BWD_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
# No TPU kernel: the JAX package differentiates its plain attention.
FLASH_BWD_REPLACES = "src/repro/kernels/flash_attention/ref.py:8"
FLASH_BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
FLASH_BWD_SHAPES = (
    ("granite-3-8b training", 2, 32, 8, 4096, 4096, 128, None, torch.bfloat16, None, True),
    ("gemma2-9b local", 1, 16, 8, 4608, 4608, 256, 50.0, torch.bfloat16, 4096, True),
    ("gemma2-9b global", 1, 16, 8, 4608, 4608, 256, 50.0, torch.bfloat16, None, True),
    ("seamless-m4t encoder", 2, 16, 16, 2048, 2048, 64, None, torch.bfloat16, None, False),
    ("seamless-m4t cross-attention", 2, 16, 16, 509, 2048, 64, None, torch.bfloat16, None,
     False),
    ("phi-3-vision-4.2b Dh 96", 1, 32, 32, 4096, 4096, 96, None, torch.bfloat16, None, True),
    ("float32", 1, 32, 8, 2048, 2048, 128, None, torch.float32, None, True),
)
# Phase 18: granite-3-8b training at full width, cut to 20 of its 40 layers
# (4.19 B parameters: 8.37 GB of bf16 weights, as many of gradients, 33.5 GB
# of float32 AdamW state), B x S = 2 x 4096, and the float32 leg's depth.
TRAIN_LAYERS = 20
TRAIN_SHAPE = (2, 4096)
TRAIN_STEPS = 3
TRAIN_F32_LAYERS = 2
TRAIN_LEAVES = ("blocks.0.attn.wq", "blocks.9.attn.wv", "blocks.19.attn.wo",
                "blocks.10.mlp.w_down", "final_norm")
TRAIN_F32_LEAVES = ("blocks.0.attn.wq", "blocks.0.attn.wv", "blocks.1.attn.wo",
                    "blocks.1.mlp.w_down", "final_norm")
# One step on the kernels against the same step with attention through the
# plain version's autograd: loss and grad norm relative to the plain's, each
# leaf by max |kernel - plain| / max |plain|. In bf16 the two attentions
# round differently (the forward kernel rounds P to bf16 before P V, the
# plain version does not) in each of 20 layers, and the bf16 activations
# carry that through the forward and the backward: a few parts in 100 of a
# leaf's largest gradient. In float32 (2 layers) only the summation orders
# differ.
TRAIN_TOL = {torch.bfloat16: {"loss": 1e-2, "grad_norm": 5e-2, "leaf": 5e-2},
             torch.float32: {"loss": 1e-5, "grad_norm": 1e-4, "leaf": 1e-4}}
# Phase 20: the recurrences' backward kernels against their plain versions
# (rwkv6_bwd_ref, ssm_scan_bwd_ref) at the training shapes: (what, BH or B,
# T, dtype, with dS_T / dh_T) for RWKV6 (K = V = 64) and the scan (Di
# 8,192, N 16). Held by max |kernel - plain| / max |plain| of each
# gradient: both sum in float32 from the same inputs and round to the
# inputs' dtype, in other orders (the scan's dB and dC by atomic adds);
# 1e-2 in bf16 (the rounding of the outputs, 2^-9 of the largest value,
# and of the float32 sums that reach them), 1e-5 in float32.
RWKV_BWD_SOURCE = "src/repro_torch/kernels/rwkv6/csrc/rwkv6_bwd.cu"
# No TPU kernel: the JAX package differentiates its plain chunked scan.
RWKV_BWD_REPLACES = "src/repro/kernels/rwkv6/ops.py:15"
SCAN_BWD_SOURCE = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_bwd.cu"
# No TPU kernel: the JAX package differentiates its plain lax.scan.
SCAN_BWD_REPLACES = "src/repro/models/ssm.py:54"
BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
RWKV_BWD_SHAPES = (("rwkv6-7b training B=2", 128, 4096, torch.bfloat16, False),
                   ("float32 +dS_T", 32, 2048, torch.float32, True))
# Untimed at the decay edges, bf16 at BH 32 x 1,024 with dS_T.
RWKV_BWD_EDGES = {"w 1.0": 1.0, "logdecay 1.2 (the clamp)": math.exp(-math.exp(1.2)),
                  "mixed": None}
SCAN_BWD_SHAPES = (("jamba training B=2", 2, 4096, torch.bfloat16, False),
                   ("float32 +h0 +dh_T", 1, 1024, torch.float32, True))
# Phase 21: rwkv6-7b training at full width, cut to 16 of its 32 layers
# (4.71 B parameters: 9.41 GB of bf16 weights, as many of gradients, 37.6 GB
# of float32 AdamW state), B x S = TRAIN_SHAPE; the comparison against the
# plain version (rwkv6_chunked's autograd) at RWKV_CMP_LAYERS layers, in
# bf16 and float32, held to RWKV_TRAIN_TOL; five leaves of its last layer.
# Deeper, the randomly initialised model's gradients are chaotic in its
# forward's rounding. In float32 a change of rounding alone grows about 70x
# from 2 to 16 layers: the plain form at chunk 16 against chunk 64, leaves
# 2.7e-6 -> 8.9e-5; the kernels against chunk 64, 1.8e-5 -> 1.5e-3
# (``--rwkv-depth-witness``). In bf16 the same growth takes a leaf to O(1)
# (u at layer 7: 1.05), while the backward kernel against its plain version
# under the same forward kernel stays within 1.3e-2 at 16 layers (measured
# on one H100).
RWKV_TRAIN_LAYERS = 16
RWKV_CMP_LAYERS = 2
RWKV_LEAF_NAMES = ("mix_w", "w0", "w_a", "u", "wr")
RWKV_CMP_LEAVES = tuple(f"blocks.1.rwkv.{n}" for n in RWKV_LEAF_NAMES)
# Tighter than TRAIN_TOL: attention's two forms round P differently in every
# layer, while the RWKV6 kernel and the chunked form both sum in float32 and
# differ only in order. At 2 layers in bf16 the loss read 1.5e-6, the grad
# norm 9.3e-5, the leaves 2.1e-3 to 8.4e-3 (the rounding of each layer's bf16
# activations and of the gradients to bf16, 2^-9 of their largest value,
# over the two layers): loss 1e-4, grad norm 1e-3 and leaves 2e-2 leave 67x,
# 11x and 2.4x over those readings. In float32 the loss and grad norm read
# 0 and the leaves up to 1.8e-5 (u, whose gradient sums r k (v . do) over
# all 8,192 tokens in other orders): 1e-6, 1e-5 and 1e-4.
RWKV_TRAIN_TOL = {torch.bfloat16: {"loss": 1e-4, "grad_norm": 1e-3, "leaf": 2e-2},
                  torch.float32: {"loss": 1e-6, "grad_norm": 1e-5, "leaf": 1e-4}}
# ``--rwkv-depth-witness``: the depths at which it reads the parting.
RWKV_WITNESS_LAYERS = (2, 16)
# jamba-v0.1-52b's Mamba mixer at full width (d_model 4,096, Di 8,192, N 16)
# as a layer, B x S = TRAIN_SHAPE: every parameter's gradient and the
# input's on the kernels against the plain scan's autograd, by max |kernel
# - plain| / max |plain|. In bf16 the block rounds its activations, and the
# two scans' gradients differ by the rounding of dx, dB, dC to bf16 (up to
# 4.8e-3 read); in float32 only the summation orders differ (up to 1.8e-6
# read; measured on one H100).
MAMBA_TRAIN_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
REPLACES = {
    "fused_extend": "src/repro/kernels/intersect/intersect.py:181",
    "fused_verify": "src/repro/kernels/intersect/intersect.py:239",
    "lex_bounds": "src/repro/kernels/intersect/intersect.py:304",
    "multiway_membership": "src/repro/kernels/intersect/intersect.py:84",
}
# The configuration whose numbers stand in each kernel's entry of the JSON line
# (every configuration is printed, and listed under "configs").
HEADLINE = {"fused_extend": "E=3 K=4", "fused_verify": "E=3 K=4",
            "lex_bounds": "KK=1", "multiway_membership": "E=2"}
TABLE4 = {"q1": 110508, "q2": 67887, "q3": 1782}
# The full-width graph: powerlaw_graph(vertices, average degree, exponent,
# seed), shaped like SNAP web-Google (exponent 3.0, not 2.5: at 2.5 its padded
# adjacency would be about 105 GB), and the engine configuration of phases 5
# and 5b there.
FULL_GRAPH = (875_713, 9.8, 3.0, 7)
FULL_CFG = dict(batch_size=1024, queue_capacity=1 << 18, cache_capacity=1 << 14, num_machines=8)
# Phase 5b's insert stream: batches of wedge-closing edges (the first a
# warm-up), and the standing queries whose deltas each batch enumerates.
# Triangle only: q2's (diamond's five delta plans) stays in phase 5c's
# table4-graph leg; at full width its count after the batches took 22.5 s of
# the 50.6 s leg (H100 80GB HBM3, 700 W).
STREAM_BATCHES, STREAM_EDGES, STREAM_SEED = 4, 64, 11
STREAM_QUERIES = ("triangle",)
PATH_PAIRS, PATH_SEED = 8, 5
# Phase 5c: the service's legs. On the table4 graph: (tenant, query, plan
# space, the reference's count); at full width: (tenant, query, match
# budget), q3's count there (phase 5's), and the ticks of its profiled window.
SERVICE_TABLE4 = (("a", "q1", "huge", 110508), ("b", "q2", "seed", 67887),
                  ("c", "q3", "rads", 1782), ("d", "q3", "huge", 1782))
# q1 is served on the table4 graph only: at full width its steps (wedges
# into squares) cost about 5 ms each on an H100 80GB, and squares are rare
# there, so even under a budget of 1,000 matches it ran 9,803 steps. q2 is
# not served at full width either (a third tenant that took about a third of
# the leg's 116.8-213.8 s on an H100 80GB).
SERVICE_FULL = (("a", "q3", None), ("b", "triangle", None))
# At full width an extend queue's slack is batch x d_pad rows (1024 x 4608):
# the sessions price past the default pool's 67.1 M int32 cells, so the
# leg's pool is larger. (At batch 256 they fit the default pool, but with
# four times the steps the leg ran past 11 minutes on an H100 80GB.)
SERVICE_FULL_POOL = 128 << 20
# Full counts on the full-width graph: q3's is phase 5's (fused and plain
# agree); triangle's is that of an isolated fused HugeEngine run on an H100
# 80GB (PERF.md §4), which the service reproduces and from which phase 5b's
# streaming starts.
FULL_Q3 = 44
FULL_COUNTS = {"triangle": 6293}
# Phase 5e's Exp-6 at full width: the direct-mapped cache beside phase 5's
# LRBU run. LRU left it: its full-width rows equalled LRBU's hit rate
# (0.0729) in every run on an H100 80GB (PERF.md §4), and it stays in the
# ten suites' Exp-6 on phase 4's graph.
EXP6_FULL_POLICIES = ("lrbu", "direct")
# 3 ticks of 4 x 32 steps, as many steps as phase 5's window: after a
# window of 20 ticks the profiler took minutes to stop (H100 80GB).
SERVICE_PROFILE_TICKS = 3
SERVICE_BENCH = "BENCH_torch_service.json"
# Phase 5d: the distributed engine's full-width configuration (phase 5's
# batch and queues), and its four-rank leg on the table4 graph: (query,
# plan space, fused, the reference's count).
DIST_FULL_CFG = dict(batch_size=1024, queue_capacity=1 << 18, fused=True)
DIST_FULL_BACKEND = "nccl"
DIST_RANKS = 4
DIST_CFG = dict(batch_size=256)
# q1/huge is not in this leg (it took 48.0-53.3 s of it on an H100 80GB);
# q1 at 1-8 gloo ranks stays held by tests/test_torch_distributed.py.
# q2/seed is not in it either (it took 37.7-70.7 s of it on an H100 80GB):
# q3/rads drives the same PUSH-JOIN shuffle and lex_bounds inside the ranks,
# q2/seed stays in phases 4 and 5c and in tests/test_torch_distributed.py.
DIST_CASES = (("q2", "huge", True, 67887), ("q3", "huge", True, 1782),
              ("q3", "rads", True, 1782), ("q3", "huge", False, 1782))
# The four ranks' MoE case: one layer at qwen3-moe-30b-a3b's widths (d 2,048,
# 128 experts, 32 a rank, width 768, top-8), push and pull at 64 tokens a
# rank (512 routed pairs: lossless, cap 512) and 2,048 (16,384: cap 161,
# pairs dropped), each rank against _moe_local on its own tokens with the
# whole weights, max |diff| over max |local| in bf16: the bodies' expert
# products run in other batch shapes than the local one's.
DIST_MOE_TOKENS = (64, 2048)
MOE_TOL_BF16 = 1e-2
# Phase 5e: the paper's suites on phase 4's graph (its counts), Exp-9's
# graph (its counts, tests/test_torch_engine.py).
SUITE_GRAPH = (512, 6.0, 0)
SUITE_COUNTS = {"q1": 4361, "q2": 2551, "q3": 84}
EXP9_GRAPH = (128, 6.0, 0)
EXP9_COUNTS = {"q7": 222908, "q8": 6106}
# Device memory a retired session may leave behind: none of its own; the
# slack covers allocator rounding.
MEM_SLACK = 4 << 20


def log(*args):
    print(*args, flush=True)


def call_ms(fn, iters: int = 20, repeats: int = 7, warmup: int = 10):
    """CUDA-event time per call of ``fn`` over ``iters`` back-to-back calls,
    ``repeats`` times after ``warmup`` calls: what a caller waits per call,
    host-side launch cost included. Returns (median, min, max)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / iters)
    means.sort()
    return means[len(means) // 2], means[0], means[-1]


def device_kernels(prof) -> int:
    """Kernels (device rows) a profile recorded."""
    from torch.autograd import DeviceType

    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def device_busy_us(prof) -> float:
    """Device time in a profile: the kernels' own durations. (A CPU event
    carries the time of the kernels it launched as well; counting it too
    would count each kernel twice.)"""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def _profiled(fn, n):
    """(kernels recorded, device busy µs) of ``n`` calls of ``fn`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return device_kernels(prof), device_busy_us(prof)


def plain_device_ms(fn, iters: int = 20, repeats: int = 5):
    """Device time per call of a plain version, whose calls launch up to tens
    of thousands of torch kernels: the device rows of ``repeats`` profiled
    windows, unchecked (no window of that many records comes out complete),
    so it may read low. Returns (median, min, max, None)."""
    fn()
    torch.cuda.synchronize()
    means = sorted(_profiled(fn, iters)[1] / 1e3 / iters for _ in range(repeats))
    assert means[-1] > 0, "the profiler recorded no device time"
    return means[len(means) // 2], means[0], means[-1], None


def queued_ms(fn, iters: int = 20, repeats: int = 5):
    """Device time per call of ``fn`` without the profiler: a sleep kernel
    keeps the device busy while the host queues ``iters`` calls, so CUDA
    events around the calls time the device alone (the gaps between its
    kernels included). The profiler can miss a library's kernels (cuDNN's
    were missing from every window of one run); this cannot. The sleep is
    doubled until it outlasts the host's queueing. Returns (median, min,
    max)."""
    fn()
    torch.cuda.synchronize()
    cycles, means = 1 << 24, []
    while len(means) < repeats:
        slept0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        slept0.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms >= 0.8 * slept0.elapsed_time(start):  # the queue may have run dry
            cycles *= 2
            assert cycles < 1 << 34, "the host cannot queue the calls ahead of the device"
            continue
        means.append(start.elapsed_time(end) / iters)
    means.sort()
    return means[len(means) // 2], means[0], means[-1]


def timed(fn, iters: int = 20, call_repeats: int = 7, warmup: int = 10, plain: bool = False):
    """Both times of ``fn``: calls first (they warm it up), then device:
    ``queued_ms`` for a kernel or a library call, 5 profiled windows of
    ``iters`` calls for a plain version (``plain``). The profiler is not used
    for kernels: it loses kernel records, and at ``lex_bounds``' shape it
    recorded no complete window in 25 in one run."""
    return (call_ms(fn, iters=iters, repeats=call_repeats, warmup=warmup),
            (plain_device_ms if plain else queued_ms)(fn, iters=iters))


def max_abs_err(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# Byte counts of the bounds: what this run's data needs each kernel to move
# ---------------------------------------------------------------------------

def sorted_rows_bytes(rows, row_id, need):
    """Least bytes read from sorted, INVALID-padded rows. ``rows[..., D]``
    holds the rows as addressed, ``row_id`` names the table row behind each
    (one read serves every address of it), ``need`` the binary searches made
    in each (-1: the row is copied whole). A distinct row costs its valid
    prefix through the first INVALID, or, if only searched and that is fewer,
    ceil(log2 D) + 1 sectors for each search."""
    d = rows.shape[-1]
    prefix = (((rows != INVALID).sum(-1) + 1).clamp(max=d) * 4 + SECTOR - 1) // SECTOR
    live = need != 0
    uniq, inv = torch.unique(row_id[live], return_inverse=True)
    searches = torch.zeros(uniq.numel(), dtype=torch.int64, device=rows.device)
    searches.scatter_add_(0, inv, need[live].clamp(min=0).long())
    copied = torch.zeros(uniq.numel(), dtype=torch.bool, device=rows.device)
    copied.scatter_(0, inv, (need[live] < 0))
    pre = torch.zeros(uniq.numel(), dtype=torch.int64, device=rows.device)
    pre.scatter_(0, inv, prefix[live].long())
    per_search = math.ceil(math.log2(d)) + 1
    sectors = torch.where(copied, pre, torch.minimum(searches * per_search, pre))
    return int(sectors.sum()) * SECTOR


def slab_row_ids(tab0, idx, sel):
    return torch.where(sel == 1, idx[0].long(), tab0.shape[0] + idx[1].long())


def extend_bytes(tab0, tab1, idx, sel, ok, rows, lt, gt, ref) -> int:
    """Slab 0 copied (its valid prefix), the other slabs searched by the
    candidates still alive (valid, past the row filters, members of every
    earlier slab), the addressing and rows once, cands and mask written."""
    b, e = sel.shape
    d = tab0.shape[1]
    slabs = ref.gather_slabs(tab0, tab1, idx, sel, ok)
    cands = slabs[:, 0]
    alive = cands != INVALID
    for col in range(rows.shape[1]):
        alive &= cands != rows[:, col : col + 1]
    for p in lt:
        alive &= cands < rows[:, p : p + 1]
    for p in gt:
        alive &= cands > rows[:, p : p + 1]
    need = torch.zeros((b, e), dtype=torch.int64, device=tab0.device)
    need[:, 0] = -1
    for j in range(1, e):
        need[:, j] = alive.sum(1)
        alive &= ref.multiway_membership_ref(cands, slabs[:, j : j + 1])
    need = torch.where(ok == 1, need, 0)
    small = (idx.numel() + sel.numel() + ok.numel() + rows.numel()) * 4
    return sorted_rows_bytes(slabs, slab_row_ids(tab0, idx, sel), need) + small + b * d * 5


def verify_bytes(tab0, tab1, idx, sel, ok, rows, vpos, ref) -> int:
    """One search per slab for each target still alive, the addressing and
    the target column once, one byte out per row."""
    b, e = sel.shape
    slabs = ref.gather_slabs(tab0, tab1, idx, sel, ok)
    target = rows[:, vpos]
    alive = target != INVALID
    need = torch.zeros((b, e), dtype=torch.int64, device=tab0.device)
    for j in range(e):
        need[:, j] = (alive & (ok[:, j] == 1)).long()
        alive &= (slabs[:, j] == target[:, None]).any(1)
    small = (idx.numel() + sel.numel() + ok.numel() + b) * 4
    return sorted_rows_bytes(slabs, slab_row_ids(tab0, idx, sel), need) + small + b


def warp_find_rounds(row, lo, hi, x):
    """(found, rounds) of intersect.cu's warp_find for each row of row[n, D]
    over [lo, hi): 32 probes a round, the search ending at a probe equal to
    x or when the range is split to nothing."""
    lane = torch.arange(32, device=row.device)
    found = torch.zeros(row.shape[0], dtype=torch.bool, device=row.device)
    rounds = torch.zeros(row.shape[0], dtype=torch.int64, device=row.device)
    live = lo < hi
    while bool(live.any()):
        n = hi - lo
        step = n // 33
        small = n <= 32
        pos = torch.where(small[:, None], lo[:, None] + lane, lo[:, None] + (lane + 1) * step[:, None])
        probe = lane < n[:, None]
        v = torch.where(probe, row.gather(1, pos.clamp(max=row.shape[1] - 1)), INVALID)
        hit = (v == x[:, None]).any(1) & live
        c = (v < x[:, None]).sum(1)
        rounds += live.long()
        found |= hit
        lo, hi = (torch.where(live, torch.where(small, lo + c, torch.where(c > 0, lo + c * step + 1, lo)), lo),
                  torch.where(live, torch.where(small, lo + c, torch.where(c < 32, lo + (c + 1) * step, hi)), hi))
        live &= ~hit & (lo < hi)
    return found, rounds


def verify_rounds(tab0, tab1, idx, sel, ok, rows, vpos, ref) -> int:
    """The most rounds past the slabs' heads that fused_verify's warp makes
    for any row of these inputs: slab by slab while the row still matches,
    a slab whose first 128 entries neither hold the target nor reach it is
    searched by ``warp_find_rounds`` over [128, D)."""
    slabs = ref.gather_slabs(tab0, tab1, idx, sel, ok)
    b, e, d = slabs.shape
    t = rows[:, vpos]
    alive = t != INVALID
    rounds = torch.zeros(b, dtype=torch.int64, device=rows.device)
    for j in range(e):
        s = slabs[:, j]
        live = alive & (ok[:, j] == 1)
        alive = live & (s[:, :128] == t[:, None]).any(1)
        if d > 128:
            ids = (live & ~alive & (s[:, 127] < t)).nonzero().squeeze(1)
            lo = torch.full_like(ids, 128)
            found, r = warp_find_rounds(s[ids], lo, torch.full_like(ids, d), t[ids])
            rounds[ids] += r
            alive[ids] = found
    return int(rounds.max()) if b else 0


def membership_bytes(cands, others) -> int:
    """cands read and the mask written in full; each others row searched by
    the candidates still alive."""
    b, e, d = others.shape
    alive = cands != INVALID
    need = torch.zeros((b, e), dtype=torch.int64, device=cands.device)
    for j in range(e):
        row = others[:, j].contiguous()
        need[:, j] = alive.sum(1)
        pos = torch.searchsorted(row, cands).clamp_(max=d - 1)
        alive &= row.gather(1, pos) == cands
    ids = torch.arange(b * e, device=cands.device).view(b, e)
    return sorted_rows_bytes(others, ids, need) + cands.numel() * 5


def lex_bytes(keys, q, ref) -> int:
    """The distinct sectors of the key table that the two binary searches
    of every query touch, the queries read once and lo, hi written."""
    cap, kk = keys.shape
    touched = []
    for upper in (False, True):
        lo = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
        hi = torch.full_like(lo, cap)
        for _ in range(max(1, cap.bit_length())):
            mid = (lo + hi) // 2
            row = mid.clamp(0, cap - 1)
            touched.append(row * kk * 4 // SECTOR)
            lt, eq = ref._lex_cmp(keys[row], q)
            go = (lt | eq) if upper else lt
            lo = torch.where(go, mid + 1, lo)
            hi = torch.where(go, hi, mid)
    return torch.unique(torch.cat(touched)).numel() * SECTOR + q.numel() * 4 + 2 * q.shape[0] * 4


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions at main-path shapes
# ---------------------------------------------------------------------------

def walk_rows(adj, deg, b, k, gen):
    """[b, k] random walks over the graph: realistic partial matches."""
    dev = adj.device
    live = (deg > 0).nonzero().squeeze(1)
    cols = [live[torch.randint(0, live.numel(), (b,), generator=gen, device=dev)]]
    for _ in range(k - 1):
        prev = cols[-1]
        j = (torch.rand(b, generator=gen, device=dev) * deg[prev]).long()
        cols.append(adj[prev, j].long())
    return torch.stack(cols, dim=1).to(torch.int32).contiguous()


def slab_inputs(adj, deg, b, e, k, cache_rows, gen, hubs=None):
    """(tab0, tab1, idx, sel, ok, rows) as the engine builds them: tab0 is a
    value-cache table holding the batch's slabs among ``cache_rows`` rows.
    ``hubs``: vertex ids that the slab columns of every row are drawn from."""
    dev = adj.device
    v = adj.shape[0]
    rows = walk_rows(adj, deg, b, k, gen)
    if hubs is not None:
        rows[:, :e] = hubs[torch.randint(0, hubs.numel(), (b, e), generator=gen, device=dev)]
    rows[::4, 1:e] = rows[::4, :1]  # a quarter of the rows intersect a slab with itself,
    vids = rows[:, :e].long()       # so that E >= 2 has members (the graph has few triangles)
    need = torch.unique(vids)
    fill = torch.unique(torch.randint(0, v, (2 * cache_rows,), generator=gen, device=dev))
    fill = fill[~torch.isin(fill, need)][: cache_rows - need.numel()]
    cache_vids = torch.unique(torch.cat([need, fill]))
    tab0 = adj[cache_vids].contiguous()
    pos = torch.searchsorted(cache_vids, vids).clamp(max=cache_vids.numel() - 1)
    cached = cache_vids[pos] == vids
    sel = (cached & (torch.rand(b, e, generator=gen, device=dev) < 0.9)).to(torch.int32)
    ok = (torch.rand(b, e, generator=gen, device=dev) < 0.97).to(torch.int32)
    idx = torch.stack([pos.to(torch.int32), vids.to(torch.int32)]).contiguous()
    return tab0, adj, idx, sel.contiguous(), ok.contiguous(), rows


def phase_kernels(graph, ik, ref):
    """Each intersect kernel against its plain version at the full-width
    shapes, with its times; beside them a plain fill of fused_extend's output
    bytes, a ``torch.ne`` over multiway_membership's and the latency floors
    of fused_verify's and lex_bounds' rounds (``load_latency``)."""
    adj, deg = graph.padded.adj, graph.padded.deg
    d = adj.shape[1]
    gen = torch.Generator(device=adj.device).manual_seed(0)
    b, cache_rows = 1024, 1 << 14
    rec = {name: {"max_abs_err": 0, "configs": []} for name in REPLACES}
    # First touch of the whole adjacency, so no timing below pays for it.
    t0 = time.perf_counter()
    adj.amax()
    torch.cuda.synchronize()
    log(f"  first touch of the {adj.numel() * 4 / 1e9:.2f} GB adjacency: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    # What a plain write of fused_extend's output bytes (cands int32 and mask
    # bytes, B*D*5) takes on this card: one fill_ of as many bytes.
    fill = torch.empty(b * d * 5, dtype=torch.uint8, device=adj.device)
    fill_ms = queued_ms(lambda: fill.fill_(0xFF))[0]
    log(f"  plain fill of fused_extend's {fill.numel()} output bytes: queued={fill_ms:.4f} ms")
    del fill
    lat = load_latency()

    def keep(name, shape, err, kernel, plain, nbytes, library=None, note="", **extra):
        (call, (ms, lo, hi)), (plain_call, plain_dev) = kernel, plain
        cfg = dict(shape=shape, ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain_dev[0],
                   bound_ms=bound_ms(nbytes), bound_bytes=nbytes,
                   library_ms=library[1][0] if library else None,
                   call_ms=call[0], call_ms_min=call[1], call_ms_max=call[2],
                   plain_call_ms=plain_call[0],
                   library_call_ms=library[0][0] if library else None, **extra)
        log(f"  {name} [{shape}{note}]: max_abs_err={err} "
            f"kernel queued={ms:.4f} ms (min {lo:.4f}, max {hi:.4f}) "
            f"call={call[0]:.4f} ms (min {call[1]:.4f}, max {call[2]:.4f}) | "
            f"plain device={plain_dev[0]:.4f} ms call={plain_call[0]:.4f} ms | "
            f"bound={cfg['bound_ms']:.5f} ms ({nbytes} B)" +
            (f" | library queued={library[1][0]:.4f} ms call={library[0][0]:.4f} ms"
             if library else ""))
        r = rec[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["configs"].append(cfg)

    for e, k in ((1, 2), (2, 3), (3, 4)):
        tab0, tab1, idx, sel, ok, rows = slab_inputs(adj, deg, b, e, k, cache_rows, gen)
        lt, gt = (k - 1,), (0,)
        c_k, m_k = ik.fused_extend(tab0, tab1, idx, sel, ok, rows, lt=lt, gt=gt)
        c_r, m_r = ref.fused_extend_ref(tab0, tab1, idx, sel, ok, rows, lt=lt, gt=gt)
        torch.cuda.synchronize()
        err = max(max_abs_err(c_k, c_r), max_abs_err(m_k, m_r))
        assert err == 0, f"fused_extend E={e} K={k} disagrees with its plain version"
        keep("fused_extend", f"E={e} K={k}", err,
             timed(lambda: ik.fused_extend(tab0, tab1, idx, sel, ok, rows, lt=lt, gt=gt)),
             timed(lambda: ref.fused_extend_ref(tab0, tab1, idx, sel, ok, rows, lt=lt, gt=gt),
                   plain=True),
             extend_bytes(tab0, tab1, idx, sel, ok, rows, lt, gt, ref),
             note=f" B={b} D={d}, {int(m_r.sum())} matches", fill_ms=fill_ms)

        vrows = rows.clone()
        vrows[::2, k - 1] = torch.where(  # half the targets are true members
            (sel[::2, 0] == 1)[:, None], tab0[idx[0, ::2, 0].long()], tab1[idx[1, ::2, 0].long()]
        )[:, 0]
        vpos = k - 1
        v_k = ik.fused_verify(tab0, tab1, idx, sel, ok, vrows, vpos=vpos)
        v_r = ref.fused_verify_ref(tab0, tab1, idx, sel, ok, vrows, vpos=vpos)
        torch.cuda.synchronize()
        err = max_abs_err(v_k, v_r)
        assert err == 0, f"fused_verify E={e} K={k} disagrees with its plain version"
        # The design's latency floor: the addressing round (the target's load
        # with it), a round of the slabs' heads for each group of 4 slabs,
        # then the most rounds past the heads that a row of these inputs
        # needs, each at L2's latency, after the launch's own time.
        rounds, heads = verify_rounds(tab0, tab1, idx, sel, ok, vrows, vpos, ref), -(-e // 4)
        floor_ms = lat["launch_ms"] + (1 + heads + rounds) * lat["l2_ns"] / 1e6
        log(f"  fused_verify [E={e} K={k}] latency floor: {lat['launch_ms']:.4f} ms launch + "
            f"(1 + {heads} + {rounds} rounds) x {lat['l2_ns']:.1f} ns = {floor_ms:.4f} ms")
        keep("fused_verify", f"E={e} K={k}", err,
             timed(lambda: ik.fused_verify(tab0, tab1, idx, sel, ok, vrows, vpos=vpos)),
             timed(lambda: ref.fused_verify_ref(tab0, tab1, idx, sel, ok, vrows, vpos=vpos),
                   plain=True),
             verify_bytes(tab0, tab1, idx, sel, ok, vrows, vpos, ref),
             note=f" B={b} D={d}, {int(v_r.sum())} kept", rounds=rounds, floor_ms=floor_ms,
             load_l2_ns=lat["l2_ns"], launch_ms=lat["launch_ms"])

        if e >= 2:
            cands = adj[rows[:, 0].long()]
            others = torch.stack([adj[rows[:, c].long()] for c in range(1, e)], dim=1).contiguous()
            w_k = ik.multiway_membership(cands, others)
            w_r = ref.multiway_membership_ref(cands, others)
            torch.cuda.synchronize()
            err = max_abs_err(w_k, w_r)
            assert err == 0, f"multiway_membership E={e} disagrees with its plain version"
            # A yardstick of bytes, not of function: one torch.ne reads the
            # same cands and writes as many mask bytes.
            m = torch.empty(cands.shape, dtype=torch.bool, device=cands.device)
            ne_ms = queued_ms(lambda: torch.ne(cands, INVALID, out=m))[0]
            log(f"  multiway_membership [{e - 1} others] yardstick: torch.ne over the same "
                f"{cands.numel() * 5} bytes queued={ne_ms:.4f} ms")
            keep("multiway_membership", f"E={e}", err,
                 timed(lambda: ik.multiway_membership(cands, others)),
                 timed(lambda: ref.multiway_membership_ref(cands, others), plain=True),
                 membership_bytes(cands, others),
                 note=f" B={b} D={d}, {e - 1} others", ne_ms=ne_ms)

    cap = 1 << 20
    src = graph.nbrs
    for kk in (2, 1):
        n_keys = int(cap * 0.9)
        pick = torch.randint(0, src.numel(), (n_keys, kk), generator=gen, device=src.device)
        filled = src[pick].to(torch.int64)  # vertex ids, skewed like a join key
        comb = filled[:, 0] * (1 << 31) + (filled[:, 1] if kk == 2 else 0)
        filled = filled[torch.sort(comb, stable=True).indices].to(torch.int32)
        keys = torch.full((cap, kk), INVALID, dtype=torch.int32, device=src.device)
        keys[:n_keys] = filled
        q = keys[torch.randint(0, n_keys, (b,), generator=gen, device=src.device)].clone()
        q[b // 2 : 3 * b // 4] = src[torch.randint(0, src.numel(), (b // 4, kk), generator=gen,
                                                   device=src.device)]
        q[3 * b // 4 :] = INVALID - 1  # the join's invalid-query encoding
        lo_k, hi_k = ik.lex_bounds(keys, q)
        lo_r, hi_r = ref.lex_bounds_ref(keys, q)
        torch.cuda.synchronize()
        err = max(max_abs_err(lo_k, lo_r), max_abs_err(hi_k, hi_r))
        assert err == 0, f"lex_bounds KK={kk} disagrees with its plain version"
        library = None
        if kk == 1:
            k1, q1 = keys[:, 0].contiguous(), q[:, 0].contiguous()
            lo_l = torch.searchsorted(k1, q1)
            hi_l = torch.searchsorted(k1, q1, right=True)
            assert torch.equal(lo_l.to(torch.int32), lo_k) and torch.equal(hi_l.to(torch.int32), hi_k)
            library = timed(lambda: (torch.searchsorted(k1, q1), torch.searchsorted(k1, q1, right=True)))
        # The design's latency floor: the query's load, then one load a round
        # (32-way splits: ceil(log2(CAP) / 5) rounds while the two bounds'
        # ranges are one), each at L2's latency, after the launch's own time.
        rounds = math.ceil(math.log2(cap) / 5)
        floor_ms = lat["launch_ms"] + (1 + rounds) * lat["l2_ns"] / 1e6
        log(f"  lex_bounds [KK={kk}] latency floor: {lat['launch_ms']:.4f} ms launch + "
            f"(1 + {rounds} rounds) x {lat['l2_ns']:.1f} ns = {floor_ms:.4f} ms")
        keep("lex_bounds", f"KK={kk}", err, timed(lambda: ik.lex_bounds(keys, q)),
             timed(lambda: ref.lex_bounds_ref(keys, q), plain=True), lex_bytes(keys, q, ref),
             library=library, note=f" CAP={cap} B={b}", rounds=rounds, floor_ms=floor_ms,
             load_l2_ns=lat["l2_ns"], load_hbm_ns=lat["hbm_ns"], launch_ms=lat["launch_ms"])
    intersect_edge_checks(graph, ik, ref, gen)
    return rec


# A chain of dependent loads: one thread follows nxt from *pos for `steps`
# loads (through L2, not L1) and leaves where it stopped in *pos. A probe of
# the card's load latency for lex_bounds' floor, not a kernel of the port.
CHASE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void chase_kernel(const int32_t* nxt, int32_t* pos, int steps) {
  int32_t i = *pos;
  for (int s = 0; s < steps; ++s) i = __ldcg(nxt + i);
  *pos = i;
}

extern "C" int chase_launch(const int32_t* nxt, int32_t* pos, int steps, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(nxt, pos, steps);
  return static_cast<int>(cudaGetLastError());
}
"""
CHASE_STEPS = 1 << 13


def chase_library():
    """The probe's library, its source written under the build directory."""
    import ctypes

    from repro_torch.kernels.build import BUILD_DIR, CudaLibrary

    src = BUILD_DIR.parent / "probe" / "chase.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    if not src.exists() or src.read_text() != CHASE_CU:
        src.write_text(CHASE_CU)

    def declare(lib):
        p = ctypes.c_void_p
        lib.chase_launch.argtypes = [p, p, ctypes.c_int, p]
        lib.chase_launch.restype = ctypes.c_int

    return CudaLibrary("chase_probe", src, declare)


def load_latency():
    """One dependent load's latency on this card, from ``CHASE_CU``: the
    queued time of CHASE_STEPS loads less that of the same launch with none,
    over a random cycle through 2^20 int32 (4 MB, read whole first so it sits
    in L2, as lex_bounds' key table does across calls) and through 2^26
    int32 (256 MB, where the chain meets each entry once: device memory).
    Returns {"l2_ns", "hbm_ns", "launch_ms"} (launch_ms: the launch with no
    load, queued)."""
    lib = chase_library().load()
    gen = torch.Generator(device="cuda").manual_seed(1)
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")

    def run(nxt, steps):
        rc = lib.chase_launch(nxt.data_ptr(), pos.data_ptr(), steps,
                              torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"chase_launch failed ({rc})"

    out = {}
    for key, n in (("l2_ns", 1 << 20), ("hbm_ns", 1 << 26)):
        perm = torch.randperm(n, generator=gen, device="cuda")
        nxt = torch.empty(n, dtype=torch.int32, device="cuda")
        nxt[perm] = perm.roll(-1).to(torch.int32)
        del perm
        if key == "l2_ns":
            run(nxt, n)  # the whole cycle once: the table is in L2 from here
            out["launch_ms"] = queued_ms(lambda: run(nxt, 0))[0]
        ms = queued_ms(lambda: run(nxt, CHASE_STEPS), iters=4, repeats=3)[0]
        out[key] = (ms - out["launch_ms"]) / CHASE_STEPS * 1e6
        del nxt
    log(f"  dependent load latency (chase of {CHASE_STEPS}): L2 {out['l2_ns']:.1f} ns, "
        f"device memory {out['hbm_ns']:.1f} ns; empty launch queued {out['launch_ms']:.4f} ms")
    return out


def intersect_edge_checks(graph, ik, ref, gen):
    """Untimed, bit-equal checks where the redesigned kernels change path, on
    the graph's longest rows: fused_extend (prefixes past the 4096 int32
    staged in shared memory, candidates past a 1024-slot tile),
    fused_verify (slabs that end past their 128-entry heads, half the
    targets at a random position of slab 0's prefix) and
    multiway_membership (cands with long prefixes, other rows past the
    stage); then lex_bounds on unpadded tables whose last key is queried and
    passed (the bound equal to CAP, which the plain version's halving reads
    as CAP + 1 where it steps past it)."""
    adj, deg = graph.padded.adj, graph.padded.deg
    hubs = torch.topk(deg, 16).indices
    degrees = f"degrees {int(deg[hubs].min())}-{int(deg[hubs].max())}"
    for e, k in ((2, 3), (3, 4)):
        tab0, tab1, idx, sel, ok, rows = slab_inputs(adj, deg, 256, e, k, 1 << 10, gen, hubs=hubs)
        c_k, m_k = ik.fused_extend(tab0, tab1, idx, sel, ok, rows, lt=(k - 1,))
        c_r, m_r = ref.fused_extend_ref(tab0, tab1, idx, sel, ok, rows, lt=(k - 1,))
        torch.cuda.synchronize()
        err = max(max_abs_err(c_k, c_r), max_abs_err(m_k, m_r))
        log(f"  fused_extend [hub slabs E={e} K={k}, {degrees}, {int(m_r.sum())} matches]: "
            f"max_abs_err={err}")
        assert err == 0, f"fused_extend on hub slabs E={e} disagrees with its plain version"

        slab0 = torch.where((sel[:, 0] == 1)[:, None], tab0[idx[0, :, 0].long()],
                            tab1[idx[1, :, 0].long()])
        at = (torch.rand(rows.shape[0], generator=gen, device=adj.device)
              * (slab0 != INVALID).sum(1)).long()
        vrows = rows.clone()
        vrows[::2, k - 1] = slab0.gather(1, at[:, None])[::2, 0]
        v_k = ik.fused_verify(tab0, tab1, idx, sel, ok, vrows, vpos=k - 1)
        v_r = ref.fused_verify_ref(tab0, tab1, idx, sel, ok, vrows, vpos=k - 1)
        torch.cuda.synchronize()
        err = max_abs_err(v_k, v_r)
        rounds = verify_rounds(tab0, tab1, idx, sel, ok, vrows, k - 1, ref)
        log(f"  fused_verify [hub slabs E={e} K={k}, {degrees}, {int(v_r.sum())} kept, "
            f"at most {rounds} rounds past the heads]: max_abs_err={err}")
        assert err == 0, f"fused_verify on hub slabs E={e} disagrees with its plain version"

        cands = adj[rows[:, 0].long()]
        others = torch.stack([adj[rows[:, c].long()] for c in range(1, e)], dim=1).contiguous()
        w_k = ik.multiway_membership(cands, others)
        w_r = ref.multiway_membership_ref(cands, others)
        torch.cuda.synchronize()
        err = max_abs_err(w_k, w_r)
        log(f"  multiway_membership [hub rows, {e - 1} others, {degrees}, {int(w_r.sum())} "
            f"members]: max_abs_err={err}")
        assert err == 0, f"multiway_membership on hub rows E={e} disagrees with its plain version"
    src = graph.nbrs
    for cap, kk in ((77, 2), (1024, 1), (1 << 20, 1), (1 << 20, 2)):
        pick = torch.randint(0, src.numel(), (cap, kk), generator=gen, device=src.device)
        keys = src[pick].to(torch.int64)
        comb = keys[:, 0] * (1 << 31) + (keys[:, 1] if kk == 2 else 0)
        keys = keys[torch.sort(comb, stable=True).indices].to(torch.int32).contiguous()
        last, beyond = keys[-1:].clone(), keys[-1:].clone()
        beyond[0, -1] += 1
        q = torch.cat([keys[torch.randint(0, cap, (61,), generator=gen, device=src.device)],
                       last, beyond, torch.full_like(last, INVALID - 1)])
        lo_k, hi_k = ik.lex_bounds(keys, q)
        lo_r, hi_r = ref.lex_bounds_ref(keys, q)
        torch.cuda.synchronize()
        err = max(max_abs_err(lo_k, lo_r), max_abs_err(hi_k, hi_r))
        log(f"  lex_bounds [unpadded CAP={cap} KK={kk}; last key -> hi={int(hi_r[-3])}, "
            f"past it -> lo={int(lo_r[-2])}]: max_abs_err={err}")
        assert err == 0, f"lex_bounds on an unpadded table CAP={cap} disagrees with its plain version"


# ---------------------------------------------------------------------------
# Phases 3-5: the main path through the engine's entry points
# ---------------------------------------------------------------------------

def run_counted(ik, launches, fn):
    """Drive one main-path run with every launch count set to 0 just before
    it; add the counts read just after into ``launches``."""
    ik.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    seen = dict(ik.launches)
    for name, n in seen.items():
        launches[name] += n
    return out, seen


# ---------------------------------------------------------------------------
# Phase 5d: the distributed engine
# ---------------------------------------------------------------------------

def dist_line(stats, wall, extra=""):
    """Phase 5d's account of one run: its steps and what the collectives moved."""
    return (f"wall={wall:.3f} s steps={stats['sched_steps']} rounds={stats['rounds']} "
            f"a2a_calls={stats['a2a_calls']} pulled={stats['pulled_vids']} vids "
            f"({stats['pulled_bytes'] / 1e6:.3f} MB) shuffled={stats['shuffle_rows']} rows "
            f"({stats['shuffle_bytes'] / 1e6:.3f} MB) stolen={stats['steal_rows']} rows "
            f"({stats['steal_bytes'] / 1e6:.3f} MB) joins={stats['joins']} "
            f"probes={stats['probe_batches']} retries={stats['retries']}{extra}")


def phase_dist_full(ik, launches, big):
    """q3/huge fused at full width through ``DistributedEngine`` on a world of
    one rank over NCCL, set up and torn down around the run in this process:
    the layout of a one-card deployment, one shard holding the graph (a view
    of it, no copy), every lookup local."""
    from repro_torch.core.distributed import DistConfig, DistributedEngine, process_group
    from repro_torch.core.query import PAPER_QUERIES

    with process_group(DIST_FULL_BACKEND, DEV) as comm:
        eng = DistributedEngine(big, comm, DistConfig(**DIST_FULL_CFG))
        assert eng.adj.data_ptr() == big.padded.adj.data_ptr(), "the shard is not a view"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run():
            t0 = time.perf_counter()
            count, stats = eng.run(PAPER_QUERIES["q3"])
            torch.cuda.synchronize()
            return count, dict(stats), time.perf_counter() - t0

        ctrl0, a2a0, bytes0 = comm.ctrl_calls, comm.a2a_calls, comm.a2a_bytes
        (count, stats, wall), seen = run_counted(ik, launches, run)
        ctrl = comm.ctrl_calls - ctrl0
        log(f"phase 5d: q3/huge full width, 1 rank over {comm.backend}, fused: count={count} "
            f"(want {FULL_Q3}) " + dist_line(stats, wall, (
                f" control all-reduces={ctrl} ({ctrl / stats['sched_steps']:.2f} a step) "
                f"a2a sent={(comm.a2a_bytes - bytes0) / 1e9:.2f} GB in "
                f"{comm.a2a_calls - a2a0} calls "
                f"max_memory_allocated={torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
                f"launches={seen}")))
        del eng
    assert count == FULL_Q3, count
    assert stats["retries"] == 0 and stats["pulled_vids"] == 0 and stats["steal_rows"] == 0, stats
    assert seen["fused_extend"] > 0, "the fused extend kernel never ran in the distributed engine"


def dist_ranks_body(comm, cases, cfg_kw, moe_cfg, moe_tokens):
    """One rank of phase 5d's four-rank leg: every case on the table4 graph,
    each with its wall on this rank (ending in a sync), this rank's kernel
    launches and control all-reduces; then the MoE layer's case
    (``dist_moe_body``)."""
    from repro_torch.core.distributed import DistConfig, DistributedEngine
    from repro_torch.core.query import PAPER_QUERIES
    from repro_torch.graph import powerlaw_graph
    from repro_torch.kernels.intersect import ops as ik
    from repro_torch.launch.table4 import GRAPH

    graph = powerlaw_graph(GRAPH[0], GRAPH[1], seed=GRAPH[2], device=comm.device)
    engines = {f: DistributedEngine(graph, comm, DistConfig(fused=f, **cfg_kw))
               for f in (True, False)}
    sync = torch.cuda.synchronize if comm.device.type == "cuda" else (lambda: None)
    out = []
    for qname, space, fused, _ in cases:
        before, ctrl0 = dict(ik.launches), comm.ctrl_calls
        sync()
        t0 = time.perf_counter()
        count, stats = engines[fused].run(PAPER_QUERIES[qname], space=space)
        sync()
        out.append({"count": count, "stats": dict(stats), "wall_s": time.perf_counter() - t0,
                    "ctrl": comm.ctrl_calls - ctrl0,
                    "launches": {k: ik.launches[k] - before[k] for k in before}})
    del engines, graph
    return {"engine": out, "moe": dist_moe_body(comm, moe_cfg, moe_tokens)}


def dist_moe_body(comm, cfg, token_counts):
    """One rank of phase 5d's MoE case: one MoE layer at ``cfg``'s widths
    (the same weights on every rank, from a seed; this rank's
    experts, E / P of them, as views), and for each count of tokens a rank
    (the rank's own, from a seed) the push and the pull body against
    ``_moe_local`` on the rank's tokens with the whole weights: max |diff|
    over max |local|, whether bit-equal, the wall, the bytes each collective
    moved, and ``moe_dispatch_mode``'s model of them (forward only)."""
    from repro_torch.core.hybrid_comm import moe_dispatch_mode
    from repro_torch.models import moe as M

    k, p = cfg.experts_per_token, comm.world_size
    layer = M.moe_init(torch.Generator(device=comm.device).manual_seed(14), cfg.d_model,
                       cfg.moe_d_ff, cfg.num_experts, torch.bfloat16)
    e_loc = cfg.num_experts // p
    mine = slice(comm.rank * e_loc, (comm.rank + 1) * e_loc)
    ws = (layer.w_gate[mine], layer.w_up[mine], layer.w_down[mine])
    sync = torch.cuda.synchronize if comm.device.type == "cuda" else (lambda: None)
    out = []
    for t_loc in token_counts:
        gen = torch.Generator(device=comm.device).manual_seed(100 + comm.rank)
        # Hidden states about a mean of 1: the router's logits get a bias
        # per expert, so experts are loaded unevenly, as trained routers
        # load them.
        x = (1.0 + torch.randn((t_loc, cfg.d_model), generator=gen, device=comm.device)
             ).to(torch.bfloat16)
        M.stats = {}
        want = M._moe_local(layer, x[None], k, 1.25)[0].float()
        res = {"tokens": t_loc, "routed": t_loc * k, "kept": int(M.stats["kept"]),
               "cap": M._capacity(t_loc * k, cfg.num_experts, 1.25)}
        M.stats = None
        for mode, body in (("push", M._moe_push), ("pull", M._moe_pull)):
            a0, g0 = comm.a2a_bytes, comm.ag_bytes
            sync()
            t0 = time.perf_counter()
            got = body(x, layer.router, *ws, k, 1.25, comm)
            sync()
            wall = time.perf_counter() - t0
            res[mode] = {"rel_err": float((got.float() - want).abs().max() / want.abs().max()),
                         "equal": bool(torch.equal(got.float(), want)), "wall_s": wall,
                         "a2a_bytes": comm.a2a_bytes - a0, "ag_bytes": comm.ag_bytes - g0}
        dec = moe_dispatch_mode(
            tokens_per_step=t_loc * p, d_model=cfg.d_model, d_ff=cfg.moe_d_ff,
            num_experts=cfg.num_experts, experts_per_token=k, dp_degree=p, backward=False)
        res["model"] = {"mode": dec.mode, "push_bytes": dec.push_bytes,
                        "pull_bytes": dec.pull_bytes}
        out.append(res)
    return out


def phase_dist_ranks(ik, launches):
    """Four ranks on the one card over gloo: each case's count against the
    reference's, no retries, every rank agreeing, the unfused q3's schedule
    and traffic equal to the fused one's, and each of the three kernels of
    the path launched inside the ranks; then the MoE layer's case
    (``check_dist_moe``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import run_ranks

    t0 = time.perf_counter()
    moe_cfg = get_config("qwen3-moe-30b-a3b")
    ranks = run_ranks(dist_ranks_body, DIST_RANKS, backend="gloo", device=DEV, timeout_s=600,
                      args=(DIST_CASES, DIST_CFG, moe_cfg, DIST_MOE_TOKENS))
    log(f"phase 5d: {DIST_RANKS} ranks over gloo on one card (processes sharing it; "
        f"gloo stages the all-to-alls through host memory), DistConfig({DIST_CFG}), "
        f"spawn to results {time.perf_counter() - t0:.1f} s")
    runs = {}
    for i, (qname, space, fused, want) in enumerate(DIST_CASES):
        per = [r.value["engine"][i] for r in ranks]
        first = per[0]
        for other in per[1:]:
            assert (other["count"], other["stats"]) == (first["count"], first["stats"]), \
                f"ranks disagree on {qname}/{space}"
        seen = {k: sum(p["launches"][k] for p in per) for k in first["launches"]}
        if fused:  # the unfused run launches no kernel
            for k, n in seen.items():
                launches[k] += n
        wall = max(p["wall_s"] for p in per)
        st = first["stats"]
        log(f"phase 5d: {qname}/{space} {'fused' if fused else 'unfused'} count={first['count']} "
            f"(want {want}) " + dist_line(st, wall, (
                f" control all-reduces a rank={first['ctrl']} "
                f"({first['ctrl'] / st['sched_steps']:.2f} a step) "
                f"rank walls={[round(p['wall_s'], 3) for p in per]} launches={seen}")))
        assert first["count"] == want and st["retries"] == 0, (qname, space, first)
        runs[(qname, space, fused)] = (st, seen)
    fused_st, unfused_st = runs[("q3", "huge", True)][0], runs[("q3", "huge", False)][0]
    for key in ("rounds", "a2a_calls", "pulled_vids", "steal_rows", "sched_steps"):
        assert fused_st[key] == unfused_st[key], (key, fused_st, unfused_st)
    assert sum(runs[("q3", "huge", False)][1].values()) == 0
    total = {k: sum(seen[k] for (_, _, f), (_, seen) in runs.items() if f) for k in ik.launches}
    log(f"phase 5d: kernel launches inside the ranks {total}")
    for name in ("fused_extend", "fused_verify", "lex_bounds"):
        assert total[name] > 0, f"{name} never launched inside the ranks"
    check_dist_moe([r.value["moe"] for r in ranks], moe_cfg, DIST_MOE_TOKENS)


def check_dist_moe(by_rank, cfg, token_counts):
    """Phase 5d's MoE case, read from every rank's ``dist_moe_body``: push
    and pull within ``MOE_TOL_BF16`` of ``_moe_local`` on each rank, pairs
    dropped exactly where the capacity is below the routed pairs, and the
    bytes moved beside the dispatch model's."""
    for i, t_loc in enumerate(token_counts):
        per = [r[i] for r in by_rank]
        first = per[0]
        lossless, model = first["cap"] == first["routed"], first["model"]
        log(f"phase 5d: MoE layer at {cfg.name}'s widths, {t_loc} tokens a rank "
            f"({'lossless' if lossless else 'pairs dropped'}, cap {first['cap']}): kept "
            f"{[p['kept'] for p in per]} of {first['routed']} routed pairs a rank; "
            f"moe_dispatch_mode(forward) picks {model['mode']}: push {model['push_bytes']:.0f} "
            f"B, pull {model['pull_bytes']:.0f} B")
        for mode in ("push", "pull"):
            got = [p[mode] for p in per]
            moved = sum(g["a2a_bytes"] + g["ag_bytes"] for g in got)
            log(f"phase 5d:   {mode} vs _moe_local on each rank's tokens: relative "
                f"{max(g['rel_err'] for g in got):.2e} (tolerance {MOE_TOL_BF16:g}), bit-equal "
                f"on {sum(g['equal'] for g in got)} of {len(per)} ranks; all_to_all "
                f"{got[0]['a2a_bytes']} B and all_gather {got[0]['ag_bytes']} B a rank "
                f"({moved} B over the ranks, {moved / model[mode + '_bytes']:.2f} x the "
                f"model's); rank walls {[round(g['wall_s'], 3) for g in got]} s")
            assert all(g["rel_err"] < MOE_TOL_BF16 for g in got), (mode, t_loc, got)
        assert all((p["kept"] == p["routed"]) == lossless for p in per), per


# ---------------------------------------------------------------------------
# Phase 5e: the paper's suites on the kernels, and Exp-6 at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def launches_per_run(ik, mod):
    """Record the kernel launches of each ``run_query`` call a suite module
    makes (the suite looks the name up in its module at each call)."""
    seen = []
    real = mod.run_query

    def counted(*args, **kwargs):
        before = dict(ik.launches)
        res = real(*args, **kwargs)
        seen.append({n: ik.launches[n] - before[n] for n in before})
        return res

    mod.run_query = counted
    try:
        yield seen
    finally:
        mod.run_query = real


def phase_paper_suites(ik, launches):
    """The paper's suites beyond table4, service load and the distributed
    Table 1, each fused through its callable runner, their own asserts
    included: on phase 4's graph (q1 4361, q2 2551, q3 84), Exp-9 on
    powerlaw_graph(128, 6.0, seed=0) (q7 222,908, q8 6,106), chaos and
    streaming at their ``--smoke`` sizes. Every suite
    launches ``fused_extend``; Table 1's SEED row and Exp-1's seed rows
    launch ``lex_bounds``; chaos's kernel-fail case counts one
    ``kernel_fallbacks``. The launches count on the main path."""
    from repro_torch.graph import powerlaw_graph
    from repro_torch.launch import (
        exp1_plugin_plans,
        exp4_batching,
        exp5_cache,
        exp6_cache_design,
        exp7_scheduling,
        exp9_plans,
        exp10_scaling,
        exp_chaos,
        exp_streaming,
        table1_comm_modes,
    )
    from repro_torch.launch.common import bench_graph

    dev = torch.device(DEV)
    g512 = powerlaw_graph(*SUITE_GRAPH[:2], seed=SUITE_GRAPH[2], device=dev)
    g128 = powerlaw_graph(*EXP9_GRAPH[:2], seed=EXP9_GRAPH[2], device=dev)
    smoke = bench_graph(512, 6.0, seed=7, device=dev)
    suites = (
        ("table1", lambda: table1_comm_modes.table1(g512, True)),
        ("exp1", lambda: exp1_plugin_plans.exp1(g512, True)),
        ("exp4", lambda: exp4_batching.exp4(g512, True)),
        ("exp5", lambda: exp5_cache.exp5(g512, True)),
        ("exp6", lambda: exp6_cache_design.exp6(g512, True)),
        ("exp7", lambda: exp7_scheduling.exp7(g512, True)),
        ("exp9", lambda: exp9_plans.exp9(g128, True)),
        ("exp10", lambda: exp10_scaling.exp10(g512, True)),
        ("exp_chaos", lambda: exp_chaos.chaos(smoke, ["q1"], fused=True)),
        ("exp_streaming", lambda: exp_streaming.streaming(smoke, ["q1"], [8], 2, fused=True)),
    )
    # The suites whose runs' launches are checked one by one.
    per_run_of = {"table1": table1_comm_modes, "exp1": exp1_plugin_plans}
    for name, call in suites:
        t0 = time.perf_counter()
        with (launches_per_run(ik, per_run_of[name]) if name in per_run_of
              else contextlib.nullcontext()) as per_run:
            entries, seen = run_counted(ik, launches, call)
        wall = time.perf_counter() - t0
        log(f"phase 5e: {name}: {len(entries)} entries in {wall:.2f} s, launches={seen}")
        for e in entries:
            if "matches" not in e:  # Table 1's summary, an infeasible plan, a stream
                extra = {k: v for k, v in e.items()
                         if k.startswith("huge_") or k in ("infeasible", "new_matches")}
                log(f"phase 5e:   {e['name']} {json.dumps(extra)}")
                continue
            log(f"phase 5e:   {e['name']} count={e['matches']} steps={e['steps']} "
                f"hit_rate={e.get('hit_rate', 0):.3f} pulled={e['pulled_bytes']} "
                f"pushed={e['pushed_bytes']} peak_queue_bytes={e['peak_queue_bytes']} "
                f"retries={e['retries']} kernel_fallbacks={e['kernel_fallbacks']} "
                f"wall={e['wall_s']:.3f} s")
            query = e["name"].rsplit("/", 1)[-1].split("_")[0]
            want = {**SUITE_COUNTS, **EXP9_COUNTS}.get(query)
            if name not in ("exp_chaos", "exp_streaming"):
                assert e["matches"] == want, (e["name"], e["matches"], want)
        assert seen["fused_extend"] > 0, f"{name}: fused_extend never ran"
        if name == "table1":  # SEED is the first row
            assert per_run[0]["lex_bounds"] > 0, per_run[0]
        if name == "exp1":  # runs in pairs (native, HUGE's settings); seed is the third system
            seed = [p for i, p in enumerate(per_run)
                    if exp1_plugin_plans.SYSTEMS[i // 2 % 4] == "seed"]
            assert len(seed) == 4 and all(p["lex_bounds"] > 0 for p in seed[::2]), seed
        if name == "exp_chaos":
            fallbacks = {e["case"]: e["kernel_fallbacks"] for e in entries}
            assert fallbacks == {"q1_queue-overflow": 0, "q1_shard-loss": 0,
                                 "q1_kernel-fail": 1}, fallbacks
        if name == "exp_streaming":
            assert entries[0]["new_matches"] > 0


def phase_exp6_full(ik, launches, big, flow, lrbu=None):
    """Exp-6 at full width: q3/huge fused under FULL_CFG (cache 2^14 a
    machine, far below the working set there) with the policies of
    ``EXP6_FULL_POLICIES``; LRBU is phase 5's fused run (``lrbu``, run here
    when not given). Each count is phase 5's; the policies' hit rates,
    pulled bytes, walls and steps print side by side."""
    from repro_torch.core.engine import EngineConfig, HugeEngine

    rows = {} if lrbu is None else {"lrbu": lrbu}
    for policy in [p for p in EXP6_FULL_POLICIES if p not in rows]:
        torch.cuda.reset_peak_memory_stats()
        eng = HugeEngine(big, EngineConfig(fused=True, cache_policy=policy, **FULL_CFG))
        res, seen = run_counted(ik, launches, lambda: eng.run(flow))
        del eng
        s = res.stats
        rows[policy] = dict(count=res.count, hit_rate=s.hit_rate, hits=s.cache_hits,
                            misses=s.cache_misses, pulled=s.pulled_bytes, wall=s.wall_time,
                            steps=res.schedule.steps, launches=seen["fused_extend"],
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        assert res.count == FULL_Q3, (policy, res.count)
        assert seen["fused_extend"] > 0, f"fused_extend never ran under {policy}"
    for policy, r in rows.items():
        log(f"phase 5e: Exp-6 full width q3/huge fused {policy:6s} count={r['count']} "
            f"hit_rate={r['hit_rate']:.4f} hits={r['hits']} misses={r['misses']} "
            f"pulled={r['pulled'] / 1e6:.2f} MB wall={r['wall']:.2f} s steps={r['steps']} "
            f"fused_extend launches={r['launches']} peak={r['peak_gb']:.2f} GB")
    order = sorted(rows, key=lambda p: -rows[p]["hit_rate"])
    log(f"phase 5e: Exp-6 full width hit-rate order {' > '.join(order)}")


# ---------------------------------------------------------------------------
# Phase 5b: the single-process engine's other paths (recovery, §6 paths,
# streaming deltas) and the pre-flight's cost
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def preflight_times():
    """Time every ``verify_flow`` call the engine's ``prepare`` makes (the
    engine looks the function up in its module at each call). Yields the
    list of (query name, ops, seconds) it fills."""
    from repro_torch.analysis import flowcheck

    times = []
    verify = flowcheck.verify_flow

    def timed(flow, **kwargs):
        t0 = time.perf_counter()
        verify(flow, **kwargs)
        times.append((flow.query_name, len(flow.ops), time.perf_counter() - t0))

    flowcheck.verify_flow = timed
    try:
        yield times
    finally:
        flowcheck.verify_flow = verify


def log_preflight(phase, times):
    """One line per flow: its calls, ops and verify_flow's mean and max ms."""
    by_flow: Dict[str, list] = {}
    for name, n, sec in times:
        by_flow.setdefault(f"{name} ({n} ops)", []).append(sec * 1e3)
    for flow, ms in by_flow.items():
        log(f"{phase}: verify_flow in prepare, {flow}: {len(ms)} calls, mean "
            f"{sum(ms) / len(ms):.3f} ms, max {max(ms):.3f} ms")
    times.clear()


def phase_recovery(ik, launches):
    """Every fault kind the engine injects, on the table4 graph with the
    fused path: q1/huge for queue-overflow, shard-loss and kernel-fail, q2
    under starjoin (its joins run the bounds kernel) for join-overflow. The
    recovered count must be the fault-free one, the recovery counters must
    name the fault, and the kernels must launch again after the restore."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.engine import EngineConfig, HugeEngine
    from repro_torch.core.faults import FAULT_KINDS, FaultPlan
    from repro_torch.core.query import PAPER_QUERIES
    from repro_torch.graph import powerlaw_graph
    from repro_torch.launch.table4 import GRAPH

    g4k = powerlaw_graph(*GRAPH[:2], seed=GRAPH[2], device=torch.device(DEV))
    base = dict(batch_size=1024, queue_capacity=1 << 17, cache_capacity=1 << 13,
                num_machines=8, join_out_capacity=1 << 18, join_buffer_capacity=1 << 21,
                fused=True)
    marks = []  # launch counts at each restore
    restore = engine_mod.EngineSession.restore

    def marked(cls, *args, **kwargs):
        marks.append(dict(ik.launches))
        return restore(*args, **kwargs)

    engine_mod.EngineSession.restore = classmethod(marked)
    try:
        # The fault-free runs arm a plan that never fires: an armed plan
        # prices the queues with retry slack, and the slack moves the
        # scheduler's steps, so only under the same sizing do the launch
        # counts compare.
        clean = {}
        for qname, space, kernel in (("q1", "huge", "fused_extend"), ("q2", "starjoin", "lex_bounds")):
            res, seen = run_counted(ik, launches, lambda: HugeEngine(
                g4k, EngineConfig(faults=FaultPlan(), **base)).run(PAPER_QUERIES[qname], space=space))
            s = res.stats
            clean[qname] = (res.count, s.wall_time, seen)
            log(f"phase 5b: recovery baseline {qname}/{space} fused count={res.count} "
                f"wall={s.wall_time:.3f} s retries={s.retries} launches={seen}")
            assert res.count == TABLE4[qname] and s.retries == 0, (qname, res.count, s)
            assert seen[kernel] > 0
        # (kind, query, space, the kernel that must launch after the restore,
        # expected retries, restarts, pressure_events, kernel_fallbacks)
        for kind, qname, space, kernel, want in (
            ("queue-overflow", "q1", "huge", "fused_extend", (1, 0, 1, 0)),
            ("shard-loss", "q1", "huge", "fused_extend", (1, 1, 0, 0)),
            ("kernel-fail", "q1", "huge", "fused_extend", (0, 0, 0, 1)),
            ("join-overflow", "q2", "starjoin", "lex_bounds", (1, 0, 1, 0)),
        ):
            fp = FaultPlan.single(kind, at_step=1)
            marks.clear()
            res, seen = run_counted(ik, launches, lambda: HugeEngine(
                g4k, EngineConfig(faults=fp, **base)).run(PAPER_QUERIES[qname], space=space))
            s = res.stats
            got = (s.retries, s.restarts, s.pressure_events, s.kernel_fallbacks)
            count0, wall0, seen0 = clean[qname]
            after = seen[kernel] - marks[0][kernel] if marks else None
            log(f"phase 5b: recovery {kind} on {qname}/{space}: fired {fp.fired} "
                f"count={res.count} (fault-free {count0}) retries/restarts/pressure/"
                f"fallbacks={got} wall={s.wall_time:.3f} s (fault-free {wall0:.3f} s) "
                f"{kernel} launches={seen[kernel]} (fault-free {seen0[kernel]}; "
                f"after the restore {after})")
            assert fp.fired_count(kind) == 1 and res.count == count0 and got == want, (kind, got)
            if kind == "kernel-fail":  # one batch took the plain path, the rest the kernel
                assert seen[kernel] == seen0[kernel] - 1, (seen, seen0)
            else:
                assert len(marks) == 1 and after > 0, (kind, marks, seen)
        # The fifth kind is the service's admission fault (phase 5c).
        assert set(FAULT_KINDS) - {"queue-overflow", "shard-loss", "kernel-fail",
                                   "join-overflow"} == {"lease-oom"}
    finally:
        engine_mod.EngineSession.restore = restore


def phase_paths(graph):
    """``shortest_path_length`` on the full-width graph for seeded vertex
    pairs, against scipy's breadth-first distances over the same CSR."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path

    from repro_torch.core.paths import shortest_path_length

    v = graph.num_vertices
    offsets = graph.offsets.cpu().numpy()
    nbrs = graph.nbrs.cpu().numpy()
    csr = sp.csr_matrix((np.ones(nbrs.shape[0], np.int8), nbrs, offsets), shape=(v, v))
    rng = np.random.default_rng(PATH_SEED)
    pairs = [tuple(int(x) for x in rng.choice(v, 2, replace=False)) for _ in range(PATH_PAIRS)]
    t0 = time.perf_counter()
    want = shortest_path(csr, unweighted=True, indices=[s for s, _ in pairs])
    scipy_s = time.perf_counter() - t0
    got, walls = [], []
    for s, t in pairs:
        t0 = time.perf_counter()
        got.append(shortest_path_length(graph, s, t))
        walls.append(time.perf_counter() - t0)
    ref = [None if math.isinf(want[i, t]) else int(want[i, t]) for i, (_, t) in enumerate(pairs)]
    log(f"phase 5b: shortest paths {pairs}: port {got} scipy {ref}; port walls "
        f"{[round(w, 4) for w in walls]} s, scipy {scipy_s:.3f} s for all {len(pairs)} sources")
    assert got == ref, (got, ref)


def wedge_batches(graph, batches, per_batch, seed):
    """``batches`` batches of ``per_batch`` new edges, each closing a wedge:
    two neighbours a, b of a vertex c that are not adjacent (a random edge of
    a sparse power-law graph seldom makes any match). Every second edge
    closes two wedges (a and b also share a neighbour d), so that it makes
    a diamond too: single wedges made no new diamond here."""
    offsets = graph.offsets.cpu().numpy().astype(np.int64)
    nbrs = graph.nbrs.cpu().numpy()

    def row(v):
        return nbrs[offsets[v]:offsets[v + 1]]

    centres = np.flatnonzero(np.diff(offsets) >= 2)
    rng = np.random.default_rng(seed)
    chosen = []
    seen = set()
    while len(chosen) < batches * per_batch:
        c = int(rng.choice(centres))
        a = int(rng.choice(row(c)))
        if len(chosen) % 2:
            others = row(a)[row(a) != c]
            if others.size == 0:
                continue
            d = int(rng.choice(others))  # a second wedge a-d-b
            pool = np.intersect1d(row(c), row(d), assume_unique=True)
        else:
            pool = row(c)
        pool = pool[pool != a]
        if pool.size == 0:
            continue
        b = int(rng.choice(pool))
        ra = row(a)
        j = np.searchsorted(ra, b)
        pair = (min(a, b), max(a, b))
        if (j < ra.shape[0] and ra[j] == b) or pair in seen:
            continue
        seen.add(pair)
        chosen.append(pair)
    return np.split(np.array(chosen, dtype=np.int64), batches)


def streaming_engines(graph):
    """The fused and the plain engine of the streaming phase, over one graph."""
    from repro_torch.core.engine import EngineConfig, HugeEngine

    return (HugeEngine(graph, EngineConfig(fused=True, **FULL_CFG)),
            HugeEngine(graph, EngineConfig(fused=False, **FULL_CFG)))


def phase_streaming(ik, launches, fused_eng, plain_eng, before):
    """Batches of inserts at full width through both engines' apply_updates,
    each followed by run_delta of every standing query: fused and plain delta
    counts equal batch by batch, and the delta counts of all batches add up
    to the difference between the full counts before them (``before``, the
    service's counts of phase 5c) and after them (exactly once)."""
    from repro_torch.core.engine import EngineConfig, HugeEngine
    from repro_torch.core.query import PAPER_QUERIES, triangle
    from repro_torch.graph import GraphUpdateBatch

    queries = {name: triangle() if name == "triangle" else PAPER_QUERIES[name]
               for name in STREAM_QUERIES}

    def full_counts():
        out = {}
        for name, q in queries.items():
            res = HugeEngine(fused_eng.graph, EngineConfig(fused=False, **FULL_CFG)).run(q)
            out[name] = res.count
            log(f"phase 5b: full count {name} = {res.count} in {res.stats.wall_time:.2f} s "
                f"(plain, {res.schedule.steps} steps)")
        return out

    torch.cuda.reset_peak_memory_stats()
    batches = wedge_batches(fused_eng.graph, STREAM_BATCHES, STREAM_EDGES, STREAM_SEED)
    totals = {name: 0 for name in queries}
    for k, edges in enumerate(batches):
        d_pad = fused_eng.d_pad
        applied = {}
        for label, eng in (("fused", fused_eng), ("plain", plain_eng)):
            t0 = time.perf_counter()
            upd = eng.apply_updates(GraphUpdateBatch(edges))
            torch.cuda.synchronize()
            # Keep numbers only: the result holds the new graph, and the
            # next update must find the old one unreferenced.
            applied[label] = (upd.num_new_edges, upd.touched.shape[0], time.perf_counter() - t0)
            del upd
        (new, touched, upd_s), plain_s = applied["fused"], applied["plain"][2]
        log(f"phase 5b: batch {k}{' (warm-up)' if k == 0 else ''}: {new} new edges, "
            f"{touched} touched rows, apply_updates {upd_s * 1e3:.1f} ms fused engine, "
            f"{plain_s * 1e3:.1f} ms plain engine, d_pad {d_pad} -> {fused_eng.d_pad}"
            f"{' (grew)' if fused_eng.d_pad != d_pad else ''}, "
            f"memory_allocated={torch.cuda.memory_allocated() / 1e9:.2f} GB")
        assert new == STREAM_EDGES and applied["plain"][:2] == (new, touched)
        # Only the two engines' graphs are alive: nothing else (no finished
        # or unfinished session) still holds an earlier one.
        adj = fused_eng.adj.numel() * 4
        assert torch.cuda.memory_allocated() < 2.5 * adj, (torch.cuda.memory_allocated(), adj)
        for name, q in queries.items():
            res, seen = run_counted(ik, launches, lambda: fused_eng.run_delta(q))
            plain = plain_eng.run_delta(q)
            log(f"phase 5b: batch {k} {name}: run_delta fused {res.stats.wall_time * 1e3:.1f} ms "
                f"new matches {res.count}; plain {plain.stats.wall_time * 1e3:.1f} ms "
                f"new matches {plain.count}; launches={seen}")
            assert res.count == plain.count, (k, name, res.count, plain.count)
            assert seen["fused_extend"] > 0, "the fused extend kernel never ran in a delta"
            totals[name] += res.count
    after = full_counts()
    for name in queries:
        log(f"phase 5b: {name}: delta counts of batches 0-{STREAM_BATCHES - 1} sum to "
            f"{totals[name]}; full counts {before[name]} -> {after[name]} "
            f"(difference {after[name] - before[name]})")
        assert totals[name] == after[name] - before[name], (name, totals, before, after)
    log(f"phase 5b: max_memory_allocated={torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


# ---------------------------------------------------------------------------
# Phase 5c: the multi-tenant graph service on the fused kernels
# ---------------------------------------------------------------------------

def ticket_line(t, cells):
    req = t.request
    name = req.query if isinstance(req.query, str) else req.query.name
    return (f"#{t.id} {req.tenant} {name}/{req.space} -> {t.status} count={t.count} "
            f"cells={cells.get(t.id)} latency={t.latency_s:.3f} s "
            f"wait={t.queue_wait_s if t.queue_wait_s is None else round(t.queue_wait_s, 3)} s "
            f"attempts={t.attempts} failures={t.failures}")


def drive(svc, tickets, ticks=None):
    """Tick ``svc`` (``ticks`` times, or until idle) and keep each ticket's
    priced cells, which the service zeroes when the lease goes back."""
    cells = {}
    n = 0
    while (svc.active or svc.admission) and (ticks is None or n < ticks):
        svc.tick()
        n += 1
        cells.update({t.id: t.queue_cells for t in tickets if t.queue_cells})
    return cells


def phase_service_load(ik, launches):
    """``launch/service_load`` at its defaults (T3xR4 on powerlaw_graph(1024,
    6.0, seed=7)), unfused as the reference runs it, then fused; the
    entries are appended to SERVICE_BENCH."""
    from repro_torch.launch import service_load

    got = []
    for fused in (False, True):
        args = ["--out", SERVICE_BENCH] + (["--fused"] if fused else [])
        e, seen = run_counted(ik, launches, lambda: service_load.main(args))
        log(f"phase 5c: reference load {e['case']} {'fused' if fused else 'unfused'}: "
            f"matches={e['matches']} wall={e['wall_s']:.3f} s "
            f"matches/s={e['matches_per_s']:.1f} p50={e['p50_s']:.3f} s "
            f"p99={e['p99_s']:.3f} s ticks={e['ticks']} peak_pool_cells={e['peak_pool_cells']} "
            f"peak_inflight_rows={e['peak_inflight_rows']} launches={seen} "
            f"on {e['device']}, {e['power_limit']}")
        assert (e["case"], e["matches"], e["ticks"], e["peak_pool_cells"]) == \
            ("T3xR4_v1024", 59500, 13, 1984512), e  # BENCH_service.json's
        assert (seen["fused_extend"] > 0) if fused else not any(seen.values()), seen
        got.append(e)
    assert got[0]["peak_inflight_rows"] == got[1]["peak_inflight_rows"], got


def phase_service_table4(ik, launches):
    """The service on the table4 graph, fused, batch 256: four tenants whose
    plans run fused_extend, lex_bounds (q2/seed's PUSH-JOIN) and
    fused_verify (q3/rads); a lease-oom at the first admission and a
    queue-overflow under checkpoints every tick, both recovered; then
    standing triangle and q2 over a batch of wedge-closing edges, whose
    deltas must be the full counts' difference."""
    from repro_torch.core.engine import EngineConfig, HugeEngine
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.query import PAPER_QUERIES, triangle
    from repro_torch.graph import GraphUpdateBatch, powerlaw_graph
    from repro_torch.launch.table4 import GRAPH
    from repro_torch.serve.graph_service import GraphQueryRequest, GraphService, ServiceConfig

    g4k = powerlaw_graph(*GRAPH[:2], seed=GRAPH[2], device=torch.device(DEV))
    lease = FaultPlan.single("lease-oom", op="admit", at_step=0)
    # Past the first two ticks (at most 224 steps), so that every session
    # has a checkpoint when it fires.
    overflow = FaultPlan.single("queue-overflow", op="ext", at_step=300)
    svc = GraphService(g4k, ServiceConfig(join_buffer_capacity=1 << 21, checkpoint_every_ticks=1,
                                          faults=lease),
                       EngineConfig(batch_size=256, fused=True, faults=overflow))

    def serve():
        t0 = time.perf_counter()
        tickets = [svc.submit(GraphQueryRequest(tenant=t, query=q, space=s))
                   for t, q, s, _ in SERVICE_TABLE4]
        cells = drive(svc, tickets)
        torch.cuda.synchronize()
        return tickets, cells, time.perf_counter() - t0

    (tickets, cells, wall), seen = run_counted(ik, launches, serve)
    for t, (_, _, _, want) in zip(tickets, SERVICE_TABLE4):
        log(f"phase 5c: table4 graph {ticket_line(t, cells)} (want {want}) "
            f"retries={t.stats.retries} pressure_events={t.stats.pressure_events}")
        assert t.status == "done" and t.count == want, (t.status, t.count, want, t.error)
    log(f"phase 5c: table4 graph service wall={wall:.3f} s ticks={svc.ticks} "
        f"peak_pool_cells={svc.peak_pool_cells} peak_inflight_rows={svc.peak_inflight_rows} "
        f"launches={seen}")
    for name in ("fused_extend", "fused_verify", "lex_bounds"):
        assert seen[name] > 0, f"{name} never ran in the service's sessions"
    leased = [t for t in tickets if any("lease-oom" in f for f in t.failures)]
    assert lease.fired_count("lease-oom") == 1 and leased == tickets[:1], lease.fired
    hit = [t for t in tickets if any("queue-overflow" in f for f in t.failures)]
    assert overflow.fired_count("queue-overflow") == 1 and len(hit) == 1, overflow.fired
    assert hit[0].attempts == 1 and hit[0].stats.pressure_events == 1  # degraded in place
    assert svc.pool.leased_cells == 0 and not svc.active

    queries = {"triangle": triangle(), "q2": PAPER_QUERIES["q2"]}
    standing = {name: svc.register_standing(f"standing-{name}", q) for name, q in queries.items()}
    plain = dict(batch_size=1024, queue_capacity=1 << 17, cache_capacity=1 << 13,
                 join_out_capacity=1 << 18, join_buffer_capacity=1 << 21)

    def full_counts():
        return {name: HugeEngine(svc.engine.graph, EngineConfig(**plain)).run(q).count
                for name, q in queries.items()}

    before = full_counts()
    edges = wedge_batches(svc.engine.graph, 1, STREAM_EDGES, STREAM_SEED)[0]
    t0 = time.perf_counter()
    out, seen = run_counted(ik, launches, lambda: svc.apply_batch(GraphUpdateBatch(edges)))
    wall = time.perf_counter() - t0
    after = full_counts()
    for name, sq in standing.items():
        got = out["deltas"][sq.id]
        log(f"phase 5c: standing {name}: delta {got}; full counts {before[name]} -> "
            f"{after[name]} (difference {after[name] - before[name]})")
        assert got == after[name] - before[name], (name, got, before, after)
    log(f"phase 5c: apply_batch of {out['new_edges']} edges ({out['touched_vertices']} touched "
        f"rows) with its delta tickets {wall * 1e3:.1f} ms, launches={seen}")
    assert out["new_edges"] == STREAM_EDGES and before["q2"] == TABLE4["q2"]
    assert all(t.status == "done" for t in out["tickets"]) and svc.pool.leased_cells == 0


def phase_service_full(ik, launches, big):
    """The service at full width, fused, phase 5's configuration (batch
    1024), two tenants at once, each count its full count (triangle's is
    returned beside q2's full count: phase 5b's streaming starts from them);
    a profiled window of a second service, its requests then cancelled;
    device memory back to its pre-submit level after each, with the cycle
    collector off."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.query import PAPER_QUERIES, triangle
    from repro_torch.serve.graph_service import GraphQueryRequest, GraphService, ServiceConfig

    cfg = EngineConfig(fused=True, **FULL_CFG)
    scfg = ServiceConfig(tick_steps=32, max_active=4, total_queue_cells=SERVICE_FULL_POOL)
    queries = {"q3": PAPER_QUERIES["q3"], "triangle": triangle(), "q2": PAPER_QUERIES["q2"]}

    def submit(svc):
        return [svc.submit(GraphQueryRequest(tenant=t, query=queries[q], match_budget=b))
                for t, q, b in SERVICE_FULL]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.disable()
    try:
        # A profiled window of SERVICE_PROFILE_TICKS ticks after 3 warm-up
        # ticks; then every request is cancelled.
        svc = GraphService(big, scfg, cfg)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()

        def window():
            tickets = submit(svc)
            drive(svc, tickets, 3)
            steps0 = sum(t.stats.batches for t in tickets)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                drive(svc, tickets, SERVICE_PROFILE_TICKS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            steps = sum(t.stats.batches for t in tickets) - steps0
            for t in tickets:
                if t.status in ("queued", "running"):
                    assert svc.cancel(t) and t.status == "cancelled"
            torch.cuda.synchronize()
            return prof, wall, steps, [t.status for t in tickets]

        (prof, pwall, psteps, statuses), seen = run_counted(ik, launches, window)
        cancelled = torch.cuda.memory_allocated()
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy_us = sum(t for _, t, _ in rows)
        ours = sum(t for k, t, _ in rows if any(f"{n}_kernel" in k for n in REPLACES))
        log(f"phase 5c: profile of {SERVICE_PROFILE_TICKS} full-width service ticks "
            f"({psteps} steps): wall={pwall * 1e3:.1f} ms device busy={busy_us / 1e3:.1f} ms "
            f"(port's kernels {ours / 1e3:.1f} ms, {ours / max(busy_us, 1e-9):.3f} of busy) "
            f"idle share={1 - busy_us / 1e3 / (pwall * 1e3):.3f} launches={seen}")
        for key, t, n in sorted(rows, key=lambda r: -r[1])[:8]:
            log(f"phase 5c:   device {t / 1e3:9.2f} ms  x{n:<6d} {key[:90]}")
        log(f"phase 5c: memory_allocated {base / 1e9:.4f} GB before the window's submits, "
            f"{cancelled / 1e9:.4f} GB after its cancels (statuses {statuses})")
        assert abs(cancelled - base) <= MEM_SLACK, (base, cancelled)
        del svc, prof

        svc = GraphService(big, scfg, cfg)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()

        def serve():
            t0 = time.perf_counter()
            tickets = submit(svc)
            cells = drive(svc, tickets, 1)
            summary = svc.run_until_idle()
            torch.cuda.synchronize()
            return tickets, cells, summary, time.perf_counter() - t0

        (tickets, cells, summary, wall), seen = run_counted(ik, launches, serve)
        done = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    steps = sum(t.stats.batches for t in tickets)
    lat = [t.latency_s for t in tickets]
    matches = sum(t.count for t in tickets)
    for t in tickets:
        log(f"phase 5c: full width {ticket_line(t, cells)} steps={t.stats.batches}")
    log(f"phase 5c: full width service wall={wall:.2f} s ticks={summary['ticks']} "
        f"steps={steps} p50={np.percentile(lat, 50):.2f} s p99={np.percentile(lat, 99):.2f} s "
        f"matches/s={matches / wall:.1f} peak_pool_cells={summary['peak_pool_cells']} "
        f"(pool {svc.pool.total_cells}) peak_inflight_rows={summary['peak_inflight_rows']} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 1e9:.2f} GB launches={seen}")
    per_step = busy_us / 1e3 / max(psteps, 1)
    log(f"phase 5c: device busy {per_step:.4f} ms a step (profiled window) -> "
        f"estimated idle share of the service run {1 - per_step * steps / (wall * 1e3):.3f}")
    log(f"phase 5c: memory_allocated {base / 1e9:.4f} GB before the first submit, "
        f"{done / 1e9:.4f} GB after run_until_idle (no gc.collect())")
    assert abs(done - base) <= MEM_SLACK, (base, done)
    by = {q: t for (_, q, _), t in zip(SERVICE_FULL, tickets)}
    assert cells.keys() == {t.id for t in tickets}, "the pool did not hold every session"
    assert by["q3"].status == "done" and by["q3"].count == FULL_Q3, by["q3"]
    counts = dict(FULL_COUNTS)
    for name in set(by) & set(FULL_COUNTS):
        assert by[name].status == "done" and by[name].count == FULL_COUNTS[name], by[name]
    assert svc.pool.leased_cells == 0 and not svc.active
    assert seen["fused_extend"] > 0
    return counts


# ---------------------------------------------------------------------------
# Phase 6: the RWKV6 kernel against its plain version at the LM path's shapes
# ---------------------------------------------------------------------------

def rwkv_inputs(bh, t, gen, kd=64, vd=64, dtype=torch.bfloat16):
    """r, k, v as the model's projections give them (unit scale), w from the
    model's decay formula around its w0 = -2, u at its init scale."""
    dev = gen.device
    r, k = (torch.randn((bh, t, kd), generator=gen, device=dev) for _ in range(2))
    v = torch.randn((bh, t, vd), generator=gen, device=dev)
    logdecay = -2.0 + torch.randn((bh, t, kd), generator=gen, device=dev)
    w = torch.exp(-torch.exp(logdecay.clamp(-8.0, 1.2)))
    u = torch.randn((bh, kd), generator=gen, device=dev) * 0.3
    return [x.to(dtype).contiguous() for x in (r, k, v, w)] + [u]


def rwkv_bound(args, with_state):
    """(bound ms, what bounds it, bytes, flops): every input read once, out
    (and the state) written once, at 3.35 TB/s; against 4*BH*T*K*V float32
    operations at 67 TFLOP/s."""
    r, v = args[0], args[2]
    bh, t, kd = r.shape
    vd = v.shape[-1]
    nbytes = sum(x.numel() * x.element_size() for x in args) + bh * t * vd * 4
    nbytes += bh * kd * vd * 4 if with_state else 0
    flops = 4 * bh * t * kd * vd
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), \
        nbytes, flops, bytes_ms, ops_ms


def phase_rwkv6_kernel(rk):
    from repro_torch.kernels.rwkv6.ref import rwkv6_ref

    log("phase 6: rwkv6 kernel vs its plain version (bf16 inputs, K=V=64)")
    gen = torch.Generator(device=DEV).manual_seed(6)
    out = {"max_abs_err": 0.0, "configs": []}
    for what, bh, t, with_state in RWKV_SHAPES:
        args = rwkv_inputs(bh, t, gen)
        got = rk.rwkv6(*args, return_state=with_state)
        want_o, want_s = rwkv6_ref(*args, return_state=True)
        torch.cuda.synchronize()
        pairs = [(got[0] if with_state else got, want_o)] + ([(got[1], want_s)] if with_state else [])
        errs = [float((g - w).abs().max()) for g, w in pairs]
        scale = max(float(w.abs().max()) for _, w in pairs)
        rel = max(errs) / max(1.0, scale)
        assert rel < RWKV_TOL, f"rwkv6 {what} T={t}: max |diff| {max(errs)} / max |plain| {scale}"
        call, (ms, lo, hi) = timed(lambda: rk.rwkv6(*args, return_state=with_state))
        # The plain version runs tens of torch ops a step: CUDA events around
        # one call (three calls after one warm-up), not profiled (reading the
        # profiler's records of three one-call windows took 85-100 s of the
        # phase on an H100 80GB).
        pcall = call_ms(lambda: rwkv6_ref(*args, return_state=with_state), iters=1,
                        repeats=3, warmup=1)
        bound, by, nbytes, flops, bytes_ms, ops_ms = rwkv_bound(args, with_state)
        shape = f"BH={bh} T={t} K=V=64 bf16" + (" +state" if with_state else "")
        out["configs"].append(dict(
            shape=shape, ms=ms, ms_min=lo, ms_max=hi, call_ms=call[0], call_ms_min=call[1],
            call_ms_max=call[2], plain_ms=pcall[0], bound_ms=bound,
            bound_by=by, bound_bytes=nbytes, bound_flops=flops, max_abs_err=max(errs),
            rel_err=rel, library_ms=None))
        out["max_abs_err"] = max(out["max_abs_err"], max(errs))
        log(f"  rwkv6 [{what}: {shape}]: max_abs_err={max(errs):.3e} (out"
            f"{', state' if with_state else ''}; max |plain| {scale:.3f}, relative {rel:.2e}, "
            f"tolerance {RWKV_TOL:g}) | kernel queued={ms:.4f} ms (min {lo:.4f}, "
            f"max {hi:.4f}) "
            f"call={call[0]:.4f} ms (min {call[1]:.4f}, max {call[2]:.4f}) | plain call="
            f"{pcall[0]:.4f} ms (CUDA events, min {pcall[1]:.4f}, max {pcall[2]:.4f}) | "
            f"bound={bound:.4f} ms by {by} "
            f"(bytes {nbytes} -> {bytes_ms:.4f} ms at 3.35 TB/s; {flops} flop -> "
            f"{ops_ms:.4f} ms at 67 TFLOP/s f32) | library: none")
        del args, got, want_o, want_s, pairs
    out["edges"] = rwkv_edge_checks(rk, rwkv6_ref, gen)
    return out


def rwkv_edge_checks(rk, rwkv6_ref, gen):
    """The kernel against its plain version at each of ``RWKV_EDGES`` (every
    w set to it, or drawn from all of them), at the serve-prefill shape with
    the state out, untimed. Returns each edge's relative error."""
    _, bh, t, _ = RWKV_SHAPES[1]
    levels = torch.tensor([x for x in RWKV_EDGES.values() if x is not None], device=DEV)
    errs = {}
    for edge, value in RWKV_EDGES.items():
        args = rwkv_inputs(bh, t, gen)
        shape = args[3].shape
        w = (levels[torch.randint(0, len(levels), shape, generator=gen, device=DEV)]
             if value is None else torch.full(shape, value, device=DEV))
        args[3] = w.to(args[3].dtype)
        got_o, got_s = rk.rwkv6(*args, return_state=True)
        want_o, want_s = rwkv6_ref(*args, return_state=True)
        torch.cuda.synchronize()
        scale = max(float(want_o.abs().max()), float(want_s.abs().max()))
        err = max(float((got_o - want_o).abs().max()), float((got_s - want_s).abs().max()))
        rel = err / max(1.0, scale)
        errs[edge] = rel
        log(f"  rwkv6 [decay edge {edge}: BH={bh} T={t} K=V=64 bf16 +state]: max_abs_err="
            f"{err:.3e} (max |plain| {scale:.3f}, relative {rel:.2e}, tolerance {RWKV_TOL:g}), "
            f"finite: {bool(torch.isfinite(got_o).all() and torch.isfinite(got_s).all())}")
        assert rel < RWKV_TOL and bool(torch.isfinite(got_o).all()), (edge, err, scale)
        del args, got_o, got_s, want_o, want_s
    return errs


# ---------------------------------------------------------------------------
# Phase 9: the flash attention kernel against its plain version and SDPA
# ---------------------------------------------------------------------------

def attention_bound(q, k, v, causal, window=None):
    """(bound ms, what bounds it, bytes, flops, pairs): q, the keys and values
    some row sees (under a sliding window, from row 0's lower edge on), each
    read once and the output written once at 3.35 TB/s, against 4 * Dh
    operations for each (query, visible key) pair at the dtype's peak (989
    TFLOP/s on the tensor cores in bf16, 67 TFLOP/s float32 outside them).
    Row i sees keys [i + Sk - Sq - window + 1, i + Sk - Sq] within [0, Sk)."""
    bhq, sq, dh = q.shape
    sk = k.shape[1]
    pos = torch.arange(sq, dtype=torch.int64) + (sk - sq)  # row i's diagonal key
    hi = (pos + 1).clamp(0, sk) if causal else torch.full_like(pos, sk)
    lo = torch.zeros_like(pos) if window is None else (pos - window + 1).clamp(0, sk)
    pairs = int((hi - lo).clamp(min=0).sum()) * bhq
    flops = 4 * pairs * dh
    first = int(lo[0])  # no row sees a key before row 0's lower edge
    kv_bytes = sum(x[:, first:].numel() * x.element_size() for x in (k, v))
    nbytes = 2 * q.numel() * q.element_size() + kv_bytes
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), \
        nbytes, flops, pairs


def flash_errs(got, want):
    """(max |got - want|, the worst row's max |got - want| over its max
    |want|) over [..., Sq, Dh] outputs; a row that is 0 in both reads 0."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    return float(diff.max()), float((diff.amax(-1) / scale).max())


def flash_check_can_fail(attention_chunked, q, k, v, cap, want, row_tol, what, window=None,
                         causal=True):
    """Whether the check above could fail: the plain version with a fault put
    into it, on the last (up to 128) query rows, read as the check reads the
    kernel. The faults: the keys of the last 64-key tile lost (their V
    zeroed), the softcap dropped, and the sliding window dropped (every
    earlier key seen). Returns their readings."""
    n = min(q.shape[1], 128)
    tail = k.shape[1] - (k.shape[1] - 1) // 64 * 64
    v_lost = v.clone()
    v_lost[:, -tail:] = 0
    faults = {"tail lost": (v_lost, cap, window)}
    if cap is not None:
        faults["softcap dropped"] = (v, None, window)
    if window is not None:
        faults["window dropped"] = (v, cap, None)
    out = {}
    for fault, (vf, capf, winf) in faults.items():
        bad = attention_chunked(q[:, -n:], k, vf, causal=causal, softcap=capf, window=winf)
        out[fault] = flash_errs(bad, want[:, -n:])
        assert out[fault][1] > row_tol, f"flash_attention {what}: the check misses '{fault}'"
    return out


def phase_flash_kernel(fa):
    """The kernel at granite's forward, serve-prefill and decode shapes, at
    gemma2's softcap branch, its local layers' sliding window and its global
    layers' prefill and decode, at chatglm3's decode and forward,
    command-r's forward, seamless-m4t's non-causal encoder, prefill,
    served-prefill and decode cross-attention shapes and phi-3-vision's
    Dh-96 forward and decode (bf16, the tensor-core forms), and at the float32
    check's prefill and decode shapes and gemma2's float32 window (the f32
    form), each against the plain version (the wrapper's CPU path, run on the
    card), with the readings of faults put into the plain version beside it,
    and timed beside SDPA where one SDPA call computes the same function
    (every shape without a softcap or a window; at those no library call
    does, and the library time is None). Kernel and library are timed the
    same way, by ``queued_ms``, the plain version by CUDA events around its
    calls (``call_ms``); the form the kernel ran is read from its
    per-form launch counts and must be the one ``kernel_form`` names. Each
    shape's line gives the seconds it took."""
    from repro_torch.kernels.flash_attention.ops import attention_chunked

    sdpa = torch.nn.functional.scaled_dot_product_attention
    log("phase 9: flash attention kernel vs its plain version and SDPA")
    gen = torch.Generator(device=DEV).manual_seed(9)
    out = {"max_abs_err": 0.0, "configs": []}
    for what, b, hq, hkv, sq, sk, dh, cap, dtype, window, causal in FLASH_SHAPES:
        t_shape = time.perf_counter()
        q = torch.randn((b * hq, sq, dh), generator=gen, device=DEV)
        if cap is not None:
            q *= SOFTCAP_Q_SCALE
        q = q.to(dtype)
        k = torch.randn((b * hkv, sk, dh), generator=gen, device=DEV).to(dtype)
        v = torch.randn((b * hkv, sk, dh), generator=gen, device=DEV).to(dtype)
        before = dict(fa.launches_by_form)
        got = fa.attention(q, k, v, causal=causal, softcap=cap, window=window)
        (form,) = [f for f, n in fa.launches_by_form.items() if n > before[f]]
        assert form == fa.kernel_form(dtype, sq, hq // hkv), (what, form)
        want = attention_chunked(q, k, v, causal=causal, softcap=cap, window=window)
        torch.cuda.synchronize()
        err, row_err = flash_errs(got, want)
        tol, row_tol = FLASH_TOL[dtype], FLASH_ROW_TOL[dtype]
        assert err < tol and row_err < row_tol, (
            f"flash_attention {what}: max |kernel - plain| {err} (tolerance {tol}), worst row "
            f"{row_err} of its max |plain| (tolerance {row_tol})")
        faults = flash_check_can_fail(attention_chunked, q, k, v, cap, want, row_tol, what,
                                      window, causal)

        def kernel():
            return fa.attention(q, k, v, causal=causal, softcap=cap, window=window)

        call = call_ms(kernel)
        ms, lo, hi = queued_ms(kernel)
        # The plain version by CUDA events around its calls (profiled windows
        # of it took most of a shape's seconds; PERF.md §4).
        big = sq * sk * b * hq > 1 << 28
        pcall = call_ms(
            lambda: attention_chunked(q, k, v, causal=causal, softcap=cap, window=window),
            iters=1 if big else 5, repeats=3, warmup=1)
        q4, k4, v4 = q.view(b, hq, sq, dh), k.view(b, hkv, sk, dh), v.view(b, hkv, sk, dh)
        lib_ms = lib_call = lib_err = ratio = None
        if cap is None and window is None:
            # One SDPA call on the same inputs as [B, H, S, Dh] views; causal at
            # Sq = 1 sees every key, elsewhere Sq = Sk and SDPA's top-left
            # causal diagonal is ours; non-causal is SDPA's unmasked attention.
            assert not causal or sq == 1 or sq == sk

            def lib():
                return sdpa(q4, k4, v4, is_causal=causal and sq > 1, enable_gqa=True)

            lib_err = flash_errs(lib().reshape(got.shape), want)[0]
            lib_call, lib_ms = call_ms(lib), queued_ms(lib)
            ratio = ms / lib_ms[0]
        bound, by, nbytes, flops, pairs = attention_bound(q, k, v, causal, window)
        shape = (f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} Dh={dh} "
                 f"{'causal' if causal else 'non-causal'} {str(dtype)[6:]}" +
                 (f" window={window}" if window else "") +
                 (f" softcap={cap:g}, q x{SOFTCAP_Q_SCALE:g}" if cap else ""))
        tflops, gbs = flops / (ms * 1e-3) / 1e12, nbytes / (ms * 1e-3) / 1e9
        out["configs"].append(dict(
            shape=shape, form=form, ms=ms, ms_min=lo, ms_max=hi, call_ms=call[0],
            call_ms_min=call[1], call_ms_max=call[2], tflops=tflops, gb_per_s=gbs,
            plain_ms=pcall[0], plain_call_ms=pcall[0], bound_ms=bound, bound_by=by,
            bound_bytes=nbytes, bound_flops=flops, max_abs_err=err, row_rel_err=row_err,
            fault_readings=faults, library="SDPA" if lib_ms else None,
            library_ms=lib_ms and lib_ms[0], library_call_ms=lib_call and lib_call[0],
            library_max_abs_err=lib_err, kernel_over_library=ratio,
            seconds=time.perf_counter() - t_shape))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        log(f"  flash_attention [{what}: {shape}] {form} form: max_abs_err={err:.3e} (tolerance "
            f"{tol:g}), worst row {row_err:.3e} of its max |plain| (tolerance {row_tol:g}); a "
            f"fault in the plain version reads " + ", ".join(
                f"{f}: {a:.3e} / row {r:.3e}" for f, (a, r) in faults.items()) +
            f" | kernel queued={ms:.4f} ms (min {lo:.4f}, max {hi:.4f}) call={call[0]:.4f} ms "
            f"(min {call[1]:.4f}, max {call[2]:.4f}) | plain call={pcall[0]:.4f} ms (min "
            f"{pcall[1]:.4f}, max {pcall[2]:.4f}) | bound={bound:.4f} ms by {by} ({nbytes} B; "
            f"{pairs} visible pairs, {flops} flop) | achieved {tflops:.1f} TFLOP/s, {gbs:.1f} GB/s, "
            f"{bound / ms:.3f} of the bound | " + (
                f"SDPA queued={lib_ms[0]:.4f} ms (min {lib_ms[1]:.4f}, max {lib_ms[2]:.4f}) "
                f"call={lib_call[0]:.4f} ms (max |SDPA - plain| {lib_err:.3e}); kernel / SDPA "
                f"queued = {ratio:.2f}" if lib_ms else "no library call computes this function") +
            f" | {time.perf_counter() - t_shape:.1f} s")
        del q, k, v, got, want
    out["unaligned"] = [flash_unaligned_check(fa, attention_chunked, gen, *shape)
                        for shape in FLASH_UNALIGNED]
    return out


def flash_unaligned_check(fa, attention_chunked, gen, what, b, hq, hkv, sq, sk, dh):
    """The kernel on operands the bf16 forms cannot read as they lie: each a
    view one element off 16 bytes (and Dh as given), which the wrapper copies
    aligned and zero-padded. Held to the bf16 tolerances against the plain
    version, with the readings of faults in the plain version; the form that
    ran must be the one the shape names."""
    dtype = torch.bfloat16
    q, k, v = (torch.randn(b * h * s * dh + 1, generator=gen, device=DEV).to(dtype)[1:]
               .view(b * h, s, dh) for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    assert not any(fa.aligned16(x) for x in (q, k, v))
    before = dict(fa.launches_by_form)
    got = fa.attention(q, k, v, causal=True)
    (form,) = [f for f, n in fa.launches_by_form.items() if n > before[f]]
    assert form == fa.kernel_form(dtype, sq, hq // hkv), (what, form)
    want = attention_chunked(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, row_err = flash_errs(got, want)
    tol, row_tol = FLASH_TOL[dtype], FLASH_ROW_TOL[dtype]
    assert err < tol and row_err < row_tol, (
        f"flash_attention {what}: max |kernel - plain| {err} (tolerance {tol}), worst row "
        f"{row_err} of its max |plain| (tolerance {row_tol})")
    faults = flash_check_can_fail(attention_chunked, q, k, v, None, want, row_tol, what)
    ms, lo, hi = queued_ms(lambda: fa.attention(q, k, v, causal=True))
    shape = f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} Dh={dh} causal bfloat16, unaligned"
    log(f"  flash_attention [{what}: {shape}] {form} form: max_abs_err={err:.3e} (tolerance "
        f"{tol:g}), worst row {row_err:.3e} of its max |plain| (tolerance {row_tol:g}); a "
        f"fault in the plain version reads " + ", ".join(
            f"{f}: {a:.3e} / row {r:.3e}" for f, (a, r) in faults.items()) +
        f" | kernel with its copies queued={ms:.4f} ms (min {lo:.4f}, max {hi:.4f})")
    return dict(shape=shape, form=form, ms=ms, ms_min=lo, ms_max=hi, max_abs_err=err,
                row_rel_err=row_err, fault_readings=faults)


# ---------------------------------------------------------------------------
# Phase 15a: Mamba's selective-scan kernel against its plain version
# ---------------------------------------------------------------------------

def scan_inputs(b, t, gen, h0=False, dt_scale=None, dtype=torch.bfloat16):
    """The scan's inputs as jamba's Mamba block forms them at full width
    (Di 8,192, N 16, dt rank 256): dt = softplus of a unit normal (or
    ``dt_scale`` times a uniform draw), x = silu of a unit normal, a = -(1..N)
    on every channel (``mamba_init``'s), B and C as slices of one [B, T,
    256 + 2N] projection (not contiguous), h0 zero or a unit normal."""
    dev = gen.device
    di, n = SCAN_DI, SCAN_N
    if dt_scale is None:
        dt = torch.nn.functional.softplus(torch.randn((b, t, di), generator=gen, device=dev))
    else:
        dt = torch.rand((b, t, di), generator=gen, device=dev) * dt_scale
    x = torch.nn.functional.silu(torch.randn((b, t, di), generator=gen, device=dev)).to(dtype)
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(di, n).contiguous()
    proj = torch.randn((b, t, SCAN_RANK + 2 * n), generator=gen, device=dev).to(dtype)
    h = (torch.randn((b, di, n), generator=gen, device=dev) if h0 else
         torch.zeros((b, di, n), device=dev))
    return [dt, x, a, proj[..., SCAN_RANK : SCAN_RANK + n], proj[..., SCAN_RANK + n :], h]


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0].split()[0]) * 1e6


def scan_bound(args, clock_hz):
    """(bound ms, what bounds it, bytes, exponentials, bytes ms, exp ms):
    dt, x and y once per (b, t, d), B, C, h0 and h_T once, at 3.35 TB/s;
    against the B*T*Di*N exponentials on the special-function units (16 a
    clock an SM, at the card's highest SM clock)."""
    dt, x, a, bm, cm, h0 = args
    b, t, di = dt.shape
    n = a.shape[1]
    nbytes = (dt.numel() * 4 + x.numel() * x.element_size() + dt.numel() * 4
              + (bm.numel() + cm.numel()) * bm.element_size() + 2 * h0.numel() * 4)
    exps = b * t * di * n
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    exp_ms = exps / (sms * SFU_EXP_PER_CLOCK * clock_hz) * 1e3
    return max(bytes_ms, exp_ms), ("bytes" if bytes_ms >= exp_ms else "operations"), \
        nbytes, exps, bytes_ms, exp_ms


def scan_errs(got, want):
    """max |diff| over y and h_T, and that over the larger max |plain|."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return err, err / max(1.0, scale), scale


def phase_ssm_scan_kernel(sk):
    """The kernel against ``ssm_scan_ref`` at jamba's shapes (forward, served
    prefill, a decode step from a non-zero state), with times and bound;
    then untimed at the decay edges, and two faults put into the plain
    version that the check must catch."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    clock = sm_clock_hz()
    log(f"phase 15: ssm_scan kernel vs its plain version (x, B, C in bf16, and in float32 at "
        f"the float32 leg's shape; Di={SCAN_DI}, N={SCAN_N}; SM clock {clock / 1e6:.0f} MHz)")
    gen = torch.Generator(device=DEV).manual_seed(15)
    out = {"max_abs_err": 0.0, "configs": []}
    for what, b, t, h0, dtype in SCAN_SHAPES:
        args = scan_inputs(b, t, gen, h0=h0, dtype=getattr(torch, dtype))
        got = sk.ssm_scan(*args)
        want = ssm_scan_ref(*args)
        torch.cuda.synchronize()
        err, rel, scale = scan_errs(got, want)
        assert rel < SCAN_TOL, f"ssm_scan {what}: max |diff| {err} / max |plain| {scale}"
        del got, want
        call, (ms, lo, hi) = timed(lambda: sk.ssm_scan(*args))
        # The plain version launches a few kernels a step: CUDA events
        # around one call (three calls after one warm-up), not profiled.
        pcall = call_ms(lambda: ssm_scan_ref(*args), iters=1, repeats=3, warmup=1)
        bound, by, nbytes, exps, bytes_ms, exp_ms = scan_bound(args, clock)
        shape = f"B={b} T={t} Di={SCAN_DI} N={SCAN_N} {dtype}" + (" +h0" if h0 else "")
        out["configs"].append(dict(
            shape=shape, ms=ms, ms_min=lo, ms_max=hi, call_ms=call[0], call_ms_min=call[1],
            call_ms_max=call[2], plain_ms=pcall[0], bound_ms=bound,
            bound_by=by, bound_bytes=nbytes, bound_exps=exps, max_abs_err=err, rel_err=rel,
            library_ms=None))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        log(f"  ssm_scan [{what}: {shape}]: max_abs_err={err:.3e} (y, h_T; max |plain| "
            f"{scale:.3f}, relative {rel:.2e}, tolerance {SCAN_TOL:g}) | kernel queued="
            f"{ms:.4f} ms (min {lo:.4f}, max {hi:.4f}) call={call[0]:.4f} ms (min "
            f"{call[1]:.4f}, max {call[2]:.4f}) | plain call={pcall[0]:.4f} ms (CUDA events, "
            f"min {pcall[1]:.4f}, max {pcall[2]:.4f}) | bound={bound:.4f} ms by {by} (bytes "
            f"{nbytes} -> {bytes_ms:.4f} ms at 3.35 TB/s; {exps} exp -> {exp_ms:.4f} ms at 16 "
            f"a clock an SM) | library: none")
        del args
    out["edges"] = scan_edge_checks(sk, ssm_scan_ref, gen)
    return out


def scan_edge_checks(sk, ssm_scan_ref, gen):
    """Untimed: dt so large that every decay underflows to 0 (served prefill
    shape), dt near 0 so that every decay is about 1 over the forward's
    4,096 steps; then the plain version with h0 ignored (decode shape) and
    with the last step's update dropped (served prefill shape), each of
    which the check must reject."""
    errs = {}
    bf, tf = SCAN_SHAPES[0][1:3]
    bp, tp = SCAN_SHAPES[1][1:3]
    bd, td = SCAN_SHAPES[2][1:3]
    for edge, b, t, dt_scale in (("decay underflows to 0", bp, tp, 200.0),
                                 ("decay about 1 over 4,096 steps", bf, tf, 1e-5)):
        args = scan_inputs(b, t, gen, h0=True, dt_scale=dt_scale)
        got = sk.ssm_scan(*args)
        want = ssm_scan_ref(*args)
        torch.cuda.synchronize()
        err, rel, scale = scan_errs(got, want)
        finite = bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
        errs[edge] = rel
        log(f"  ssm_scan [edge: {edge}, B={b} T={t} +h0]: max_abs_err={err:.3e} (max |plain| "
            f"{scale:.3f}, relative {rel:.2e}, tolerance {SCAN_TOL:g}), finite: {finite}")
        assert rel < SCAN_TOL and finite, (edge, err, scale)
        del args, got, want

    def no_h0(dt, x, a, bm, cm, h0):
        return ssm_scan_ref(dt, x, a, bm, cm, torch.zeros_like(h0))

    def last_step_dropped(dt, x, a, bm, cm, h0):
        y, _ = ssm_scan_ref(dt, x, a, bm, cm, h0)
        y_short, h_short = ssm_scan_ref(dt[:, :-1], x[:, :-1], a, bm[:, :-1], cm[:, :-1], h0)
        return torch.cat([y[:, :-1], y_short[:, -1:]], dim=1), h_short

    for fault, b, t, fn in (("h0 ignored", bd, td, no_h0),
                            ("last step's update dropped", bp, tp, last_step_dropped)):
        args = scan_inputs(b, t, gen, h0=True)
        got = sk.ssm_scan(*args)
        bad = fn(*args)
        torch.cuda.synchronize()
        _, rel, _ = scan_errs(got, bad)
        errs[f"fault: {fault}"] = rel
        log(f"  ssm_scan [fault in the plain version: {fault}, B={b} T={t}]: relative "
            f"{rel:.2e} (the check fails above {SCAN_TOL:g})")
        assert rel > SCAN_TOL, (fault, rel)
        del args, got, bad
    return errs


def phase_mamba_cache():
    """One of jamba's Mamba layers at full width (``mamba_init`` from a seed),
    in bf16, then in float32 with the same parameters widened: prefill of
    ``MAMBA_CACHE``'s rows from zero and one-token steps through the (conv
    tail, state) that each call returns, against one pass over all their
    tokens at the same positions; then the steps from a state or a conv tail
    set to zero, which the check must reject. Returns the readings."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config("jamba-v0.1-52b")
    rows, pre, extra, total = MAMBA_CACHE
    gen = torch.Generator(device=DEV).manual_seed(24)
    out = {}
    with torch.no_grad():
        layer = ssm.mamba_init(gen, cfg.d_model, expand=cfg.mamba_expand, state=cfg.ssm_state,
                               conv_dim=cfg.ssm_conv, dtype=torch.bfloat16)
        x = torch.randn((rows, total, cfg.d_model), generator=gen, device=DEV)
        for dtype, tol in ((torch.bfloat16, MAMBA_TOL_BF16), (torch.float32, LOGITS_TOL_F32)):
            if dtype == torch.float32:
                wide = ssm.Mamba(cfg.d_model, dtype, expand=cfg.mamba_expand,
                                 state=cfg.ssm_state, conv_dim=cfg.ssm_conv, device=DEV)
                for name, p in layer.named_parameters():
                    getattr(wide, name).copy_(p)
                layer = wide
            xd = x.to(dtype)
            want = ssm.mamba_block(layer, xd)[0][:, pre - 1 : pre + extra].float()
            scale = float(want.abs().max())

            def steps(lost=None):
                y, state = ssm.mamba_block(layer, xd[:, :pre])
                ys = [y[:, -1:]]
                if lost is not None:  # 0: the conv tail, 1: the state
                    state = tuple(torch.zeros_like(v) if i == lost else v
                                  for i, v in enumerate(state))
                for i in range(extra):
                    y, state = ssm.mamba_block(layer, xd[:, pre + i : pre + i + 1], state)
                    ys.append(y)
                return torch.cat(ys, dim=1).float()

            got = steps()
            by_pos = [round(float((got[:, j] - want[:, j]).abs().max()) / scale, 6)
                      for j in range(extra + 1)]
            rel = max(by_pos)
            faults = {what: float((steps(lost)[:, 1:] - want[:, 1:]).abs().max()) / scale
                      for what, lost in (("state lost", 1), ("conv tail lost", 0))}
            name = str(dtype).replace("torch.", "")
            log(f"phase 15: one Mamba layer at full width ({name}, d_model {cfg.d_model}, "
                f"Di {cfg.mamba_expand * cfg.d_model}, N {cfg.ssm_state}): prefill of {rows} x "
                f"{pre} tokens + {extra} decode steps vs one pass over {rows} x {total} tokens "
                f"at positions {pre - 1}..{pre + extra - 1}: relative {rel:.2e} (by position "
                f"{by_pos}; max |pass| {scale:.4f}; tolerance {tol:g}); decode steps with the "
                f"{' / '.join(faults)}: relative "
                f"{' / '.join(f'{v:.2e}' for v in faults.values())} (must read above {tol:g})")
            assert rel < tol, (name, by_pos, scale)
            assert all(v > tol for v in faults.values()), (name, faults)
            out[name] = dict(rel=rel, by_position=by_pos, faults=faults)
    return out


# ---------------------------------------------------------------------------
# Phases 7-8 (rwkv6-7b), 10-11 (granite-3-8b), 12 (gemma2-9b), 13
# (chatglm3-6b, command-r-35b), 14 (qwen3-moe-30b-a3b) and 15
# (jamba-v0.1-52b): LM inference at full width
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelUse:
    """A kernel a model's path must run: ``ops`` holds its launch counter
    ``kernel``; every pass over the layers (forward, prefill) launches it
    once in each layer whose mixer is one of ``mixers`` (None: every layer),
    and each decode step ``per_decode`` times there. ``symbol`` picks its
    kernels out of a profile. ``cross``: the attention kernel of an
    encoder–decoder, which also runs each decoder layer's cross-attention
    (in every pass and decode step) and each encoder layer (in every pass
    that takes frames), all non-causal."""
    ops: Any
    kernel: str
    symbol: str
    per_decode: int
    mixers: Any = None
    cross: bool = False

    def layers(self, cfg) -> int:
        if self.mixers is None:
            return cfg.num_layers
        return sum(cfg.mixer_at(layer) in self.mixers for layer in range(cfg.num_layers))

    def noncausal(self, cfg, kind: str) -> int:
        """The non-causal calls of a pass or a decode step."""
        if not (self.cross and cfg.encoder_layers):
            return 0
        return cfg.num_layers + (0 if kind == "decode" else cfg.encoder_layers)

    def launches(self, cfg, kind: str) -> int:
        return (self.layers(cfg) * (self.per_decode if kind == "decode" else 1)
                + self.noncausal(cfg, kind))


@dataclasses.dataclass(frozen=True)
class LMPath:
    """One model's path and the kernels it must run (``uses``; the first is
    the one whose forms ``forms`` lists: {(pass kind, dtype): the kernel's
    forms} where it has several). ``layers``: the depth the model is cut to
    on the card (0: its own). ``forward``: (B, S, prefill length, decode
    steps); ``serve``: (requests, prompt length, new tokens, slots);
    ``widen``: whether the float32 leg runs with the parameters copied to
    float32 beside the bf16 ones; ``f32_leg``: (layers, prefill length,
    decode steps, forward length) of a float32 leg run instead after the
    bf16 parameters are freed, on the model cut to ``layers`` and
    initialised in float32; ``lossless_ref``: hold the prefill to the
    forward of its own tokens, and the decode steps to the forward of the
    prefilled rows' first ``ref_len`` tokens (0: the prefill and decode
    steps' own; longer where the model takes only some lengths) where no
    routing leaves it (an MoE model's B x S forward drops routed pairs that
    those passes keep), and only log the B x S forward's difference.
    ``frontend``: (frames or patches a row of the forward leg, frames a
    served request) of a model with a frontend: an encoder–decoder's frames
    feed its encoder, a vision model's patches stand in front of the tokens
    (its requests are served text-only, through ``BatchedServer``)."""
    arch: str
    uses: Tuple[KernelUse, ...]
    forward_phase: str
    serve_phase: str
    forms: Any = None
    forward: Any = LM_FORWARD
    serve: Any = LM_SERVE
    widen: bool = True
    f32_leg: Any = None
    lossless_ref: bool = False
    layers: int = 0
    ref_len: int = 0
    frontend: Tuple[int, int] = (0, 0)

    def config(self):
        from repro_torch.configs import get_config

        cfg = get_config(self.arch)
        return cfg.scaled(num_layers=self.layers) if self.layers else cfg


def lm_setup(path: LMPath):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = path.config()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    moe = (f", MoE {cfg.num_experts} experts top-{cfg.experts_per_token} of width "
           f"{cfg.moe_d_ff}, {cfg.active_param_count()} parameters active a token"
           if cfg.num_experts else "")
    depth = (f"{cfg.num_layers} layers" if not path.layers else
             f"cut to {cfg.num_layers} of its {get_config(path.arch).num_layers} layers")
    if cfg.encoder_layers:
        depth += f" and {cfg.encoder_layers} encoder layers with cross-attention"
    elif cfg.frontend:
        depth += f", {cfg.frontend_len} {cfg.frontend} patch embeddings in front of the tokens"
    log(f"{path.forward_phase}: {cfg.name} full width ({depth}, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads ({cfg.num_kv_heads} KV) of {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}{moe}): {n} parameters ({cfg.param_count()} in "
        f"param_count's matrices), {nbytes / 1e9:.2f} GB, initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, params


# Profile rows by kind: the path's kernels first, then these, by substrings
# of the kernel's name (an indexed write names index_put in its template
# arguments, an indexed read the plain index kernel).
KINDS = (("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")), ("sort", ("sort", "Sort")),
         ("scatter", ("index_put", "scatter")), ("gather", ("index", "gather")),
         ("copy", ("copy",)))


def by_category(rows, symbols):
    """Device ms of profile rows ``(name, device µs)`` summed by kind: each
    of the port's kernels (``symbols``: its name → a substring of its
    device kernels' names), the cuBLAS GEMMs, sorts (the MoE layer's routing
    and dispatch), indexed writes (its buckets) and reads (its combine, the
    embedding), copies and casts, the other torch kernels (elementwise:
    norms, activations, Mamba's conv products and sums)."""
    out = {**{name: 0.0 for name in symbols}, **{k: 0.0 for k, _ in KINDS}, "other": 0.0}
    for key, us in rows:
        kind = next((name for name, sym in symbols.items() if sym in key), None) or next(
            (k for k, subs in KINDS if any(s in key for s in subs)), "other")
        out[kind] += us / 1e3
    return {k: round(v, 2) for k, v in out.items()}


def kernel_shares(path: LMPath, rows, busy_ms):
    """'name x ms (share of busy)' for each of the path's kernels."""
    parts = []
    for u in path.uses:
        ms = sum(r[1] for r in rows if u.symbol in r[0]) / 1e3
        parts.append(f"{u.kernel} kernel {ms:.3f} ms, {ms / max(busy_ms, 1e-9):.3f} of busy")
    return "; ".join(parts)


@contextlib.contextmanager
def attention_masks(fa):
    """Tallies the flash wrapper's calls inside by mask (``causal`` True or
    False): calls, beside the wrapper's own count of launches."""
    calls = {True: 0, False: 0}
    wrapped = fa.attention

    def spy(*args, causal=True, **kw):
        calls[bool(causal)] += 1
        return wrapped(*args, causal=causal, **kw)

    fa.attention = spy
    try:
        yield calls
    finally:
        fa.attention = wrapped


class PassCounter:
    """Runs one pass of a path with every kernel's count set to 0 just
    before it, asserts each kernel's launches (and, for an encoder–decoder's
    attention kernel, how many of its calls were non-causal), and keeps them
    by kernel and pass kind, with the first kernel's forms that ran by (pass
    kind, dtype)."""

    def __init__(self, path: LMPath):
        self.path = path
        self.total = {u.kernel: {"forward": 0, "prefill": 0, "decode": 0} for u in path.uses}
        self.forms = {}
        self.noncausal = {}

    def __call__(self, fn, cfg, kind):
        for u in self.path.uses:
            u.ops.reset_launches()
        cross = next((u for u in self.path.uses if u.cross), None)
        with (attention_masks(cross.ops) if cross else contextlib.nullcontext({})) as calls:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        for u in self.path.uses:
            n, want = u.ops.launches[u.kernel], u.launches(cfg, kind)
            assert n == want, f"{u.kernel} launched {n} times in a {kind} pass, want {want}"
            self.total[u.kernel][kind] += n
        if cross:
            want = cross.noncausal(cfg, kind)
            assert calls[False] == want, f"{calls[False]} non-causal calls, want {want}"
            key = (kind, cfg.dtype)
            self.noncausal[key] = self.noncausal.get(key, 0) + calls[False]
        ran = {f for f, c in getattr(self.path.uses[0].ops, "launches_by_form", {}).items() if c}
        self.forms[(kind, cfg.dtype)] = self.forms.get((kind, cfg.dtype), set()) | ran
        return res, wall

    def check_forms(self, ph, want):
        if want is None:
            return
        kernel = self.path.uses[0].kernel
        log(f"{ph}: {kernel} forms by (pass kind, dtype): "
            f"{ {k: sorted(v) for k, v in self.forms.items()} }" +
            (f"; non-causal calls (the encoder's and the cross-attentions') by (pass kind, "
             f"dtype): {self.noncausal}" if self.noncausal else ""))
        assert self.forms == want, (kernel, self.forms, want)


@contextlib.contextmanager
def moe_dispatch_stats(cfg, ph, what, routes=False):
    """Logs the routed pairs of the MoE layers' dispatches inside: how many
    were dropped, and how full the buckets were (kept pairs over slots).
    Yields the statistics, which keep every routing's choice and margins
    where ``routes``. Nothing for a model without an MoE layer."""
    from repro_torch.models import moe as moe_mod

    if not cfg.num_experts:
        yield {}
        return
    moe_mod.stats = {"routes": []} if routes else {}
    try:
        yield moe_mod.stats
        st = moe_mod.stats
    finally:
        moe_mod.stats = None
    kept, routed = int(st["kept"]), st["routed"]
    log(f"{ph}: {what}: MoE dispatch over {cfg.num_layers_moe()} layers: {routed} routed "
        f"pairs, {routed - kept} dropped ({(routed - kept) / routed:.4f} of them), buckets "
        f"filled {kept / st['slots']:.4f} ({kept} of {st['slots']} slots)")


def lm_batch(toks, front=None):
    """A pass's batch: tokens, and the frontend's embeddings where given."""
    return {"tokens": toks} if front is None else {"tokens": toks, "frontend": front}


def text_offset(cfg, front) -> int:
    """Positions in front of the first token: a vision model's patches."""
    return 0 if front is None or cfg.encoder_layers else front.shape[1]


def prefill_decode(counted, cfg, params, toks, pre, extra, front=None):
    """Logits [rows, 1 + extra, vocab] (float32) of prefill of ``toks[:, :pre]``
    (behind or beside ``front``; its last position) and of ``extra`` decode
    steps, and the prefill's wall."""
    from repro_torch.models import transformer as T

    vocab = cfg.vocab_size  # the padded columns hold -1e30: compare the real ones
    off = text_offset(cfg, front)
    (cache, last), wall = counted(
        lambda: T.prefill(cfg, params, lm_batch(toks[:, :pre], front), off + pre + extra + 8,
                          device=DEV), cfg, "prefill")
    out = [last[:, 0, :vocab].float()]
    for i in range(extra):
        (logits, cache), _ = counted(
            lambda: T.decode_step(cfg, params, cache, toks[:, pre + i : pre + i + 1],
                                  off + pre + i, device=DEV), cfg, "decode")
        out.append(logits[:, 0, :vocab].float())
    return torch.stack(out, dim=1), wall


def routing_flips(ph, cfg, fwd, passes, rows, pre, extra, ref_len):
    """Where the routing of prefill (``pre`` tokens a row) and ``extra``
    decode steps first leaves the forward's at the same positions, MoE
    layer by MoE layer (``fwd``: the routes of a forward of ``ref_len``
    tokens a row; ``passes``: the prefill's MoE
    layers first, then each step's): logs, for the prefilled positions, how
    many left it, and for each decoded position in each row the first layer
    where its top-k set differs and the forward's margin there (its k-th
    router probability less its (k+1)-th). Returns the largest such margin
    of a decoded position and the number of positions that left it."""
    moe_layers = [layer for layer in range(cfg.num_layers)
                  if cfg.mlp_at(layer) in ("moe", "moe_dense")]
    layers, k = len(moe_layers), cfg.experts_per_token
    s = ref_len

    def stack(recs, n):
        return torch.stack([i.view(rows, n, k) for i, _ in recs]).sort(-1).values

    f_idx = stack(fwd, s)[:, :, : pre + extra]
    f_gap = torch.stack([g.view(rows, s) for _, g in fwd])[:, :, : pre + extra]
    p_idx = torch.cat([stack(passes[:layers], pre)] + [
        stack(passes[layers * (1 + i) : layers * (2 + i)], 1) for i in range(extra)], dim=2)
    diff = (f_idx != p_idx).any(-1)                     # [MoE layers, rows, positions]
    left = diff.any(0)
    first = diff.int().argmax(0)
    gap = f_gap.gather(0, first[None])[0]
    steps = [[(moe_layers[int(first[r, pre + i])], float(gap[r, pre + i]))
              if left[r, pre + i] else None for r in range(rows)] for i in range(extra)]
    pre_left = left[:, :pre]
    where = ""
    if bool(pre_left.any()):
        pos = [int(pre_left[r].nonzero()[0]) if bool(pre_left[r].any()) else None
               for r in range(rows)]
        crossed = gap[:, :pre][pre_left]
        where = (f" (per row the first such position {pos}; the forward's margin at each one's "
                 f"first differing layer: median {float(crossed.median()):.2e}, smallest "
                 f"{float(crossed.min()):.2e})")
    log(f"{ph}: routing against the lossless forward's: {int(pre_left.sum())} of "
        f"{rows * pre} prefilled positions leave it{where}; decode steps (per row: the first "
        f"layer whose top-{k} differs, the forward's margin there; None: never): {steps}; the "
        f"forward's margins: median {float(f_gap.median()):.2e}")
    dec_left = left[:, pre:]
    return (float(gap[:, pre:][dec_left].max()) if bool(dec_left.any()) else 0.0,
            int(left.sum()))


def logits_agree(ph, label, got, want, tol, pre, extra, against):
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    same_top = int((got.argmax(-1) == want.argmax(-1)).sum())
    log(f"{ph}: {label}: prefill {pre} tokens x{got.shape[0]} + {extra} decode steps vs "
        f"{against}, logits at positions {pre - 1}..{pre + extra - 1}: max |diff| {err:.5f}, "
        f"max |logit| {scale:.4f}, relative {err / scale:.2e} (tolerance {tol:g}), same "
        f"argmax {same_top}/{got.shape[0] * got.shape[1]}")
    assert err / scale < tol, (label, err, scale)


def frontend_embeddings(cfg, b: int, n: int, gen):
    """[b, n, d] unit-normal frames or patches in the model dtype (None if
    n is 0): the frontend stubs' precomputed embeddings."""
    if not n:
        return None
    return torch.randn((b, n, cfg.d_model), generator=gen, device=DEV).to(
        getattr(torch, cfg.dtype))


def phase_lm_forward(path: LMPath, cfg, params) -> Dict[str, Dict[str, int]]:
    """loss_fn and forward on B x S tokens (``path.forward``: 4 x 4096 by
    default), a profiled forward, then prefill of the first tokens of (up to)
    two rows and decode steps against a forward's logits (``lossless_ref``:
    the forward of those rows' own tokens, else the B x S one), in bf16 and
    (``path.widen``) float32. Returns each kernel's launches of the phase by
    pass kind."""
    from repro_torch.models import transformer as T

    ph = path.forward_phase
    b, s, pre, extra = path.forward
    ref = path.ref_len or pre + extra
    seqs = min(b, 2)  # the rows prefilled and decoded
    gen = torch.Generator(device=DEV).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=DEV)
    front = frontend_embeddings(cfg, b, path.frontend[0], gen)
    seq_front = None if front is None else front[:seqs]  # the prefilled rows' frames or patches
    off = text_offset(cfg, front)
    batch = lm_batch(toks, front)
    what = "" if front is None else \
        f" behind {front.shape[1]} patches" if off else f" over {front.shape[1]} frames"
    counted = PassCounter(path)
    per_pass = {u.kernel: u.launches(cfg, "forward") for u in path.uses}

    torch.cuda.reset_peak_memory_stats()
    loss, wall = counted(lambda: T.loss_fn(cfg, params, batch, device=DEV), cfg, "forward")
    assert bool(torch.isfinite(loss)), loss
    log(f"{ph}: loss_fn B={b} S={s}{what}: loss={float(loss):.4f} (ln vocab "
        f"{math.log(cfg.vocab_size):.4f}) wall={wall:.3f} s tokens/s={b * s / wall:,.0f} "
        f"launches={per_pass} max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        with (moe_dispatch_stats(cfg, ph, f"forward B={b} S={s}") if i == 0
              else contextlib.nullcontext()):
            logits, wall = counted(lambda: T.forward(cfg, params, batch, device=DEV), cfg,
                                   "forward")
        log(f"{ph}: forward {i + 1} B={b} S={s}{what}: wall={wall:.3f} s "
            f"tokens/s={b * s / wall:,.0f} launches={per_pass} "
            f"max_memory_allocated={torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    vocab = cfg.vocab_size  # the padded columns hold -1e30: compare the real ones
    assert logits.shape[1] == off + s
    full = logits[:seqs, off + pre - 1 : off + pre + extra, :vocab].float()
    assert bool(torch.isfinite(full).all())
    del logits, loss

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (logits, wall) = counted(lambda: T.forward(cfg, params, batch, device=DEV), cfg,
                                 "forward")
    del logits
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in rows) / 1e3
    log(f"{ph}: profiled forward: wall={wall * 1e3:.1f} ms device busy={busy:.1f} ms "
        f"({kernel_shares(path, rows, busy)}) idle share={1 - busy / (wall * 1e3):.3f}")
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"{ph}:   device {t / 1e3:9.2f} ms  x{n:<5d} {key[:90]}")
    log(f"{ph}:   device ms by kind: "
        f"{by_category([(k, t) for k, t, _ in rows], {u.kernel: u.symbol for u in path.uses})}")

    short = lm_batch(toks[:seqs, :ref], seq_front)
    at = slice(off + pre - 1, off + pre + extra)  # the prefilled rows' checked positions
    if path.lossless_ref:
        # A decoded token's hidden state carries bf16 roundings of other
        # product shapes than the forward's; where its k-th and (k+1)-th
        # router probabilities lie closer than they move, its experts
        # change, and with them its logits. So the prefill's logits are held
        # to the lossless forward, the decode steps' are logged beside where
        # their routing left the forward's, and the float32 leg holds both.
        with moe_dispatch_stats(cfg, ph, f"prefill of {seqs} x {pre} tokens and {extra} "
                                f"decode steps", routes=True) as st:
            got, wall = prefill_decode(counted, cfg, params, toks[:seqs], pre, extra)
        passes = st.pop("routes")
        log(f"{ph}: bf16 prefill of {pre} tokens x{seqs}: wall {wall:.3f} s")
        # The prefill against the forward of its own tokens: the same
        # product shapes. A forward of another length runs others (its MoE
        # buckets too), and one routing flip at any earlier position reaches
        # every later one (through a Mamba state too).
        same, _ = counted(
            lambda: T.forward(cfg, params, {"tokens": toks[:seqs, :pre]}, device=DEV)
            [:, pre - 1 :, :vocab].float(), cfg, "forward")
        logits_agree(ph, "bf16 prefill", got[:, :1], same, LOGITS_TOL_BF16, pre, 0,
                     f"the forward of {seqs} x {pre} tokens")
        with moe_dispatch_stats(cfg, ph, f"forward of {seqs} x {ref} tokens",
                                routes=True) as st:
            want, _ = counted(
                lambda: T.forward(cfg, params, short, device=DEV)[:, pre - 1 : pre + extra,
                                                                  :vocab].float(),
                cfg, "forward")
        fwd = st.pop("routes")
        flips, moved = routing_flips(ph, cfg, fwd, passes, seqs, pre, extra, ref)
        rel = [round(float((got[:, j] - want[:, j]).abs().max() / want[:, j].abs().max()), 4)
               for j in range(extra + 1)]
        if not moved:
            logits_agree(ph, "bf16", got, want, LOGITS_TOL_BF16, pre, extra,
                         f"the forward of {seqs} x {ref} tokens, its routing equal")
        log(f"{ph}: bf16 prefill and decode steps vs the forward of {seqs} x {ref} tokens, "
            f"{'held above' if not moved else 'logged, not held (routing left it)'}: relative "
            f"{rel}, same argmax "
            f"{int((got[:, 1:].argmax(-1) == want[:, 1:].argmax(-1)).sum())}/{seqs * extra}; "
            f"the largest margin a decode step's routing crossed {flips:.2e}")
        log(f"{ph}: the {b} x {s} forward ({b * s * cfg.experts_per_token} routed pairs a "
            f"layer, pairs over the capacity dropped) at the same positions, logged, not held: "
            f"relative "
            f"{float((full - want).abs().max() / want.abs().max()):.2e}, same argmax "
            f"{int((full.argmax(-1) == want.argmax(-1)).sum())}/{want.numel() // vocab}")
    else:
        got, wall = prefill_decode(counted, cfg, params, toks[:seqs], pre, extra, seq_front)
        log(f"{ph}: bf16 prefill of {pre} tokens{what} x{seqs}: wall {wall:.3f} s")
        logits_agree(ph, "bf16", got, full, LOGITS_TOL_BF16, pre, extra,
                     f"the {b} x {s} forward")
        # bf16's own floor at these positions: the same forward in another batch
        # shape, and (below) the float32 forward of the same weights.
        other, _ = counted(
            lambda: T.forward(cfg, params, short, device=DEV)[:, at, :vocab].float(),
            cfg, "forward")
        log(f"{ph}: bf16 floor: forward of {seqs} x {ref} tokens vs the {b} x {s} "
            f"forward: relative {float((other - full).abs().max() / full.abs().max()):.2e}")
    if path.widen:
        # The same check in float32, with the parameters widened (exactly):
        # here the two paths may differ only in summation order. The logits'
        # slice is copied, so that the whole float32 logits do not stay alive.
        cfg32 = cfg.scaled(dtype="float32")
        p32 = T.LM(cfg32, DEV)
        with torch.no_grad():
            for wide, narrow in zip(p32.parameters(), params.parameters()):
                wide.copy_(narrow)
        torch.cuda.reset_peak_memory_stats()
        want32, _ = counted(
            lambda: T.forward(cfg32, p32, short, device=DEV)[:, at, :vocab].clone(),
            cfg32, "forward")
        log(f"{ph}: bf16 floor: bf16 forward vs float32 forward: relative "
            f"{float((full - want32).abs().max() / want32.abs().max()):.2e}")
        got32, _ = prefill_decode(counted, cfg32, p32, toks[:seqs], pre, extra, seq_front)
        logits_agree(ph, "float32", got32, want32, LOGITS_TOL_F32, pre, extra,
                     f"the float32 forward of {seqs} x {ref} tokens")
        log(f"{ph}: float32 leg: {sum(p.numel() for p in p32.parameters()) * 4 / 1e9:.2f} GB "
            f"of float32 parameters beside the bf16 ones, max_memory_allocated="
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del p32
    counted.check_forms(ph, path.forms and {k: v for k, v in path.forms.items()
                                            if k[1] == cfg.dtype or path.widen})
    return counted.total


def phase_lm_f32(path: LMPath) -> Dict[str, Dict[str, int]]:
    """The float32 leg where a float32 copy of the whole model does not fit
    beside it: the model cut to ``path.f32_leg``'s layers, initialised in
    float32 on the card (after the bf16 parameters are freed), prefill +
    decode steps of two rows against the forward of the same tokens (and
    more, up to the leg's forward length), every pass lossless; here the two
    may differ only in summation order. Returns each kernel's launches by
    pass kind."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    layers, pre, extra, ref = path.f32_leg
    ph = path.forward_phase
    cfg = get_config(path.arch)
    cfg32 = cfg.scaled(num_layers=layers, dtype="float32")
    t0 = time.perf_counter()
    params = T.init_params(cfg32, seed=0, device=DEV)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"{ph}: float32 leg: {cfg.name} cut to {layers} of its {cfg.num_layers} layers, "
        f"{nbytes / 1e9:.2f} GB of float32 parameters, initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=DEV).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (2, ref), generator=gen, device=DEV)
    counted = PassCounter(path)
    torch.cuda.reset_peak_memory_stats()
    with moe_dispatch_stats(cfg32, ph, f"float32 forward of 2 x {ref} tokens",
                            routes=True) as st:
        want, wall = counted(lambda: T.forward(cfg32, params, {"tokens": toks}, device=DEV)
                             [:, pre - 1 : pre + extra, :cfg.vocab_size].clone(),
                             cfg32, "forward")
    fwd = st.pop("routes", None)
    with moe_dispatch_stats(cfg32, ph, f"float32 prefill of 2 x {pre} tokens and {extra} "
                            f"decode steps", routes=True) as st:
        got, pwall = prefill_decode(counted, cfg32, params, toks, pre, extra)
    if fwd is not None:
        routing_flips(ph, cfg32, fwd, st.pop("routes"), 2, pre, extra, ref)
    logits_agree(ph, "float32", got, want, LOGITS_TOL_F32, pre, extra,
                 f"the float32 forward of 2 x {ref} tokens")
    log(f"{ph}: float32 leg: forward wall {wall:.3f} s, prefill wall {pwall:.3f} s, "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    counted.check_forms(ph, path.forms and {k: v for k, v in path.forms.items()
                                            if k[1] == "float32"})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counted.total


def decode_profile(path: LMPath, cfg, params, b: int, plen: int, frames: int = 0) -> None:
    """One profiled decode step of ``b`` sequences after a ``plen``-token
    prefill (over ``frames`` frames for an encoder–decoder): its wall time
    against its device time and against the time to read every weight
    once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    gen = torch.Generator(device=DEV).manual_seed(9)
    toks = torch.randint(2, cfg.vocab_size, (b, plen + 2), generator=gen, device=DEV)
    cache, _ = T.prefill(cfg, params, lm_batch(toks[:, :plen], frontend_embeddings(
        cfg, b, frames, gen)), plen + 8, device=DEV)
    T.decode_step(cfg, params, cache, toks[:, plen : plen + 1], plen, device=DEV)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        T.decode_step(cfg, params, cache, toks[:, plen + 1 : plen + 2], plen + 1, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(t for _, t, _ in rows) / 1e3
    n = sum(c for _, _, c in rows)
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"{path.serve_phase}: profiled decode step B={b}: wall={wall * 1e3:.2f} ms (profiled) "
        f"device busy={busy:.2f} ms over {n} kernels ({kernel_shares(path, rows, busy)}), "
        f"idle share={1 - busy / (wall * 1e3):.3f}; reading the {weights / 1e9:.2f} GB of "
        f"weights once takes {weights / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s")
    for key, t, c in sorted(rows, key=lambda r: -r[1])[:6]:
        log(f"{path.serve_phase}:   device {t / 1e3:8.3f} ms  x{c:<5d} {key[:90]}")
    log(f"{path.serve_phase}:   device ms by kind: "
        f"{by_category([(k, t) for k, t, _ in rows], {u.kernel: u.symbol for u in path.uses})}")


def phase_lm_serve(path: LMPath, cfg, params) -> Dict[str, int]:
    """BatchedServer, greedy (``path.serve``: 16 requests of 512 prompt
    tokens, 32 new tokens each, 8 slots by default). Returns each kernel's
    launches of the measured run."""
    from repro_torch.serve.engine import BatchedServer, Request, ServeConfig

    ph = path.serve_phase
    n_req, plen, new, slots = path.serve
    rng = np.random.default_rng(8)
    scfg = ServeConfig(max_len=plen + new + 8, batch_slots=slots, temperature=0.0,
                       eos_token=-1, max_new_tokens=new)

    def requests(n):
        return [Request(prompt=rng.integers(2, cfg.vocab_size, size=plen).astype(np.int32))
                for _ in range(n)]

    # Warm-up group (cuBLAS picks its kernels for these shapes); not counted.
    BatchedServer(cfg, params, dataclasses.replace(scfg, max_new_tokens=2),
                  device=DEV).run(requests(slots))
    reqs = requests(n_req)
    server = BatchedServer(cfg, params, scfg, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    for u in path.uses:
        u.ops.reset_launches()
    with moe_dispatch_stats(cfg, ph, f"serving {n_req} requests"):
        stats = server.run(reqs)
        torch.cuda.synchronize()
    groups = -(-n_req // slots)
    assert all(r.done and len(r.out_tokens) == new for r in reqs), "a request is short"
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    launched = {}
    for u in path.uses:
        n = u.ops.launches[u.kernel]
        want = u.layers(cfg) * groups * (1 + (new - 1) * u.per_decode)
        assert n == want, f"{u.kernel} launched {n} times in {groups} groups, want {want}"
        launched[u.kernel] = n
    first = path.uses[0]
    n = launched[first.kernel]
    by_form = {f: c for f, c in getattr(first.ops, "launches_by_form", {}).items() if c}
    if path.forms is not None:  # each group: one prefill pass, then its decode steps
        (pf,), (df,) = path.forms[("prefill", cfg.dtype)], path.forms[("decode", cfg.dtype)]
        prefills = first.layers(cfg) * groups
        assert by_form == {pf: prefills, df: n - prefills}, (first.kernel, by_form)
    lat = np.array([r.latency_s for r in reqs])
    peak = torch.cuda.max_memory_allocated()
    decode_profile(path, cfg, params, slots, plen)
    log(f"{ph}: served {n_req} requests x {new} tokens (prompt {plen}, {slots} slots): "
        f"wall={stats['wall_s']:.3f} s, {stats['new_tokens']} decode tokens -> "
        f"{stats['tokens_per_s']:,.1f} tokens/s; all {n_req * new} generated tokens -> "
        f"{n_req * new / stats['wall_s']:,.1f} tokens/s; latency p50 "
        f"{np.percentile(lat, 50):.3f} s p99 {np.percentile(lat, 99):.3f} s; launches="
        f"{launched}{f' by form {by_form}' if by_form else ''}; max_memory_allocated="
        f"{peak / 1e9:.2f} GB")
    return launched


def phase_encdec_serve(path: LMPath, cfg, params) -> Dict[str, int]:
    """An encoder–decoder's greedy serving loop through ``prefill`` and
    ``decode_step`` (``BatchedServer`` takes token prompts only, as the JAX
    package's does): ``path.serve`` requests of ``path.frontend[1]`` frames
    and a prompt, in groups of ``slots``, each decoding its new tokens.
    Logs decode tokens/s, latency p50/p99 and peak memory; asserts the
    launches (a prefill: the encoder's, the decoder's and the
    cross-attentions'; a decode step: the decoder's and the
    cross-attentions') and returns them."""
    from repro_torch.models import transformer as T

    ph = path.serve_phase
    n_req, plen, new, slots = path.serve
    frames = path.frontend[1]
    gen = torch.Generator(device=DEV).manual_seed(8)
    uses = path.uses

    def group(b, steps):
        """One group's tokens [b, steps] and its wall."""
        toks = torch.randint(2, cfg.vocab_size, (b, plen), generator=gen, device=DEV)
        batch = lm_batch(toks, frontend_embeddings(cfg, b, frames, gen))
        t0 = time.perf_counter()
        cache, logits = T.prefill(cfg, params, batch, plen + new + 8, device=DEV)
        cur = logits[:, -1].float().argmax(-1)
        out = [cur.tolist()]  # each step's tokens reach the host once, as the server's do
        for i in range(steps - 1):
            logits, cache = T.decode_step(cfg, params, cache, cur[:, None], plen + i,
                                          device=DEV)
            cur = logits[:, -1].float().argmax(-1)
            out.append(cur.tolist())
        return np.array(out).T, time.perf_counter() - t0

    group(slots, 2)  # warm-up (cuBLAS picks its kernels for these shapes); not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for u in uses:
        u.ops.reset_launches()
    lat, t0 = [], time.perf_counter()
    for base in range(0, n_req, slots):
        toks, wall = group(min(slots, n_req - base), new)
        assert toks.shape[1] == new and ((0 <= toks) & (toks < cfg.vocab_size)).all()
        lat += [wall] * toks.shape[0]
    wall = time.perf_counter() - t0
    groups = -(-n_req // slots)
    launched = {}
    for u in uses:
        n = u.ops.launches[u.kernel]
        want = groups * (u.launches(cfg, "prefill") + (new - 1) * u.launches(cfg, "decode"))
        assert n == want, f"{u.kernel} launched {n} times in {groups} groups, want {want}"
        launched[u.kernel] = n
    first = uses[0]
    by_form = {f: c for f, c in getattr(first.ops, "launches_by_form", {}).items() if c}
    # A group's prefill runs its encoder (frames rows) in the prefill form and
    # its prompt's self- and cross-attention in the form plen names.
    pform = first.ops.kernel_form(getattr(torch, cfg.dtype), plen, 1)
    want_forms = {"prefill": groups * cfg.encoder_layers}
    want_forms[pform] = want_forms.get(pform, 0) + groups * 2 * cfg.num_layers
    want_forms["decode"] = want_forms.get("decode", 0) + \
        groups * (new - 1) * 2 * cfg.num_layers
    assert by_form == want_forms, (by_form, want_forms)
    peak = torch.cuda.max_memory_allocated()
    decode_profile(path, cfg, params, slots, plen, frames)
    log(f"{ph}: served {n_req} requests x {new} tokens (prompt {plen} over {frames} frames, "
        f"{slots} slots) through prefill + decode_step, greedy: wall={wall:.3f} s, "
        f"{n_req * (new - 1)} decode tokens -> {n_req * (new - 1) / wall:,.1f} tokens/s; all "
        f"{n_req * new} generated tokens -> {n_req * new / wall:,.1f} tokens/s; latency p50 "
        f"{np.percentile(lat, 50):.3f} s p99 {np.percentile(lat, 99):.3f} s; launches="
        f"{launched} by form {by_form}; max_memory_allocated={peak / 1e9:.2f} GB")
    return launched


@torch.inference_mode()
def lm_phases(path: LMPath) -> Dict[str, int]:
    """A model's forward and serving phases; its parameters are freed when it
    returns. Returns each kernel's launches on the main path."""
    cfg, params = lm_setup(path)
    by_kind = phase_lm_forward(path, cfg, params)
    served = (phase_encdec_serve if cfg.encoder_layers else phase_lm_serve)(path, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if path.f32_leg is not None:
        for kernel, kinds in phase_lm_f32(path).items():
            for kind, n in kinds.items():
                by_kind[kernel][kind] += n
    out = {}
    for u in path.uses:
        log(f"{path.forward_phase}: {u.kernel} launches on the main path: {by_kind[u.kernel]}, "
            f"serving {served[u.kernel]}")
        for kind, n in by_kind[u.kernel].items():
            assert n > 0 or (kind == "decode" and u.per_decode == 0), (u.kernel, kind)
        out[u.kernel] = sum(by_kind[u.kernel].values()) + served[u.kernel]
    return out


# ---------------------------------------------------------------------------
# Phases 17-19: training (the flash backward kernel, granite-3-8b, the driver)
# ---------------------------------------------------------------------------

def attention_bwd_plain(ref, q, k, v, o, do, lse, cap, window, causal):
    """``ref.attention_bwd_ref`` on [B, H, S, Dh] operands (flattened to its
    [B·H, S, Dh]); the gradients come back in the operands' shapes."""
    flat = [x.reshape(-1, *x.shape[-2:]) for x in (q, k, v, o, do)]
    grads = ref.attention_bwd_ref(*flat, lse.reshape(-1, q.shape[-2]), causal=causal,
                                  softcap=cap, window=window)
    return tuple(g.view(x.shape) for g, x in zip(grads, (q, k, v)))


def attention_grads(fa, ref, q, k, v, do, cap, window, causal):
    """The forward with its log-sum-exp, then the backward kernel and its
    plain version on the same inputs: (out, lse, kernel's (dq, dk, dv),
    plain's (dq, dk, dv))."""
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    out = fa.attention(q, k, v, causal=causal, softcap=cap, window=window, lse=lse)
    got = fa.attention_bwd(q, k, v, out, do, lse, causal=causal, softcap=cap, window=window)
    want = attention_bwd_plain(ref, q, k, v, out, do, lse, cap, window, causal)
    torch.cuda.synchronize()
    return out, lse, got, want


def grad_errs(got, want):
    """(max |got - want|, max |got - want| / max |want|) of each of dq, dk, dv."""
    out = []
    for g, w in zip(got, want):
        diff = float((g.float() - w.float()).abs().max())
        out.append((diff, diff / max(float(w.float().abs().max()), 1e-30)))
    return out


def phase_flash_backward(fa):
    """Phase 17: the backward kernel against its plain version
    (``ref.attention_bwd_ref``) at the training shapes, each of dq, dk, dv
    held by max |kernel - plain| / max |plain| (``FLASH_BWD_TOL``), with the
    reading of a fault put into the plain version (every P halved: the
    log-sum-exp off by log 2) to show the check can fail; the kernel's
    device time (``queued_ms``) and call time, the plain version's call
    time, the bound (10 * Dh flop a visible pair at the dtype's peak, or the
    bytes of q, k, v, o, dO read and dq, dk, dv written, whichever is
    larger) and SDPA's backward where one SDPA call computes the same
    function (no softcap or window), timed by ``queued_ms`` of
    ``torch.autograd.grad`` on a kept graph."""
    from repro_torch.kernels.flash_attention import ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    log("phase 17: flash attention backward kernel vs its plain version and SDPA's backward")
    gen = torch.Generator(device=DEV).manual_seed(17)
    out = {"max_abs_err": 0.0, "max_rel_err": 0.0, "configs": []}
    for what, b, hq, hkv, sq, sk, dh, cap, dtype, window, causal in FLASH_BWD_SHAPES:
        t_shape = time.perf_counter()
        randn = lambda *s: torch.randn(s, generator=gen, device=DEV)
        q = randn(b, hq, sq, dh) * (SOFTCAP_Q_SCALE if cap is not None else 1.0)
        q, k, v, do = (x.to(dtype) for x in (q, randn(b, hkv, sk, dh), randn(b, hkv, sk, dh),
                                             randn(b, hq, sq, dh)))
        o, lse, got, want = attention_grads(fa, ref, q, k, v, do, cap, window, causal)
        errs = grad_errs(got, want)
        tol = FLASH_BWD_TOL[dtype]
        assert all(math.isfinite(e) and r < tol for e, r in errs), (
            f"flash_attention_bwd {what}: max |kernel - plain| / max |plain| of dq, dk, dv "
            f"{[r for _, r in errs]} (tolerance {tol})")
        fault = grad_errs(attention_bwd_plain(ref, q, k, v, o, do, lse + math.log(2), cap,
                                              window, causal), want)
        assert min(r for _, r in fault) > tol, f"flash_attention_bwd {what}: the check misses P/2"

        def kernel():
            return fa.attention_bwd(q, k, v, o, do, lse, causal=causal, softcap=cap, window=window)

        call = call_ms(kernel, iters=3, repeats=3, warmup=2)
        ms, lo, hi = queued_ms(kernel, iters=3, repeats=3)
        pcall = call_ms(lambda: attention_bwd_plain(ref, q, k, v, o, do, lse, cap, window,
                                                    causal), iters=1, repeats=3, warmup=1)
        lib_ms = lib_call = None
        if cap is None and window is None:
            assert not causal or sq == sk  # SDPA's causal diagonal is top-left
            qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
            lib_out = sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True)

            def lib():
                return torch.autograd.grad(lib_out, (qs, ks, vs), do, retain_graph=True)

            lib_call, lib_ms = call_ms(lib, iters=3, repeats=3, warmup=2), queued_ms(
                lib, iters=3, repeats=3)
            del lib_out, qs, ks, vs
        _, _, fwd_bytes, _, pairs = attention_bound(q.flatten(0, 1), k.flatten(0, 1),
                                                    v.flatten(0, 1), causal, window)
        nbytes = 2 * fwd_bytes + lse.numel() * 4  # q, o, dO, dq; k, v, dk, dv; the lse
        flops = 10 * pairs * dh
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        bound, by = max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"
        shape = (f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} Dh={dh} "
                 f"{'causal' if causal else 'non-causal'} {str(dtype)[6:]}" +
                 (f" window={window}" if window else "") +
                 (f" softcap={cap:g}, q x{SOFTCAP_Q_SCALE:g}" if cap else ""))
        out["configs"].append(dict(
            shape=shape, ms=ms, ms_min=lo, ms_max=hi, call_ms=call[0], plain_ms=pcall[0],
            bound_ms=bound, bound_by=by, bound_bytes=nbytes, bound_flops=flops,
            tflops=flops / (ms * 1e-3) / 1e12, max_abs_err=max(e for e, _ in errs),
            rel_errs=[r for _, r in errs], fault_rel_errs=[r for _, r in fault],
            library="SDPA backward" if lib_ms else None, library_ms=lib_ms and lib_ms[0],
            library_call_ms=lib_call and lib_call[0], seconds=time.perf_counter() - t_shape))
        out["max_abs_err"] = max(out["max_abs_err"], max(e for e, _ in errs))
        out["max_rel_err"] = max(out["max_rel_err"], max(r for _, r in errs))
        log(f"  flash_attention_bwd [{what}: {shape}] max |kernel - plain| / max |plain| "
            f"dq/dk/dv = {', '.join(f'{r:.3e}' for _, r in errs)} (tolerance {tol:g}; with P "
            f"halved in the plain version {', '.join(f'{r:.3e}' for _, r in fault)}) | kernel "
            f"queued={ms:.3f} ms (min {lo:.3f}, max {hi:.3f}) call={call[0]:.3f} ms | plain "
            f"call={pcall[0]:.3f} ms | bound={bound:.4f} ms by {by} ({nbytes} B; {pairs} visible "
            f"pairs, {flops} flop) | achieved {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
            f"{bound / ms:.4f} of the bound | " + (
                f"SDPA backward queued={lib_ms[0]:.3f} ms (min {lib_ms[1]:.3f}, max "
                f"{lib_ms[2]:.3f}) call={lib_call[0]:.3f} ms; kernel / SDPA = "
                f"{ms / lib_ms[0]:.2f}" if lib_ms else "no library call computes this function")
            + f" | {time.perf_counter() - t_shape:.1f} s")
        del q, k, v, do, o, lse, got, want, fault
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def swapped(mod, name, fn):
    """``mod.<name>`` replaced by ``fn`` inside the context: a kernel's
    wrapper swapped for its plain version, whose autograd then runs."""
    kept = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, kept)


def attention_plain(q, k, v, *, causal=True, softcap=None, chunk=512, window=None, lse=None):
    """``fa.attention`` through the plain version (``ref.attention_ref``, its
    scores materialised)."""
    from repro_torch.kernels.flash_attention import ref

    flat = [x.reshape(-1, *x.shape[-2:]) for x in (q, k, v)]
    return ref.attention_ref(*flat, causal=causal, softcap=softcap,
                             window=window).reshape(q.shape)


def train_grads(cfg, lm, batch, leaves):
    """One step's loss, global grad norm and the gradients of the named
    ``leaves`` (float32 copies), the others freed."""
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import _loss

    names = [n for n, _ in lm.named_parameters()]
    params = [p.requires_grad_(True) for p in lm.parameters()]
    loss = _loss(cfg, lm, batch, 0.0)
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    kept = {n: g.float().clone() for n, g in zip(names, grads) if n in leaves}
    gnorm = float(global_norm(grads))
    del grads
    return float(loss.detach()), gnorm, kept


def train_step_check(mod, bwd, plain, phase, cfg, lm, batch, tol, what, leaves):
    """The step's loss, grad norm and named leaves' gradients on the kernels
    (forward and backward) against the same step with the kernels of
    ``mod`` swapped for their plain versions' autograd (the context
    ``plain``, a ``swapped``), on the card; the backward kernel ``bwd`` must
    run once a layer."""
    mod.reset_launches()
    t0 = time.perf_counter()
    got = train_grads(cfg, lm, batch, leaves)
    torch.cuda.synchronize()
    k_s, seen = time.perf_counter() - t0, dict(mod.launches)
    assert seen[bwd] == cfg.num_layers, seen
    t0 = time.perf_counter()
    with plain:
        want = train_grads(cfg, lm, batch, leaves)
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    loss_err = abs(got[0] - want[0]) / abs(want[0])
    gnorm_err = abs(got[1] - want[1]) / want[1]
    leaf_errs = {n: float((got[2][n] - want[2][n]).abs().max() / want[2][n].abs().max())
                 for n in leaves}
    log(f"{phase}: {what}: loss {got[0]:.6f} (plain version {want[0]:.6f}, rel {loss_err:.2e}) "
        f"grad norm {got[1]:.6f} (plain {want[1]:.6f}, rel {gnorm_err:.2e}); leaves' "
        f"max |kernel - plain| / max |plain|: " +
        ", ".join(f"{n} {e:.2e}" for n, e in leaf_errs.items()) +
        f" (tolerances {tol}) | step on the kernels {k_s:.2f} s, on the plain version "
        f"{p_s:.2f} s (both first calls) | kernel launches {seen}")
    assert math.isfinite(got[0]) and math.isfinite(got[1])
    assert loss_err < tol["loss"] and gnorm_err < tol["grad_norm"], (loss_err, gnorm_err)
    assert all(e < tol["leaf"] for e in leaf_errs.values()), leaf_errs
    return dict(loss=got[0], plain_loss=want[0], grad_norm=got[1], plain_grad_norm=want[1],
                leaf_rel_errs=leaf_errs, step_s=k_s, plain_step_s=p_s)


def phase_train_granite(fa):
    """Phase 18: granite-3-8b at full width cut to ``TRAIN_LAYERS`` layers
    (B x S = ``TRAIN_SHAPE``, the seeded Zipf stream): one step's loss, grad
    norm and leaves on the kernels against plain attention, then
    ``TRAIN_STEPS`` steps through ``launch.train.train`` (the driver's loop:
    adaptive microbatches, AdamW in float32 state) on the forward and
    backward kernels, with their launches, tokens/s, step times and peak
    memory; then the comparison in float32 at ``TRAIN_F32_LAYERS`` layers.
    Returns each kernel's launches in the training steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as T
    from repro_torch.train.data import DataConfig, synth_batch

    b, s = TRAIN_SHAPE
    full = get_config("granite-3-8b")
    cfg = full.scaled(num_layers=TRAIN_LAYERS)
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b), 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = T.init_params(cfg, torch.Generator(device=DEV).manual_seed(18), device=DEV)
    nbytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    log(f"phase 18: {cfg.name} full width cut to {cfg.num_layers} of its {full.num_layers} "
        f"layers: {cfg.param_count()} parameters (param_count), {nbytes / 1e9:.2f} GB of bf16 "
        f"weights, initialised on the card in {time.perf_counter() - t0:.2f} s; B={b} x S={s}")
    check = train_step_check(fa, "flash_attention_bwd", swapped(fa, "attention", attention_plain),
                             "phase 18", cfg, lm, batch, TRAIN_TOL[torch.bfloat16], "bf16",
                             TRAIN_LEAVES)
    torch.cuda.synchronize()
    log(f"phase 18: comparison peak max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    lines = []
    res = train(cfg, steps=TRAIN_STEPS, global_batch=b, seq_len=s, log_every=1, device=DEV,
                lm=lm, log=lambda m: (lines.append(m), log(f"phase 18: {m}")))
    torch.cuda.synchronize()
    seen = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in res["history"]]
    step_s = [h["step_s"] for h in res["history"]]
    log(f"phase 18: {TRAIN_STEPS} steps ({res['decision'].note}, est. activations "
        f"{res['decision'].est_activation_bytes / 1e9:.2f} GB): losses {losses}, grad norms "
        f"{[h['grad_norm'] for h in res['history']]}, step times {step_s} s, "
        f"tokens/s={res['tokens_per_s']:,.0f} (steps after the first "
        f"{b * s / (sum(step_s[1:]) / max(len(step_s) - 1, 1)):,.0f}), "
        f"peak max_memory_allocated={peak:.2f} GB, launches {seen}")
    assert all(math.isfinite(x) for x in losses) and len(losses) == TRAIN_STEPS
    want = {"flash_attention": 2 * cfg.num_layers * TRAIN_STEPS,  # forward and its recompute
            "flash_attention_bwd": cfg.num_layers * TRAIN_STEPS}
    assert seen == want, (seen, want)
    del lm, res
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = full.scaled(num_layers=TRAIN_F32_LAYERS, dtype="float32")
    lm = T.init_params(cfg32, torch.Generator(device=DEV).manual_seed(18), device=DEV)
    check32 = train_step_check(fa, "flash_attention_bwd",
                               swapped(fa, "attention", attention_plain), "phase 18", cfg32,
                               lm, batch, TRAIN_TOL[torch.float32],
                               f"float32 at {TRAIN_F32_LAYERS} layers", TRAIN_F32_LEAVES)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return seen, dict(bf16=check, float32=check32, steps=dict(
        losses=losses, step_s=step_s, peak_gb=peak, launches=seen))


def phase_train_driver():
    """Phase 19: the training driver (``python -m repro_torch.launch.train``)
    on the card at the smoke size: a run killed by ``--fail-at`` (exit 42)
    after its async checkpoints, then the same command resuming from the
    latest valid checkpoint to the end, as the reference's restart test."""
    import shutil
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    ck = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite-3-8b",
           "--smoke", "--steps", "16", "--ckpt-dir", ck, "--ckpt-every", "2",
           "--global-batch", "4", "--seq-len", "16", "--log-every", "5"]
    try:
        t0 = time.perf_counter()
        r1 = subprocess.run(cmd + ["--fail-at", "12"], env=env, cwd=root, capture_output=True,
                            text=True, timeout=300)
        t1 = time.perf_counter()
        r2 = subprocess.run(cmd, env=env, cwd=root, capture_output=True, text=True, timeout=300)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    for label, r, wall in (("crashed run", r1, t1 - t0), ("resumed run", r2, t2 - t1)):
        log(f"phase 19: {label} exit {r.returncode} in {wall:.1f} s:")
        for line in r.stdout.strip().splitlines():
            log(f"phase 19:   {line}")
    assert r1.returncode == 42 and "injected failure at step 12" in r1.stdout, r1.stderr[-2000:]
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resuming from valid checkpoint step" in r2.stdout and "done: final loss" in r2.stdout


# ---------------------------------------------------------------------------
# Phases 20-21: the recurrences' backward kernels, and training through them
# ---------------------------------------------------------------------------

def grad_rels(got, want):
    """max |got - want| / max |want| of each gradient, after checking dtype,
    shape and finiteness."""
    out = []
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
        assert bool(torch.isfinite(g).all())
        diff = float((g.float() - w.float()).abs().max())
        out.append(diff / max(float(w.float().abs().max()), 1e-30))
    return out


def rwkv_bwd_bound(args, do, ds):
    """(bound ms, what bounds it, bytes, flops, bytes ms, ops ms): r, k, v,
    w, u, dout (and dS_T) read once, dr, dk, dv, dw, du written once, at
    3.35 TB/s; against 14 float32 operations an element of the state a step
    (S recomputed: 3; S do, G v, G^T k, G.S: 2 each; G's update: 3) at 67
    TFLOP/s. The kernel does 17: it walks S forward twice."""
    r, v = args[0], args[2]
    bh, t, kd = r.shape
    vd = v.shape[-1]
    ins = sum(x.numel() * x.element_size() for x in args)
    nbytes = 2 * ins + do.numel() * 4 + (0 if ds is None else ds.numel() * 4)
    flops = 14 * bh * t * kd * vd
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), \
        nbytes, flops, bytes_ms, ops_ms


def scan_bwd_bound(args, clock_hz):
    """(bound ms, what bounds it, bytes, exponentials, bytes ms, exp ms):
    dt, x, a, B, C, h0, dy and dh_T read once, ddt, dx, da, dB, dC and dh0
    written once, at 3.35 TB/s; against the B*T*Di*N decays' exponentials
    taken once (16 a clock an SM at the card's highest SM clock). The kernel
    takes each twice (once in each walk over a tile)."""
    dt, x, a, bm, cm, h0 = args
    b, t, di = dt.shape
    n = a.shape[1]
    es = x.element_size()
    nbytes = (dt.numel() * (4 + es + 4 + 4 + es)          # dt, x, dy read; ddt, dx written
              + (bm.numel() + cm.numel()) * es * 2        # B, C read; dB, dC written
              + a.numel() * 4 * 2 + h0.numel() * 4 * 3)   # a, h0, dh_T read; da, dh0 written
    exps = b * t * di * n
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    exp_ms = exps / (sms * SFU_EXP_PER_CLOCK * clock_hz) * 1e3
    return max(bytes_ms, exp_ms), ("bytes" if bytes_ms >= exp_ms else "operations"), \
        nbytes, exps, bytes_ms, exp_ms


def bwd_timings(kernel, plain):
    """The kernel's CUDA-event call time and queued device time, and the
    plain version's call time: CUDA events around one call, warmed by the
    correctness check's call (it launches tens of torch ops a step and
    takes seconds, so one call reads it to well under a percent)."""
    call = call_ms(kernel, iters=3, repeats=3, warmup=2)
    queued = queued_ms(kernel, iters=3, repeats=3)
    pcall = call_ms(plain, iters=1, repeats=1, warmup=0)
    return call, queued, pcall


def phase_rwkv6_backward(rk):
    """The RWKV6 backward kernel against ``rwkv6_bwd_ref`` at the training
    shapes with times and bound, then untimed at the decay edges, and
    against u's terms dropped from the plain version (the check must fail)."""
    from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref

    gen = torch.Generator(device=DEV).manual_seed(20)
    out = {"max_abs_err": 0.0, "max_rel_err": 0.0, "configs": [], "edges": {}}

    def cotangents(bh, t, with_ds):
        do = torch.randn((bh, t, 64), generator=gen, device=DEV)
        return do, (torch.randn((bh, 64, 64), generator=gen, device=DEV) if with_ds else None)

    for what, bh, t, dtype, with_ds in RWKV_BWD_SHAPES:
        t_shape = time.perf_counter()
        args = rwkv_inputs(bh, t, gen, dtype=dtype)
        do, ds = cotangents(bh, t, with_ds)
        got = rk.rwkv6_bwd(*args, do, ds)
        want = rwkv6_bwd_ref(*args, do, ds)
        torch.cuda.synchronize()
        rels, tol = grad_rels(got, want), BWD_TOL[dtype]
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        assert max(rels) < tol, f"rwkv6_bwd {what}: dr, dk, dv, dw, du {rels} (tolerance {tol})"
        del got, want
        call, (ms, lo, hi), pcall = bwd_timings(lambda: rk.rwkv6_bwd(*args, do, ds),
                                                lambda: rwkv6_bwd_ref(*args, do, ds))
        bound, by, nbytes, flops, bytes_ms, ops_ms = rwkv_bwd_bound(args, do, ds)
        shape = f"BH={bh} T={t} K=V=64 {str(dtype)[6:]}" + (" +dS_T" if with_ds else "")
        out["configs"].append(dict(
            shape=shape, ms=ms, ms_min=lo, ms_max=hi, call_ms=call[0], plain_ms=pcall[0],
            bound_ms=bound, bound_by=by, bound_bytes=nbytes, bound_flops=flops,
            max_abs_err=err, rel_errs=rels, library_ms=None,
            seconds=time.perf_counter() - t_shape))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["max_rel_err"] = max(out["max_rel_err"], max(rels))
        log(f"  rwkv6_bwd [{what}: {shape}] max |kernel - plain| / max |plain| dr/dk/dv/dw/du "
            f"= {', '.join(f'{r:.3e}' for r in rels)} (tolerance {tol:g}) | kernel queued="
            f"{ms:.4f} ms (min {lo:.4f}, max {hi:.4f}) call={call[0]:.4f} ms | plain call="
            f"{pcall[0]:.2f} ms | bound={bound:.4f} ms by {by} (bytes {nbytes} -> "
            f"{bytes_ms:.4f} ms at 3.35 TB/s; {flops} flop -> {ops_ms:.4f} ms at 67 TFLOP/s "
            f"f32), {bound / ms:.3f} of the bound | library: none | "
            f"{time.perf_counter() - t_shape:.1f} s")
        del args, do, ds
    levels = torch.tensor([x for x in RWKV_BWD_EDGES.values() if x is not None], device=DEV)
    for edge, value in RWKV_BWD_EDGES.items():
        args = rwkv_inputs(32, 1024, gen)
        shape = args[3].shape
        w = (levels[torch.randint(0, len(levels), shape, generator=gen, device=DEV)]
             if value is None else torch.full(shape, value, device=DEV))
        args[3] = w.to(args[3].dtype)
        do, ds = cotangents(32, 1024, True)
        rels = grad_rels(rk.rwkv6_bwd(*args, do, ds), rwkv6_bwd_ref(*args, do, ds))
        out["edges"][edge] = max(rels)
        log(f"  rwkv6_bwd [decay edge {edge}: BH=32 T=1024 K=V=64 bf16 +dS_T] max |kernel - "
            f"plain| / max |plain| {max(rels):.3e} (tolerance {BWD_TOL[torch.bfloat16]:g})")
        assert max(rels) < BWD_TOL[torch.bfloat16], (edge, rels)
    args = rwkv_inputs(32, 1024, gen, dtype=torch.float32)
    do, _ = cotangents(32, 1024, False)
    got = rk.rwkv6_bwd(*args, do)
    bad = rwkv6_bwd_ref(*args[:4], torch.zeros_like(args[4]), do)
    fault = max(grad_rels(got[:4], bad[:4]))
    out["edges"]["fault: u's terms dropped"] = fault
    log(f"  rwkv6_bwd [fault in the plain version: u's terms dropped, BH=32 T=1024 float32] "
        f"{fault:.3e} (the check fails above {BWD_TOL[torch.float32]:g})")
    assert fault > BWD_TOL[torch.float32]
    return out


def phase_scan_backward(sk):
    """The scan's backward kernel against ``ssm_scan_bwd_ref`` at jamba's
    training shape (its tile states from the forward kernel, as training
    keeps them) and a float32 shape with h0 and dh_T, with times and bound;
    then untimed at the decay edges, and against dh_T ignored by the plain
    version (the check must fail)."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref

    clock = sm_clock_hz()
    gen = torch.Generator(device=DEV).manual_seed(20)
    out = {"max_abs_err": 0.0, "max_rel_err": 0.0, "configs": [], "edges": {}}

    def cotangents(b, t, nonzero):
        dy = torch.randn((b, t, SCAN_DI), generator=gen, device=DEV)
        dh = torch.randn((b, SCAN_DI, SCAN_N), generator=gen, device=DEV) if nonzero else \
            torch.zeros((b, SCAN_DI, SCAN_N), device=DEV)
        return dy, dh

    def kernel_bwd(args, dy, dh):
        """The backward kernel from the tile states the forward kernel keeps."""
        return sk.ssm_scan_bwd(*args, dy, dh, hb=sk._scan(*args, tile_states=True)[2])

    for what, b, t, dtype, nonzero in SCAN_BWD_SHAPES:
        t_shape = time.perf_counter()
        args = scan_inputs(b, t, gen, h0=nonzero, dtype=dtype)
        dy, dh = cotangents(b, t, nonzero)
        hb = sk._scan(*args, tile_states=True)[2]
        got = sk.ssm_scan_bwd(*args, dy, dh, hb=hb)
        want = ssm_scan_bwd_ref(*args, dy, dh)
        torch.cuda.synchronize()
        rels, tol = grad_rels(got, want), BWD_TOL[dtype]
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        assert max(rels) < tol, (f"ssm_scan_bwd {what}: ddt, dx, da, dB, dC, dh0 {rels} "
                                 f"(tolerance {tol})")
        del got, want
        call, (ms, lo, hi), pcall = bwd_timings(lambda: sk.ssm_scan_bwd(*args, dy, dh, hb=hb),
                                                lambda: ssm_scan_bwd_ref(*args, dy, dh))
        bound, by, nbytes, exps, bytes_ms, exp_ms = scan_bwd_bound(args, clock)
        shape = f"B={b} T={t} Di={SCAN_DI} N={SCAN_N} {str(dtype)[6:]}" + \
            (" +h0 +dh_T" if nonzero else "")
        out["configs"].append(dict(
            shape=shape, ms=ms, ms_min=lo, ms_max=hi, call_ms=call[0], plain_ms=pcall[0],
            bound_ms=bound, bound_by=by, bound_bytes=nbytes, bound_exps=exps,
            max_abs_err=err, rel_errs=rels, library_ms=None,
            seconds=time.perf_counter() - t_shape))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["max_rel_err"] = max(out["max_rel_err"], max(rels))
        log(f"  ssm_scan_bwd [{what}: {shape}] max |kernel - plain| / max |plain| "
            f"ddt/dx/da/dB/dC/dh0 = {', '.join(f'{r:.3e}' for r in rels)} (tolerance {tol:g}) "
            f"| kernel queued={ms:.4f} ms (min {lo:.4f}, max {hi:.4f}) call={call[0]:.4f} ms "
            f"(the forward that keeps the tile states not included) | plain call="
            f"{pcall[0]:.2f} ms | bound={bound:.4f} ms by {by} (bytes {nbytes} -> "
            f"{bytes_ms:.4f} ms at 3.35 TB/s; {exps} exp -> {exp_ms:.4f} ms at 16 a clock an "
            f"SM), {bound / ms:.3f} of the bound | library: none | "
            f"{time.perf_counter() - t_shape:.1f} s")
        del args, dy, dh, hb
    for edge, b, t, dt_scale in (("decay underflows to 0", 2, 512, 200.0),
                                 ("decay about 1 over 4,096 steps", 1, 4096, 1e-5)):
        args = scan_inputs(b, t, gen, h0=True, dt_scale=dt_scale)
        dy, dh = cotangents(b, t, True)
        rels = grad_rels(kernel_bwd(args, dy, dh), ssm_scan_bwd_ref(*args, dy, dh))
        out["edges"][edge] = max(rels)
        log(f"  ssm_scan_bwd [edge: {edge}, B={b} T={t} bf16 +h0 +dh_T] max |kernel - plain| / "
            f"max |plain| {max(rels):.3e} (tolerance {BWD_TOL[torch.bfloat16]:g})")
        assert max(rels) < BWD_TOL[torch.bfloat16], (edge, rels)
    args = scan_inputs(1, 1024, gen, h0=True, dt_scale=0.05, dtype=torch.float32)
    dy, dh = cotangents(1, 1024, True)
    fault = max(grad_rels(kernel_bwd(args, dy, dh),
                          ssm_scan_bwd_ref(*args, dy, torch.zeros_like(dh))))
    out["edges"]["fault: dh_T ignored"] = fault
    log(f"  ssm_scan_bwd [fault in the plain version: dh_T ignored, B=1 T=1024 float32] "
        f"{fault:.3e} (the check fails above {BWD_TOL[torch.float32]:g})")
    assert fault > BWD_TOL[torch.float32]
    return out


def phase_train_rwkv6(rk):
    """Phase 21a: rwkv6-7b at full width: one step's loss, grad norm and five
    leaves on the kernels against the plain chunked form's autograd at
    ``RWKV_CMP_LAYERS`` layers in bf16; then, cut to ``RWKV_TRAIN_LAYERS``
    layers (B x S = ``TRAIN_SHAPE``, the seeded Zipf stream),
    ``TRAIN_STEPS`` steps through ``launch.train.train`` on the forward and
    backward kernels, with their launches, tokens/s, step times and peak
    memory; then the comparison in float32. Returns the kernels' launches in
    the training steps and the records."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as T
    from repro_torch.train.data import DataConfig, synth_batch

    b, s = TRAIN_SHAPE
    full = get_config("rwkv6-7b")
    batch = synth_batch(DataConfig(vocab_size=full.vocab_size, seq_len=s, global_batch=b), 0)

    def compare(dtype):
        cfg = full.scaled(num_layers=RWKV_CMP_LAYERS, dtype=str(dtype)[6:])
        lm = T.init_params(cfg, torch.Generator(device=DEV).manual_seed(21), device=DEV)
        check = train_step_check(rk, "rwkv6_bwd", swapped(rk, "rwkv6", rk.rwkv6_chunked),
                                 "phase 21", cfg, lm, batch, RWKV_TRAIN_TOL[dtype],
                                 f"{str(dtype)[6:]} at {cfg.num_layers} layers", RWKV_CMP_LEAVES)
        del lm
        gc.collect()
        torch.cuda.empty_cache()
        return check

    check = compare(torch.bfloat16)
    cfg = full.scaled(num_layers=RWKV_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = T.init_params(cfg, torch.Generator(device=DEV).manual_seed(21), device=DEV)
    nbytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    log(f"phase 21: {cfg.name} full width cut to {cfg.num_layers} of its {full.num_layers} "
        f"layers: {cfg.param_count()} parameters (param_count), {nbytes / 1e9:.2f} GB of "
        f"weights, initialised on the card in {time.perf_counter() - t0:.2f} s; B={b} x S={s}")
    rk.reset_launches()
    res = train(cfg, steps=TRAIN_STEPS, global_batch=b, seq_len=s, log_every=1, device=DEV,
                lm=lm, log=lambda m: log(f"phase 21: {m}"))
    torch.cuda.synchronize()
    seen = dict(rk.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in res["history"]]
    step_s = [h["step_s"] for h in res["history"]]
    later = b * s / (sum(step_s[1:]) / max(len(step_s) - 1, 1))
    tokens_per_s = res["tokens_per_s"]
    log(f"phase 21: {TRAIN_STEPS} steps ({res['decision'].note}, est. activations "
        f"{res['decision'].est_activation_bytes / 1e9:.2f} GB): losses {losses}, grad norms "
        f"{[h['grad_norm'] for h in res['history']]}, step times {step_s} s, "
        f"tokens/s={tokens_per_s:,.0f} (steps after the first {later:,.0f}), "
        f"peak max_memory_allocated={peak:.2f} GB, launches {seen}")
    assert all(math.isfinite(x) for x in losses) and len(losses) == TRAIN_STEPS
    want = {"rwkv6": 2 * cfg.num_layers * TRAIN_STEPS,  # forward and its recompute
            "rwkv6_bwd": cfg.num_layers * TRAIN_STEPS}
    assert seen == want, (seen, want)
    del lm, res
    gc.collect()
    torch.cuda.empty_cache()
    check32 = compare(torch.float32)
    return seen, dict(bf16=check, float32=check32, steps=dict(
        losses=losses, step_s=step_s, tokens_per_s=tokens_per_s, tokens_per_s_later=later,
        peak_gb=peak, launches=seen))


def phase_train_mamba_layer(sk):
    """Phase 21b: jamba-v0.1-52b's Mamba mixer at full width as a layer
    (``models/ssm.py::mamba_block``, ``mamba_init``'s parameters), one
    forward and backward at B x S = ``TRAIN_SHAPE`` of a scalar loss (the
    output against a seeded cotangent), in bf16 and float32: every
    parameter's gradient and the input's on the kernels against the plain
    scan's autograd, with the scan kernels' launches, times and peak memory.
    Returns the launches of the bf16 leg and the records."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models.ssm import mamba_block, mamba_init

    cfg = get_config("jamba-v0.1-52b")
    b, s = TRAIN_SHAPE
    out, seen_bf16 = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=DEV).manual_seed(21)
        p = mamba_init(gen, cfg.d_model, expand=cfg.mamba_expand, state=cfg.ssm_state,
                       conv_dim=cfg.ssm_conv, dtype=dtype)
        names = [n for n, _ in p.named_parameters()]
        params = [t.requires_grad_(True) for t in p.parameters()]
        x = torch.randn((b, s, cfg.d_model), generator=gen, device=DEV).to(dtype)
        x.requires_grad_(True)
        cot = torch.randn((b, s, cfg.d_model), generator=gen, device=DEV)

        def step():
            y, _ = mamba_block(p, x)
            return torch.autograd.grad((y.float() * cot).sum(), [x, *params])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.reset_launches()
        t0 = time.perf_counter()
        got = step()
        torch.cuda.synchronize()
        k_s, seen = time.perf_counter() - t0, dict(sk.launches)
        k_peak = torch.cuda.max_memory_allocated() / 1e9
        assert seen == {"ssm_scan": 1, "ssm_scan_bwd": 1}, seen
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with swapped(sk, "ssm_scan", ssm_scan_ref):
            want = step()
        torch.cuda.synchronize()
        p_s = time.perf_counter() - t0
        p_peak = torch.cuda.max_memory_allocated() / 1e9
        errs = dict(zip(["x", *names], grad_rels(got, want)))
        tol = MAMBA_TRAIN_TOL[dtype]
        what = str(dtype)[6:]
        log(f"phase 21: jamba's Mamba mixer at full width (d_model {cfg.d_model}, Di "
            f"{cfg.mamba_expand * cfg.d_model}, N {cfg.ssm_state}), B={b} x S={s}, {what}: "
            f"gradients' max |kernel - plain| / max |plain|: " +
            ", ".join(f"{n} {e:.2e}" for n, e in errs.items()) + f" (tolerance {tol:g}) | "
            f"forward + backward on the kernels {k_s:.3f} s (peak {k_peak:.2f} GB), on the "
            f"plain scan {p_s:.3f} s (peak {p_peak:.2f} GB), both first calls | launches {seen}")
        assert all(e < tol for e in errs.values()), errs
        out[what] = dict(rel_errs=errs, step_s=k_s, plain_step_s=p_s, peak_gb=k_peak,
                         plain_peak_gb=p_peak, launches=seen)
        seen_bf16 = seen_bf16 or seen
        del p, params, x, cot, got, want
        gc.collect()
        torch.cuda.empty_cache()
    return seen_bf16, out


def rwkv_depth_witness() -> int:
    """``python3 chip_smoke.py --rwkv-depth-witness``: how far rwkv6-7b's
    gradients at full width part, by depth, when only its forward's rounding
    changes. In float32, B x S = ``TRAIN_SHAPE``, phase 21's weights and
    batch, at each of ``RWKV_WITNESS_LAYERS`` layers: the plain chunked form
    at chunk 16, and the kernels, each against the plain chunked form at the
    model's chunk 64 (loss, grad norm, five leaves of the first and of the
    last layer). Not a phase of the smoke: it prints its readings, and
    asserts only that they are finite."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import ops as rk
    from repro_torch.models import transformer as T
    from repro_torch.train.data import DataConfig, synth_batch

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    b, s = TRAIN_SHAPE
    full = get_config("rwkv6-7b")
    batch = synth_batch(DataConfig(vocab_size=full.vocab_size, seq_len=s, global_batch=b), 0)

    def chunk16(r, k, v, w, u, *, chunk=64, return_state=False):
        return rk.rwkv6_chunked(r, k, v, w, u, chunk=16, return_state=return_state)

    for layers in RWKV_WITNESS_LAYERS:
        cfg = full.scaled(num_layers=layers, dtype="float32")
        lm = T.init_params(cfg, torch.Generator(device=DEV).manual_seed(21), device=DEV)
        leaves = tuple(f"blocks.{i}.rwkv.{n}" for i in (0, layers - 1) for n in RWKV_LEAF_NAMES)
        with swapped(rk, "rwkv6", rk.rwkv6_chunked):
            base = train_grads(cfg, lm, batch, leaves)
        for what, ctx in (("plain chunked form at chunk 16", swapped(rk, "rwkv6", chunk16)),
                          ("kernels", contextlib.nullcontext())):
            t0 = time.perf_counter()
            with ctx:
                got = train_grads(cfg, lm, batch, leaves)
            torch.cuda.synchronize()
            errs = {n: float((got[2][n] - base[2][n]).abs().max() / base[2][n].abs().max())
                    for n in leaves}
            log(f"rwkv depth witness: float32 at {layers} layers, {what} against the plain "
                f"chunked form at chunk 64: loss {got[0]:.7f} ({base[0]:.7f}, rel "
                f"{abs(got[0] - base[0]) / abs(base[0]):.2e}) grad norm {got[1]:.6f} "
                f"({base[1]:.6f}, rel {abs(got[1] - base[1]) / base[1]:.2e}); leaves' max |a - "
                f"b| / max |b|: " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()) +
                f" | {time.perf_counter() - t0:.1f} s")
            assert math.isfinite(got[0]) and math.isfinite(got[1])
        del lm, base, got
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.intersect import ops as ik
    from repro_torch.kernels.rwkv6 import ops as rk
    from repro_torch.kernels.ssm_scan import ops as sk

    # -- phase 1 ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = (ik.LIB, rk.LIB, fa.LIB, fa.BWD_LIB, sk.LIB, rk.BWD_LIB, sk.BWD_LIB, chase_library())
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source, started together
        list(pool.map(lambda lib: lib.build(), libs))
    for lib in libs:
        lib.load()
        log(f"phase 1: {lib.name} built in {lib.build_seconds:.2f} s -> {lib.library_path()}")
        for line in lib.build_log.splitlines():
            if any(w in line.lower() for w in ("registers", "spill", "compiling entry", "warning")):
                log(f"phase 1:   {line.strip()}")
    log(f"phase 1: builds took {time.perf_counter() - t0:.2f} s of wall time")

    rec, launches = enumeration_phases(ik)
    torch.cuda.empty_cache()  # the 16 GB adjacency of phase 5 goes back to the card
    log(f"chip_smoke: phases 1-5b done at {time.perf_counter() - t_all:.1f} s")

    # -- phases 6-8 ------------------------------------------------------------
    rwkv = phase_rwkv6_kernel(rk)
    log(f"chip_smoke: phase 6 done at {time.perf_counter() - t_all:.1f} s")
    launches["rwkv6"] = lm_phases(LMPath(
        "rwkv6-7b", (KernelUse(rk, "rwkv6", "rwkv6_kernel", 0),), "phase 7", "phase 8"))["rwkv6"]
    log(f"chip_smoke: phases 6-8 done at {time.perf_counter() - t_all:.1f} s")

    # -- phases 9-11 -----------------------------------------------------------
    flash = phase_flash_kernel(fa)
    log(f"chip_smoke: phase 9 done at {time.perf_counter() - t_all:.1f} s")
    attn = (KernelUse(fa, "flash_attention", "flash_", 1),)
    launches["flash_attention"] = lm_phases(LMPath(
        "granite-3-8b", attn, "phase 10", "phase 11", GRANITE_FORMS))["flash_attention"]
    log(f"chip_smoke: phases 9-11 done at {time.perf_counter() - t_all:.1f} s")

    # -- phase 12: gemma2-9b, its local layers' window in the flash kernel ------
    launches["flash_attention"] += lm_phases(LMPath(
        "gemma2-9b", attn, "phase 12", "phase 12", GEMMA2_FORMS, forward=GEMMA2_FORWARD,
        serve=GEMMA2_SERVE))["flash_attention"]
    log(f"chip_smoke: phase 12 done at {time.perf_counter() - t_all:.1f} s")

    # -- phase 13: chatglm3-6b and command-r-35b --------------------------------
    for arch in ("chatglm3-6b", "command-r-35b"):
        launches["flash_attention"] += lm_phases(LMPath(
            arch, attn, "phase 13", "phase 13", DENSE_FORMS[arch],
            forward=DENSE_FORWARD[arch], serve=DENSE_SERVE,
            widen=arch != "command-r-35b"))["flash_attention"]
    log(f"chip_smoke: phase 13 done at {time.perf_counter() - t_all:.1f} s")

    # -- phase 14: qwen3-moe-30b-a3b, the MoE layer -------------------------------
    launches["flash_attention"] += lm_phases(LMPath(
        "qwen3-moe-30b-a3b", attn, "phase 14", "phase 14", GRANITE_FORMS,
        forward=QWEN3_FORWARD, serve=DENSE_SERVE, widen=False, f32_leg=QWEN3_F32,
        lossless_ref=True))["flash_attention"]
    log(f"chip_smoke: phase 14 done at {time.perf_counter() - t_all:.1f} s")

    # -- phase 15: jamba-v0.1-52b, the Mamba mixer on the ssm_scan kernel --------
    t15 = time.perf_counter()
    scan = phase_ssm_scan_kernel(sk)
    scan["mamba_layer"] = phase_mamba_cache()
    log(f"chip_smoke: phase 15's kernel and layer checks done at "
        f"{time.perf_counter() - t_all:.1f} s")
    jamba = lm_phases(LMPath(
        "jamba-v0.1-52b", (KernelUse(fa, "flash_attention", "flash_", 1, ("attn",)),
                           KernelUse(sk, "ssm_scan", "ssm_scan_kernel", 1, ("mamba",))),
        "phase 15", "phase 15", GRANITE_FORMS, forward=JAMBA_FORWARD, serve=DENSE_SERVE,
        widen=False, f32_leg=JAMBA_F32, lossless_ref=True, layers=JAMBA_LAYERS,
        ref_len=JAMBA_REF_LEN))
    launches["flash_attention"] += jamba["flash_attention"]
    launches["ssm_scan"] = jamba["ssm_scan"]
    log(f"chip_smoke: phase 15 took {time.perf_counter() - t15:.1f} s, done at "
        f"{time.perf_counter() - t_all:.1f} s")

    # -- phase 16: seamless-m4t's encoder-decoder, phi-3-vision's patches -------
    t16 = time.perf_counter()
    launches["flash_attention"] += lm_phases(LMPath(
        "seamless-m4t-large-v2", (KernelUse(fa, "flash_attention", "flash_", 1, cross=True),),
        "phase 16", "phase 16", GRANITE_FORMS, forward=SEAMLESS_FORWARD, serve=SEAMLESS_SERVE,
        frontend=SEAMLESS_FRAMES))["flash_attention"]
    log(f"chip_smoke: phase 16's seamless-m4t-large-v2 took {time.perf_counter() - t16:.1f} s")
    t16 = time.perf_counter()
    launches["flash_attention"] += lm_phases(LMPath(
        "phi-3-vision-4.2b", attn, "phase 16", "phase 16", GRANITE_FORMS, forward=PHI3V_FORWARD,
        serve=DENSE_SERVE, frontend=PHI3V_PATCHES))["flash_attention"]
    log(f"chip_smoke: phase 16's phi-3-vision-4.2b took {time.perf_counter() - t16:.1f} s, "
        f"done at {time.perf_counter() - t_all:.1f} s")

    # -- phases 17-19: training ---------------------------------------------------
    t17 = time.perf_counter()
    flash_bwd = phase_flash_backward(fa)
    log(f"chip_smoke: phase 17 took {time.perf_counter() - t17:.1f} s")
    t18 = time.perf_counter()
    seen, flash_bwd["training"] = phase_train_granite(fa)
    launches["flash_attention"] += seen["flash_attention"]
    launches["flash_attention_bwd"] = seen["flash_attention_bwd"]
    log(f"chip_smoke: phase 18 took {time.perf_counter() - t18:.1f} s")
    t19 = time.perf_counter()
    phase_train_driver()
    log(f"chip_smoke: phase 19 took {time.perf_counter() - t19:.1f} s, done at "
        f"{time.perf_counter() - t_all:.1f} s")

    # -- phases 20-21: the recurrences' backward kernels, training through them ---
    t20 = time.perf_counter()
    log("phase 20: the RWKV6 and scan backward kernels vs their plain versions")
    rwkv_bwd = phase_rwkv6_backward(rk)
    scan_bwd = phase_scan_backward(sk)
    log(f"chip_smoke: phase 20 took {time.perf_counter() - t20:.1f} s")
    t21 = time.perf_counter()
    seen, rwkv_bwd["training"] = phase_train_rwkv6(rk)
    launches["rwkv6"] += seen["rwkv6"]
    launches["rwkv6_bwd"] = seen["rwkv6_bwd"]
    seen, scan_bwd["mamba_layer"] = phase_train_mamba_layer(sk)
    launches["ssm_scan"] += seen["ssm_scan"]
    launches["ssm_scan_bwd"] = seen["ssm_scan_bwd"]
    log(f"chip_smoke: phase 21 took {time.perf_counter() - t21:.1f} s, done at "
        f"{time.perf_counter() - t_all:.1f} s")

    for name in launches:
        assert launches[name] > 0, f"{name} was never launched on the main path"
    kernels = []
    for name in ("fused_extend", "fused_verify", "lex_bounds", "multiway_membership"):
        head = next(c for c in rec[name]["configs"] if c["shape"] == HEADLINE[name])
        kernels.append(dict(
            name=name, route="cuda", source=CU_SOURCE, replaces=REPLACES[name],
            launches=launches[name], max_abs_err=rec[name]["max_abs_err"],
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by="bytes", library_ms=head["library_ms"], shape=head["shape"],
            configs=rec[name]["configs"]))
    head = rwkv["configs"][0]
    kernels.append(dict(
        name="rwkv6", route="cuda", source=RWKV_SOURCE, replaces=RWKV_REPLACES,
        launches=launches["rwkv6"], max_abs_err=rwkv["max_abs_err"],
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, shape=head["shape"],
        configs=rwkv["configs"]))
    head = flash["configs"][0]
    kernels.append(dict(
        name="flash_attention", route="cuda", source=FLASH_SOURCE, replaces=FLASH_REPLACES,
        launches=launches["flash_attention"], max_abs_err=flash["max_abs_err"],
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"], shape=head["shape"],
        configs=flash["configs"], unaligned=flash["unaligned"]))
    head = scan["configs"][0]
    kernels.append(dict(
        name="ssm_scan", route="cuda", source=SCAN_SOURCE, replaces=SCAN_REPLACES,
        replaces_note="the JAX package's plain lax.scan (no TPU kernel)",
        launches=launches["ssm_scan"], max_abs_err=scan["max_abs_err"],
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, shape=head["shape"],
        configs=scan["configs"], edges=scan["edges"], mamba_layer=scan["mamba_layer"]))
    head = flash_bwd["configs"][0]
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda", source=FLASH_BWD_SOURCE,
        replaces=FLASH_BWD_REPLACES,
        replaces_note="the gradient of the JAX package's plain attention (no TPU kernel)",
        launches=launches["flash_attention_bwd"], max_abs_err=flash_bwd["max_abs_err"],
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"], shape=head["shape"],
        configs=flash_bwd["configs"], max_rel_err=flash_bwd["max_rel_err"],
        training=flash_bwd["training"]))
    for name, rec, source, replaces, note in (
            ("rwkv6_bwd", rwkv_bwd, RWKV_BWD_SOURCE, RWKV_BWD_REPLACES,
             "the gradient (jax.grad) of the JAX package's plain chunked scan rwkv6_chunked "
             "(no TPU kernel)"),
            ("ssm_scan_bwd", scan_bwd, SCAN_BWD_SOURCE, SCAN_BWD_REPLACES,
             "the gradient (jax.grad) of the JAX package's plain lax.scan _ssm_scan_chunked "
             "(no TPU kernel)")):
        head = rec["configs"][0]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, replaces_note=note,
            launches=launches[name], max_abs_err=rec["max_abs_err"], ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, shape=head["shape"], configs=rec["configs"],
            max_rel_err=rec["max_rel_err"], edges=rec["edges"],
            training=rec.get("training") or rec.get("mamba_layer")))
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def enumeration_phases(ik):
    """Phases 1 (graph) to 5b: the enumeration engine's kernels and paths.
    Returns the phase-2 records and the launch counts of the paths' runs;
    the graphs are freed when it returns."""
    from repro_torch.core.cost import GraphStats
    from repro_torch.core.dataflow import translate
    from repro_torch.core.engine import EngineConfig, HugeEngine
    from repro_torch.core.optimizer import optimal_plan
    from repro_torch.core.query import PAPER_QUERIES
    from repro_torch.graph import powerlaw_graph
    from repro_torch.kernels.intersect import ref
    from repro_torch.launch import table4

    dev = torch.device(DEV)
    t0 = time.perf_counter()
    big = powerlaw_graph(*FULL_GRAPH[:2], exponent=FULL_GRAPH[2], seed=FULL_GRAPH[3], device=dev)
    torch.cuda.synchronize()
    log(f"phase 1: full-width graph |V|={big.num_vertices} |E|={big.num_edges} "
        f"max_deg={big.max_degree} d_pad={big.padded.d_pad} "
        f"adj={big.padded.adj.numel() * 4 / 1e9:.2f} GB, built in {time.perf_counter() - t0:.1f} s")

    # -- phase 2 ---------------------------------------------------------------
    log("phase 2: kernels vs plain versions at full-width shapes")
    rec = phase_kernels(big, ik, ref)

    launches = {name: 0 for name in ik.launches}
    # -- phase 3 ---------------------------------------------------------------
    # The table4 runner: each query plain, then fused (the plain runs launch
    # no kernel), with per-machine result rows.
    for qname, want in TABLE4.items():
        entries, seen = run_counted(ik, launches, lambda: table4.table4(dev, queries=(qname,)))
        for e in entries:
            log(f"phase 3: table4 {qname}/huge {e['mode']} count={e['matches']} (want {want}) "
                f"wall={e['wall_s']:.3f} s matches/s={e['matches_per_s']:.1f} "
                f"per_machine_rows={e['per_machine_rows']} on {e['device']}, {e['power_limit']}")
            assert e["matches"] == want == sum(e["per_machine_rows"]), (qname, e)
        log(f"phase 3: table4 {qname} record {json.dumps(entries[-1])}")
        log(f"phase 3: table4 {qname} launches={seen}")
        assert seen["fused_extend"] > 0, "the fused extend kernel never ran"

    # -- phase 4 ---------------------------------------------------------------
    g512 = powerlaw_graph(512, 6.0, seed=0, device=dev)
    for qname, space, want, cfg, must in (
        ("q3", "rads", 84, EngineConfig(fused=True), "fused_verify"),
        ("q1", "seed", 4361, EngineConfig(fused=True), "lex_bounds"),
        ("q2", "seed", 2551, EngineConfig(fused=True), "lex_bounds"),
        ("q3", "huge", 84, EngineConfig(use_intersect_kernel=True), "multiway_membership"),
    ):
        res, seen = run_counted(
            ik, launches, lambda: HugeEngine(g512, cfg).run(PAPER_QUERIES[qname], space=space))
        log(f"phase 4: {qname}/{space} count={res.count} (want {want}) "
            f"wall={res.stats.wall_time:.3f} s launches={seen}")
        assert res.count == want, (qname, space, res.count, want)
        assert seen[must] > 0, f"{must} never ran in {qname}/{space}"

    with preflight_times() as preflight:
        # -- phase 5 -----------------------------------------------------------
        qname = "q3"
        t0 = time.perf_counter()
        flow = translate(optimal_plan(PAPER_QUERIES[qname], GraphStats.from_graph(big), 8, "huge"))
        plan_s = time.perf_counter() - t0
        log(f"phase 5: planning {plan_s * 1e3:.1f} ms; dataflow:\n{flow.describe()}")
        counts, walls = {}, {}
        for fused in (True, False):
            torch.cuda.reset_peak_memory_stats()
            eng = HugeEngine(big, EngineConfig(fused=fused, **FULL_CFG), track_balance=True)
            res, seen = run_counted(ik, launches if fused else {n: 0 for n in launches},
                                    lambda: eng.run(flow))
            s = res.stats
            counts[fused] = res.count
            walls[fused] = (s.wall_time, res.schedule.steps)
            if fused:  # Exp-6's LRBU row (phase 5e)
                lrbu = dict(count=res.count, hit_rate=s.hit_rate, hits=s.cache_hits,
                            misses=s.cache_misses, pulled=s.pulled_bytes, wall=s.wall_time,
                            steps=res.schedule.steps, launches=seen["fused_extend"],
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            log(f"phase 5: {qname}/huge full width fused={fused} count={res.count} "
                f"wall={s.wall_time:.2f} s matches/s={res.count / s.wall_time:.1f} "
                f"steps={res.schedule.steps} launches={seen} "
                f"max_memory_allocated={torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
                f"T_R={s.compute_time:.2f} s T_C={s.comm_time:.2f} s "
                f"per_machine_rows={s.per_machine_rows.tolist()}")
            assert int(s.per_machine_rows.sum()) == res.count
            if fused:
                assert seen["fused_extend"] > 0, "the fused extend kernel never ran at full width"
        del eng
        assert counts[True] == counts[False], counts
        profile_window(big, flow, EngineConfig(fused=True, **FULL_CFG), HugeEngine, *walls[True])
        log_preflight("phase 5", preflight)

        # -- phase 5e ----------------------------------------------------------
        t0 = time.perf_counter()
        phase_paper_suites(ik, launches)
        log(f"phase 5e: the ten suites took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_exp6_full(ik, launches, big, flow, lrbu)
        log(f"phase 5e: Exp-6 at full width took {time.perf_counter() - t0:.1f} s")
        log_preflight("phase 5e", preflight)

        # -- phase 5d ----------------------------------------------------------
        t0 = time.perf_counter()
        phase_dist_full(ik, launches, big)
        log(f"phase 5d: full width took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_dist_ranks(ik, launches)
        log(f"phase 5d: four ranks took {time.perf_counter() - t0:.1f} s")
        log_preflight("phase 5d", preflight)

        # -- phase 5c ----------------------------------------------------------
        # The full-width leg (phase_service_full) runs as a card test
        # (tests/test_torch_gpu.py); phase 5b's streaming starts from the full
        # counts it holds the service to.
        for leg, run in (("reference load", lambda: phase_service_load(ik, launches)),
                         ("table4 graph", lambda: phase_service_table4(ik, launches))):
            t0 = time.perf_counter()
            run()
            log(f"phase 5c: {leg} took {time.perf_counter() - t0:.1f} s")
        before = dict(FULL_COUNTS)
        log_preflight("phase 5c", preflight)

        # -- phase 5b ----------------------------------------------------------
        t0 = time.perf_counter()
        phase_recovery(ik, launches)
        log(f"phase 5b: recovery matrix took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_paths(big)
        log(f"phase 5b: paths took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        # The engines below hold the only references to the full-width graph,
        # so each update frees the adjacency it replaced.
        engines = streaming_engines(big)
        del big
        phase_streaming(ik, launches, *engines, before)
        del engines
        log(f"phase 5b: streaming took {time.perf_counter() - t0:.1f} s")
        log_preflight("phase 5b", preflight)
    return rec, launches


def profile_window(graph, flow, cfg, engine_cls, run_wall, run_steps, steps: int = 400):
    """Profile the first ``steps`` scheduler steps of a fresh fused run: device
    time by kernel against the window's wall time (the idle share is what the
    host's launches and syncs cost). The profiler slows the host, so the
    unprofiled run's idle share is also estimated from its own wall time
    (``run_wall`` over ``run_steps``) and the window's device time a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = engine_cls(graph, cfg)
    session = eng.prepare(flow, session_stats=eng.stats)
    try:
        session.tick(20)  # warm-up outside the window
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            session.tick(steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        # An unfinished session holds its engine, and with it the graph,
        # until it is closed.
        session.close()
    events = prof.key_averages()
    rows = [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = device_busy_us(prof)
    ours = sum(t for k, t, _ in rows if any(f"{name}_kernel" in k for name in REPLACES))
    log(f"phase 5: profile of {steps} fused steps: wall={wall * 1e3:.1f} ms "
        f"device busy={busy_us / 1e3:.1f} ms (port's kernels {ours / 1e3:.1f} ms) "
        f"idle share={1 - busy_us / 1e3 / (wall * 1e3):.3f}")
    per_step_ms = busy_us / 1e3 / steps
    log(f"phase 5: device busy {per_step_ms:.4f} ms a step; unprofiled run "
        f"{run_wall / run_steps * 1e3:.4f} ms a step -> estimated idle share "
        f"{1 - per_step_ms * run_steps / (run_wall * 1e3):.3f}")
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"phase 5:   device {t / 1e3:9.2f} ms  x{n:<6d} {key[:90]}")
    # Host time inside the CUDA runtime: waits for the device (syncs) and launches.
    for e in sorted((e for e in events if e.key.startswith("cuda")),
                    key=lambda e: -e.self_cpu_time_total)[:6]:
        log(f"phase 5:   host {e.self_cpu_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key}")
    if not rows:
        log("phase 5: profiler recorded no device time (not measured)")


if __name__ == "__main__":
    sys.exit(rwkv_depth_witness() if sys.argv[1:] == ["--rwkv-depth-witness"] else main())
