"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (each prints its results; any failure exits non-zero):

1. set-up: the card's name and power limit, versions, the kernel builds (one
   nvcc per source, started together);
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
   full width: q3 under ``huge``, fused, with the LRU and direct-mapped
   caches beside phase 5's LRBU run (44 matches each), hit rates, pulled
   bytes, walls and steps side by side;
5d. the distributed engine (``core/distributed.py``): q3 under ``huge``,
   fused, at full width on a world of one rank over NCCL in this process
   (44 matches, every lookup local); then four ranks on the one card over
   gloo (``run_ranks``; gloo stages its all-to-alls through host memory,
   and four processes share one GPU, so no multi-GPU time) on the table4 graph: q2 and q3 under ``huge``,
   q2 under ``seed`` (PUSH-JOIN: ``lex_bounds``) and q3 under ``rads``
   (VERIFY: ``fused_verify``) fused, and q3 under ``huge`` unfused, whose
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
   then standing triangle and q2 over a batch of inserts; three tenants at
   full width (q3, triangle, q2) against their full counts, with a profiled
   window, latencies, and device memory back to its pre-submit level with
   the cycle collector off;
5b. the engine's other paths: every injected fault kind recovered on the
   table4 graph (the kernels launching again after the restore),
   ``shortest_path_length`` at full width against scipy, and batches of
   inserts at full width through a fused and a plain engine's
   ``apply_updates`` and ``run_delta`` (triangle and diamond), the deltas
   summed against full counts; with the pre-flight's time in every
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
   command-r's forward (8) and qwen3-moe's decode step (8), over all outputs
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
   2 x 253 + 3 decode steps against a forward of 2 x 256).

The line before the last holds the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. It imports torch, numpy and the port only.
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
from typing import Any, Dict

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
QWEN3_F32 = (16, 253, 3)
# The flash kernel's shapes: (what, B, Hq, Hkv, Sq, Sk, Dh, softcap, dtype,
# sliding window), all causal, q scaled by SOFTCAP_Q_SCALE where there is a
# softcap; the first is the JSON line's headline. gemma2's local shapes are
# those of phase 12's local layers: a sequence of the forward (8,192), a
# decode step after a 4,608-token prompt and 31 new tokens, the float32
# prefill of 4,608 (one row of two); its global shapes are those of the same
# passes' global layers (no window, the same softcap). chatglm3's and
# command-r's prefill shapes are phase 13's forwards (groups of 16 and 8);
# qwen3's decode shape is phase 14's served decode step (8 query heads a KV
# head, 512 + 32 keys).
FLASH_SHAPES = (
    ("granite forward B=4", 4, 32, 8, 4096, 4096, 128, None, torch.bfloat16, None),
    ("granite serve prefill B=8", 8, 32, 8, 512, 512, 128, None, torch.bfloat16, None),
    ("granite decode B=8", 8, 32, 8, 1, 544, 128, None, torch.bfloat16, None),
    ("gemma2 softcap B=4", 4, 16, 8, 2048, 2048, 256, 50.0, torch.bfloat16, None),
    ("granite float32 check B=2", 2, 32, 8, 512, 512, 128, None, torch.float32, None),
    ("granite float32 decode B=8", 8, 32, 8, 1, 544, 128, None, torch.float32, None),
    ("gemma2 local prefill B=1", 1, 16, 8, 8192, 8192, 256, 50.0, torch.bfloat16, 4096),
    ("gemma2 local decode B=8", 8, 16, 8, 1, 4640, 256, 50.0, torch.bfloat16, 4096),
    ("gemma2 local float32 B=1", 1, 16, 8, 4608, 4608, 256, 50.0, torch.float32, 4096),
    ("gemma2 global prefill B=1", 1, 16, 8, 8192, 8192, 256, 50.0, torch.bfloat16, None),
    ("gemma2 global decode B=8", 8, 16, 8, 1, 4640, 256, 50.0, torch.bfloat16, None),
    ("chatglm3 decode B=8", 8, 32, 2, 1, 544, 128, None, torch.bfloat16, None),
    ("chatglm3 forward B=4", 4, 32, 2, 4096, 4096, 128, None, torch.bfloat16, None),
    ("command-r forward B=1", 1, 64, 8, 4096, 4096, 128, None, torch.bfloat16, None),
    ("qwen3 decode B=8", 8, 32, 4, 1, 544, 128, None, torch.bfloat16, None),
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
STREAM_BATCHES, STREAM_EDGES, STREAM_SEED = 4, 64, 11
STREAM_QUERIES = ("triangle", "q2")
PATH_PAIRS, PATH_SEED = 8, 5
# Phase 5c: the service's legs. On the table4 graph: (tenant, query, plan
# space, the reference's count); at full width: (tenant, query, match
# budget), q3's count there (phase 5's), and the ticks of its profiled window.
SERVICE_TABLE4 = (("a", "q1", "huge", 110508), ("b", "q2", "seed", 67887),
                  ("c", "q3", "rads", 1782), ("d", "q3", "huge", 1782))
# q1 is served on the table4 graph only: at full width its steps (wedges
# into squares) cost about 5 ms each on an H100 80GB, and squares are rare
# there, so even under a budget of 1,000 matches it ran 9,803 steps.
SERVICE_FULL = (("a", "q3", None), ("b", "triangle", None), ("c", "q2", None))
# At full width an extend queue's slack is batch x d_pad rows (1024 x 4608):
# the sessions price past the default pool's 67.1 M int32 cells, so the
# leg's pool is larger. (At batch 256 they fit the default pool, but with
# four times the steps the leg ran past 11 minutes on an H100 80GB.)
SERVICE_FULL_POOL = 128 << 20
# Full counts on the full-width graph: q3's is phase 5's (fused and plain
# agree); triangle's and q2's are those of isolated fused HugeEngine runs on
# an H100 80GB (PERF.md §4), which the service must reproduce and from which
# phase 5b's streaming starts.
FULL_Q3 = 44
FULL_COUNTS = {"triangle": 6293, "q2": 11018}
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
DIST_CASES = (("q2", "huge", True, 67887), ("q3", "huge", True, 1782),
              ("q2", "seed", True, 67887), ("q3", "rads", True, 1782),
              ("q3", "huge", False, 1782))
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
    machine, far below the working set there) with the LRU and
    direct-mapped policies; LRBU is phase 5's fused run (``lrbu``, run here
    when not given). Each count is phase 5's; the three policies' hit
    rates, pulled bytes, walls and steps print side by side."""
    from repro_torch.core.engine import EngineConfig, HugeEngine

    rows = {} if lrbu is None else {"lrbu": lrbu}
    for policy in [p for p in ("lrbu", "lru", "direct") if p not in rows]:
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
    1024), three tenants at once, each count its full count (triangle's and
    q2's are returned: phase 5b's streaming starts from them); a profiled
    window of a second service, its requests then cancelled; device memory
    back to its pre-submit level after each, with the cycle collector off."""
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
    counts = {}
    for name in ("triangle", "q2"):
        assert by[name].status == "done" and by[name].count == FULL_COUNTS[name], by[name]
        counts[name] = by[name].count
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
        # The plain version runs tens of torch ops a step, and reading the
        # profiler's records of them takes seconds a window: three windows of
        # one call each.
        pcall = call_ms(lambda: rwkv6_ref(*args, return_state=with_state), iters=1,
                        repeats=3, warmup=1)
        pdev = plain_device_ms(lambda: rwkv6_ref(*args, return_state=with_state), iters=1,
                               repeats=3)
        bound, by, nbytes, flops, bytes_ms, ops_ms = rwkv_bound(args, with_state)
        shape = f"BH={bh} T={t} K=V=64 bf16" + (" +state" if with_state else "")
        out["configs"].append(dict(
            shape=shape, ms=ms, ms_min=lo, ms_max=hi, call_ms=call[0], call_ms_min=call[1],
            call_ms_max=call[2], plain_ms=pdev[0], plain_call_ms=pcall[0], bound_ms=bound,
            bound_by=by, bound_bytes=nbytes, bound_flops=flops, max_abs_err=max(errs),
            rel_err=rel, library_ms=None))
        out["max_abs_err"] = max(out["max_abs_err"], max(errs))
        log(f"  rwkv6 [{what}: {shape}]: max_abs_err={max(errs):.3e} (out"
            f"{', state' if with_state else ''}; max |plain| {scale:.3f}, relative {rel:.2e}, "
            f"tolerance {RWKV_TOL:g}) | kernel queued={ms:.4f} ms (min {lo:.4f}, "
            f"max {hi:.4f}) "
            f"call={call[0]:.4f} ms (min {call[1]:.4f}, max {call[2]:.4f}) | plain device="
            f"{pdev[0]:.4f} ms call={pcall[0]:.4f} ms | bound={bound:.4f} ms by {by} "
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


def flash_check_can_fail(attention_chunked, q, k, v, cap, want, row_tol, what, window=None):
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
        bad = attention_chunked(q[:, -n:], k, vf, causal=True, softcap=capf, window=winf)
        out[fault] = flash_errs(bad, want[:, -n:])
        assert out[fault][1] > row_tol, f"flash_attention {what}: the check misses '{fault}'"
    return out


def phase_flash_kernel(fa):
    """The kernel at granite's forward, serve-prefill and decode shapes, at
    gemma2's softcap branch, its local layers' sliding window and its global
    layers' prefill and decode, at chatglm3's decode and forward and
    command-r's forward (bf16, the tensor-core forms), and at the float32
    check's prefill and decode shapes and gemma2's float32 window (the f32
    form), each against the plain version (the wrapper's CPU path, run on the
    card), with the readings of faults put into the plain version beside it,
    and timed beside SDPA where one SDPA call computes the same function
    (every shape without a softcap or a window; at those no library call
    does, and the library time is None). Kernel and library are timed the
    same way, by ``queued_ms``; the form the kernel ran is read from its
    per-form launch counts and must be the one ``kernel_form`` names. Each
    shape's line gives the seconds it took."""
    from repro_torch.kernels.flash_attention.ops import attention_chunked

    sdpa = torch.nn.functional.scaled_dot_product_attention
    log("phase 9: flash attention kernel vs its plain version and SDPA")
    gen = torch.Generator(device=DEV).manual_seed(9)
    out = {"max_abs_err": 0.0, "configs": []}
    for what, b, hq, hkv, sq, sk, dh, cap, dtype, window in FLASH_SHAPES:
        t_shape = time.perf_counter()
        q = torch.randn((b * hq, sq, dh), generator=gen, device=DEV)
        if cap is not None:
            q *= SOFTCAP_Q_SCALE
        q = q.to(dtype)
        k = torch.randn((b * hkv, sk, dh), generator=gen, device=DEV).to(dtype)
        v = torch.randn((b * hkv, sk, dh), generator=gen, device=DEV).to(dtype)
        before = dict(fa.launches_by_form)
        got = fa.attention(q, k, v, causal=True, softcap=cap, window=window)
        (form,) = [f for f, n in fa.launches_by_form.items() if n > before[f]]
        assert form == fa.kernel_form(dtype, sq, hq // hkv), (what, form)
        want = attention_chunked(q, k, v, causal=True, softcap=cap, window=window)
        torch.cuda.synchronize()
        err, row_err = flash_errs(got, want)
        tol, row_tol = FLASH_TOL[dtype], FLASH_ROW_TOL[dtype]
        assert err < tol and row_err < row_tol, (
            f"flash_attention {what}: max |kernel - plain| {err} (tolerance {tol}), worst row "
            f"{row_err} of its max |plain| (tolerance {row_tol})")
        faults = flash_check_can_fail(attention_chunked, q, k, v, cap, want, row_tol, what,
                                      window)

        def kernel():
            return fa.attention(q, k, v, causal=True, softcap=cap, window=window)

        call = call_ms(kernel)
        ms, lo, hi = queued_ms(kernel)
        big = sq * sk * b * hq > 1 << 28
        pcall, pdev = timed(
            lambda: attention_chunked(q, k, v, causal=True, softcap=cap, window=window),
            iters=1 if big else 5, call_repeats=3, warmup=1, plain=True)
        q4, k4, v4 = q.view(b, hq, sq, dh), k.view(b, hkv, sk, dh), v.view(b, hkv, sk, dh)
        lib_ms = lib_call = lib_err = ratio = None
        if cap is None and window is None:
            # One SDPA call on the same inputs as [B, H, S, Dh] views; at Sq = 1
            # every key is visible, elsewhere Sq = Sk and its top-left causal
            # diagonal is ours.
            assert sq == 1 or sq == sk

            def lib():
                return sdpa(q4, k4, v4, is_causal=sq > 1, enable_gqa=True)

            lib_err = flash_errs(lib().reshape(got.shape), want)[0]
            lib_call, lib_ms = call_ms(lib), queued_ms(lib)
            ratio = ms / lib_ms[0]
        bound, by, nbytes, flops, pairs = attention_bound(q, k, v, True, window)
        shape = (f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} Dh={dh} causal "
                 f"{str(dtype)[6:]}" + (f" window={window}" if window else "") +
                 (f" softcap={cap:g}, q x{SOFTCAP_Q_SCALE:g}" if cap else ""))
        tflops, gbs = flops / (ms * 1e-3) / 1e12, nbytes / (ms * 1e-3) / 1e9
        out["configs"].append(dict(
            shape=shape, form=form, ms=ms, ms_min=lo, ms_max=hi, call_ms=call[0],
            call_ms_min=call[1], call_ms_max=call[2], tflops=tflops, gb_per_s=gbs,
            plain_ms=pdev[0], plain_call_ms=pcall[0], bound_ms=bound, bound_by=by,
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
            f"(min {call[1]:.4f}, max {call[2]:.4f}) | plain device={pdev[0]:.4f} ms "
            f"call={pcall[0]:.4f} ms | bound={bound:.4f} ms by {by} ({nbytes} B; {pairs} "
            f"visible pairs, {flops} flop) | achieved {tflops:.1f} TFLOP/s, {gbs:.1f} GB/s, "
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
# Phases 7-8 (rwkv6-7b), 10-11 (granite-3-8b), 12 (gemma2-9b), 13
# (chatglm3-6b, command-r-35b) and 14 (qwen3-moe-30b-a3b): LM inference at
# full width
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMPath:
    """One model's path and the kernel it must run: ``ops`` holds its launch
    counter ``kernel``; every pass over the layers (forward, prefill)
    launches it once a layer, and each decode step ``per_decode`` times a
    layer. ``symbol`` picks its kernels out of a profile. ``forward``: (B, S,
    prefill length, decode steps); ``serve``: (requests, prompt length, new
    tokens, slots); ``widen``: whether the float32 leg runs with the
    parameters copied to float32 beside the bf16 ones; ``f32_leg``: (layers,
    prefill length, decode steps) of a float32 leg run instead after the bf16
    parameters are freed, on the model cut to ``layers`` and initialised in
    float32; ``lossless_ref``: hold prefill + decode to the forward of the
    prefilled rows' own tokens (an MoE model's B x S forward drops routed
    pairs that those passes keep) and only log the B x S forward's
    difference."""
    arch: str
    ops: Any
    kernel: str
    symbol: str
    per_decode: int
    forward_phase: str
    serve_phase: str
    forms: Any = None  # {(pass kind, dtype): the kernel's forms} where it has several
    forward: Any = LM_FORWARD
    serve: Any = LM_SERVE
    widen: bool = True
    f32_leg: Any = None
    lossless_ref: bool = False


def lm_setup(path: LMPath):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(path.arch)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    moe = (f", MoE {cfg.num_experts} experts top-{cfg.experts_per_token} of width "
           f"{cfg.moe_d_ff}, {cfg.active_param_count()} parameters active a token"
           if cfg.num_experts else "")
    log(f"{path.forward_phase}: {cfg.name} full width ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads ({cfg.num_kv_heads} KV) of {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}{moe}): {n} parameters ({cfg.param_count()} in "
        f"param_count's matrices), {nbytes / 1e9:.2f} GB, initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, params


# Profile rows by kind: the kernel first, then these, by substrings of the
# kernel's name (an indexed write names index_put in its template arguments,
# an indexed read the plain index kernel).
KINDS = (("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")), ("sort", ("sort", "Sort")),
         ("scatter", ("index_put", "scatter")), ("gather", ("index", "gather")),
         ("copy", ("copy",)))


def by_category(rows, symbol):
    """Device ms of profile rows ``(name, device µs)`` summed by kind: the
    port's kernel, the cuBLAS GEMMs, sorts (the MoE layer's routing and
    dispatch), indexed writes (its buckets) and reads (its combine, the
    embedding), copies and casts, the other torch kernels."""
    out = {"kernel": 0.0, **{k: 0.0 for k, _ in KINDS}, "other": 0.0}
    for key, us in rows:
        kind = "kernel" if symbol in key else next(
            (k for k, subs in KINDS if any(s in key for s in subs)), "other")
        out[kind] += us / 1e3
    return {k: round(v, 2) for k, v in out.items()}


class PassCounter:
    """Runs one pass of a path with the kernel's counts set to 0 just before
    it, asserts its launches, and keeps them by pass kind, with the forms
    that ran by (pass kind, dtype)."""

    def __init__(self, path: LMPath):
        self.path = path
        self.total = {"forward": 0, "prefill": 0, "decode": 0}
        self.forms = {}

    def __call__(self, fn, want, kind, dtype):
        ops = self.path.ops
        ops.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = ops.launches[self.path.kernel]
        assert n == want, f"{self.path.kernel} launched {n} times, want {want}"
        self.total[kind] += n
        ran = {f for f, c in getattr(ops, "launches_by_form", {}).items() if c}
        self.forms[(kind, dtype)] = self.forms.get((kind, dtype), set()) | ran
        return res, wall

    def check_forms(self, ph, want):
        if want is None:
            return
        log(f"{ph}: {self.path.kernel} forms by (pass kind, dtype): "
            f"{ {k: sorted(v) for k, v in self.forms.items()} }")
        assert self.forms == want, (self.path.kernel, self.forms, want)


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
    log(f"{ph}: {what}: MoE dispatch over {cfg.num_layers} layers: {routed} routed pairs, "
        f"{routed - kept} dropped ({(routed - kept) / routed:.4f} of them), buckets filled "
        f"{kept / st['slots']:.4f} ({kept} of {st['slots']} slots)")


def prefill_decode(counted, cfg, params, toks, pre, extra, per_step):
    """Logits [rows, 1 + extra, vocab] (float32) of prefill of ``toks[:, :pre]``
    (its last position) and of ``extra`` decode steps, and the prefill's wall."""
    from repro_torch.models import transformer as T

    vocab = cfg.vocab_size  # the padded columns hold -1e30: compare the real ones
    (cache, last), wall = counted(
        lambda: T.prefill(cfg, params, {"tokens": toks[:, :pre]}, pre + extra + 8, device=DEV),
        cfg.num_layers, "prefill", cfg.dtype)
    out = [last[:, 0, :vocab].float()]
    for i in range(extra):
        (logits, cache), _ = counted(
            lambda: T.decode_step(cfg, params, cache, toks[:, pre + i : pre + i + 1], pre + i,
                                  device=DEV), per_step, "decode", cfg.dtype)
        out.append(logits[:, 0, :vocab].float())
    return torch.stack(out, dim=1), wall


def routing_flips(ph, cfg, fwd, passes, rows, pre, extra):
    """Where the routing of prefill (``pre`` tokens a row) and ``extra``
    decode steps first leaves the forward's at the same positions, layer by
    layer (``fwd``, ``passes``: the recorded routes, the prefill's layers
    first, then each step's): logs, for the prefilled positions, how many
    left it, and for each decoded position in each row the first layer where
    its top-k set differs and the forward's margin there (its k-th router
    probability less its (k+1)-th). Returns the largest such margin."""
    layers, k = cfg.num_layers, cfg.experts_per_token

    def stack(recs, s):
        return torch.stack([i.view(rows, s, k) for i, _ in recs]).sort(-1).values

    f_idx = stack(fwd, pre + extra)
    f_gap = torch.stack([g.view(rows, pre + extra) for _, g in fwd])
    p_idx = torch.cat([stack(passes[:layers], pre)] + [
        stack(passes[layers * (1 + i) : layers * (2 + i)], 1) for i in range(extra)], dim=2)
    diff = (f_idx != p_idx).any(-1)                     # [layers, rows, positions]
    left = diff.any(0)
    first = diff.int().argmax(0)
    gap = f_gap.gather(0, first[None])[0]
    steps = [[(int(first[r, pre + i]), float(gap[r, pre + i])) if left[r, pre + i] else None
              for r in range(rows)] for i in range(extra)]
    log(f"{ph}: routing against the lossless forward's: {int(left[:, :pre].sum())} of "
        f"{rows * pre} prefilled positions leave it; decode steps (per row: the first layer "
        f"whose top-{k} differs, the forward's margin there; None: never): {steps}; the "
        f"forward's margins: median {float(f_gap.median()):.2e}")
    return float(gap[left].max()) if bool(left.any()) else 0.0


def logits_agree(ph, label, got, want, tol, pre, extra, against):
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    same_top = int((got.argmax(-1) == want.argmax(-1)).sum())
    log(f"{ph}: {label}: prefill {pre} tokens x{got.shape[0]} + {extra} decode steps vs "
        f"{against}, logits at positions {pre - 1}..{pre + extra - 1}: max |diff| {err:.5f}, "
        f"max |logit| {scale:.4f}, relative {err / scale:.2e} (tolerance {tol:g}), same "
        f"argmax {same_top}/{got.shape[0] * got.shape[1]}")
    assert err / scale < tol, (label, err, scale)


def phase_lm_forward(path: LMPath, cfg, params) -> Dict[str, int]:
    """loss_fn and forward on B x S tokens (``path.forward``: 4 x 4096 by
    default), a profiled forward, then prefill of the first tokens of (up to)
    two rows and decode steps against a forward's logits (``lossless_ref``:
    the forward of those rows' own tokens, else the B x S one), in bf16 and
    (``path.widen``) float32. Returns the kernel launches of the phase by
    pass kind."""
    from repro_torch.models import transformer as T

    ph = path.forward_phase
    b, s, pre, extra = path.forward
    seqs = min(b, 2)  # the rows prefilled and decoded
    gen = torch.Generator(device=DEV).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=DEV)
    batch = {"tokens": toks}
    counted = PassCounter(path)
    per_pass, per_step = cfg.num_layers, cfg.num_layers * path.per_decode

    torch.cuda.reset_peak_memory_stats()
    loss, wall = counted(lambda: T.loss_fn(cfg, params, batch, device=DEV), per_pass, "forward",
                         cfg.dtype)
    assert bool(torch.isfinite(loss)), loss
    log(f"{ph}: loss_fn B={b} S={s}: loss={float(loss):.4f} (ln vocab "
        f"{math.log(cfg.vocab_size):.4f}) wall={wall:.3f} s tokens/s={b * s / wall:,.0f} "
        f"launches={per_pass} max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        with (moe_dispatch_stats(cfg, ph, f"forward B={b} S={s}") if i == 0
              else contextlib.nullcontext()):
            logits, wall = counted(lambda: T.forward(cfg, params, batch, device=DEV), per_pass,
                                   "forward", cfg.dtype)
        log(f"{ph}: forward {i + 1} B={b} S={s}: wall={wall:.3f} s "
            f"tokens/s={b * s / wall:,.0f} launches={per_pass} "
            f"max_memory_allocated={torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    vocab = cfg.vocab_size  # the padded columns hold -1e30: compare the real ones
    full = logits[:seqs, pre - 1 : pre + extra, :vocab].float()
    assert bool(torch.isfinite(full).all())
    del logits, loss

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (logits, wall) = counted(lambda: T.forward(cfg, params, batch, device=DEV), per_pass,
                                 "forward", cfg.dtype)
    del logits
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in rows) / 1e3
    ours = sum(t for k, t, _ in rows if path.symbol in k) / 1e3
    log(f"{ph}: profiled forward: wall={wall * 1e3:.1f} ms device busy={busy:.1f} ms "
        f"({path.kernel} kernel {ours:.1f} ms, {ours / max(busy, 1e-9):.3f} of busy) "
        f"idle share={1 - busy / (wall * 1e3):.3f}")
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"{ph}:   device {t / 1e3:9.2f} ms  x{n:<5d} {key[:90]}")
    log(f"{ph}:   device ms by kind: {by_category([(k, t) for k, t, _ in rows], path.symbol)}")

    short = {"tokens": toks[:seqs, : pre + extra]}
    if path.lossless_ref:
        # A decoded token's hidden state carries bf16 roundings of other
        # product shapes than the forward's; where its k-th and (k+1)-th
        # router probabilities lie closer than they move, its experts
        # change, and with them its logits. So the prefill's logits are held
        # to the lossless forward, the decode steps' are logged beside where
        # their routing left the forward's, and the float32 leg holds both.
        with moe_dispatch_stats(cfg, ph, f"prefill of {seqs} x {pre} tokens and {extra} "
                                f"decode steps", routes=True) as st:
            got, wall = prefill_decode(counted, cfg, params, toks[:seqs], pre, extra, per_step)
        passes = st.pop("routes")
        log(f"{ph}: bf16 prefill of {pre} tokens x{seqs}: wall {wall:.3f} s")
        with moe_dispatch_stats(cfg, ph, f"forward of {seqs} x {pre + extra} tokens",
                                routes=True) as st:
            want, _ = counted(
                lambda: T.forward(cfg, params, short, device=DEV)[:, pre - 1 :, :vocab].float(),
                per_pass, "forward", cfg.dtype)
        fwd = st.pop("routes")
        logits_agree(ph, "bf16 prefill", got[:, :1], want[:, :1], LOGITS_TOL_BF16, pre, 0,
                     f"the forward of {seqs} x {pre + extra} tokens")
        flips = routing_flips(ph, cfg, fwd, passes, seqs, pre, extra)
        rel = [round(float((got[:, j] - want[:, j]).abs().max() / want[:, j].abs().max()), 4)
               for j in range(1, extra + 1)]
        log(f"{ph}: bf16 decode steps vs the forward of {seqs} x {pre + extra} tokens, logged, "
            f"not held: relative {rel}, same argmax "
            f"{int((got[:, 1:].argmax(-1) == want[:, 1:].argmax(-1)).sum())}/{seqs * extra}; "
            f"the largest margin a decode step's routing crossed {flips:.2e}")
        log(f"{ph}: the {b} x {s} forward ({b * s * cfg.experts_per_token} routed pairs a "
            f"layer, pairs over the capacity dropped) at the same positions, logged, not held: "
            f"relative "
            f"{float((full - want).abs().max() / want.abs().max()):.2e}, same argmax "
            f"{int((full.argmax(-1) == want.argmax(-1)).sum())}/{want.numel() // vocab}")
    else:
        got, wall = prefill_decode(counted, cfg, params, toks[:seqs], pre, extra, per_step)
        log(f"{ph}: bf16 prefill of {pre} tokens x{seqs}: wall {wall:.3f} s")
        logits_agree(ph, "bf16", got, full, LOGITS_TOL_BF16, pre, extra,
                     f"the {b} x {s} forward")
        # bf16's own floor at these positions: the same forward in another batch
        # shape, and (below) the float32 forward of the same weights.
        other, _ = counted(
            lambda: T.forward(cfg, params, short, device=DEV)[:, pre - 1 :, :vocab].float(),
            per_pass, "forward", cfg.dtype)
        log(f"{ph}: bf16 floor: forward of {seqs} x {pre + extra} tokens vs the {b} x {s} "
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
            lambda: T.forward(cfg32, p32, short, device=DEV)[:, pre - 1 :, :vocab].clone(),
            per_pass, "forward", cfg32.dtype)
        log(f"{ph}: bf16 floor: bf16 forward vs float32 forward: relative "
            f"{float((full - want32).abs().max() / want32.abs().max()):.2e}")
        got32, _ = prefill_decode(counted, cfg32, p32, toks[:seqs], pre, extra, per_step)
        logits_agree(ph, "float32", got32, want32, LOGITS_TOL_F32, pre, extra,
                     f"the float32 forward of {seqs} x {pre + extra} tokens")
        log(f"{ph}: float32 leg: {sum(p.numel() for p in p32.parameters()) * 4 / 1e9:.2f} GB "
            f"of float32 parameters beside the bf16 ones, max_memory_allocated="
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del p32
    counted.check_forms(ph, path.forms and {k: v for k, v in path.forms.items()
                                            if k[1] == cfg.dtype or path.widen})
    return counted.total


def phase_lm_f32(path: LMPath) -> Dict[str, int]:
    """The float32 leg where a float32 copy of the whole model does not fit
    beside it: the model cut to ``path.f32_leg``'s layers, initialised in
    float32 on the card (after the bf16 parameters are freed), prefill +
    decode steps of two rows against the forward of the same tokens, every
    pass lossless; here the two may differ only in summation order. Returns
    the kernel launches by pass kind."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    layers, pre, extra = path.f32_leg
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
    toks = torch.randint(0, cfg.vocab_size, (2, pre + extra), generator=gen, device=DEV)
    counted = PassCounter(path)
    torch.cuda.reset_peak_memory_stats()
    with moe_dispatch_stats(cfg32, ph, f"float32 forward of 2 x {pre + extra} tokens",
                            routes=True) as st:
        want, wall = counted(lambda: T.forward(cfg32, params, {"tokens": toks}, device=DEV)
                             [:, pre - 1 :, :cfg.vocab_size].clone(),
                             layers, "forward", cfg32.dtype)
    fwd = st.pop("routes", None)
    with moe_dispatch_stats(cfg32, ph, f"float32 prefill of 2 x {pre} tokens and {extra} "
                            f"decode steps", routes=True) as st:
        got, pwall = prefill_decode(counted, cfg32, params, toks, pre, extra,
                                    layers * path.per_decode)
    if fwd is not None:
        routing_flips(ph, cfg32, fwd, st.pop("routes"), 2, pre, extra)
    logits_agree(ph, "float32", got, want, LOGITS_TOL_F32, pre, extra,
                 f"the float32 forward of 2 x {pre + extra} tokens")
    log(f"{ph}: float32 leg: forward wall {wall:.3f} s, prefill wall {pwall:.3f} s, "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    counted.check_forms(ph, path.forms and {k: v for k, v in path.forms.items()
                                            if k[1] == "float32"})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counted.total


def decode_profile(path: LMPath, cfg, params, b: int, plen: int) -> None:
    """One profiled decode step of ``b`` sequences after a ``plen``-token
    prefill: its wall time against its device time and against the time to
    read every weight once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    gen = torch.Generator(device=DEV).manual_seed(9)
    toks = torch.randint(2, cfg.vocab_size, (b, plen + 2), generator=gen, device=DEV)
    cache, _ = T.prefill(cfg, params, {"tokens": toks[:, :plen]}, plen + 8, device=DEV)
    T.decode_step(cfg, params, cache, toks[:, plen : plen + 1], plen, device=DEV)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        T.decode_step(cfg, params, cache, toks[:, plen + 1 : plen + 2], plen + 1, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    ours = sum(e.self_device_time_total for e in rows if path.symbol in e.key) / 1e3
    n = sum(e.count for e in rows)
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"{path.serve_phase}: profiled decode step B={b}: wall={wall * 1e3:.2f} ms (profiled) "
        f"device busy={busy:.2f} ms over {n} kernels ({path.kernel} kernel {ours:.3f} ms), "
        f"idle share={1 - busy / (wall * 1e3):.3f}; reading the {weights / 1e9:.2f} GB of "
        f"weights once takes {weights / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"{path.serve_phase}:   device {e.self_device_time_total / 1e3:8.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")
    log(f"{path.serve_phase}:   device ms by kind: "
        f"{by_category([(e.key, e.self_device_time_total) for e in rows], path.symbol)}")


def phase_lm_serve(path: LMPath, cfg, params) -> int:
    """BatchedServer, greedy (``path.serve``: 16 requests of 512 prompt
    tokens, 32 new tokens each, 8 slots by default). Returns the kernel
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
    path.ops.reset_launches()
    with moe_dispatch_stats(cfg, ph, f"serving {n_req} requests"):
        stats = server.run(reqs)
        torch.cuda.synchronize()
    n = path.ops.launches[path.kernel]
    groups = -(-n_req // slots)
    want = cfg.num_layers * groups * (1 + (new - 1) * path.per_decode)
    assert all(r.done and len(r.out_tokens) == new for r in reqs), "a request is short"
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert n == want, f"{path.kernel} launched {n} times in {groups} groups, want {want}"
    by_form = {f: c for f, c in getattr(path.ops, "launches_by_form", {}).items() if c}
    if path.forms is not None:  # each group: one prefill pass, then its decode steps
        (pf,), (df,) = path.forms[("prefill", cfg.dtype)], path.forms[("decode", cfg.dtype)]
        prefills = cfg.num_layers * groups
        assert by_form == {pf: prefills, df: n - prefills}, (path.kernel, by_form)
    lat = np.array([r.latency_s for r in reqs])
    peak = torch.cuda.max_memory_allocated()
    decode_profile(path, cfg, params, slots, plen)
    log(f"{ph}: served {n_req} requests x {new} tokens (prompt {plen}, {slots} slots): "
        f"wall={stats['wall_s']:.3f} s, {stats['new_tokens']} decode tokens -> "
        f"{stats['tokens_per_s']:,.1f} tokens/s; all {n_req * new} generated tokens -> "
        f"{n_req * new / stats['wall_s']:,.1f} tokens/s; latency p50 "
        f"{np.percentile(lat, 50):.3f} s p99 {np.percentile(lat, 99):.3f} s; launches={n}"
        f"{f' by form {by_form}' if by_form else ''}; max_memory_allocated={peak / 1e9:.2f} GB")
    return n


def lm_phases(path: LMPath) -> int:
    """A model's forward and serving phases; its parameters are freed when it
    returns. Returns the kernel launches of the main path."""
    cfg, params = lm_setup(path)
    by_kind = phase_lm_forward(path, cfg, params)
    served = phase_lm_serve(path, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if path.f32_leg is not None:
        for kind, n in phase_lm_f32(path).items():
            by_kind[kind] += n
    log(f"{path.forward_phase}: {path.kernel} launches on the main path: {by_kind}, "
        f"serving {served}")
    for kind, n in by_kind.items():
        assert n > 0 or (kind == "decode" and path.per_decode == 0), (path.kernel, kind)
    return sum(by_kind.values()) + served


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

    # -- phase 1 ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = (ik.LIB, rk.LIB, fa.LIB, chase_library())
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
    launches["rwkv6"] = lm_phases(LMPath("rwkv6-7b", rk, "rwkv6", "rwkv6_kernel", 0,
                                         "phase 7", "phase 8"))
    log(f"chip_smoke: phases 6-8 done at {time.perf_counter() - t_all:.1f} s")

    # -- phases 9-11 -----------------------------------------------------------
    flash = phase_flash_kernel(fa)
    log(f"chip_smoke: phase 9 done at {time.perf_counter() - t_all:.1f} s")
    launches["flash_attention"] = lm_phases(LMPath(
        "granite-3-8b", fa, "flash_attention", "flash_", 1, "phase 10", "phase 11",
        GRANITE_FORMS))
    log(f"chip_smoke: phases 9-11 done at {time.perf_counter() - t_all:.1f} s")

    # -- phase 12: gemma2-9b, its local layers' window in the flash kernel ------
    launches["flash_attention"] += lm_phases(LMPath(
        "gemma2-9b", fa, "flash_attention", "flash_", 1, "phase 12", "phase 12",
        GEMMA2_FORMS, forward=GEMMA2_FORWARD, serve=GEMMA2_SERVE))
    log(f"chip_smoke: phase 12 done at {time.perf_counter() - t_all:.1f} s")

    # -- phase 13: chatglm3-6b and command-r-35b --------------------------------
    for arch in ("chatglm3-6b", "command-r-35b"):
        launches["flash_attention"] += lm_phases(LMPath(
            arch, fa, "flash_attention", "flash_", 1, "phase 13", "phase 13",
            DENSE_FORMS[arch], forward=DENSE_FORWARD[arch], serve=DENSE_SERVE,
            widen=arch != "command-r-35b"))
    log(f"chip_smoke: phase 13 done at {time.perf_counter() - t_all:.1f} s")

    # -- phase 14: qwen3-moe-30b-a3b, the MoE layer -------------------------------
    launches["flash_attention"] += lm_phases(LMPath(
        "qwen3-moe-30b-a3b", fa, "flash_attention", "flash_", 1, "phase 14", "phase 14",
        GRANITE_FORMS, forward=QWEN3_FORWARD, serve=DENSE_SERVE, widen=False,
        f32_leg=QWEN3_F32, lossless_ref=True))
    log(f"chip_smoke: phase 14 done at {time.perf_counter() - t_all:.1f} s")

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
        for leg, run in (("reference load", lambda: phase_service_load(ik, launches)),
                         ("table4 graph", lambda: phase_service_table4(ik, launches)),
                         ("full width", lambda: phase_service_full(ik, launches, big))):
            t0 = time.perf_counter()
            before = run()  # the last leg's: the full-width triangle and q2 counts
            log(f"phase 5c: {leg} took {time.perf_counter() - t0:.1f} s")
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
    sys.exit(main())
