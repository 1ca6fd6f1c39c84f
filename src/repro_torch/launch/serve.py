"""Serving driver.

LM batch serving (the default when no mode is given), on the card:

    python -m repro_torch.launch.serve lm --arch rwkv6-7b [--smoke] [--device cpu]

The flags are the JAX launcher's, plus ``--device``. Parameters are random,
drawn on the device from ``--seed``. The multi-tenant graph service
(``graph`` mode) is not ported yet.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import BatchedServer, Request, ServeConfig


def lm_main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve lm")
    ap.add_argument("--arch", default="rwkv6-7b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(args.seed)
    params = T.init_params(cfg, seed=args.seed, device=device)
    scfg = ServeConfig(
        max_len=args.prompt_len + args.max_new + 8,
        batch_slots=args.slots,
        temperature=args.temperature,
        max_new_tokens=args.max_new,
        eos_token=-1,  # never stop early in the benchmark
    )
    server = BatchedServer(cfg, params, scfg, device=device,
                           generator=torch.Generator(device=device).manual_seed(args.seed))
    reqs = [
        Request(prompt=rng.integers(2, cfg.vocab_size, size=args.prompt_len).astype(np.int32))
        for _ in range(args.requests)
    ]
    stats = server.run(reqs)
    lat = [r.latency_s for r in reqs]
    print(
        f"[serve] {cfg.name} on {device}: {stats['requests']} requests, "
        f"{stats['new_tokens']} new tokens, {stats['tokens_per_s']:,.1f} tok/s, "
        f"latency p50 {np.percentile(lat, 50):.3f}s p99 {np.percentile(lat, 99):.3f}s"
    )
    return stats


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "graph":
        raise SystemExit("repro_torch.launch.serve: the graph service is not ported yet")
    if argv and argv[0] == "lm":
        return lm_main(argv[1:])
    return lm_main(argv)


if __name__ == "__main__":
    main()
