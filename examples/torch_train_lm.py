"""End-to-end driver of the PyTorch port: train a ~100M-parameter
granite-style LM for a few hundred steps, with checkpointing and the
adaptive microbatch scheduler (the port's ``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py --device cpu [--steps 200]

(~100M params: 12 layers x d_model 512 on the granite backbone; on the card
drop ``--device cpu``.)
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.configs import get_config
from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="build/torch_train_lm")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    # ~100M params: granite-3-8b's shape at a reduced depth and width.
    cfg100m = get_config("granite-3-8b").scaled(
        num_layers=12, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=32064, attn_chunk=128,
    )
    train(cfg100m, steps=args.steps, global_batch=8, seq_len=128, lr=6e-4,
          ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=10, device=args.device,
          log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()
