"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536. Data-dependent decay linear recurrence (head size 64).
[arXiv:2404.05892; hf]

At full width it fits one 80 GB card: 8.875 B parameters (17.75 GB in
bf16) and a decode state of 32 layers x 64 heads x 64 x 64 float32 (32 MB)
per sequence.
"""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,            # head size 64
        num_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        layer_pattern=("rwkv",),
        sub_quadratic=True,      # O(1)-state decode → long_500k runs
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, attn_chunk=64,
    )
