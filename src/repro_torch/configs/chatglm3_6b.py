"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024. 2d-RoPE (rotation on half the head dim), GQA.
[arXiv:2406.12793; hf]

At full width it fits one 80 GB card: 6.24 B parameters (12.49 GB in bf16;
the qkv biases, which ``param_count`` leaves out, add 0.26 MB) and a KV cache
of 28 layers x 2 x 2 heads x 128 bf16 values (28 KB) per token and
sequence: 16 query heads share each KV head.
"""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=65024,
        rope_theta=1e4,
        rope_fraction=0.5,   # chatglm rotates only half of each head (2d RoPE)
        qkv_bias=True,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, attn_chunk=64,
    )
