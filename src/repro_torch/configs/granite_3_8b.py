"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155. GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]

At full width it fits one 80 GB card: 8.17 B parameters (16.3 GB in bf16,
embeddings tied) and a KV cache of 40 layers x 2 x 8 heads x 128 bf16 values
(160 KB) per token and sequence. The JAX model has none of granite's
muP-style multipliers, so neither does the port.
"""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab_size=49155,
        rope_theta=1e4,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, attn_chunk=64,
    )
