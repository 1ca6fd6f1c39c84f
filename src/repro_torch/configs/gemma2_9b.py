"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000. Local+global alternating attention, logit softcap.
[arXiv:2408.00118; hf]

At full width it fits one 80 GB card: 9.24 B parameters (18.48 GB in bf16,
embeddings tied) and a KV cache of 42 layers x 2 x 8 heads x 256 bf16 values
(336 KB) per token and sequence. Its layers alternate a 4,096-key sliding
window (``attn_local``, pattern position 0) with global attention
(position 1); the attention scores are soft-capped at 50 and the logits at
30. A local layer's KV cache holds ``max_len`` positions, as the JAX
package's does.
"""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        layer_pattern=("attn_local", "attn"),   # alternating 4k-window / global
        local_window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        rope_theta=1e4,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, local_window=16, attn_chunk=64,
    )
