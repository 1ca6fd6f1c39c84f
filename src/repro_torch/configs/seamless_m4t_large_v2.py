"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206. Encoder-decoder, multimodal. The speech frontend is a STUB:
``input_specs()`` feeds precomputed frame embeddings [B, S, d_model] to the
encoder; the decoder is a causal text LM with cross-attention.
[arXiv:2308.11596; hf]

At full width and depth it fits one 80 GB card: 2.03 B parameters (4.07 GB
in bf16). The encoder's self-attention and every decoder layer's
cross-attention run the flash kernel's non-causal forms (16 heads of 64,
one query head a KV head); ``frontend_len`` is 0, so a cache from
``init_cache`` holds a zero memory of ``max_len`` frames until ``prefill``
puts the frames' keys and values there.
"""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=24,           # decoder layers
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        rope_theta=1e4,
        frontend="audio",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, encoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, attn_chunk=64,
    )
