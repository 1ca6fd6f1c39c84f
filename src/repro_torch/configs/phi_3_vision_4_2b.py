"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (kv=32, MHA) d_ff=8192
vocab=32064. phi3-mini backbone + CLIP vision frontend. The vision tower is a
STUB: ``input_specs()`` provides 256 precomputed patch embeddings [B, 256,
d_model] prepended to the token sequence.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

At full width and depth it fits one 80 GB card: 3.82 B parameters (7.64 GB
in bf16). Its head width of 96 runs in the flash kernel's 128-wide
template (the bf16 forms pad Dh to it in shared memory). Served without
patches, it is a text-only LM, as the JAX package's server serves it.
"""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        rope_theta=1e4,
        frontend="vision",
        frontend_len=256,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, frontend_len=8, attn_chunk=64,
    )
