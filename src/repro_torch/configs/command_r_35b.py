"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000. GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]

At full width its 30.28 B parameters take 60.57 GB in bf16 (embeddings
tied) of one 80 GB card, with a KV cache of 40 layers x 2 x 8 heads x 128
bf16 values (160 KB) per token and sequence; its logits are 256,000 wide
(0.5 MB a token in bf16), so what fits beside the weights is a few
thousand tokens a pass.
"""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        num_layers=40,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22528,
        vocab_size=256000,
        rope_theta=1e4,
        qkv_bias=False,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, attn_chunk=64,
    )
