"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8. Every layer is MoE (768-wide experts).
[hf:Qwen/Qwen3-30B-A3B; hf]

The expert dispatch is the hash-join shuffle, and HUGE's push/pull rule picks
its collective. At full width its 30.53 B parameters take 61.06 GB in bf16 of
one 80 GB card, 3.35 B of them active a token, with a KV cache of 48 layers x
2 x 4 heads x 128 bf16 values (96 KB) per token and sequence. Its logits are
151,936 wide (0.3 MB a token in bf16). A lossless pass (up to 1,024 tokens:
8,192 routed pairs) builds [128, n, 2048] buckets, 4.29 GB in bf16 at n =
8,192, and a decode step reads every expert (1.21 GB a layer).
"""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        mlp_pattern=("moe",),
        num_experts=128,
        experts_per_token=8,
        moe_d_ff=768,
        moe_comm="auto",
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, num_experts=8, experts_per_token=2,
        moe_d_ff=64, attn_chunk=64,
    )
