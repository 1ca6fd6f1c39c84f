"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2. Mamba:attention 7:1 interleave (one
attention layer per 8-layer block, at position 4), MoE every other layer.
[arXiv:2403.19887; hf]

Its 51.51 B parameters take 103.0 GB in bf16, more than one 80 GB card: on
the card it runs cut to 16 layers (two groups of the 8-layer period: 14
Mamba and 2 attention layers, 8 dense MLPs and 8 MoE layers; 26.02 B, 52.04
GB). A Mamba layer's inner width is 8,192 (expand 2) with 16 states a
channel and a 4-tap conv: its decode state is a [8,192, 16] float32 h and a
3-row conv tail, whatever the sequence's length.
"""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        layer_pattern=(
            "mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba",
        ),
        mlp_pattern=("dense", "moe"),
        num_experts=16,
        experts_per_token=2,
        moe_d_ff=14336,
        moe_comm="auto",
        ssm_state=16,
        ssm_conv=4,
        mamba_expand=2,
        sub_quadratic=True,   # mamba state + 4 attention layers → long_500k runs
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, num_experts=4, experts_per_token=2,
        moe_d_ff=64, attn_chunk=64,
    )
