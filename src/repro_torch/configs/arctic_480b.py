"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 **plus a dense residual MLP in parallel** (Snowflake's
dense-MoE hybrid). [hf:Snowflake/snowflake-arctic-base; hf]

At full width one layer holds 13.61 B parameters (27.2 GB in bf16), so two of
its 35 layers already take 55.4 GB of one 80 GB card: the port runs it at
its smoke size only.
"""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        mlp_pattern=("moe_dense",),   # dense residual in parallel with MoE
        num_experts=128,
        experts_per_token=2,
        moe_d_ff=4864,
        moe_comm="auto",
        rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, num_experts=8, experts_per_token=2,
        moe_d_ff=64, attn_chunk=64,
    )
