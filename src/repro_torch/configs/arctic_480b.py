"""arctic-480b — 128-expert top-2 MoE + dense residual branch
[hf:Snowflake/snowflake-arctic-base]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,                       # = d_expert
    vocab_size=32000,
    head_dim=128,
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        d_expert=4864,
        dense_residual=True,
        dense_d_ff=4864,
    ),
)
