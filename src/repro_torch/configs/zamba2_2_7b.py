"""zamba2-2.7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

54 Mamba2 layers, d_model=2560, one weight-shared full-attention block
(32H MHA, SwiGLU d_ff=10240) invoked every 6 SSM layers (9 invocations),
vocab 32000, ssm_state=64.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256),
    hybrid_attn_every=6,
)
