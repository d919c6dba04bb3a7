"""mamba2-2.7b — attention-free SSD (state-space duality) [arXiv:2405.21060].

64 Mamba2 blocks (no MLP: d_ff=0), d_model=2560, ssm_state=128.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,                     # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256),
)
