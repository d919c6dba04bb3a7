"""chameleon-34b — early-fusion VLM backbone: VQ image tokens share the
text vocabulary (65536); qk-norm for stability [arXiv:2405.09818].

Modality frontend is a stub per assignment: images arrive as discrete VQ
token ids inside the ordinary token stream (that is Chameleon's design).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    qk_norm=True,
)
