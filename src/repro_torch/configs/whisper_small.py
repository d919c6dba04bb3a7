"""whisper-small — enc-dec audio backbone [arXiv:2212.04356].

Conv frontend is a STUB per assignment: ``input_specs()`` provides
precomputed frame embeddings (B, 1500, 768). LayerNorm, learned positions,
plain GELU MLP, MHA (kv=12), biases on projections.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,                   # decoder layers
    encoder_layers=12,
    encoder_decoder=True,
    encoder_seq=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    norm="layernorm",
    pos_emb="learned",
    act="gelu_mlp",
    qkv_bias=True,
    o_bias=True,
    tie_embeddings=True,
)
