"""gemma2-9b — alternating local/global attention, logit softcaps, GeGLU,
post-block norms, sqrt(d)-scaled embeddings [arXiv:2408.00118]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    act="gelu",                      # GeGLU
    sliding_window=4096,
    alt_local_global=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norms=True,
    scale_embed=True,
    tie_embeddings=True,
)
