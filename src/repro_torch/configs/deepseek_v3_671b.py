"""deepseek-v3-671b — MLA + MoE 256e top-8 (1 shared), 3 leading dense
layers, aux-free router bias, MTP [arXiv:2412.19437]."""
from .base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,                # MLA: per-head latent KV
    d_ff=2048,                       # = d_expert
    vocab_size=129280,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_expert=2048,
        num_shared=1,
        first_dense_layers=3,
        dense_d_ff=18432,
        router_aux_free_bias=True,
    ),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    mtp=True,
)
