"""Config dataclasses of the port.

A copy of ``repro/configs/base.py`` (pure data): ``ModelConfig``,
``MoEConfig``, ``MLAConfig``, ``SSMConfig``, ``reduced`` and
``TrainConfig``.  ``ShapeConfig``, ``SHAPES`` and ``MeshConfig`` come
with the cells and meshes (ROADMAP Queue 1 #11 step 6).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                    # per-expert FFN hidden size
    num_shared: int = 0              # always-on shared experts (DeepSeek)
    dense_residual: bool = False     # dense FFN in parallel (Arctic)
    dense_d_ff: int = 0              # hidden of the dense residual / first-dense layers
    first_dense_layers: int = 0      # leading dense layers (DeepSeek: 3)
    capacity_factor: float = 0.0     # 0 => dropless (sort + ragged_dot)
    router_aux_free_bias: bool = False  # DeepSeek aux-loss-free balancing bias


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block config."""
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # defaults to d_model // num_heads
    qkv_bias: bool = False           # Qwen2.5
    o_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    norm: str = "rmsnorm"            # rmsnorm | layernorm (whisper)
    pos_emb: str = "rope"            # rope | learned (whisper)
    act: str = "silu"                # gated: silu->SwiGLU, gelu->GeGLU; "gelu_mlp" = plain
    rope_theta: float = 10000.0
    # gemma2
    sliding_window: Optional[int] = None
    alt_local_global: bool = False   # alternate sliding/global layers
    final_logit_softcap: Optional[float] = None
    attn_logit_softcap: Optional[float] = None
    post_norms: bool = False         # gemma2 post-block norms
    # chameleon
    qk_norm: bool = False
    # gemma2 scales embeddings by sqrt(d_model)
    scale_embed: bool = False
    # learned-position table size (whisper decoder)
    max_pos: int = 32768
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # zamba2 hybrid: one weight-shared attention block every k SSM blocks
    hybrid_attn_every: int = 0
    # whisper-style encoder-decoder
    encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500          # stub frontend emits this many frames
    # deepseek multi-token prediction (one extra depth-1 module)
    mtp: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"              # full | dots | none
    attn_chunk_q: int = 2048         # chunked-attention block sizes (long seq)
    attn_chunk_kv: int = 2048
    # attention implementation: "xla" (plain torch attention in the port,
    # chunked online softmax past attn_chunk_q, where the JAX package
    # leaves it to XLA) | "flash" (the CUDA kernel, forward only,
    # kernels/flash_attention.py) | "stub" (the JAX package's roofline
    # stand-in; not ported)
    attn_impl: str = "xla"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS and sanity checks."""
        d, hd = self.d_model, self.head_dim_
        n_q, n_kv = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params():
            if self.mla is not None:
                m = self.mla
                qk_head = m.qk_nope_dim + m.qk_rope_dim
                p = d * m.q_lora_rank + m.q_lora_rank * n_q * qk_head
                p += d * (m.kv_lora_rank + m.qk_rope_dim)
                p += m.kv_lora_rank * n_q * (m.qk_nope_dim + m.v_head_dim)
                p += n_q * m.v_head_dim * d
                return p
            return d * hd * (n_q + 2 * n_kv) + n_q * hd * d

        def mlp_params(dff, gated=True):
            return d * dff * (3 if gated else 2)

        def ssm_params():
            s = self.ssm
            d_in = s.expand * d
            p = d * (2 * d_in + 2 * s.n_groups * s.state_dim + d_in // s.head_dim)
            p += d_in * d  # out proj
            return p

        total = emb
        gated = self.act != "gelu_mlp"
        if self.family in ("ssm", "hybrid"):
            total += self.num_layers * ssm_params()
            if self.hybrid_attn_every:
                total += attn_params() + mlp_params(self.d_ff, gated)  # shared
        elif self.moe is not None:
            moe_layers = self.num_layers - self.moe.first_dense_layers
            per_expert = mlp_params(self.moe.d_expert, gated)
            total += self.num_layers * attn_params()
            total += moe_layers * (
                (self.moe.num_experts + self.moe.num_shared) * per_expert
                + d * self.moe.num_experts  # router
                + (mlp_params(self.moe.dense_d_ff, gated) if self.moe.dense_residual else 0)
            )
            total += self.moe.first_dense_layers * mlp_params(
                self.moe.dense_d_ff or self.d_ff, gated)
        else:
            layers = self.num_layers + (self.encoder_layers if self.encoder_decoder else 0)
            total += layers * (attn_params() + mlp_params(self.d_ff, gated))
            if self.encoder_decoder:  # cross-attention in decoder
                total += self.num_layers * attn_params()
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        gated = self.act != "gelu_mlp"
        per_expert = d * m.d_expert * (3 if gated else 2)
        inactive = (self.num_layers - m.first_dense_layers) * (
            (m.num_experts - m.top_k) * per_expert)
        return int(self.param_count() - inactive)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized config of the same family (small dims, same code
    paths). Full configs are exercised only via the dry-run."""
    small = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=256,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        attn_chunk_q=64,
        attn_chunk_kv=64,
    )
    if cfg.sliding_window:
        small["sliding_window"] = 64
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            d_expert=128,
            dense_d_ff=256 if (cfg.moe.dense_residual or cfg.moe.first_dense_layers) else 0,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
        )
    if cfg.mla is not None:
        small["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                 qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
        small["head_dim"] = None
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32,
                                           chunk=32)
    if cfg.hybrid_attn_every:
        small["hybrid_attn_every"] = 2
    if cfg.encoder_decoder:
        small["encoder_layers"] = 2
        small["encoder_seq"] = 16
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    optimizer: str = "adamw"          # adamw | shampoo
    shampoo_update_interval: int = 1  # gram-stat update cadence
    shampoo_precond_interval: int = 20
    shampoo_block_size: int = 1024
    ata_levels: int = 1               # Strassen levels inside Shampoo grams
    microbatch: int = 0               # 0 => no grad accumulation
    seed: int = 0
    grad_compress: bool = False       # int8 error-feedback all-reduce
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
