"""Layer library of the port: norms, rope, attention (GQA/MLA), MLPs,
MoE, Mamba2-SSD.

The port of ``repro/models/layers.py``.  Functional
layers over parameter dicts, as in the JAX package:

- activations (B, S, D); attention heads (B, S, H, Dh);
- parameters in ``cfg.dtype``; projections are torch matmuls in that
  dtype; norms, softmax and attention scores in fp32 (full fp32 on the
  card: TF32 off, :func:`~repro_torch.core.strassen.ieee_fp32`);
- every ``init_*`` takes a maker (:class:`Init` for random weights,
  :class:`Spec` for the shapes alone) and returns a dict.

``attention`` takes the flash branch, the CUDA kernel behind
``ops.flash_mha``, exactly where the JAX package takes its Pallas
kernel: ``impl == "flash"``, more than one query and no ``kv_len`` (train
and prefill).  Otherwise sequences longer than ``cfg.attn_chunk_q`` take
the chunked branch (an online softmax over kv chunks, each step
rematerialized in the backward), as in the JAX package, and shorter ones
and decode the one-shot branch, plain torch where the JAX package leaves
both to XLA.  Non-causal attention (Whisper's encoder) hands the kernel
its keys unpadded, whatever their length: the kernel masks its ragged
edges itself.  The JAX package pads the keys to blocks of 512 and so
refuses a non-causal length that is not a multiple of 512 (1500 frames
at full width; ROADMAP.md Queue 3); wherever it runs, the two agree.

MLA (DeepSeek-V3's multi-head latent attention) runs its two branches as
the JAX package: the absorbed one (decode, and a prefill shorter than
the cache) in the compressed space, the expanded one through
``attention``, in "xla" only: the flash kernel takes one head_dim for q,
k and v, and MLA's v is narrower than its q (ROADMAP.md Queue 3).  The
MoE layer is the JAX package's sort-based capacity dispatch with every
expert on the one card; its expert-parallel ``shard_map`` branch waits
for the mesh policies (ROADMAP.md Queue 1 #11 step 7).

The Mamba2 SSD layer (``init_ssm``, ``apply_ssm``) is the JAX package's
chunked dual form: einsums in fp32 (TF32 off) and, where the JAX package
scans its chunk states, a loop over the chunks.  It has no Pallas
kernel, so it is plain torch here too.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from ..core.strassen import ieee_fp32

# A large-but-finite mask value: big enough to zero softmax weight, small
# enough that (-MASK) + finite stays finite in bf16/fp32.
MASK_VALUE = -1e9


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Parameter makers
# ---------------------------------------------------------------------------

class Init:
    """Random weights: normal * scale drawn in fp32 from ``generator``
    and cast to ``dtype`` (or the leaf's own ``dtype``, as the router's
    fp32), ones and zeros, on ``device``.

    A leaf of more than ``SLICE_ELEMENTS`` elements is drawn one slice of
    its leading axis at a time, so the fp32 draw never holds the whole
    leaf (Arctic's 128 x 7168 x 4864 expert stack would take 17.8 GB);
    every smaller leaf is drawn whole, as before."""

    SLICE_ELEMENTS = 1 << 30

    def __init__(self, generator: torch.Generator, device, dtype):
        self.generator, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, scale: float, dtype=None) -> torch.Tensor:
        dtype = dtype or self.dtype
        if math.prod(shape) <= self.SLICE_ELEMENTS:
            x = torch.randn(shape, generator=self.generator,
                            device=self.device)
            return (x * scale).to(dtype)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        for i in range(shape[0]):
            out[i] = self.normal(shape[1:], scale, dtype)
        return out

    def ones(self, shape, dtype=None) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype or self.dtype,
                          device=self.device)

    def zeros(self, shape, dtype=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype or self.dtype,
                           device=self.device)

    def log_range(self, n: int, dtype=None) -> torch.Tensor:
        """log(1), ..., log(n) (Mamba2's ``a_log``)."""
        return torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=self.device)).to(
            dtype or self.dtype)


class Spec:
    """Shapes alone: the parameter tree's layout, allocating nothing."""

    def normal(self, shape, scale: float, dtype=None):
        return tuple(shape)

    def ones(self, shape, dtype=None):
        return tuple(shape)

    zeros = ones

    def log_range(self, n: int, dtype=None):
        return (n,)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d: int, mk):
    if cfg.norm == "layernorm":
        return {"scale": mk.ones((d,)), "bias": mk.zeros((d,))}
    return {"scale": mk.ones((d,))}


def apply_norm(p, x, cfg: ModelConfig):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float()
    return y.to(x.dtype)


def rms_head_norm(x, scale, eps=1e-6):
    """Per-head qk-norm (Chameleon): RMS over the head dim."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


def softcap(x, cap):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_table(positions, dim: int, theta: float):
    """(..., S) int positions -> cos/sin tables (..., S, dim//2), fp32."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2).  Rotates the
    interleaved (even, odd) lane pairs, as the JAX package (not the
    halves of Hugging Face's ``rotate_half``)."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]  # (B,S,1,D/2)
    xf1, xf2 = x[..., 0::2].float(), x[..., 1::2].float()
    o1 = xf1 * cos - xf2 * sin
    o2 = xf2 * cos + xf1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, kv_pos, *, causal, window, kv_len=None):
    """Additive fp32 mask (R, Sq, Skv) from position vectors: R = 1 for
    q_pos (Sq,), R = B for per-row q_pos (B, Sq) and kv_len (B,).

    window: number of positions attended (q - kv < window) or None.
    kv_len masks invalid cache slots (decode).
    """
    q_pos = q_pos.reshape(-1, q_pos.shape[-1])
    diff = q_pos[:, :, None] - kv_pos[None, None, :]
    valid = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        valid &= diff >= 0
    if window is not None:
        valid &= diff < window
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=diff.device).reshape(-1)
        valid &= (kv_pos[None, :] < kv_len[:, None])[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(valid, zero, MASK_VALUE)


def attention(q, k, v, *, q_pos, kv_pos, causal=True, window=None,
              kv_len=None, attn_softcap=None, scale=None,
              chunk_q: int = 0, chunk_kv: int = 0, impl: str = "xla"):
    """General GQA attention.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); Hq % Hkv == 0.
    q_pos: (Sq,) or per-row (B, Sq) int positions of queries; kv_pos:
    (Skv,).  window: optional int sliding window.  kv_len: optional
    number of valid kv slots, a scalar or per row (B,) (decode caches).
    Returns (B, Sq, Hq, D) in q.dtype.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if impl == "stub":
        raise NotImplementedError(
            "attn_impl='stub' is the JAX package's roofline stand-in for "
            "its dry-run; not ported (ROADMAP.md Queue 1 #11)")
    if impl == "flash" and sq > 1 and kv_len is None:
        from ..kernels import ops as _kops
        # non-causal: one kv block as long as the keys, so none is padded
        return _kops.flash_mha(q, k, v, causal=causal, window=window or 0,
                               softcap=float(attn_softcap or 0.0),
                               block_kv=512 if causal else skv,
                               device=q.device)
    if chunk_q and sq > chunk_q and skv > max(chunk_kv, 1):
        return _chunked_attention(
            q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=causal,
            window=window, kv_len=kv_len, attn_softcap=attn_softcap,
            scale=scale, cq=chunk_q, ckv=chunk_kv or chunk_q)

    bias = _mask_bias(q_pos, kv_pos, causal=causal, window=window,
                      kv_len=kv_len)
    qg = q.reshape(b, sq, hkv, g, d)
    with ieee_fp32():
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
        if attn_softcap is not None:
            s = softcap(s, attn_softcap)
        s = s + bias[:, None, None]
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype).float(),
                         v.float())
    return o.reshape(b, sq, hq, dv).to(q.dtype)


def _kv_step(qi, qpi, kj, vj, kpj, kvalid, m, l, acc, *, causal, window,
             kv_len, attn_softcap, scale):
    """One kv chunk of the online softmax: the carry (m, l, acc) after
    kv chunk j, in fp32.  Padded kv slots (``kvalid`` False) are masked
    whatever ``causal``, ``window`` and ``kv_len`` say."""
    bias = _mask_bias(qpi, kpj, causal=causal, window=window, kv_len=kv_len)
    bias = torch.where(kvalid, bias, MASK_VALUE)
    with ieee_fp32():
        s = torch.einsum("bqhgd,bkhd->bhgqk", qi.float(), kj.float()) * scale
        if attn_softcap is not None:
            s = softcap(s, attn_softcap)
        s = s + bias[:, None, None]                 # (b,hkv,g,cq,ckv)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(vj.dtype).float(),
                         vj.float())                # (b,cq,hkv,g,dv)
        acc_new = acc * corr.permute(0, 3, 1, 2)[..., None] + o
    return m_new, l_new, acc_new


def _chunked_attention(q, k, v, *, q_pos, kv_pos, causal, window, kv_len,
                       attn_softcap, scale, cq: int, ckv: int):
    """The JAX package's chunked branch (``repro/models/layers.py:175``):
    a loop over q chunks of ``cq`` rows and, inside it, over kv chunks of
    ``ckv`` with the online-softmax carry (m, l, acc) in fp32.  Exact;
    with grad enabled each kv step runs under ``torch.utils.checkpoint``
    (the counterpart of ``jax.checkpoint`` there), so the backward
    recomputes a chunk's scores instead of keeping (cq, ckv) of them per
    step.

    q positions are padded with -1 and kv positions with 2^30, as the
    JAX package pads them; unlike it, the padded kv slots are masked
    whatever ``causal``, ``window`` and ``kv_len`` are (the reference
    masks them only through those, so its non-causal ragged case counts
    the zero-padded keys in the softmax: ROADMAP.md Queue 3).
    """
    from torch.utils.checkpoint import checkpoint
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    nq = -(-sq // cq) * cq
    nkv = -(-skv // ckv) * ckv
    qp = F.pad(q.reshape(b, sq, hkv, g, d), (0, 0, 0, 0, 0, 0, 0, nq - sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nkv - skv))
    vp = F.pad(v, (0, 0, 0, 0, 0, nkv - skv))
    qpos = F.pad(q_pos, (0, nq - sq), value=-1)
    kpos = F.pad(kv_pos, (0, nkv - skv), value=2 ** 30)
    kvalid = torch.arange(nkv, device=k.device) < skv
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    step = functools.partial(_kv_step, causal=causal, window=window,
                             kv_len=kv_len, attn_softcap=attn_softcap,
                             scale=scale)
    outs = []
    for i in range(0, nq, cq):
        qi, qpi = qp[:, i:i + cq], qpos[..., i:i + cq]
        m = torch.full((b, hkv, g, cq), -math.inf, device=q.device)
        l = torch.zeros((b, hkv, g, cq), device=q.device)
        acc = torch.zeros((b, cq, hkv, g, dv), device=q.device)
        for j in range(0, nkv, ckv):
            args = (qi, qpi, kp[:, j:j + ckv], vp[:, j:j + ckv],
                    kpos[j:j + ckv], kvalid[j:j + ckv], m, l, acc)
            m, l, acc = checkpoint(step, *args, use_reentrant=False) \
                if remat else step(*args)
        l = l.clamp_min(1e-30)
        outs.append(acc / l.permute(0, 3, 1, 2)[..., None])
    out = torch.cat(outs, 1).reshape(b, nq, hq, dv)[:, :sq]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, mk):
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    sc = 0.02
    p = {
        "wq": mk.normal((d, hq * hd), sc),
        "wk": mk.normal((d, hkv * hd), sc),
        "wv": mk.normal((d, hkv * hd), sc),
        "wo": mk.normal((hq * hd, d), sc / math.sqrt(2 * cfg.num_layers)),
    }
    if cfg.qkv_bias:
        p["bq"] = mk.zeros((hq * hd,))
        p["bk"] = mk.zeros((hkv * hd,))
        p["bv"] = mk.zeros((hkv * hd,))
    if cfg.o_bias:
        p["bo"] = mk.zeros((d,))
    if cfg.qk_norm:
        p["q_norm"] = mk.ones((hd,))
        p["k_norm"] = mk.ones((hd,))
    return p


def attention_q(p, x, cfg: ModelConfig):
    """The query projection (+bias, qk-norm) with no rope: what the
    cross-attention reads of the decoder."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim_)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(1, 1, cfg.num_heads, cfg.head_dim_)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def attention_qkv(p, x, cfg: ModelConfig, *, kv_src=None, positions=None,
                  kv_positions=None):
    """Project to q, k, v (+bias, qk-norm, rope). Returns (q, k, v).
    ``kv_src`` (the encoder's output, for cross-attention) gives k and v
    in place of x."""
    b, _, _ = x.shape
    hd = cfg.head_dim_
    kv_src = x if kv_src is None else kv_src
    skv = kv_src.shape[1]
    q = attention_q(p, x, cfg)
    k = (kv_src @ p["wk"]).reshape(b, skv, cfg.num_kv_heads, hd)
    v = (kv_src @ p["wv"]).reshape(b, skv, cfg.num_kv_heads, hd)
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(1, 1, cfg.num_kv_heads, hd)
        v = v + p["bv"].reshape(1, 1, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        k = rms_head_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_emb == "rope" and positions is not None:
        cos_q, sin_q = rope_table(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos_q, sin_q)
        kv_positions = positions if kv_positions is None else kv_positions
        cos_k, sin_k = rope_table(kv_positions, hd, cfg.rope_theta)
        k = apply_rope(k, cos_k, sin_k)
    return q, k, v


def attention_out(p, o, cfg: ModelConfig):
    b, s = o.shape[:2]
    y = o.reshape(b, s, cfg.num_heads * cfg.head_dim_) @ p["wo"]
    if cfg.o_bias:
        y = y + p["bo"]
    return y


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, mk):
    m: MLAConfig = cfg.mla
    d, hq = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_dim + m.qk_rope_dim
    sc = 0.02
    return {
        "w_dq": mk.normal((d, m.q_lora_rank), sc),
        "q_norm": mk.ones((m.q_lora_rank,)),
        "w_uq": mk.normal((m.q_lora_rank, hq * qk_head), sc),
        "w_dkv": mk.normal((d, m.kv_lora_rank + m.qk_rope_dim), sc),
        "kv_norm": mk.ones((m.kv_lora_rank,)),
        "w_uk": mk.normal((m.kv_lora_rank, hq * m.qk_nope_dim), sc),
        "w_uv": mk.normal((m.kv_lora_rank, hq * m.v_head_dim), sc),
        "wo": mk.normal((hq * m.v_head_dim, d),
                        sc / math.sqrt(2 * cfg.num_layers)),
    }


def mla_compress(p, x, cfg: ModelConfig, positions):
    """x -> (c_kv normed, k_rope roped): the MLA cache content."""
    m: MLAConfig = cfg.mla
    ckv_kr = x @ p["w_dkv"]
    c_kv = rms_head_norm(ckv_kr[..., :m.kv_lora_rank], p["kv_norm"],
                         cfg.norm_eps)
    k_rope = ckv_kr[..., m.kv_lora_rank:]               # (B, S, rope_dim)
    cos, sin = rope_table(positions, m.qk_rope_dim, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return c_kv, k_rope


def mla_queries(p, x, cfg: ModelConfig, positions):
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    qk_head = m.qk_nope_dim + m.qk_rope_dim
    cq = rms_head_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(b, s, cfg.num_heads, qk_head)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    cos, sin = rope_table(positions, m.qk_rope_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def mla_attention(p, x, cfg: ModelConfig, *, positions, q_pos, kv_pos,
                  c_kv=None, k_rope=None, kv_len=None, absorbed=False,
                  chunk_q=0, chunk_kv=0, impl: str = "xla"):
    """Full MLA attention.  If (c_kv, k_rope) are given they are the
    (cached) compressed KV; else they are computed from x.
    ``absorbed=True`` runs attention in the compressed space, never
    expanding K or V per position; otherwise K and V are expanded and go
    through :func:`attention`.  Products of 16-bit operands accumulate in
    fp32, as the JAX package's ``preferred_element_type``.

    ``impl="flash"`` raises ``ValueError``: q's head_dim (qk_nope +
    qk_rope) is not v's, which neither the TPU kernel nor its port takes
    (the JAX package's flash branch returns q's width there and its
    reshape fails: ROADMAP.md Queue 3, the MLA note)."""
    if impl == "flash":
        raise ValueError(
            "MLA takes attn_impl='xla': its v head_dim differs from q's, "
            "which the flash kernel does not take (ROADMAP.md Queue 3, "
            "the MLA note)")
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    hq = cfg.num_heads
    if c_kv is None:
        c_kv, k_rope = mla_compress(p, x, cfg, positions)
    skv = c_kv.shape[1]
    q_nope, q_rope = mla_queries(p, x, cfg, positions)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)

    if absorbed:
        # absorb W_uk into q: scores = (q W_uk^T) c_kv + q_rope k_rope
        w_uk = p["w_uk"].reshape(m.kv_lora_rank, hq, m.qk_nope_dim)
        w_uv = p["w_uv"].reshape(m.kv_lora_rank, hq, m.v_head_dim)
        bias = _mask_bias(q_pos, kv_pos, causal=True, window=None,
                          kv_len=kv_len)
        with ieee_fp32():
            q_lat = torch.einsum("bshd,rhd->bshr", q_nope.float(),
                                 w_uk.float()).to(x.dtype)
            s_lat = torch.einsum("bshr,bkr->bhsk", q_lat.float(),
                                 c_kv.float())
            s_rope = torch.einsum("bshd,bkd->bhsk", q_rope.float(),
                                  k_rope.float())
            w = torch.softmax((s_lat + s_rope) * scale + bias[:, None], -1)
            o_lat = torch.einsum("bhsk,bkr->bshr", w.to(x.dtype).float(),
                                 c_kv.float()).to(x.dtype)
            o = torch.einsum("bshr,rhv->bshv", o_lat.float(),
                             w_uv.float()).to(x.dtype)
    else:
        k_nope = (c_kv @ p["w_uk"]).reshape(b, skv, hq, m.qk_nope_dim)
        v = (c_kv @ p["w_uv"]).reshape(b, skv, hq, m.v_head_dim)
        k_rope_h = k_rope[:, :, None, :].expand(b, skv, hq, m.qk_rope_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope_h], dim=-1)
        o = attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=True,
                      kv_len=kv_len, scale=scale, chunk_q=chunk_q,
                      chunk_kv=chunk_kv, impl=impl)
    y = o.reshape(b, s, hq * m.v_head_dim) @ p["wo"]
    return y, (c_kv, k_rope)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, mk, d_ff: Optional[int] = None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    sc = 0.02
    out_sc = sc / math.sqrt(2 * cfg.num_layers)
    if cfg.act == "gelu_mlp":                      # plain 2-matrix MLP
        return {"w_in": mk.normal((d, f), sc), "b_in": mk.zeros((f,)),
                "w_out": mk.normal((f, d), out_sc), "b_out": mk.zeros((d,))}
    return {"w_gate": mk.normal((d, f), sc), "w_up": mk.normal((d, f), sc),
            "w_down": mk.normal((f, d), out_sc)}


def _act(cfg: ModelConfig, x):
    if cfg.act in ("gelu", "gelu_mlp"):
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def apply_mlp(p, x, cfg: ModelConfig):
    if "w_in" in p:                                 # plain MLP
        h = _act(cfg, x @ p["w_in"] + p["b_in"])
        return h @ p["w_out"] + p["b_out"]
    h = _act(cfg, x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE (top-k routing, sort + capacity scatter, batched expert products)
# ---------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, mk):
    mo: MoEConfig = cfg.moe
    d, f, e = cfg.d_model, mo.d_expert, mo.num_experts
    sc = 0.02
    p = {
        "router": mk.normal((d, e), sc, dtype=torch.float32),
        "w_gate": mk.normal((e, d, f), sc),
        "w_up": mk.normal((e, d, f), sc),
        "w_down": mk.normal((e, f, d), sc / math.sqrt(2 * cfg.num_layers)),
    }
    if mo.router_aux_free_bias:
        p["router_bias"] = mk.zeros((e,), dtype=torch.float32)
    if mo.num_shared:
        p["shared"] = init_mlp(cfg, mk, d_ff=mo.d_expert * mo.num_shared)
    return p


def moe_capacity(tokens: int, moe: MoEConfig) -> int:
    cf = moe.capacity_factor or 1.25
    cap = int(math.ceil(tokens * moe.top_k / moe.num_experts * cf))
    return max(min(cap, tokens), 1)


def moe_route(p, xt, cfg: ModelConfig):
    """The router over tokens xt (..., T, d), in fp32: (probs (..., T, E),
    top_idx (..., T, k), gates (..., T, k)).  The aux-free bias moves
    which experts are selected and not the gates."""
    mo: MoEConfig = cfg.moe
    with ieee_fp32():
        logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    sel = probs + p["router_bias"] if mo.router_aux_free_bias else probs
    top_idx = torch.topk(sel, mo.top_k, dim=-1).indices
    gates = torch.gather(probs, -1, top_idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_idx, gates


def _moe_dispatch_compute(p, xt, cfg: ModelConfig):
    """Sort-based capacity dispatch of G groups of T tokens, xt (G, T, d),
    each group routed on its own (its own capacity), every expert's
    tokens of every group in one batched product: the JAX package's
    ``_moe_dispatch_compute`` with all experts local, for each group.

    Within a group the assignments are sorted by expert id, stably, so an
    expert's first ``moe_capacity(T)`` assignments in token order keep
    their place and the rest are dropped (they go to one extra row of the
    buffer, which is discarded).  Returns (out (G, T, d), aux over all
    tokens)."""
    mo: MoEConfig = cfg.moe
    g, t, d = xt.shape
    e, k = mo.num_experts, mo.top_k
    probs, top_idx, gates = moe_route(p, xt, cfg)

    flat_e = top_idx.reshape(g, t * k)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = torch.gather(flat_e, -1, sort_idx)
    tok_sorted = sort_idx // k
    counts = torch.zeros((g, e), dtype=torch.long, device=xt.device)
    counts.scatter_add_(-1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, -1) - counts
    pos_in_e = torch.arange(t * k, device=xt.device) \
        - torch.gather(offsets, -1, e_sorted)
    cap = moe_capacity(t, mo)
    valid = pos_in_e < cap
    # buffer rows (expert, group, place); the dropped ones to the extra row
    group = torch.arange(g, device=xt.device)[:, None]
    slot = torch.where(valid, (e_sorted * g + group) * cap + pos_in_e,
                       e * g * cap)

    rows = xt[group, tok_sorted]                      # (G, T*k, d)
    buf = xt.new_zeros((e * g * cap + 1, d))
    buf = buf.index_put((slot.reshape(-1),),
                        torch.where(valid[..., None], rows, 0).reshape(-1, d))
    buf = buf[:e * g * cap].reshape(e, g * cap, d)

    h = _act(cfg, torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    y = torch.bmm(h, p["w_down"])

    y_flat = torch.cat([y.reshape(e * g * cap, d), y.new_zeros((1, d))])
    y_sorted = y_flat[slot]                           # dropped -> 0
    inv = torch.argsort(sort_idx, dim=-1)
    y_k = y_sorted[group, inv].reshape(g, t, k, d)
    out = (y_k * gates[..., None].to(y_k.dtype)).sum(dim=2)
    aux = moe_load_aux(probs.reshape(g * t, e), top_idx.reshape(g * t, k), e)
    return out, aux


def apply_moe(p, x, cfg: ModelConfig, *, rows_apart: bool = False):
    """x: (B, S, D) -> ((B, S, D), aux).  All B * S tokens are routed
    together (one capacity), as the JAX package routes them; with
    ``rows_apart`` each row is routed on its own, with its own capacity,
    as the JAX serving engine routes each slot of its vmapped decode.

    The JAX package's expert-parallel branch (dispatch inside
    ``shard_map`` under a mesh policy) waits for the mesh policies
    (ROADMAP.md Queue 1 #11 step 7); here every expert is on the card."""
    mo: MoEConfig = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b, s, d) if rows_apart else x.reshape(1, b * s, d)
    out, aux = _moe_dispatch_compute(p, xt, cfg)
    out = out.reshape(b * s, d)
    if mo.num_shared:
        out = out + apply_mlp(p["shared"], x.reshape(b * s, d), cfg)
    return out.reshape(b, s, d), aux


def moe_load_aux(probs, top_idx, e):
    """Switch-style load-balance aux loss: E * sum_e f_e * p_e."""
    t, k = top_idx.shape
    hits = torch.bincount(top_idx.reshape(-1), minlength=e).float()
    f = hits / (t * k)
    pbar = probs.mean(dim=0)
    return e * (f * pbar).sum()


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, chunked) — the SSD dual form of arXiv:2405.21060
# ---------------------------------------------------------------------------

def init_ssm(cfg: ModelConfig, mk):
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    h = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    sc = 0.02
    f32 = torch.float32
    # in_proj emits [z, x, B, C, dt]
    zxbcdt = 2 * d_in + 2 * s.n_groups * s.state_dim + h
    return {
        "w_in": mk.normal((d, zxbcdt), sc),
        "conv_w": mk.normal((s.conv_width, conv_dim), sc),
        "conv_b": mk.zeros((conv_dim,)),
        "a_log": mk.log_range(h, dtype=f32),
        "d_skip": mk.ones((h,), dtype=f32),
        "dt_bias": mk.zeros((h,), dtype=f32),
        "norm": mk.ones((d_in,)),
        "w_out": mk.normal((d_in, d), sc / math.sqrt(2 * cfg.num_layers)),
    }


def _segsum(x):
    """x: (..., Q) -> (..., Q, Q) lower-tri cumulative sums over segments,
    -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -math.inf)


def _ssd_chunked(xh, dt, a, bmat, cmat, chunk: int, init_state=None):
    """SSD scan, in fp32.  xh: (B, S, H, P); dt: (B, S, H) fp32; a: (H,)
    fp32 (negative); bmat/cmat: (B, S, G, N).  Returns (y (B, S, H, P),
    final_state (B, H, P, N)), both fp32.

    Head h reads group h // (H / G) (``jnp.repeat``'s order), so the
    heads are laid out as (G, H / G) and each group's B and C are read
    without repeating them; C Bᵀ, the same for every head of a group, is
    computed once a group.  A sequence that is not a multiple of the
    chunk is zero-padded: a padded dt of 0 leaves the state as it is, so
    ``final_state`` is the one after the last true position."""
    b, s_len, h, p_dim = xh.shape
    g, n = bmat.shape[2], bmat.shape[3]
    r = h // g
    q = min(chunk, s_len)
    nc = -(-s_len // q)
    pad = nc * q - s_len
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    with ieee_fp32():
        # chunked views: (B, NC, Q, G, R, ...)
        xc = xh.reshape(b, nc, q, g, r, p_dim).float()
        dtc = dt.reshape(b, nc, q, g, r).float()
        bc = bmat.reshape(b, nc, q, g, n).float()
        cc = cmat.reshape(b, nc, q, g, n).float()

        da = dtc * a.float().reshape(g, r)           # (B,NC,Q,G,R) negative
        da_cum = torch.cumsum(da, dim=2)             # within-chunk cumsum
        da_total = da_cum[:, :, -1]                  # (B,NC,G,R)
        dx = dtc[..., None] * xc                     # dt x

        # 1) intra-chunk (dual quadratic form): Y_d = (C Bᵀ . L) (dt x)
        l_mat = torch.exp(_segsum(da.permute(0, 1, 3, 4, 2)))  # (B,NC,G,R,Q,Q)
        cb = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)
        att = cb[:, :, :, None] * l_mat
        y_diag = torch.einsum("bcgrqk,bckgrp->bcqgrp", att, dx)

        # 2) chunk states: S_c = sum_k exp(da_total - da_cum_k) dt_k B_k x_k
        decay = torch.exp(da_total[:, :, None] - da_cum)         # (B,NC,Q,G,R)
        states = torch.einsum("bcqgn,bcqgrp->bcgrpn", bc,
                              decay[..., None] * dx)             # (B,NC,G,R,P,N)

        # 3) inter-chunk recurrence over the chunk states
        carry = (torch.zeros((b, g, r, p_dim, n), device=xh.device)
                 if init_state is None
                 else init_state.float().reshape(b, g, r, p_dim, n))
        prev = []
        for c in range(nc):
            prev.append(carry)                        # state BEFORE chunk c
            carry = states[:, c] \
                + carry * torch.exp(da_total[:, c])[..., None, None]
        prev_states = torch.stack(prev, 1)           # (B,NC,G,R,P,N)

        # 4) inter-chunk output: Y_off = C . exp(da_cum) . prev_state
        y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", cc, prev_states) \
            * torch.exp(da_cum)[..., None]

    y = (y_diag + y_off).reshape(b, nc * q, h, p_dim)[:, :s_len]
    return y, carry.reshape(b, h, p_dim, n)


def apply_ssm(p, x, cfg: ModelConfig, *, conv_state=None, ssm_state=None,
              decode=False):
    """Mamba-2 layer.  Train/prefill: the whole sequence (chunked SSD,
    from ``ssm_state`` where given).  Decode: one token's recurrent update
    from (conv_state (B, W-1, conv_dim), ssm_state (B, H, P, N)).
    Returns (out (B, S, D), (new conv_state in x's dtype, new ssm_state
    in fp32))."""
    s: SSMConfig = cfg.ssm
    b, seq, _ = x.shape
    d_in = s.expand * cfg.d_model
    h = d_in // s.head_dim
    g, n = s.n_groups, s.state_dim
    conv_dim = d_in + 2 * g * n

    zxbcdt = x @ p["w_in"]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + conv_dim]
    dt_raw = zxbcdt[..., d_in + conv_dim:]            # (B,S,H)

    # causal depthwise conv over xbc, in x's dtype
    w = p["conv_w"]                                    # (W, conv_dim)
    cw = s.conv_width
    if decode:
        window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # (B,W,C)
        new_conv_state = window[:, 1:]
        with ieee_fp32():
            conv = torch.einsum("bwc,wc->bc", window.float(), w.float())
        xbc = conv.to(x.dtype)[:, None] + p["conv_b"]
    else:
        xp = F.pad(xbc, (0, 0, cw - 1, 0))
        new_conv_state = xp[:, xp.shape[1] - (cw - 1):]
        # the JAX package's sum(xp[:, i:i+seq] * w[i]), term by term
        conv = xp[:, 0:seq] * w[0]
        for i in range(1, cw):
            conv = conv + xp[:, i:i + seq] * w[i]
        xbc = conv + p["conv_b"]
    xbc = F.silu(xbc)

    xin = xbc[..., :d_in].reshape(b, -1, h, s.head_dim)
    bmat = xbc[..., d_in:d_in + g * n].reshape(b, -1, g, n)
    cmat = xbc[..., d_in + g * n:].reshape(b, -1, g, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])                         # (H,) negative

    if decode:
        # recurrent: state' = exp(dt a) state + dt B x ; y = C state' + D x
        # head h reads group h // (H / G): jnp.repeat's order, by a view
        bh, ch = (m[:, 0, :, None].expand(b, g, h // g, n).reshape(b, h, n)
                  .float() for m in (bmat, cmat))             # (B,H,N)
        xf = xin[:, 0].float()                         # (B,H,P)
        dt0 = dt[:, 0]                                 # (B,H)
        decay = torch.exp(dt0 * a[None, :])[:, :, None, None]
        upd = (dt0[:, :, None] * xf)[..., None] * bh[:, :, None, :]
        new_state = ssm_state.float() * decay + upd
        with ieee_fp32():
            y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
        y = y + p["d_skip"][None, :, None] * xf
        y = y.reshape(b, 1, d_in)
    else:
        yh, new_state = _ssd_chunked(xin, dt, a, bmat, cmat, s.chunk,
                                     init_state=ssm_state)
        yh = yh + p["d_skip"][None, None, :, None] * xin.float()
        y = yh.reshape(b, seq, d_in)

    y = (y * F.silu(z.float())).to(x.dtype)
    y = rms_head_norm(y, p["norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    return out, (new_conv_state.to(x.dtype), new_state)
