"""Blocks of the port: norms and residuals around the layers.

The port of ``repro/models/blocks.py``.  The attention block,

    attn_block(params, x, cfg, *, layer_idx, pos, cache=None,
               enc_out=None, causal=True) -> (x, new_cache)

serves the dense families, Zamba2's shared block and both of Whisper's
stacks (its decoder's blocks carry a cross-attention over the encoder's
output).  ``cache`` is a dict or None; ``pos`` carries (positions,
q_pos, kv_pos, kv_len) so train, prefill and decode share one code path.
Where the JAX package returns a new cache, the port writes the new keys
and values (and the SSM's states) into the cache's tensors in place and
returns them (a decode step would otherwise copy the whole cache).  The
moe family's two blocks,

    moe_block / mla_block(params, x, cfg, *, layer_idx, pos, cache=None,
                          rows_apart=False) -> (x, new_cache, aux)

return the MoE layer's load-balance term as well (0 for DeepSeek-V3's
dense layers); ``rows_apart`` routes each row's tokens on their own (the
batched decode, where the JAX serving engine vmaps over its slots).  The
Mamba2 block,

    ssm_block(params, x, cfg, *, layer_idx, cache=None, decode=False)
      -> (x, new_cache)

keeps no positions: its cache is the conv window and the SSM state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from . import layers as L


class PosInfo(NamedTuple):
    positions: torch.Tensor          # (B, S) or (S,) absolute positions of x
    q_pos: torch.Tensor              # (S,) or per-row (B, S) query positions
    kv_pos: torch.Tensor             # (Skv,) kv positions
    kv_len: Optional[torch.Tensor]   # valid kv slots (decode), scalar or (B,)


def _window_for_layer(cfg: ModelConfig, layer_idx: int) -> Optional[int]:
    """Gemma-2 alternating local/global: even layers slide, odd are global.

    ``layer_idx`` is a Python int (the port loops over the layers), so the
    window is one too, and the flash branch applies it.  The JAX package
    computes it with ``jnp.where``, a traced value that its flash branch
    drops (ROADMAP.md Queue 3); its one-shot branch applies it as here.
    """
    if cfg.sliding_window is None:
        return None
    if not cfg.alt_local_global or layer_idx % 2 == 0:
        return cfg.sliding_window
    return None


# ---------------------------------------------------------------------------
# Attention (+MLP) block — dense families, gemma2, chameleon, qwen, whisper
# ---------------------------------------------------------------------------

def init_attn_block(cfg: ModelConfig, mk, *, cross: bool = False,
                    d_ff: Optional[int] = None):
    p = {
        "ln_attn": L.init_norm(cfg, cfg.d_model, mk),
        "attn": L.init_attention(cfg, mk),
        "ln_mlp": L.init_norm(cfg, cfg.d_model, mk),
        "mlp": L.init_mlp(cfg, mk, d_ff=d_ff),
    }
    if cfg.post_norms:
        p["post_attn"] = L.init_norm(cfg, cfg.d_model, mk)
        p["post_mlp"] = L.init_norm(cfg, cfg.d_model, mk)
    if cross:
        p["ln_cross"] = L.init_norm(cfg, cfg.d_model, mk)
        p["cross"] = L.init_attention(cfg, mk)
    return p


def _write_rows(buf, x, q_pos):
    """Write x (B, S, ...) into the cache tensor buf (B, max_seq, ...) in
    place: a prompt as long as the cache fills it; shorter ones (a
    prefill bucket, a decode token) go in at each row's first query
    position, clamped so that they fit, as ``lax.dynamic_update_slice``
    clamps."""
    b, s = x.shape[:2]
    if s == buf.shape[1]:                       # prefill fills the cache
        return buf.copy_(x)
    start = q_pos[..., 0].reshape(-1).long().clamp(0, buf.shape[1] - s)
    rows = torch.arange(b, device=buf.device)[:, None]
    cols = start.expand(b)[:, None] + torch.arange(s, device=buf.device)
    buf[rows, cols] = x.to(buf.dtype)
    return buf


def _write_cache(cache, k, v, q_pos):
    """Write k, v (B, S, Hkv, D) into the cache's "k" and "v" in place
    (:func:`_write_rows`)."""
    return (_write_rows(cache["k"], k, q_pos),
            _write_rows(cache["v"], v, q_pos))


def _self_attention(p, h, cfg: ModelConfig, *, layer_idx: int,
                    pos: PosInfo, cache, causal=True, softcap=None):
    """GQA self-attention of the normed h, its keys and values written
    into the cache in place: (the output projection, the new cache)."""
    q, k, v = L.attention_qkv(p, h, cfg, positions=pos.positions)
    new_cache = None
    if cache is not None:
        k, v = _write_cache(cache, k, v, pos.q_pos)
        new_cache = {"k": k, "v": v}
    o = L.attention(q, k, v, q_pos=pos.q_pos, kv_pos=pos.kv_pos,
                    causal=causal, window=_window_for_layer(cfg, layer_idx),
                    kv_len=pos.kv_len, attn_softcap=softcap,
                    chunk_q=cfg.attn_chunk_q if h.shape[1] > cfg.attn_chunk_q
                    else 0,
                    chunk_kv=cfg.attn_chunk_kv, impl=cfg.attn_impl)
    return L.attention_out(p, o, cfg), new_cache


def attn_block(p, x, cfg: ModelConfig, *, layer_idx: int, pos: PosInfo,
               cache=None, enc_out=None, causal=True):
    """Pre-norm attention + MLP block (optional gemma2 post-norms, optional
    whisper cross-attention).  cache: {"k", "v"} of (B, max_seq, Hkv, D)
    [+ the cross keys and values {"ck", "cv"} of (B, encoder_seq, Hkv,
    D)], updated in place, or None.

    The cross-attention's q has no rope (whisper's positions are
    learned); its keys and values come from ``enc_out`` where it is
    given (train, prefill: then written into the cache) and from the
    cache in decode.  It is non-causal and always takes the "xla"
    branch, as in the JAX package."""
    h = L.apply_norm(p["ln_attn"], x, cfg)
    o, new_cache = _self_attention(p["attn"], h, cfg, layer_idx=layer_idx,
                                   pos=pos, cache=cache, causal=causal,
                                   softcap=cfg.attn_logit_softcap)
    if cfg.post_norms:
        o = L.apply_norm(p["post_attn"], o, cfg)
    x = x + o

    if "cross" in p:
        h = L.apply_norm(p["ln_cross"], x, cfg)
        if enc_out is None:                         # decode: cached cross K/V
            qc = L.attention_q(p["cross"], h, cfg)
            kc, vc = cache["ck"], cache["cv"]
        else:
            qc, kc, vc = L.attention_qkv(p["cross"], h, cfg, kv_src=enc_out)
            if cache is not None:                   # prefill: cache them
                kc, vc = cache["ck"].copy_(kc), cache["cv"].copy_(vc)
        if new_cache is not None:
            new_cache.update(ck=kc, cv=vc)
        enc_pos = torch.arange(kc.shape[1], device=x.device)
        oc = L.attention(qc, kc, vc, q_pos=pos.q_pos, kv_pos=enc_pos,
                         causal=False)
        x = x + L.attention_out(p["cross"], oc, cfg)

    h = L.apply_norm(p["ln_mlp"], x, cfg)
    o = L.apply_mlp(p["mlp"], h, cfg)
    if cfg.post_norms:
        o = L.apply_norm(p["post_mlp"], o, cfg)
    x = x + o
    return x, new_cache


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V3)
# ---------------------------------------------------------------------------

def init_mla_block(cfg: ModelConfig, mk, *, moe: bool):
    p = {
        "ln_attn": L.init_norm(cfg, cfg.d_model, mk),
        "attn": L.init_mla(cfg, mk),
        "ln_mlp": L.init_norm(cfg, cfg.d_model, mk),
    }
    if moe:
        p["moe"] = L.init_moe(cfg, mk)
    else:
        p["mlp"] = L.init_mlp(cfg, mk, d_ff=cfg.moe.dense_d_ff or cfg.d_ff)
    return p


def mla_block(p, x, cfg: ModelConfig, *, layer_idx: int, pos: PosInfo,
              cache=None, rows_apart: bool = False):
    """MLA + (MoE or dense MLP) block.  cache: {"ckv" (B, max_seq,
    kv_lora_rank), "krope" (B, max_seq, qk_rope_dim)}, updated in place,
    or None.  A prompt as long as the cache takes the expanded branch; a
    shorter one (a prefill bucket, a decode token) is written at
    ``q_pos[0]`` and takes the absorbed branch over the whole cache, as
    in the JAX package."""
    del layer_idx
    h = L.apply_norm(p["ln_attn"], x, cfg)
    c_kv = k_rope = None
    new_cache = None
    absorbed = False
    if cache is not None:
        c_new, kr_new = L.mla_compress(p["attn"], h, cfg, pos.positions)
        absorbed = x.shape[1] != cache["ckv"].shape[1]
        new_cache = {"ckv": _write_rows(cache["ckv"], c_new, pos.q_pos),
                     "krope": _write_rows(cache["krope"], kr_new, pos.q_pos)}
        c_kv, k_rope = (new_cache["ckv"], new_cache["krope"]) if absorbed \
            else (c_new, kr_new)
    o, _ = L.mla_attention(p["attn"], h, cfg, positions=pos.positions,
                           q_pos=pos.q_pos, kv_pos=pos.kv_pos,
                           c_kv=c_kv, k_rope=k_rope, kv_len=pos.kv_len,
                           absorbed=absorbed,
                           chunk_q=cfg.attn_chunk_q
                           if x.shape[1] > cfg.attn_chunk_q else 0,
                           chunk_kv=cfg.attn_chunk_kv, impl=cfg.attn_impl)
    x = x + o

    h = L.apply_norm(p["ln_mlp"], x, cfg)
    if "moe" in p:
        o, aux = L.apply_moe(p["moe"], h, cfg, rows_apart=rows_apart)
    else:
        o = L.apply_mlp(p["mlp"], h, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + o, new_cache, aux


# ---------------------------------------------------------------------------
# MoE attention block (Arctic: GQA attn + 128e top-2 MoE + dense residual)
# ---------------------------------------------------------------------------

def init_moe_block(cfg: ModelConfig, mk):
    p = {
        "ln_attn": L.init_norm(cfg, cfg.d_model, mk),
        "attn": L.init_attention(cfg, mk),
        "ln_mlp": L.init_norm(cfg, cfg.d_model, mk),
        "moe": L.init_moe(cfg, mk),
    }
    if cfg.moe.dense_residual:
        p["ln_dense"] = L.init_norm(cfg, cfg.d_model, mk)
        p["dense"] = L.init_mlp(cfg, mk, d_ff=cfg.moe.dense_d_ff)
    return p


def moe_block(p, x, cfg: ModelConfig, *, layer_idx: int, pos: PosInfo,
              cache=None, rows_apart: bool = False):
    """GQA attention + MoE block, with Arctic's dense FFN residual in
    parallel with the MoE where the config has one.  cache: {"k", "v"},
    updated in place, or None."""
    h = L.apply_norm(p["ln_attn"], x, cfg)
    o, new_cache = _self_attention(p["attn"], h, cfg, layer_idx=layer_idx,
                                   pos=pos, cache=cache)
    x = x + o

    h = L.apply_norm(p["ln_mlp"], x, cfg)
    o, aux = L.apply_moe(p["moe"], h, cfg, rows_apart=rows_apart)
    if "dense" in p:   # Arctic: dense FFN residual in parallel with MoE
        o = o + L.apply_mlp(p["dense"], L.apply_norm(p["ln_dense"], x, cfg),
                            cfg)
    return x + o, new_cache, aux


# ---------------------------------------------------------------------------
# SSM block (Mamba2) — norm + SSD + residual (no MLP when d_ff == 0)
# ---------------------------------------------------------------------------

def init_ssm_block(cfg: ModelConfig, mk):
    p = {"ln": L.init_norm(cfg, cfg.d_model, mk), "ssm": L.init_ssm(cfg, mk)}
    if cfg.d_ff:
        p["ln_mlp"] = L.init_norm(cfg, cfg.d_model, mk)
        p["mlp"] = L.init_mlp(cfg, mk)
    return p


def ssm_block(p, x, cfg: ModelConfig, *, layer_idx: int, cache=None,
              decode: bool = False):
    """Norm + Mamba2 layer + residual (+ an MLP where ``cfg.d_ff``).
    cache: {"conv" (B, W-1, conv_dim), "ssm" (B, H, P, N) fp32}, updated
    in place, or None.  A prefill starts its SSM from the cache's state
    and its conv from zeros, as in the JAX package."""
    del layer_idx
    h = L.apply_norm(p["ln"], x, cfg)
    o, (conv, ssm) = L.apply_ssm(
        p["ssm"], h, cfg, conv_state=None if cache is None else cache["conv"],
        ssm_state=None if cache is None else cache["ssm"], decode=decode)
    x = x + o
    new_cache = None
    if cache is not None:
        new_cache = {"conv": cache["conv"].copy_(conv),
                     "ssm": cache["ssm"].copy_(ssm)}
    if "mlp" in p:
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln_mlp"], x, cfg), cfg)
    return x, new_cache
