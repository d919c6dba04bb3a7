"""Transformer blocks of the port: norms and residuals around the layers.

The port of the attention block of ``repro/models/blocks.py``:

    attn_block(params, x, cfg, *, layer_idx, pos, cache=None)
      -> (x, new_cache)

``cache`` is a dict or None; ``pos`` carries (positions, q_pos, kv_pos,
kv_len) so train, prefill and decode share one code path.  Where the JAX
package returns a new cache, the port writes the new keys and values
into the cache's tensors in place and returns them (a decode step would
otherwise copy the whole cache).  The MLA, MoE and SSM blocks come with
their families (ROADMAP.md Queue 1 #11).
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
# Attention (+MLP) block — dense families, gemma2, chameleon, qwen
# ---------------------------------------------------------------------------

def init_attn_block(cfg: ModelConfig, mk, *, d_ff: Optional[int] = None):
    p = {
        "ln_attn": L.init_norm(cfg, cfg.d_model, mk),
        "attn": L.init_attention(cfg, mk),
        "ln_mlp": L.init_norm(cfg, cfg.d_model, mk),
        "mlp": L.init_mlp(cfg, mk, d_ff=d_ff),
    }
    if cfg.post_norms:
        p["post_attn"] = L.init_norm(cfg, cfg.d_model, mk)
        p["post_mlp"] = L.init_norm(cfg, cfg.d_model, mk)
    return p


def _write_cache(cache, k, v, q_pos):
    """Write k, v (B, S, Hkv, D) into the cache in place: a prompt as long
    as the cache fills it; shorter ones (a prefill bucket, a decode token)
    go in at each row's first query position, clamped so that they fit,
    as ``lax.dynamic_update_slice`` clamps."""
    ck, cv = cache["k"], cache["v"]
    b, s = k.shape[:2]
    if s == ck.shape[1]:                        # prefill fills the cache
        ck.copy_(k)
        cv.copy_(v)
        return ck, cv
    start = q_pos[..., 0].reshape(-1).long().clamp(0, ck.shape[1] - s)
    rows = torch.arange(b, device=ck.device)[:, None]
    cols = start.expand(b)[:, None] + torch.arange(s, device=ck.device)
    ck[rows, cols] = k.to(ck.dtype)
    cv[rows, cols] = v.to(cv.dtype)
    return ck, cv


def attn_block(p, x, cfg: ModelConfig, *, layer_idx: int, pos: PosInfo,
               cache=None, enc_out=None, causal=True):
    """Pre-norm attention + MLP block (optional gemma2 post-norms).
    cache: {"k", "v"} of (B, max_seq, Hkv, D), updated in place, or
    None."""
    if "cross" in p or enc_out is not None:
        raise NotImplementedError(
            "cross-attention (the audio family) is not ported: ROADMAP.md "
            "Queue 1 #11")
    window = _window_for_layer(cfg, layer_idx)

    h = L.apply_norm(p["ln_attn"], x, cfg)
    q, k, v = L.attention_qkv(p["attn"], h, cfg, positions=pos.positions)
    new_cache = None
    if cache is not None:
        k, v = _write_cache(cache, k, v, pos.q_pos)
        new_cache = {"k": k, "v": v}
    o = L.attention(q, k, v, q_pos=pos.q_pos, kv_pos=pos.kv_pos,
                    causal=causal, window=window, kv_len=pos.kv_len,
                    attn_softcap=cfg.attn_logit_softcap,
                    chunk_q=cfg.attn_chunk_q if x.shape[1] > cfg.attn_chunk_q
                    else 0,
                    chunk_kv=cfg.attn_chunk_kv, impl=cfg.attn_impl)
    o = L.attention_out(p["attn"], o, cfg)
    if cfg.post_norms:
        o = L.apply_norm(p["post_attn"], o, cfg)
    x = x + o

    h = L.apply_norm(p["ln_mlp"], x, cfg)
    o = L.apply_mlp(p["mlp"], h, cfg)
    if cfg.post_norms:
        o = L.apply_norm(p["post_mlp"], o, cfg)
    x = x + o
    return x, new_cache
