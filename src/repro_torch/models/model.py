"""Model assembly of the port: init / forward / cache for the dense and
vlm families.

The port of ``repro/models/model.py``.  One ``forward`` serves train,
prefill and decode (mode-switched), as in the JAX package.  Where the
JAX package stacks the layers' parameters on a leading axis and runs them
under ``lax.scan``, the port keeps a list of per-layer parameter dicts
and loops over it in Python; the cache keeps the JAX layout, (L, B,
max_seq, Hkv, D), and each layer reads and writes its slice in place.
``parallel/act.constrain``, a sharding hint that is the identity on one
card, is dropped.  ``cfg.remat`` rematerializes each block in train mode
with grad enabled, as ``_maybe_remat`` does in the JAX package:
``"full"`` under ``torch.utils.checkpoint``, ``"dots"`` under selective
checkpointing that keeps the projections' matmul outputs, ``"none"`` not
at all; it changes memory, never numbers.  ``loss_fn`` is next-token
cross-entropy with z-loss.  The other families raise
``NotImplementedError`` naming their ROADMAP item, and so do the moe
auxiliary loss and multi-token prediction in ``loss_fn``.

Decode takes ``cache["index"]`` as a scalar, as the JAX package, or one
index per row (B,), so that requests at different positions decode in one
batch (the serving engine's slots, where the JAX engine vmaps).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Union

import torch
from torch.utils import checkpoint as _ckpt

from ..configs.base import ModelConfig
from ..configs.registry import PORTED_FAMILIES, not_ported
from ..kernels.ops import resolve_device
from . import blocks as B
from . import layers as L

__all__ = ["init_params", "param_spec", "init_cache", "forward", "prefill",
           "decode_step", "cross_entropy", "loss_fn"]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise not_ported(cfg.family)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _tree(cfg: ModelConfig, mk) -> Dict[str, Any]:
    _check_family(cfg)
    p: Dict[str, Any] = {
        "embed": mk.normal((cfg.vocab_size, cfg.d_model), 0.02),
        "ln_f": L.init_norm(cfg, cfg.d_model, mk),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = mk.normal((cfg.d_model, cfg.vocab_size), 0.02)
    p["blocks"] = [B.init_attn_block(cfg, mk) for _ in range(cfg.num_layers)]
    return p


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator] = 0, *,
                device=None) -> Dict[str, Any]:
    """Random parameters in ``cfg.dtype`` on ``device`` (the card unless
    ``device="cpu"``), drawn from ``key``: a ``torch.Generator`` on that
    device or an int seed for one.  They are not the JAX package's numbers
    for the same seed; ``convert.params_from_jax`` carries those over."""
    dev = resolve_device(device)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=dev).manual_seed(int(key))
    return _tree(cfg, L.Init(gen, dev, L.dtype_of(cfg)))


def param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree with each leaf's shape in place of a tensor."""
    return _tree(cfg, L.Spec())


def param_count(params) -> int:
    """Elements of a parameter tree (dicts and lists of tensors)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(param_count(v) for v in params)
    return params.numel()


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=None) -> Dict[str, Any]:
    """Zeroed decoding cache sized for ``max_seq`` context, on ``device``
    (the card unless ``device="cpu"``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = L.dtype_of(cfg)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim_)
    return {"index": torch.zeros((), dtype=torch.int64, device=dev),
            "blocks": {"k": torch.zeros(shape, dtype=dt, device=dev),
                       "v": torch.zeros(shape, dtype=dt, device=dev)}}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _pos_info(batch: int, seq: int, max_seq: int, index=None,
              device=None) -> B.PosInfo:
    kv_pos = torch.arange(max_seq, device=device)
    if index is None:                       # train / prefill: positions 0..S
        pos = torch.arange(seq, device=device)
        return B.PosInfo(pos, pos, kv_pos, None)
    # decode: each row's tokens at its `index` (one index for all rows, or
    # one per row)
    idx = torch.as_tensor(index, device=device).long().reshape(-1)
    pos = idx.expand(batch)[:, None].expand(batch, seq)
    return B.PosInfo(pos, pos, kv_pos, pos[:, 0] + 1)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of the matmuls without batch dimensions (the
    projections, which torch runs as ``mm`` / ``addmm``), recompute the
    rest (the attention's batched einsums among them)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` rematerialized in the backward as ``cfg.remat`` says."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                _dots_policy)
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    if cfg.remat != "full":
        raise ValueError(f"remat is full, dots or none, got {cfg.remat!r}")
    return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)


def _embed(cfg: ModelConfig, p, tokens):
    x = p["embed"][tokens]
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    return x


def _unembed(cfg: ModelConfig, p, x):
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    logits = x @ w
    if cfg.final_logit_softcap:
        logits = L.softcap(logits, cfg.final_logit_softcap)
    return logits


def forward(cfg: ModelConfig, params, tokens, *,
            enc_inputs: Optional[torch.Tensor] = None,
            cache: Optional[Dict[str, Any]] = None,
            mode: str = "train"):
    """Run the model on the device its parameters lie on.

    mode="train":   tokens (B, S) -> (logits (B, S, V), aux, hidden).
                    cache must be None.
    mode="prefill": tokens (B, S) -> (logits (B, S, V), cache).
    mode="decode":  tokens (B, 1) -> (logits (B, 1, V), cache); the
                    position is ``cache["index"]``, scalar or per row.
    The cache's tensors are written in place; the returned dict holds
    them and the new index.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode is train, prefill or decode, got {mode!r}")
    _check_family(cfg)
    if enc_inputs is not None:
        raise not_ported("audio")
    device = params["embed"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    b, seq = tokens.shape
    decode = mode == "decode"
    use_cache = cache is not None
    max_seq = seq
    index = None
    if use_cache:
        index = cache["index"] if decode else None
        max_seq = cache["blocks"]["k"].shape[2]
    pos = _pos_info(b, seq, max_seq, index, device)

    x = _embed(cfg, params, tokens)
    block = B.attn_block
    if mode == "train" and not use_cache and torch.is_grad_enabled():
        block = _maybe_remat(B.attn_block, cfg)
    for li, lp in enumerate(params["blocks"]):
        cache_l = None
        if use_cache:
            cache_l = {"k": cache["blocks"]["k"][li],
                       "v": cache["blocks"]["v"][li]}
        x, _ = block(lp, x, cfg, layer_idx=li, pos=pos, cache=cache_l)

    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = _unembed(cfg, params, x)

    if use_cache:
        new_cache = dict(cache)
        new_cache["index"] = (cache["index"] + seq) if decode else \
            torch.tensor(seq, dtype=torch.int64, device=device)
        return (logits, new_cache, torch.zeros((), device=device)) \
            if mode == "train" else (logits, new_cache)
    return logits, torch.zeros((), device=device), x


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, *, z_loss: float = 1e-4):
    """Token-mean CE in fp32 with z-loss; logits (B,S,V), labels (B,S)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    labels = torch.as_tensor(labels, device=lf.device).long()
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    loss = (lse - gold).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, Any], *,
            aux_weight: float = 1e-2, mtp_weight: float = 0.3):
    """Next-token CE.  batch: inputs, labels (B, S) int (numpy or
    tensors).  Returns (loss, {"ce", "moe_aux", "loss"}), as the JAX
    package; its moe auxiliary term (``aux_weight``) and multi-token
    prediction (``mtp_weight``) come with their families."""
    if cfg.moe is not None:
        raise not_ported("moe")
    if cfg.mtp:
        raise not_ported("moe (multi-token prediction)")
    logits, aux, _ = forward(cfg, params, batch["inputs"],
                             enc_inputs=batch.get("enc_inputs"), mode="train")
    loss = cross_entropy(logits, batch["labels"])
    return loss, {"ce": loss, "moe_aux": aux, "loss": loss}


def prefill(cfg: ModelConfig, params, tokens, cache):
    """Fill ``cache`` from a (B, S) prompt; returns (last_logits, cache)."""
    logits, cache = forward(cfg, params, tokens, cache=cache, mode="prefill")
    return logits[:, -1], cache


def decode_step(cfg: ModelConfig, params, tokens, cache):
    """One decode step: tokens (B, 1) at position cache["index"]."""
    logits, cache = forward(cfg, params, tokens, cache=cache, mode="decode")
    return logits[:, -1], cache
