"""Model assembly of the port: init / forward / cache / loss for all ten
architectures.

The port of ``repro/models/model.py``.  One ``forward`` serves train,
prefill and decode (mode-switched), as in the JAX package.  Where the
JAX package stacks the layers' parameters on a leading axis and runs them
under ``lax.scan``, the port keeps a list of per-layer parameter dicts
and loops over it in Python; the cache keeps the JAX layout, (L, B, ...),
and each layer reads and writes its slice in place.
``parallel/act.constrain``, a sharding hint that is the identity on one
card, is dropped.  ``cfg.remat`` rematerializes each block in train mode
with grad enabled, as ``_maybe_remat`` does in the JAX package:
``"full"`` under ``torch.utils.checkpoint``, ``"dots"`` under selective
checkpointing that keeps the projections' matmul outputs, ``"none"`` not
at all; it changes memory, never numbers.  ``loss_fn`` is next-token
cross-entropy with z-loss, plus the MoE load-balance term and DeepSeek-V3's
depth-1 multi-token prediction where the config has them.  A family the
JAX package does not know raises ``ValueError``, as there.

The moe family: Arctic's layers are one stack, ``blocks`` (GQA attention
and a MoE with a dense residual); DeepSeek-V3's are two, ``mla_dense``
(its leading dense layers) and ``mla_moe``, with an MLA cache (``ckv``,
``krope``) and the ``mtp`` head that only ``loss_fn`` runs.  The MoE
term is summed over the layers.

The ssm family (Mamba2) is one stack of SSM blocks, its cache each
layer's conv window (in the model's dtype) and SSM state (fp32).  The
hybrid family (Zamba2) runs its SSM blocks in groups of
``hybrid_attn_every``, each group followed by one call of the shared
attention block: ONE weight set, ``shared_attn``, with a KV cache of its
own for each call.  The audio family (Whisper) runs its encoder stack
non-causally over ``enc_inputs`` + ``enc_pos`` (the stub frontend's frame
embeddings), then ``ln_enc``; its decoder adds the learned ``dec_pos``
at each token's position and cross-attends to the encoder's output,
whose keys and values a prefill stores in the cache (``ck``, ``cv``) for
decode.

Decode takes ``cache["index"]`` as a scalar, as the JAX package, or one
index per row (B,), so that requests at different positions decode in one
batch (the serving engine's slots, where the JAX engine vmaps).  For the
same reason decode routes each row's token through the MoE on its own:
under the JAX engine's vmap each slot's dispatch sees one token, so its
capacity is 1 and nothing is dropped, where rows routed together would
compete for capacity.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Union

import torch
from torch.utils import checkpoint as _ckpt

from ..configs.base import ModelConfig
from ..configs.registry import PORTED_FAMILIES
from ..kernels.ops import resolve_device
from . import blocks as B
from . import layers as L

__all__ = ["init_params", "param_spec", "init_cache", "forward", "prefill",
           "decode_step", "cross_entropy", "loss_fn"]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


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
    fam = cfg.family
    if fam in ("dense", "vlm"):
        p["blocks"] = [B.init_attn_block(cfg, mk)
                       for _ in range(cfg.num_layers)]
    elif cfg.mla is not None:                           # DeepSeek-V3
        nd = cfg.moe.first_dense_layers
        if nd:
            p["mla_dense"] = [B.init_mla_block(cfg, mk, moe=False)
                              for _ in range(nd)]
        p["mla_moe"] = [B.init_mla_block(cfg, mk, moe=True)
                        for _ in range(cfg.num_layers - nd)]
        if cfg.mtp:
            p["mtp"] = {
                "proj": mk.normal((2 * cfg.d_model, cfg.d_model), 0.02),
                "block": B.init_mla_block(cfg, mk, moe=False),
                "ln": L.init_norm(cfg, cfg.d_model, mk),
            }
    elif fam == "moe":                                  # Arctic
        p["blocks"] = [B.init_moe_block(cfg, mk)
                       for _ in range(cfg.num_layers)]
    elif fam in ("ssm", "hybrid"):
        p["blocks"] = [B.init_ssm_block(cfg, mk)
                       for _ in range(cfg.num_layers)]
        if fam == "hybrid":
            p["shared_attn"] = B.init_attn_block(cfg, mk)  # ONE weight set
    else:                                               # Whisper backbone
        p["enc_blocks"] = [B.init_attn_block(cfg, mk)
                           for _ in range(cfg.encoder_layers)]
        p["blocks"] = [B.init_attn_block(cfg, mk, cross=True)
                       for _ in range(cfg.num_layers)]
        p["ln_enc"] = L.init_norm(cfg, cfg.d_model, mk)
        p["enc_pos"] = mk.normal((cfg.encoder_seq, cfg.d_model), 0.02)
        p["dec_pos"] = mk.normal((cfg.max_pos, cfg.d_model), 0.02)
    return p


def _stacks(cfg: ModelConfig):
    """(parameter and cache key, block, index of its first layer) of each
    layer stack of the dense, vlm and moe families, in the order the
    forward runs them.  The moe family's blocks route tokens and return
    the MoE term too."""
    if cfg.mla is not None:
        nd = cfg.moe.first_dense_layers
        return ([("mla_dense", B.mla_block, 0)] if nd else []) \
            + [("mla_moe", B.mla_block, nd)]
    if cfg.family == "moe":
        return [("blocks", B.moe_block, 0)]
    return [("blocks", B.attn_block, 0)]


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

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)
    cache: Dict[str, Any] = {"index": torch.zeros((), dtype=torch.int64,
                                                  device=dev)}
    if cfg.mla is not None:
        m = cfg.mla
        nd = cfg.moe.first_dense_layers
        for key, layers in (("mla_dense", nd),
                            ("mla_moe", cfg.num_layers - nd)):
            if layers:
                cache[key] = {
                    "ckv": zeros(layers, batch, max_seq, m.kv_lora_rank),
                    "krope": zeros(layers, batch, max_seq, m.qk_rope_dim)}
        return cache

    def kv(layers, seq=max_seq):
        shape = (layers, batch, seq, cfg.num_kv_heads, cfg.head_dim_)
        return {"k": zeros(*shape), "v": zeros(*shape)}
    fam = cfg.family
    if fam in ("ssm", "hybrid"):
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        h = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.state_dim
        cache["blocks"] = {
            "conv": zeros(cfg.num_layers, batch, s.conv_width - 1, conv_dim),
            "ssm": torch.zeros((cfg.num_layers, batch, h, s.head_dim,
                                s.state_dim), dtype=torch.float32,
                               device=dev)}
        if fam == "hybrid":
            cache["shared_attn"] = kv(cfg.num_layers // cfg.hybrid_attn_every)
        return cache
    cache["blocks"] = kv(cfg.num_layers)
    if fam == "audio":
        cross = kv(cfg.num_layers, cfg.encoder_seq)
        cache["blocks"].update(ck=cross["k"], cv=cross["v"])
    return cache


def _cache_seq(cfg: ModelConfig, cache) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.mla is not None:
        return cache["mla_moe"]["ckv"].shape[2]
    if cfg.family == "hybrid":
        return cache["shared_attn"]["k"].shape[2]
    return cache["blocks"]["k"].shape[2]


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


def _dec_pos(table, b: int, seq: int, index, device):
    """Whisper's learned decoder positions for ``seq`` tokens from
    ``index`` (None: from 0; a scalar or one a row), (1 or B, seq, D):
    ``lax.dynamic_slice_in_dim``'s rows, its start clamped likewise."""
    if index is None:
        return table[:seq][None]
    start = torch.as_tensor(index, device=device).long().reshape(-1)
    start = start.expand(b).clamp(0, table.shape[0] - seq)
    return table[start[:, None] + torch.arange(seq, device=device)]


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
    enc_inputs: (B, S_enc, D) precomputed frame embeddings (whisper's stub
    frontend), needed by the audio family except in decode.
    The cache's tensors are written in place; the returned dict holds
    them and the new index.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode is train, prefill or decode, got {mode!r}")
    _check_family(cfg)
    device = params["embed"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    b, seq = tokens.shape
    decode = mode == "decode"
    use_cache = cache is not None
    max_seq = seq
    index = None
    if use_cache:
        index = cache["index"] if decode else None
        max_seq = _cache_seq(cfg, cache)
    pos = _pos_info(b, seq, max_seq, index, device)

    x = _embed(cfg, params, tokens)
    aux = torch.zeros((), device=device)
    remat = mode == "train" and not use_cache and torch.is_grad_enabled()
    fam = cfg.family

    def block_fn(block):
        return _maybe_remat(block, cfg) if remat else block

    def layer_cache(key, i):
        return ({name: t[i] for name, t in cache[key].items()}
                if use_cache else None)

    if fam in ("ssm", "hybrid"):
        ssm, shared = block_fn(B.ssm_block), block_fn(B.attn_block)
        every = cfg.hybrid_attn_every if fam == "hybrid" else cfg.num_layers
        for g in range(cfg.num_layers // every):
            for i in range(g * every, (g + 1) * every):
                x, _ = ssm(params["blocks"][i], x, cfg, layer_idx=i,
                           cache=layer_cache("blocks", i), decode=decode)
            if fam == "hybrid":
                # the shared (weight-tied) block, its own KV cache a call
                x, _ = shared(params["shared_attn"], x, cfg, layer_idx=g,
                              pos=pos, cache=layer_cache("shared_attn", g))
    elif fam == "audio":                                # Whisper backbone
        if enc_inputs is None and not (use_cache and decode):
            raise ValueError("whisper needs enc_inputs (stub frontend) "
                             "except in decode")
        x = x + _dec_pos(params["dec_pos"], b, seq, index,
                         device).to(x.dtype)
        attn = block_fn(B.attn_block)
        enc_out = None
        if enc_inputs is not None:
            e = torch.as_tensor(enc_inputs, device=device).to(x.dtype) \
                + params["enc_pos"][None].to(x.dtype)
            epos = torch.arange(cfg.encoder_seq, device=device)
            enc_pos = B.PosInfo(epos, epos, epos, None)
            for i, lp in enumerate(params["enc_blocks"]):
                e, _ = attn(lp, e, cfg, layer_idx=i, pos=enc_pos,
                            causal=False)
            enc_out = L.apply_norm(params["ln_enc"], e, cfg)
        for i, lp in enumerate(params["blocks"]):
            x, _ = attn(lp, x, cfg, layer_idx=i, pos=pos,
                        cache=layer_cache("blocks", i), enc_out=enc_out)
    else:
        routes = fam == "moe"
        # decode routes each row on its own (the JAX engine's vmap)
        extra = {"rows_apart": decode} if routes else {}
        for key, block, idx0 in _stacks(cfg):
            fn = block_fn(block)
            for i, lp in enumerate(params[key]):
                out = fn(lp, x, cfg, layer_idx=idx0 + i, pos=pos,
                         cache=layer_cache(key, i), **extra)
                x = out[0]
                if routes:
                    aux = aux + out[2]

    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = _unembed(cfg, params, x)

    if use_cache:
        new_cache = dict(cache)
        new_cache["index"] = (cache["index"] + seq) if decode else \
            torch.tensor(seq, dtype=torch.int64, device=device)
        return (logits, new_cache, aux) if mode == "train" \
            else (logits, new_cache)
    return logits, aux, x


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
    """Next-token CE (+ MoE aux + optional MTP).  batch: inputs, labels
    (B, S) int [+ enc_inputs (B, S_enc, D)] (numpy or tensors).  Returns (loss, {"ce", "moe_aux",
    ["mtp_ce",] "loss"}), as the JAX package: ``aux_weight`` times the
    MoE term where the config has a MoE, and ``mtp_weight`` times the
    depth-1 multi-token prediction's CE where it has an ``mtp`` head (h_t
    with the embedding of x_{t+1}, through one dense MLA block, predicts
    label_{t+1})."""
    logits, aux, h = forward(cfg, params, batch["inputs"],
                             enc_inputs=batch.get("enc_inputs"), mode="train")
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    loss = cross_entropy(logits, labels)
    metrics = {"ce": loss, "moe_aux": aux}
    if cfg.moe is not None:
        loss = loss + aux_weight * aux
    if cfg.mtp and "mtp" in params:
        mtp = params["mtp"]
        inputs = torch.as_tensor(batch["inputs"], device=h.device).long()
        emb_next = _embed(cfg, params, inputs[:, 1:])
        hcat = torch.cat([h[:, :-1], emb_next], dim=-1)
        hm = L.apply_norm(mtp["ln"], hcat @ mtp["proj"], cfg)
        pos = _pos_info(hm.shape[0], hm.shape[1], hm.shape[1],
                        device=h.device)
        hm, _, _ = B.mla_block(mtp["block"], hm, cfg, layer_idx=0, pos=pos)
        mtp_loss = cross_entropy(_unembed(cfg, params, hm), labels[:, 1:])
        metrics["mtp_ce"] = mtp_loss
        loss = loss + mtp_weight * mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def prefill(cfg: ModelConfig, params, tokens, cache, *, enc_inputs=None):
    """Fill ``cache`` from a (B, S) prompt; returns (last_logits, cache)."""
    logits, cache = forward(cfg, params, tokens, cache=cache,
                            enc_inputs=enc_inputs, mode="prefill")
    return logits[:, -1], cache


def decode_step(cfg: ModelConfig, params, tokens, cache):
    """One decode step: tokens (B, 1) at position cache["index"]."""
    logits, cache = forward(cfg, params, tokens, cache=cache, mode="decode")
    return logits[:, -1], cache
