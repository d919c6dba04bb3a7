"""Optimizers of the port: AdamW + ATA-powered Shampoo (+schedules,
gradient compression).  The JAX package's functional API:

    opt = adamw(lr) | shampoo(lr)
    state = opt.init(params)
    updates, state, metrics = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)
"""
from .adamw import adamw, apply_updates, global_norm, clip_by_global_norm  # noqa: F401
from .shampoo import shampoo  # noqa: F401
from .schedules import warmup_cosine, warmup_linear, constant  # noqa: F401
from .grad_compress import (  # noqa: F401
    int8_quantize, int8_dequantize, compressed_psum, ErrorFeedback,
    lowrank_basis, lowrank_psum,
)
