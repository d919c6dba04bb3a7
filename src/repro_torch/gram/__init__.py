"""Gram service: streaming, batched, autotuned A^tA serving.

The port of ``repro/gram``, the layer between the fused ATA kernel and
the world (DESIGN.md §10):

- ``stream``   — online accumulators: C += chunk^t chunk in packed
                 lower-triangular state or a tile stack, their
                 checkpointed, crash-recoverable wrapper, and the sharded
                 and distributed streams over a ``DeviceMesh``.
- ``engine``   — ``GramEngine``: slot-based continuous batching of
                 heterogeneous Gram requests, power-of-two shape buckets,
                 one bound batched program per bucket (one launch of the
                 leaf-program kernel over the slots on the card), the
                 degradation ladder, admission and fair scheduling; and
                 ``batched_gram``.
- ``autotune`` — per-(bucket, dtype, backend) search over
                 mode x levels x variant x gram x blocks, persisted to
                 ``artifacts/autotune/gram_autotune.json`` and consulted
                 by ``kernels/ops.py`` for its block defaults.
- ``verify``   — the Freivalds-style output guards.
"""
from . import autotune, engine, stream  # noqa: F401
from .autotune import (  # noqa: F401
    autotune as autotune_bucket, bucket_shape, lookup as autotune_lookup,
    resolve_block_defaults,
)
from . import verify  # noqa: F401
from .engine import (  # noqa: F401
    BucketHealth, EngineShutdown, GramEngine, GramFuture, GramRequest,
    GramServeError, Overloaded, TenantState, batched_gram,
)
from .stream import (  # noqa: F401
    GramStream, init as stream_init, update as stream_update,
    finalize as stream_finalize,
    GramStackStream, stack_init, stack_update, stack_finalize,
    sharded_init, update_sharded,
    distributed_init, distributed_update, distributed_finalize,
    CheckpointedGramStream,
)
from .verify import (  # noqa: F401
    GramVerdict, VerificationError, freivalds_gram, verify_gram,
)

__all__ = [
    "autotune", "engine", "stream", "verify",
    "autotune_bucket", "bucket_shape", "autotune_lookup",
    "resolve_block_defaults",
    "GramEngine", "GramRequest", "GramFuture", "BucketHealth",
    "TenantState", "GramServeError", "Overloaded", "EngineShutdown",
    "batched_gram",
    "GramStream", "stream_init", "stream_update", "stream_finalize",
    "GramStackStream", "stack_init", "stack_update", "stack_finalize",
    "sharded_init", "update_sharded",
    "distributed_init", "distributed_update", "distributed_finalize",
    "CheckpointedGramStream",
    "GramVerdict", "VerificationError", "freivalds_gram", "verify_gram",
]
