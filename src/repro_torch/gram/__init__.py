"""The Gram service layer of the port.

The port of ``repro/gram``: ``verify`` (the Freivalds-style output
guards), ``stream`` (the packed and tile-stack streaming accumulators,
their checkpointed, crash-recoverable wrapper, and the sharded and
distributed streams over a ``DeviceMesh``) and ``autotune`` (the
per-bucket search over mode x levels x variant x gram x blocks,
persisted to ``artifacts/autotune/gram_autotune.json`` and consulted by
``kernels/ops.py`` for its block defaults).  The engine comes with the
slice that ports it (ROADMAP.md Queue 1 #9).
"""
from . import autotune, stream, verify  # noqa: F401
from .autotune import (  # noqa: F401
    autotune as autotune_bucket, bucket_shape, lookup as autotune_lookup,
    resolve_block_defaults,
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

__all__ = ["autotune", "stream", "verify",
           "autotune_bucket", "bucket_shape", "autotune_lookup",
           "resolve_block_defaults",
           "GramStream", "stream_init", "stream_update", "stream_finalize",
           "GramStackStream", "stack_init", "stack_update", "stack_finalize",
           "sharded_init", "update_sharded",
           "distributed_init", "distributed_update", "distributed_finalize",
           "CheckpointedGramStream",
           "GramVerdict", "VerificationError", "freivalds_gram",
           "verify_gram"]
