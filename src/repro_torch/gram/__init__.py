"""The Gram service layer of the port.

The port of ``repro/gram``: ``verify`` (the Freivalds-style output
guards) and the local parts of ``stream`` (the packed and tile-stack
streaming accumulators and their checkpointed, crash-recoverable
wrapper).  The sharded and distributed streams come with the port's
distributed layer, the engine and autotune with the slices that port
them.
"""
from . import stream, verify  # noqa: F401
from .stream import (  # noqa: F401
    GramStream, init as stream_init, update as stream_update,
    finalize as stream_finalize,
    GramStackStream, stack_init, stack_update, stack_finalize,
    CheckpointedGramStream,
)
from .verify import (  # noqa: F401
    GramVerdict, VerificationError, freivalds_gram, verify_gram,
)

__all__ = ["stream", "verify",
           "GramStream", "stream_init", "stream_update", "stream_finalize",
           "GramStackStream", "stack_init", "stack_update", "stack_finalize",
           "CheckpointedGramStream",
           "GramVerdict", "VerificationError", "freivalds_gram",
           "verify_gram"]
