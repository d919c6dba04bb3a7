"""The Gram service layer of the port.

The port of ``repro/gram``.  Only ``verify`` so far: the Freivalds-style
output guards.  The stream, engine and autotune modules come with the
slices that port them.
"""
from . import verify  # noqa: F401
from .verify import (  # noqa: F401
    GramVerdict, VerificationError, freivalds_gram, verify_gram,
)

__all__ = ["verify", "GramVerdict", "VerificationError", "freivalds_gram",
           "verify_gram"]
