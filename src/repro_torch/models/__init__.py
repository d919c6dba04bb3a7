"""The port's model zoo: the dense and vlm families (GQA, sliding window
and softcap, qk-norm, QKV bias), as parameter dicts with a Python loop
over the layers, and their training loss."""
from .model import (  # noqa: F401
    init_params,
    forward,
    init_cache,
    prefill,
    decode_step,
    cross_entropy,
    loss_fn,
)
