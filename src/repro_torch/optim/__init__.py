"""Optimizers of the LM trainer (counterpart of ``repro.optim``)."""

from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    ef_compress,
    ef_init,
    get_optimizer,
    warmup_cosine,
)

__all__ = [
    "Optimizer",
    "adafactor",
    "adamw",
    "clip_by_global_norm",
    "ef_compress",
    "ef_init",
    "get_optimizer",
    "warmup_cosine",
]
