"""Model inputs: (shape, dtype) specs and demo batches (smoke tests).

Counterpart of ``repro.launch.specs``. Where the reference gives
``ShapeDtypeStruct`` stand-ins, :func:`input_specs` gives ``(shape, torch
dtype)`` pairs (the decode cache as ``meta`` tensors). :func:`make_demo_batch`
draws from the caller's ``np.random.Generator`` in the reference's order, so
both packages build the same batch from one seed.

Modality frontends are stubs: ``[audio]``/``[vlm]`` archs receive
precomputed frame/patch embeddings in their input dict.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.tree import resolve_device
from repro_torch.models import lm as lm_lib
from repro_torch.models.common import ArchConfig


def _train_like_shapes(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Tuple]:
    """(shape, dtype) entries for a full-sequence (train/prefill) batch."""
    if cfg.family == "encdec":
        return {
            "src_embeds": ((batch, seq, cfg.d_model), torch.bfloat16),
            "tokens": ((batch, seq), torch.int32),
            "targets": ((batch, seq), torch.int32),
        }
    if cfg.family == "vlm":
        n_img = min(cfg.frontend_tokens, max(seq // 2, 8))
        s_txt = seq - n_img
        return {
            "patch_embeds": ((batch, n_img, cfg.d_model), torch.bfloat16),
            "tokens": ((batch, s_txt), torch.int32),
            "targets": ((batch, s_txt), torch.int32),
        }
    return {
        "tokens": ((batch, seq), torch.int32),
        "targets": ((batch, seq), torch.int32),
    }


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """(shape, dtype) for every model input of this cell.

    train/prefill -> the batch dict; decode -> {"cache": {name: (shape,
    dtype)}, "tokens": ..., "pos": ...}.
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        return _train_like_shapes(cfg, b, s)
    # decode: one new token against a cache of length seq_len
    cache = lm_lib.init_cache(cfg, b, s, src_len=s if cfg.family == "encdec" else 0,
                              device="meta")
    return {
        "cache": {k: (tuple(v.shape), v.dtype) for k, v in cache.items()},
        "tokens": ((b,), torch.int32),
        "pos": ((), torch.int32),
    }


def make_demo_batch(cfg: ArchConfig, rng: np.random.Generator, batch: int, seq: int,
                    *, device: str | torch.device | None = None) -> Dict[str, torch.Tensor]:
    """Concrete random batch matching input_specs, on ``device`` (CUDA
    unless named): token ids from ``rng.integers``, embeddings from
    ``rng.standard_normal`` rounded to f32 and then to bf16."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for k, (shp, dt) in _train_like_shapes(cfg, batch, seq).items():
        if dt == torch.int32:
            a = rng.integers(0, cfg.vocab, size=shp).astype(np.int32)
            out[k] = torch.from_numpy(a).to(dev)
        else:
            a = rng.standard_normal(shp).astype(np.float32)
            out[k] = torch.from_numpy(a).to(dev).to(dt)
    return out
