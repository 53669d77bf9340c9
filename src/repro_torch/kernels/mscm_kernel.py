"""The grouped MSCM kernel for Hopper, and its plain PyTorch version.

Counterpart of the grouped half of ``repro.kernels.mscm_kernel``. The
kernel (``csrc/mscm_grouped.cu``) replaces the Pallas TPU kernel
``mscm_grouped``: one [QT, R] x [R, B] product per chunk-major query tile,
with the beam epilogue (σ(logit) ⊗ parent score, paper eq. 5) fused before
the store.

:func:`mscm_grouped` takes the plain version for tensors on the CPU and
launches the CUDA kernel for tensors on a GPU, raising if it cannot; it
never falls back from one to the other. :data:`GROUPED_LAUNCHES` counts the
kernel's launches, so a run can show its main path went through it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: Launches of the CUDA kernel since import (or since a caller reset it).
GROUPED_LAUNCHES = 0

MODES = {"none": 0, "prod": 1, "logsum": 2}


def group_blocks_by_chunk(
    block_c: np.ndarray, qt: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side grouping (the reference packing): active blocks into
    per-chunk tiles of QT.

    Returns
      tile_chunk [T]      chunk id of each tile
      tile_src   [T, QT]  index into the (unsorted) block list, -1 = padding
    """
    order = np.argsort(block_c, kind="stable")
    sorted_c = block_c[order]
    tiles_c, tiles_s = [], []
    i = 0
    a = len(block_c)
    while i < a:
        c = sorted_c[i]
        j = i
        while j < a and sorted_c[j] == c:
            j += 1
        members = order[i:j]
        for t0 in range(0, len(members), qt):
            grp = members[t0 : t0 + qt]
            src = np.full(qt, -1, dtype=np.int32)
            src[: len(grp)] = grp
            tiles_c.append(c)
            tiles_s.append(src)
        i = j
    if not tiles_c:  # degenerate empty input
        tiles_c, tiles_s = [0], [np.full(qt, -1, np.int32)]
    return np.asarray(tiles_c, np.int32), np.stack(tiles_s)


def _check_args(xg_tiles, vals, tile_chunk, parent_scores, mode) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown epilogue mode {mode!r}")
    if parent_scores is None and mode != "none":
        raise ValueError(
            f"mode={mode!r} combines with the parent beam scores; pass "
            "parent_scores (zeros would silently flatten every score)"
        )
    if xg_tiles.dim() != 3 or vals.dim() != 3 or tile_chunk.dim() != 1:
        raise ValueError(
            f"expected xg_tiles [T,QT,R], vals [C,R,B], tile_chunk [T]; got "
            f"{tuple(xg_tiles.shape)}, {tuple(vals.shape)}, {tuple(tile_chunk.shape)}"
        )
    t, qt, r = xg_tiles.shape
    if vals.shape[1] != r or tile_chunk.shape[0] != t or vals.shape[0] == 0:
        raise ValueError(
            f"shape mismatch: xg_tiles {tuple(xg_tiles.shape)}, vals "
            f"{tuple(vals.shape)}, tile_chunk {tuple(tile_chunk.shape)}"
        )
    if parent_scores is not None and tuple(parent_scores.shape) != (t, qt):
        raise ValueError(
            f"parent_scores must be [T, QT] = {(t, qt)}; got {tuple(parent_scores.shape)}"
        )
    floats = [xg_tiles, vals] + ([parent_scores] if parent_scores is not None else [])
    if any(x.dtype != torch.float32 for x in floats):
        raise TypeError("xg_tiles, vals and parent_scores must be float32")
    if tile_chunk.dtype != torch.int64:
        raise TypeError(f"tile_chunk must be int64; got {tile_chunk.dtype}")


def mscm_grouped_plain(
    xg_tiles: torch.Tensor,    # f32 [T, QT, R] gathered query rows per tile
    vals: torch.Tensor,        # f32 [C, R, B]
    tile_chunk: torch.Tensor,  # int [T]
    parent_scores: Optional[torch.Tensor] = None,  # f32 [T, QT]
    *,
    mode: str = "none",
) -> torch.Tensor:
    """The plain PyTorch version: ``bmm(xg_tiles, vals[tile_chunk])`` and the
    epilogue. Out-of-range chunk ids are clamped, as the reference's gather
    clamps them."""
    acc = torch.bmm(xg_tiles, vals[tile_chunk.clamp(0, vals.shape[0] - 1)])
    if mode == "prod":
        return torch.sigmoid(acc) * parent_scores[:, :, None]
    if mode == "logsum":
        return F.logsigmoid(acc) + parent_scores[:, :, None]
    return acc


def mscm_grouped(
    xg_tiles: torch.Tensor,    # f32 [T, QT, R]
    vals: torch.Tensor,        # f32 [C, R, B]
    tile_chunk: torch.Tensor,  # int64 [T]
    parent_scores: Optional[torch.Tensor] = None,  # f32 [T, QT] beam scores
    *,
    mode: str = "none",
) -> torch.Tensor:
    """Chunk-major query-tile product with an optionally fused beam epilogue.

    ``mode``: ``none`` raw logits; ``prod`` σ(logit) · parent_score;
    ``logsum`` logσ(logit) + parent_score. Returns f32 [T, QT, B].
    """
    _check_args(xg_tiles, vals, tile_chunk, parent_scores, mode)
    tensors = [xg_tiles, vals, tile_chunk] + (
        [parent_scores] if parent_scores is not None else []
    )
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = xg_tiles.device
    if dev.type == "cpu":
        return mscm_grouped_plain(xg_tiles, vals, tile_chunk, parent_scores, mode=mode)
    if dev.type != "cuda":
        raise ValueError(f"mscm_grouped runs on cpu or cuda tensors; got {dev}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("mscm_grouped needs contiguous tensors")
    return _launch(xg_tiles, vals, tile_chunk, parent_scores, mode)


def _launch(xg_tiles, vals, tile_chunk, parent_scores, mode) -> torch.Tensor:
    global GROUPED_LAUNCHES
    from repro_torch.kernels.build import load_library

    t, qt, r = xg_tiles.shape
    c, _, b = vals.shape
    dev = xg_tiles.device
    out = torch.empty((t, qt, b), dtype=torch.float32, device=dev)
    lib = load_library("mscm_grouped")
    with torch.cuda.device(dev):
        err = lib.mscm_grouped_launch(
            xg_tiles.data_ptr(), vals.data_ptr(), tile_chunk.data_ptr(),
            parent_scores.data_ptr() if parent_scores is not None else None,
            out.data_ptr(), t, qt, r, b, c, MODES[mode],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"mscm_grouped launch failed with CUDA error {err} "
            f"(T={t}, QT={qt}, R={r}, B={b}, C={c}, mode={mode})"
        )
    GROUPED_LAUNCHES += 1
    return out
