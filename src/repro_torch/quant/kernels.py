"""Quantized grouped MSCM: the grouped kernel over int8/fp8 chunk tiles.

Counterpart of ``repro.quant.kernels``. ``mscm_grouped_q`` replaces the
Pallas TPU kernel of that name with the CUDA entry point
``mscm_grouped_q_launch`` of ``kernels/csrc/mscm_grouped.cu``: the grouped
kernel's routine, which copies the int8/fp8 chunk tile into shared memory
and widens each weight to f32 and multiplies it by its (chunk, column) scale
as it reads it. So device memory carries one byte per weight, and the
result is bitwise the f32 kernel's on the dequantized tiles (``float(q) * scale``,
:func:`repro_torch.quant.storage.dequantize_layer`): quantization error
comes from storage, never from the kernel.

The wrapper takes the plain version for tensors on the CPU and launches the
kernel for tensors on a GPU, raising if it cannot. Each launch adds 1 to
the ``obs`` counter ``launches.mscm_grouped_q``. The level around it is
:func:`repro_torch.kernels.ops.mscm_grouped_level` with this product in
place of the f32 one: same grouping, staging and unsort.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.kernels.mscm_kernel import (
    Q_DTYPES,
    check_grouped_args,
    common_device,
    grouped_tensors,
    launch_grouped,
    mscm_grouped_plain,
)


def _check_scales(vals: torch.Tensor, scales: torch.Tensor) -> None:
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32; got {scales.dtype}")
    if tuple(scales.shape) != (vals.shape[0], vals.shape[2]):
        raise ValueError(
            f"scales must be [C, B] = {(vals.shape[0], vals.shape[2])}; "
            f"got {tuple(scales.shape)}"
        )


def mscm_grouped_q_plain(
    xg_tiles: torch.Tensor,    # f32 [T, QT, R]
    vals: torch.Tensor,        # int8/fp8 [C, R, B]
    scales: torch.Tensor,      # f32 [C, B]
    tile_chunk: torch.Tensor,  # int [T]
    parent_scores: Optional[torch.Tensor] = None,  # f32 [T, QT]
    *,
    mode: str = "none",
    tile_src: Optional[torch.Tensor] = None,  # int [T, QT], -1 = padding
) -> torch.Tensor:
    """The plain PyTorch version: ``bmm(xg, vals[tc].float() * scales[tc])``,
    the epilogue and zeros for the padding tiles, chunk ids clamped; bitwise
    :func:`~repro_torch.kernels.mscm_kernel.mscm_grouped_plain` on the
    dequantized tiles."""
    tc = tile_chunk.clamp(0, vals.shape[0] - 1)
    tiles = vals[tc].to(torch.float32) * scales[tc][:, None, :]   # [T, R, B]
    own = torch.arange(tc.shape[0], device=tc.device)
    return mscm_grouped_plain(xg_tiles, tiles, own, parent_scores, mode=mode,
                              tile_src=tile_src)


def mscm_grouped_q(
    xg_tiles: torch.Tensor,    # f32 [T, QT, R] gathered query rows per tile
    vals: torch.Tensor,        # int8 or float8_e4m3fn [C, R, B]
    scales: torch.Tensor,      # f32 [C, B]
    tile_chunk: torch.Tensor,  # int64 [T]
    parent_scores: Optional[torch.Tensor] = None,  # f32 [T, QT] beam scores
    *,
    mode: str = "none",
    tile_src: Optional[torch.Tensor] = None,  # int64 [T, QT], -1 = padding
) -> torch.Tensor:
    """Quantized chunk-major tile product with the fused beam epilogue; the
    contract of ``mscm_grouped`` (``mode`` none/prod/logsum, padding tiles
    by ``tile_src`` zero, f32 [T, QT, B])."""
    check_grouped_args(xg_tiles, vals, tile_chunk, parent_scores, mode, tile_src,
                       vals_dtypes=tuple(Q_DTYPES))
    _check_scales(vals, scales)
    tensors = grouped_tensors(xg_tiles, vals, scales, tile_chunk, parent_scores, tile_src)
    if common_device(tensors, "mscm_grouped_q").type == "cpu":
        return mscm_grouped_q_plain(xg_tiles, vals, scales, tile_chunk, parent_scores,
                                    mode=mode, tile_src=tile_src)
    out = launch_grouped(xg_tiles, vals, scales, tile_chunk, tile_src, parent_scores, mode)
    obs.count("launches.mscm_grouped_q")
    return out


def mscm_grouped_q_level(
    x_dense: torch.Tensor,        # f32 [n, Dp]
    rows: torch.Tensor,           # int [C, R]
    vals: torch.Tensor,           # int8/fp8 [C, R, B]
    scales: torch.Tensor,         # f32 [C, B]
    block_q: torch.Tensor,        # int [A]
    block_c: torch.Tensor,        # int [A]
    parent_scores: Optional[torch.Tensor] = None,  # f32 [A] (beam scores)
    *,
    qt: int = ops.DEFAULT_QT,
    mode: str = "none",
) -> torch.Tensor:
    """One tree level through the quantized grouped kernel: the grouping,
    staging and unsort of ``ops.mscm_grouped_level``. Returns f32 [A, B]."""
    def product(xg, tc, ps, tile_src):
        return mscm_grouped_q(xg, vals, scales, tc, ps, mode=mode, tile_src=tile_src)

    return ops.mscm_grouped_level(x_dense, rows, vals, block_q, block_c, parent_scores,
                                  qt=qt, mode=mode, product=product)


def mscm_pallas_grouped_q(
    x_dense: torch.Tensor,
    rows: torch.Tensor,
    vals: torch.Tensor,
    scales: torch.Tensor,
    block_q: torch.Tensor,
    block_c: torch.Tensor,
    parent_scores: Optional[torch.Tensor] = None,
    *,
    qt: int = ops.DEFAULT_QT,
    mode: str = "none",
) -> torch.Tensor:
    """The reference's entry point of this name. Returns f32 [A, B] in the
    original block order."""
    return mscm_grouped_q_level(x_dense, rows, vals, scales, block_q, block_c,
                                parent_scores, qt=qt, mode=mode)
