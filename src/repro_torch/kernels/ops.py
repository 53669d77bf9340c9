"""The MSCM levels around the kernels (counterpart of ``repro.kernels.ops``).

All index arithmetic stays here, outside the kernels, so the CPU tests reach
it. Online path: :func:`mscm_pallas` sorts the blocks by chunk, runs the
fused or the pregather kernel and restores the block order. Batch path:
:func:`group_blocks_device` packs the active blocks chunk-major into QT-row
tiles with sorts, searchsorted and gathers; :func:`mscm_grouped_level`
gathers the query rows into tiles, runs the grouped kernel and restores the
block order. Tile counts come from shapes only (:func:`grouped_tile_bound`),
and nothing here reads a value back to the host, so a whole traversal is
enqueued on the GPU without a synchronisation.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.mscm import gather_query_rows
from repro_torch.kernels.mscm_kernel import mscm_fused, mscm_grouped, mscm_pregather

# The reference's switch between its fused and pregather kernels: a dense
# query row wider than this many elements would not fit the TPU's VMEM.
# Nothing on this card needs the switch; it is kept so that one
# configuration reaches the same kernel in both packages.
VMEM_ROW_LIMIT = 1 << 20

# Query-tile height of the grouped kernel: rows per [QT, R] x [R, B] product.
DEFAULT_QT = 8


def sort_blocks_by_chunk(block_q: torch.Tensor, block_c: torch.Tensor):
    """Chunk-major ordering (paper Alg. 3 lines 6-8) + the permutation."""
    order = torch.argsort(block_c, stable=True)
    return block_q[order], block_c[order], order


def unsort(out_sorted: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Undo a permutation by gathering through its inverse."""
    return out_sorted[torch.argsort(order)]


def mscm_pallas(
    x_dense: torch.Tensor,   # f32 or bf16 [n, Dp]
    rows: torch.Tensor,      # int32 [C, R]
    vals: torch.Tensor,      # same type as x_dense [C, R, B]
    block_q: torch.Tensor,   # int [A]
    block_c: torch.Tensor,   # int [A]
    *,
    variant: str = "auto",
    sort: bool = True,
) -> torch.Tensor:
    """Masked chunk multiplication through the per-block kernels. Returns
    f32 [A, B] in the original block order.

    ``variant``: ``fused`` gathers the query values inside the kernel,
    ``pregather`` gathers them first; ``auto`` picks by the reference's rule
    (fused up to :data:`VMEM_ROW_LIMIT` columns of ``x_dense``). ``sort``
    evaluates the blocks in chunk order (paper §4), a pure schedule change.
    """
    if variant == "auto":
        variant = "fused" if x_dense.shape[1] <= VMEM_ROW_LIMIT else "pregather"
    if variant not in ("fused", "pregather"):
        raise ValueError(f"unknown variant {variant}")
    block_q, block_c = block_q.to(torch.int64), block_c.to(torch.int64)
    if sort:
        bq, bc, order = sort_blocks_by_chunk(block_q, block_c)
    else:
        bq, bc, order = block_q, block_c, None
    if variant == "fused":
        out = mscm_fused(x_dense, rows, vals, bq, bc)
    else:
        out = mscm_pregather(gather_query_rows(x_dense, rows, bq, bc), vals, bc)
    return unsort(out, order) if order is not None else out


def grouped_tile_bound(a: int, qt: int, num_chunks: int) -> int:
    """Worst-case tile count for A blocks grouped per chunk into QT-row tiles:
    ``min(A, ceil(A/qt) + #distinct chunks)``, from shapes alone."""
    return max(1, min(a, -(-a // qt) + min(num_chunks, a)))


def group_blocks_device(
    block_c: torch.Tensor, qt: int, num_chunks: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter-free grouping of active blocks into per-chunk tiles, on the
    tensors' device.

    Returns (all int64)
      tile_chunk [T]      chunk id per tile (padding tiles repeat the last
                          real chunk)
      tile_src   [T, QT]  index into the *unsorted* block list, -1 = padding
      order      [A]      chunk-major permutation of the block list
      flat_pos   [A]      position of sorted block i in the flattened
                          [T*QT] tile layout (strictly increasing)
    """
    with obs.span("mscm.group"):
        a = block_c.shape[0]
        t = grouped_tile_bound(a, qt, num_chunks)
        dev = block_c.device
        order = torch.argsort(block_c, stable=True)
        sc = block_c[order].to(torch.int64)                  # [A] sorted chunks
        idx = torch.arange(a, device=dev)
        run_start = torch.searchsorted(sc, sc, side="left")
        slot = (idx - run_start) % qt                        # position in run, mod qt
        tile_id = torch.cumsum((slot == 0).to(torch.int64), 0) - 1
        flat_pos = tile_id * qt + slot                       # strictly increasing
        # Invert sorted-position -> tile-slot by binary search: flat slot f is
        # occupied iff some flat_pos equals f.
        fgrid = torch.arange(t * qt, device=dev)
        j = torch.searchsorted(flat_pos, fgrid).clamp(max=a - 1)
        hit = flat_pos[j] == fgrid
        tile_src = torch.where(hit, order[j], -1).reshape(t, qt)
        # Chunk per tile from its slot-0 occupant; padding tiles (all at the
        # tail, chunks ascending) inherit the last real chunk via cummax.
        hit0 = hit.reshape(t, qt)[:, 0]
        j0 = j.reshape(t, qt)[:, 0]
        tile_chunk = torch.cummax(torch.where(hit0, sc[j0], 0), 0).values
        return tile_chunk, tile_src, order, flat_pos


def mscm_grouped_level(
    x_dense: torch.Tensor,        # f32 [n, Dp]
    rows: torch.Tensor,           # int [C, R]
    vals: torch.Tensor,           # f32 [C, R, B]
    block_q: torch.Tensor,        # int [A]
    block_c: torch.Tensor,        # int [A]
    parent_scores: Optional[torch.Tensor] = None,  # f32 [A] (beam scores)
    *,
    qt: int = DEFAULT_QT,
    mode: str = "none",
    product: Optional[Callable[..., torch.Tensor]] = None,
) -> torch.Tensor:
    """One tree level through the grouped kernel: group the blocks
    chunk-major, gather the query rows into [T, QT, R] tiles, run one
    [QT, R] x [R, B] product per tile with the epilogue ``mode`` fused, and
    return the [A, B] block scores in the original block order.

    ``product(xg, tile_chunk, parent_scores, tile_src)`` replaces the tile
    product (the quantized level passes its kernel over int8/fp8 ``vals``);
    by default it is :func:`mscm_grouped` over ``vals``. Both get the
    grouping's ``tile_src``, so the padding tiles return at once; the unsort
    reads only live slots, so the [A, B] result does not depend on it."""
    c, _, b = vals.shape
    tile_chunk, tile_src, order, flat_pos = group_blocks_device(block_c, qt, c)
    real = tile_src >= 0                                 # [T, QT]
    safe_src = tile_src.clamp(min=0)
    bq = block_q[safe_src]                               # [T, QT]
    # The reference's gathers clamp a chunk id past the last chunk.
    tc = tile_chunk.clamp(0, c - 1)
    r = rows[tc]                                         # [T, R]
    xg = x_dense[bq[..., None], r[:, None, :]]           # [T, QT, R]
    xg = torch.where(real[..., None], xg, 0.0)
    ps = None
    if parent_scores is not None:
        ps = torch.where(real, parent_scores[safe_src], 0.0)
    if product is None:
        tiles = mscm_grouped(xg, vals, tc, ps, mode=mode, tile_src=tile_src)  # [T, QT, B]
    else:
        tiles = product(xg, tc, ps, tile_src)
    flat = tiles.reshape(-1, b)
    # Sorted block i lives at flat slot flat_pos[i]; composing with the
    # inverse permutation restores the block order (clamped like the
    # reference's gather, should a tile bound ever be exceeded).
    return flat[flat_pos[torch.argsort(order)].clamp(max=flat.shape[0] - 1)]


def mscm_pallas_grouped(
    x_dense: torch.Tensor,
    rows: torch.Tensor,
    vals: torch.Tensor,
    block_q: torch.Tensor,
    block_c: torch.Tensor,
    parent_scores: Optional[torch.Tensor] = None,
    *,
    qt: int = DEFAULT_QT,
    mode: str = "none",
) -> torch.Tensor:
    """Batch-mode grouped MSCM (the reference's entry point of this name).
    Returns f32 [A, B] in the original block order."""
    return mscm_grouped_level(
        x_dense, rows, vals, block_q, block_c, parent_scores, qt=qt, mode=mode,
    )
