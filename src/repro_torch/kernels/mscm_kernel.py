"""The MSCM kernels for Hopper, and their plain PyTorch versions.

Counterpart of ``repro.kernels.mscm_kernel``. Three kernels, each replacing
the Pallas TPU kernel of the same name:

``mscm_grouped``    (``csrc/mscm_grouped.cu``) one [QT, R] x [R, B] product
                    per chunk-major query tile, with the beam epilogue
                    (σ(logit) ⊗ parent score, paper eq. 5) fused before the
                    store: the batch path. Padding tiles (``tile_src``)
                    return at once; the launch plan is
                    :func:`grouped_launch_plan`'s;
``mscm_fused``      (``csrc/mscm_block.cu``) one [1, R] x [R, B] product per
                    chunk-sorted block, gathering the query values from the
                    dense query row inside the kernel: the online path for
                    d up to ``ops.VMEM_ROW_LIMIT``;
``mscm_pregather``  (``csrc/mscm_block.cu``) the same product over query
                    values gathered beforehand: the online path above it.
                    Both split R over a thread-block cluster by the plan of
                    :func:`block_launch_plan`.

The fourth TPU kernel, ``mscm_grouped_q``, is the grouped kernel over
int8/fp8 tiles: its wrapper is in ``repro_torch.quant.kernels``, its entry
point in ``csrc/mscm_grouped.cu``.

Each wrapper takes the plain version for tensors on the CPU and launches
its CUDA kernel for tensors on a GPU, raising if it cannot; it never falls
back from one to the other. Each launch adds 1 to the ``obs`` counter
``launches.<kernel>`` (``launches.mscm_grouped``, ``.mscm_fused``,
``.mscm_pregather``), so a run can show its main path went through it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs

#: Element types the per-block kernels take, by their code in the C interface.
BLOCK_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

MODES = {"none": 0, "prod": 1, "logsum": 2}

#: Code types the quantized grouped entry point takes, by their code in the
#: C interface.
Q_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}

#: Streaming multiprocessors of an H100, which the launch plans fill.
H100_SMS = 132


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


def _align16(n: int) -> int:
    return _cdiv(n, 16) * 16


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


def common_device(tensors, name: str) -> torch.device:
    """The one device of ``tensors``: raise if they lie on several, on one
    that is neither the CPU nor a GPU, or on a GPU and not contiguous."""
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors; got {dev}")
    if dev.type == "cuda" and not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    return dev


def check_grouped_args(xg_tiles, vals, tile_chunk, parent_scores, mode, tile_src=None,
                       vals_dtypes=(torch.float32,)) -> None:
    """Checks shared by :func:`mscm_grouped` and the quantized
    ``repro_torch.quant.kernels.mscm_grouped_q`` (``vals_dtypes`` differ)."""
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
    floats = [xg_tiles] + ([parent_scores] if parent_scores is not None else [])
    if any(x.dtype != torch.float32 for x in floats) or vals.dtype not in vals_dtypes:
        raise TypeError(
            f"xg_tiles and parent_scores must be float32 and vals one of {vals_dtypes}; "
            f"got {xg_tiles.dtype}, {vals.dtype}"
        )
    if tile_chunk.dtype != torch.int64:
        raise TypeError(f"tile_chunk must be int64; got {tile_chunk.dtype}")
    if tile_src is not None:
        if tuple(tile_src.shape) != (t, qt):
            raise ValueError(f"tile_src must be [T, QT] = {(t, qt)}; got {tuple(tile_src.shape)}")
        if tile_src.dtype != torch.int64:
            raise TypeError(f"tile_src must be int64; got {tile_src.dtype}")


def grouped_tensors(*tensors):
    """The tensors of a grouped call that are given (None dropped)."""
    return [x for x in tensors if x is not None]


def zero_padding_tiles(out: torch.Tensor, tile_src: Optional[torch.Tensor]) -> torch.Tensor:
    """``out`` [T, QT, B] with the tiles whose first slot is padding
    (``tile_src[t, 0] < 0``) set to 0, as the kernel writes them."""
    if tile_src is None:
        return out
    return torch.where(tile_src[:, :1, None] >= 0, out, 0.0)


def mscm_grouped_plain(
    xg_tiles: torch.Tensor,    # f32 [T, QT, R] gathered query rows per tile
    vals: torch.Tensor,        # f32 [C, R, B]
    tile_chunk: torch.Tensor,  # int [T]
    parent_scores: Optional[torch.Tensor] = None,  # f32 [T, QT]
    *,
    mode: str = "none",
    tile_src: Optional[torch.Tensor] = None,  # int [T, QT], -1 = padding
) -> torch.Tensor:
    """The plain PyTorch version: ``bmm(xg_tiles, vals[tile_chunk])`` and the
    epilogue, then zeros for the padding tiles. Out-of-range chunk ids are
    clamped, as the reference's gather clamps them."""
    acc = torch.bmm(xg_tiles, vals[tile_chunk.clamp(0, vals.shape[0] - 1)])
    if mode == "prod":
        acc = torch.sigmoid(acc) * parent_scores[:, :, None]
    elif mode == "logsum":
        acc = F.logsigmoid(acc) + parent_scores[:, :, None]
    return zero_padding_tiles(acc, tile_src)


def mscm_grouped(
    xg_tiles: torch.Tensor,    # f32 [T, QT, R]
    vals: torch.Tensor,        # f32 [C, R, B]
    tile_chunk: torch.Tensor,  # int64 [T]
    parent_scores: Optional[torch.Tensor] = None,  # f32 [T, QT] beam scores
    *,
    mode: str = "none",
    tile_src: Optional[torch.Tensor] = None,  # int64 [T, QT], -1 = padding
) -> torch.Tensor:
    """Chunk-major query-tile product with an optionally fused beam epilogue.

    ``mode``: ``none`` raw logits; ``prod`` σ(logit) · parent_score;
    ``logsum`` logσ(logit) + parent_score. ``tile_src``, as
    ``ops.group_blocks_device`` returns it, marks the padding tiles
    (``tile_src[t, 0] < 0``), whose output is 0 and which the kernel skips;
    None: every tile is live. Returns f32 [T, QT, B].
    """
    check_grouped_args(xg_tiles, vals, tile_chunk, parent_scores, mode, tile_src)
    tensors = grouped_tensors(xg_tiles, vals, tile_chunk, parent_scores, tile_src)
    if common_device(tensors, "mscm_grouped").type == "cpu":
        return mscm_grouped_plain(xg_tiles, vals, tile_chunk, parent_scores, mode=mode,
                                  tile_src=tile_src)
    out = launch_grouped(xg_tiles, vals, None, tile_chunk, tile_src, parent_scores, mode)
    obs.count("launches.mscm_grouped")
    return out


#: Rows of a tile one unit of the grouped kernel computes (kMaxQT): a tile
#: of QT rows runs as ceil(QT / 16) row groups, the last one short.
GROUPED_MAX_QT = 16
#: Columns of a window are a multiple of this many (16 bytes of codes), so
#: that every window's rows start on 16 bytes in f32 and in int8/fp8.
GROUPED_WINDOW_STEP = 16
#: Shared memory one CTA of the grouped kernel may take: an H100 block's
#: opt-in limit, 227 KB.
GROUPED_SMEM_LIMIT = 232448
#: Shared memory of one H100 SM, of which each resident CTA also reserves 1 KB.
H100_SM_SMEM = 233472
#: Items one CTA of the grouped kernel walks at most (kMaxTiles).
GROUPED_MAX_TILES = 32
# kWarps, kWarpsPerSlab, kMaxSlabs, kMaxStages in csrc/mscm_grouped.cu.
_GROUPED_WARPS, _WARPS_PER_SLAB, _MAX_SLABS, _MAX_STAGES = 8, 2, 4, 2


class GroupedPlan(NamedTuple):
    """How ``csrc/mscm_grouped.cu`` runs T tiles of [QT, R] x [R, B].

    A tile is cut into ``row_groups`` groups of ``group_rows`` rows (the
    last may be shorter) and its columns into ``windows`` windows of
    ``window_cols`` columns (the last may be narrower); each (tile, window,
    row group) is an item, numbered ``(t * windows + w) * row_groups + g``.
    A window splits columns, never R, so each output is summed in the same
    order whatever the windows. ``grid`` persistent CTAs; CTA g walks items
    g, g + grid, ... (at most :data:`GROUPED_MAX_TILES`). R goes in
    ``passes`` passes of ``pass_rows`` rows (one pass whenever the item fits
    shared memory); each pass of each live item is a unit, and the units go
    through a ring of ``stages`` shared-memory stages, so the next unit's
    copies are in flight while one is computed. Warp w takes rows
    ``[w * warp_rows, (w + 1) * warp_rows)`` of a pass; a pass's tile rows
    arrive in ``slabs`` slabs of ``slab_rows`` rows (two warps' rows), each
    on its own barrier. ``bulk_*``: the query rows, the tile rows and the
    scale row arrive by 16-byte-aligned bulk copies, else by ordinary
    loads. Below QT = 16 and the widest B that fits in one window, a plan
    has one row group and one window: the plan of every such shape is the
    one it had before row groups and windows existed."""

    pass_rows: int
    passes: int
    warp_rows: int
    slab_rows: int
    slabs: int
    stages: int
    grid: int
    bulk_xg: bool
    bulk_tile: bool
    bulk_scales: bool
    smem_bytes: int
    group_rows: int
    row_groups: int
    window_cols: int
    windows: int

    def items(self, t: int) -> int:
        """Items of T tiles: each tile's row groups times its windows."""
        return t * self.row_groups * self.windows

    def args(self) -> Tuple[int, ...]:
        """The plan as the C entry points take it: pass_rows, warp_rows,
        slab_rows, the bulk operands as bits (1 xg, 2 tile, 4 scales),
        stages, grid, group_rows, window_cols."""
        bulk = int(self.bulk_xg) | 2 * int(self.bulk_tile) | 4 * int(self.bulk_scales)
        return (self.pass_rows, self.warp_rows, self.slab_rows, bulk, self.stages, self.grid,
                self.group_rows, self.window_cols)


def grouped_item(plan: GroupedPlan, v: int, qt: int, b: int) -> Tuple[int, int, int, int, int]:
    """(tile, first row, rows, first column, columns) of item ``v``, as
    ``csrc/mscm_grouped.cu`` decodes it."""
    g, rest = v % plan.row_groups, v // plan.row_groups
    w, t = rest % plan.windows, rest // plan.windows
    row0, col0 = g * plan.group_rows, w * plan.window_cols
    return t, row0, min(plan.group_rows, qt - row0), col0, min(plan.window_cols, b - col0)


def grouped_smem_bytes(qt: int, b: int, elem_bytes: int, pass_rows: int, stages: int) -> int:
    """Shared memory of one CTA (``Layout`` in ``csrc/mscm_grouped.cu``; the
    kernel has no other) for items of ``qt`` rows and ``b`` columns: the
    mbarriers (5 a stage, room for two stages), the chunk ids [32], item
    indices [32] with two counters, and parent scores [32, QT] of the CTA's
    items, the warps' partials [8, QT, B], and per stage the scale row [B],
    the query rows [QT, pass_rows rounded up to 4] and the tile rows
    [pass_rows, B]."""
    xr = _cdiv(pass_rows, 4) * 4
    head = (_align16(8 * _MAX_STAGES * (_MAX_SLABS + 1)) + 8 * GROUPED_MAX_TILES
            + _align16(4 * (GROUPED_MAX_TILES + 2)) + _align16(4 * GROUPED_MAX_TILES * qt)
            + _align16(4 * _GROUPED_WARPS * qt * b))
    stage = _align16(4 * b) + _align16(4 * qt * xr) + _align16(pass_rows * b * elem_bytes)
    return head + stages * stage


def _grouped_pass_rows(rows: int, cols: int, r: int, stages: int = 1) -> Optional[int]:
    """Rows a pass for items of ``rows`` x ``cols``, sized for f32 tiles: all
    of R if ``stages`` stages of it fit :data:`GROUPED_SMEM_LIMIT`, else the
    most that fit, a multiple of 32; None if not even 32 do."""
    if grouped_smem_bytes(rows, cols, 4, r, stages) <= GROUPED_SMEM_LIMIT:
        return r
    step = _GROUPED_WARPS * 4
    pass_rows = (r - 1) // step * step
    while (pass_rows >= step
           and grouped_smem_bytes(rows, cols, 4, pass_rows, stages) > GROUPED_SMEM_LIMIT):
        pass_rows -= step
    return pass_rows if pass_rows >= step else None


def _grouped_window(rows: int, r: int, b: int) -> Tuple[int, int]:
    """(window_cols, pass_rows) for B wider than one window takes: the
    fewest windows, each a multiple of :data:`GROUPED_WINDOW_STEP` columns,
    whose f32 items take two stages of at least min(R, 128) rows, so that
    every lane of the 8 warps has rows and copies overlap the product. A
    window of 16 columns always does (16 x 16 items of 128 rows take 44 KB)."""
    step = GROUPED_WINDOW_STEP
    cols = _cdiv(_cdiv(b, 2), step) * step
    while True:
        pass_rows = _grouped_pass_rows(rows, cols, r, stages=2)
        if (pass_rows is not None and pass_rows >= min(r, 128)) or cols == step:
            return cols, pass_rows
        n = _cdiv(b, cols) + 1  # at least one window more than this width needs
        cols = max(step, min(cols - step, _cdiv(_cdiv(b, n), step) * step))


def grouped_launch_plan(t: int, qt: int, r: int, b: int, elem_bytes: int, *,
                        aligned: bool = True, sms: int = H100_SMS) -> GroupedPlan:
    """The launch plan of the grouped kernel for T tiles of QT rows over
    [R, B] chunk tiles of ``elem_bytes``-byte weights (4 f32, 1 int8/fp8).

    Items are tiles cut into row groups of at most :data:`GROUPED_MAX_QT`
    rows. Their columns go in one window if a pass of at least 32 rows of
    the whole width fits :data:`GROUPED_SMEM_LIMIT`, else in the windows of
    :func:`_grouped_window`. An item goes in one pass if one stage of it
    fits, else in passes of a multiple of 32 rows. Windows and passes are
    sized as for f32 tiles whatever ``elem_bytes`` is, so the quantized
    entry point sums in the f32 one's order and stays bitwise equal to it
    on dequantized tiles. Two stages if they fit, else one. ``grid`` fills
    the card's ``sms`` SMs with as many CTAs as fit one (at most two; one
    when items are cut, as that kernel's registers allow one), and more if
    a CTA would walk more than :data:`GROUPED_MAX_TILES` items. Each
    warp takes a multiple of 4 rows. An operand goes by bulk copies if
    every copy of it starts and ends on 16 bytes and the caller's pointers
    are 16-byte aligned (``aligned``)."""
    if t < 0 or qt < 1 or r < 1 or b < 1 or elem_bytes not in (1, 4):
        raise ValueError(f"no plan for T={t}, QT={qt}, R={r}, B={b}, elem_bytes={elem_bytes}")
    rows = min(qt, GROUPED_MAX_QT)
    cols, pass_rows = b, _grouped_pass_rows(rows, b, r)
    if pass_rows is None:
        cols, pass_rows = _grouped_window(rows, r, b)
    windows, row_groups = _cdiv(b, cols), _cdiv(qt, rows)
    stages = 2 if grouped_smem_bytes(rows, cols, elem_bytes, pass_rows, 2) <= GROUPED_SMEM_LIMIT else 1
    smem = grouped_smem_bytes(rows, cols, elem_bytes, pass_rows, stages)
    per_sm = max(1, min(2, H100_SM_SMEM // (smem + 1024)))
    if row_groups > 1 or windows > 1:
        per_sm = 1  # the kernel that cuts items takes 150-166 registers a thread

    warp_rows = _cdiv(_cdiv(pass_rows, _GROUPED_WARPS), 4) * 4
    slab_rows = _WARPS_PER_SLAB * warp_rows
    row_bytes = b * elem_bytes
    if windows == 1:  # a slab is one contiguous copy
        bulk_tile = all(n * row_bytes % 16 == 0 for n in (r, pass_rows, slab_rows))
    else:  # a copy a row of a window
        bulk_tile = row_bytes % 16 == 0
    items = t * row_groups * windows
    return GroupedPlan(
        pass_rows=pass_rows,
        passes=_cdiv(r, pass_rows),
        warp_rows=warp_rows,
        slab_rows=slab_rows,
        slabs=_cdiv(pass_rows, slab_rows),
        stages=stages,
        grid=min(items, max(sms * per_sm, _cdiv(items, GROUPED_MAX_TILES))),
        bulk_xg=aligned and r % 4 == 0,
        bulk_tile=aligned and bulk_tile,
        bulk_scales=aligned and elem_bytes == 1 and b % 4 == 0,
        smem_bytes=smem,
        group_rows=rows,
        row_groups=row_groups,
        window_cols=cols,
        windows=windows,
    )


@functools.lru_cache(maxsize=256)
def _cached_grouped_plan(t, qt, r, b, elem_bytes, aligned) -> GroupedPlan:
    """:func:`grouped_launch_plan`, once per shape: the batch path launches
    the same few shapes every level and is short of host time."""
    return grouped_launch_plan(t, qt, r, b, elem_bytes, aligned=aligned)


def launch_grouped(xg_tiles, vals, scales, tile_chunk, tile_src, parent_scores,
                   mode) -> torch.Tensor:
    """Launch the grouped routine on checked CUDA tensors: the f32 entry
    point if ``scales`` is None, else the quantized one. Returns the output;
    the caller counts the launch."""
    from repro_torch.kernels.build import load_library

    t, qt, r = xg_tiles.shape
    c, _, b = vals.shape
    dev = xg_tiles.device
    out = torch.empty((t, qt, b), dtype=torch.float32, device=dev)
    ptrs = grouped_tensors(xg_tiles, vals, scales)
    plan = _cached_grouped_plan(t, qt, r, b, vals.element_size(),
                                all(x.data_ptr() % 16 == 0 for x in ptrs))
    lib = load_library("mscm_grouped")

    def ptr(x):
        return x.data_ptr() if x is not None else None

    head = (ptr(xg_tiles), ptr(vals)) + ((ptr(scales),) if scales is not None else ())
    tail = (ptr(tile_chunk), ptr(tile_src), ptr(parent_scores), ptr(out), t, qt, r, b, c,
            MODES[mode])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if scales is None:
            name = "mscm_grouped"
            err = lib.mscm_grouped_launch(*head, *tail, *plan.args(), stream)
        else:
            name = "mscm_grouped_q"
            err = lib.mscm_grouped_q_launch(*head, *tail, Q_DTYPES[vals.dtype], *plan.args(),
                                            stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with CUDA error {err} "
            f"(T={t}, QT={qt}, R={r}, B={b}, C={c}, mode={mode}, {vals.dtype}, {plan})"
        )
    return out


# ---------------------------------------------------------------------------
# fused and pregather: one [1, R] x [R, B] product per block
# ---------------------------------------------------------------------------

#: Largest thread-block cluster that every Hopper part schedules.
MAX_CLUSTER = 8
#: Shared memory one CTA of the per-block kernel may take. Above it a
#: slice streams through a ring of slabs.
BLOCK_SMEM_BUDGET = 96 * 1024
_BLOCK_WARPS = 8  # kWarps in csrc/mscm_block.cu


class BlockPlan(NamedTuple):
    """How ``csrc/mscm_block.cu`` runs A blocks of R rows and B columns.

    Each block is served by a cluster of ``cluster`` CTAs for each of
    ``windows`` windows of ``window_cols`` columns (the last may be
    narrower; one window of all B columns whenever that fits). The grid is
    ``A * windows`` clusters, cluster ``a * windows + w`` serving window w
    of block a; CTA ``rank`` of a cluster takes rows ``[rank *
    rows_per_slice, (rank + 1) * rows_per_slice)`` of the chunk's window
    (the last slice may be shorter, none is empty) and streams them in slabs
    of ``slab_rows`` rows through ``stages`` shared-memory buffers. A
    window splits columns, never R, so each output is summed in the same
    order whatever the windows. ``bulk``: the slabs arrive by
    16-byte-aligned bulk copies, else by ordinary loads."""

    cluster: int
    rows_per_slice: int
    slab_rows: int
    stages: int
    bulk: bool
    smem_bytes: int
    window_cols: int
    windows: int

    def grid(self, a: int) -> int:
        """CTAs of a launch over A blocks."""
        return a * self.cluster * self.windows

    def args(self) -> Tuple[int, int, int, int, int, int]:
        """The plan as the C entry points take it: S, rps, slab, stages, bulk,
        window_cols."""
        return (self.cluster, self.rows_per_slice, self.slab_rows, self.stages,
                int(self.bulk), self.window_cols)


def block_smem_bytes(b: int, elem_bytes: int, slab_rows: int, stages: int) -> int:
    """Shared memory of one CTA (``Layout`` in ``csrc/mscm_block.cu``) for a
    window of ``b`` columns: two mbarriers a stage and one for the cluster
    sum, the warps' partials [8, B], the cluster's partials [8, B], and per
    stage a tile slab, its query values and its rows."""
    stage = (_align16(slab_rows * b * elem_bytes) + _align16(slab_rows * elem_bytes)
             + _align16(4 * slab_rows))
    return (_align16(8 * (2 * stages + 1)) + _align16(4 * _BLOCK_WARPS * b)
            + _align16(4 * MAX_CLUSTER * b) + stages * stage)


def _block_slabs(cols: int, elem_bytes: int, rps: int, q: int,
                 bulk: bool) -> Optional[Tuple[int, int]]:
    """(slab_rows, stages) of a slice of ``rps`` rows of a ``cols``-column
    window within :data:`BLOCK_SMEM_BUDGET`: the whole slice in one buffer
    if it fits, else slabs of a whole number of ``q`` rows (a ring of two
    on the bulk path); None if not even ``q`` rows fit."""
    stages, slab, n_slabs = 1, rps, 1
    while block_smem_bytes(cols, elem_bytes, slab, stages) > BLOCK_SMEM_BUDGET:
        if slab <= q:
            return None
        stages = 2 if bulk else 1
        n_slabs += 1
        slab = min(slab - q, _cdiv(_cdiv(rps, n_slabs), q) * q)
    return slab, stages


def block_launch_plan(a: int, r: int, b: int, elem_bytes: int, *,
                      aligned: bool = True) -> BlockPlan:
    """The launch plan of the per-block kernel for A blocks of an [R, B]
    chunk tile of ``elem_bytes``-byte values.

    ``cluster`` fills the card: ``132 // A`` CTAs a block (the H100's SMs),
    at most :data:`MAX_CLUSTER`, so 10 blocks take 80 SMs and 132 or more
    take one CTA each. Slices are a whole number of ``q`` rows (4 in f32, 8
    in bf16), so that each slice's tile rows, query values and int32 rows
    start and end on 16 bytes whenever R is a multiple of ``q``; then, and
    if the caller's pointers are 16-byte aligned (``aligned``), the slabs go
    by bulk copies. A slice whose buffer exceeds
    :data:`BLOCK_SMEM_BUDGET` is cut into slabs: a ring of two on the bulk
    path, one buffer refilled by ordinary loads on the other. B wider than
    a slab of ``q`` rows can take is cut into the fewest windows of a
    multiple of 16 columns that fit; a window's tile rows then go one bulk
    copy a row, if rows of B values start on 16 bytes."""
    if a < 0 or r < 1 or b < 1 or elem_bytes not in (2, 4):
        raise ValueError(f"no plan for A={a}, R={r}, B={b}, elem_bytes={elem_bytes}")
    q = max(4, 16 // elem_bytes)
    cluster = min(MAX_CLUSTER, max(1, H100_SMS // max(a, 1)))
    rps = _cdiv(_cdiv(r, cluster), q) * q
    cluster = _cdiv(r, rps)  # no empty slice
    bulk = aligned and r % q == 0
    cols, fit = b, _block_slabs(b, elem_bytes, rps, q, bulk)
    if fit is None:
        bulk = bulk and b * elem_bytes % 16 == 0
        cols = _cdiv(_cdiv(b, 2), 16) * 16
        while (fit := _block_slabs(cols, elem_bytes, rps, q, bulk)) is None:
            if cols <= 16:
                raise ValueError(f"R={r} in slices of {rps} rows leaves no room for "
                                 f"{BLOCK_SMEM_BUDGET} bytes of shared memory")
            cols = max(16, min(cols - 16, _cdiv(_cdiv(b, _cdiv(b, cols) + 1), 16) * 16))
    slab, stages = fit
    return BlockPlan(cluster, rps, slab, stages, bulk,
                     block_smem_bytes(cols, elem_bytes, slab, stages), cols, _cdiv(b, cols))


def _check_block_args(x, vals, block_c, rows=None, block_q=None) -> None:
    """Checks shared by :func:`mscm_fused` (``x`` = x_dense [n, Dp], with
    ``rows`` and ``block_q``) and :func:`mscm_pregather` (``x`` = xg [A, R])."""
    fused = rows is not None
    if x.dim() != 2 or vals.dim() != 3 or block_c.dim() != 1:
        raise ValueError(
            f"expected {'x_dense [n, Dp]' if fused else 'xg [A, R]'}, vals [C, R, B], "
            f"block_c [A]; got {tuple(x.shape)}, {tuple(vals.shape)}, {tuple(block_c.shape)}"
        )
    c, r, _ = vals.shape
    a = block_c.shape[0]
    if fused:
        bad = (rows.dim() != 2 or tuple(rows.shape) != (c, r) or block_q.dim() != 1
               or block_q.shape[0] != a or x.shape[0] == 0 or x.shape[1] == 0)
    else:
        bad = tuple(x.shape) != (a, r)
    if bad or c == 0:
        what = f"rows {tuple(rows.shape)}, block_q {tuple(block_q.shape)}, " if fused else ""
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, vals {tuple(vals.shape)}, "
            f"{what}block_c {tuple(block_c.shape)}"
        )
    if x.dtype not in BLOCK_DTYPES or vals.dtype != x.dtype:
        raise TypeError(
            f"x and vals must both be float32 or both bfloat16; got {x.dtype}, {vals.dtype}"
        )
    ids = [block_c] + ([block_q] if fused else [])
    if any(i.dtype != torch.int64 for i in ids):
        raise TypeError("block ids must be int64")
    if fused and rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32; got {rows.dtype}")


def mscm_pregather_plain(
    xg: torch.Tensor,       # [A, R] pre-gathered query values
    vals: torch.Tensor,     # [C, R, B]
    block_c: torch.Tensor,  # int [A]
) -> torch.Tensor:
    """The plain PyTorch version: ``einsum("ar,arb->ab")`` in f32 over the
    chunk tiles, with out-of-range chunk ids clamped as the reference's
    gather clamps them. Returns f32 [A, B]."""
    bc = block_c.clamp(0, vals.shape[0] - 1)
    return torch.einsum("ar,arb->ab", xg.float(), vals[bc].float())


def mscm_fused_plain(
    x_dense: torch.Tensor,  # [n, Dp]
    rows: torch.Tensor,     # int [C, R]
    vals: torch.Tensor,     # [C, R, B]
    block_q: torch.Tensor,  # int [A]
    block_c: torch.Tensor,  # int [A]
) -> torch.Tensor:
    """The plain PyTorch version: gather ``x_dense[q, clip(rows[c])]``, as the
    reference's ``jnp.take(..., mode="clip")`` does, then contract."""
    n, dp = x_dense.shape
    bc = block_c.clamp(0, vals.shape[0] - 1)
    idx = rows[bc].to(torch.int64).clamp(0, dp - 1)            # [A, R]
    xg = x_dense[block_q.clamp(0, n - 1)[:, None], idx]         # [A, R]
    return mscm_pregather_plain(xg, vals, bc)


def mscm_fused(
    x_dense: torch.Tensor,  # f32 or bf16 [n, Dp] (Dp >= d+1; sentinel slot is 0)
    rows: torch.Tensor,     # int32 [C, R]
    vals: torch.Tensor,     # same type as x_dense [C, R, B]
    block_q: torch.Tensor,  # int64 [A]  sorted by block_c for chunk reuse
    block_c: torch.Tensor,  # int64 [A]
) -> torch.Tensor:
    """Per-block ``x_dense[q][rows[c]] [1, R] @ vals[c] [R, B]``, the gather
    inside the kernel. Returns f32 [A, B]."""
    _check_block_args(x_dense, vals, block_c, rows, block_q)
    dev = common_device([x_dense, rows, vals, block_q, block_c], "mscm_fused")
    if dev.type == "cpu":
        return mscm_fused_plain(x_dense, rows, vals, block_q, block_c)
    return _launch_block(x_dense, vals, block_c, rows, block_q)


def mscm_pregather(
    xg: torch.Tensor,       # f32 or bf16 [A, R] pre-gathered query values
    vals: torch.Tensor,     # same type as xg [C, R, B]
    block_c: torch.Tensor,  # int64 [A] sorted
) -> torch.Tensor:
    """Per-block ``xg[a] [1, R] @ vals[c] [R, B]``. Returns f32 [A, B]."""
    _check_block_args(xg, vals, block_c)
    dev = common_device([xg, vals, block_c], "mscm_pregather")
    if dev.type == "cpu":
        return mscm_pregather_plain(xg, vals, block_c)
    return _launch_block(xg, vals, block_c)


def _launch_block(x, vals, block_c, rows=None, block_q=None) -> torch.Tensor:
    from repro_torch.kernels.build import load_library

    c, r, b = vals.shape
    a = block_c.shape[0]
    dev = x.device
    out = torch.empty((a, b), dtype=torch.float32, device=dev)
    lib = load_library("mscm_block")
    dtype = BLOCK_DTYPES[x.dtype]
    head = rows if rows is not None else x  # what the bulk path copies beside the tile
    plan = block_launch_plan(a, r, b, x.element_size(),
                             aligned=head.data_ptr() % 16 == 0 and vals.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if rows is not None:
            name = "mscm_fused"
            err = lib.mscm_fused_launch(
                x.data_ptr(), rows.data_ptr(), vals.data_ptr(), block_q.data_ptr(),
                block_c.data_ptr(), out.data_ptr(), a, x.shape[1], r, b, c, x.shape[0],
                dtype, *plan.args(), stream,
            )
        else:
            name = "mscm_pregather"
            err = lib.mscm_pregather_launch(
                x.data_ptr(), vals.data_ptr(), block_c.data_ptr(), out.data_ptr(),
                a, r, b, c, dtype, *plan.args(), stream,
            )
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with CUDA error {err} "
            f"(A={a}, R={r}, B={b}, C={c}, x {tuple(x.shape)} {x.dtype}, {plan})"
        )
    obs.count(f"launches.{name}")
    return out
