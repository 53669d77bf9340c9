"""Quantized ELL chunk storage: int8/fp8 weights + pruned re-pack.

Counterpart of ``repro.quant.storage``. A quantized level replaces the f32
``chunk_vals`` [C, R, B] with int8 (or fp8-e4m3) codes of the same shape
plus ``chunk_scales`` f32 [C, B], one symmetric scale per (chunk, column);
``chunk_rows`` (the ELL mask) stays exact int32.

Scales: ``scale[c, b] = max_r |vals[c, r, b]| / Q`` in f32, with ``Q = 127``
(int8) or ``448`` (the fp8-e4m3 finite max), and 1 where the column is all
zero. int8 codes are ``clip(round_half_even(v / scale), ±127)``; fp8 codes a
plain cast of ``v / scale``, which the scale keeps within ±448, where
PyTorch's and JAX's casts round alike. The arithmetic is the reference's,
so codes and scales are bitwise equal to its own on the same weights, on
the CPU and on a GPU (every division is tensor by tensor: PyTorch turns a
division by a Python scalar on a GPU into a product with the reciprocal,
which rounds differently).

:func:`prune_chunks` keeps, per chunk, the top ``ceil(keep_frac · nnz)``
rows by ``max_b |v|`` (ties to the lower row) and re-packs them in row
order into ``R' = max(8, round_up(max kept, 8))``. Only the chunked layout
is quantized: :func:`dequantize_layer` returns sentinel-only stubs for the
per-column arrays, so a dequantized tree serves the chunked methods, not
``vanilla``. :func:`quantize_index` compresses the partitions of a
:class:`~repro_torch.index.partition.PartitionedIndex`, the router head
staying f32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.core.tree import TreeLayerArrays, XMRTree

#: Storage dtypes by name -> (torch dtype, symmetric qmax).
QUANT_DTYPES = {"int8": (torch.int8, 127.0), "fp8": (torch.float8_e4m3fn, 448.0)}
#: The numpy name of each storage dtype, as a manifest records it.
DTYPE_NAMES = {"int8": "int8", "fp8": "float8_e4m3fn"}


@dataclasses.dataclass
class QuantLayerArrays:
    """Quantized device tensors for one level; the field names it shares
    with :class:`~repro_torch.core.tree.TreeLayerArrays` mean the same."""

    chunk_rows: torch.Tensor    # int32 [C, R]  exact ELL mask (sentinel = d)
    chunk_vals: torch.Tensor    # int8/fp8 [C, R, B] quantized weights
    chunk_scales: torch.Tensor  # f32 [C, B] per-(chunk, column) scale

    def to(self, device: torch.device) -> "QuantLayerArrays":
        return QuantLayerArrays(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )


@dataclasses.dataclass
class QuantizedTree(XMRTree):
    """An :class:`XMRTree` whose layers are :class:`QuantLayerArrays`,
    served by ``method="mscm_pallas_grouped_q"``; ``tier`` names the recipe."""

    tier: str = "int8"

    def head(self, level: int) -> XMRTree:
        raise TypeError(
            "QuantizedTree cannot be re-split: quantize per partition "
            "(repro_torch.quant.quantize_index) after partition_tree()"
        )

    def extract(self, level: int, chunk_start: int, chunk_end: int) -> XMRTree:
        raise TypeError(
            "QuantizedTree cannot be re-split: quantize per partition "
            "(repro_torch.quant.quantize_index) after partition_tree()"
        )


def tier_dtype(tier: str) -> str:
    """The key of :data:`QUANT_DTYPES` a compressed tier stores in."""
    if tier in ("int8", "int8_pruned"):
        return "int8"
    if tier == "fp8":
        return "fp8"
    raise ValueError(f"no storage dtype for tier {tier!r}")


def quantize_chunks(vals: torch.Tensor, dtype: str = "int8"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes [C, R, B] and scales f32 [C, B] of f32 chunk tiles [C, R, B]."""
    qdtype, qmax = QUANT_DTYPES[tier_dtype(dtype)]
    vals = vals.to(torch.float32)
    amax = vals.abs().amax(dim=1)                            # [C, B]
    scale = amax / torch.full_like(amax, qmax)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    scaled = vals / scale[:, None, :]
    if qdtype is torch.int8:
        return scaled.round().clamp(-qmax, qmax).to(torch.int8), scale
    return scaled.to(qdtype), scale


def quantize_layer(layer, dtype: str = "int8", *,
                   rows: torch.Tensor | None = None,
                   vals: torch.Tensor | None = None) -> QuantLayerArrays:
    """Symmetric per-(chunk, column) quantization of one level's chunk tiles.
    ``rows``/``vals`` override the layer's (the pruned re-pack's tiles)."""
    q, scale = quantize_chunks(layer.chunk_vals if vals is None else vals, dtype)
    return QuantLayerArrays(
        chunk_rows=layer.chunk_rows if rows is None else rows,
        chunk_vals=q,
        chunk_scales=scale,
    )


def dequantize_layer(qlayer: QuantLayerArrays, *, d: int) -> TreeLayerArrays:
    """f32 reconstruction ``q · scale`` of a quantized layer, with
    sentinel-only per-column stubs (see the module docstring)."""
    dev = qlayer.chunk_vals.device
    return TreeLayerArrays(
        chunk_rows=qlayer.chunk_rows,
        chunk_vals=qlayer.chunk_vals.to(torch.float32) * qlayer.chunk_scales[:, None, :],
        col_rows=torch.full((1, 1), d, dtype=torch.int32, device=dev),
        col_vals=torch.zeros((1, 1), dtype=torch.float32, device=dev),
    )


def _round_up(x: int, align: int) -> int:
    return -(-x // align) * align


def prune_chunks(
    rows: torch.Tensor,   # int32 [C, R] (sentinel = d)
    vals: torch.Tensor,   # f32 [C, R, B]
    keep_frac: float,
    *,
    sentinel: int,
    row_align: int = 8,
    min_width: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Magnitude-pruned ELL re-pack: per chunk the top ``ceil(keep_frac ·
    nnz_c)`` rows by ``max_b |vals[c, r, :]|`` survive (ties keep the lower
    row), re-packed in ascending row order into ``R' = round_up(max kept,
    row_align)`` (at least ``min_width``). Kept values are copied bitwise."""
    if not 0.0 < keep_frac <= 1.0:
        raise ValueError(f"keep_frac must be in (0, 1]; got {keep_frac}")
    c, r = rows.shape
    dev = rows.device
    valid = rows != sentinel                                   # [C, R]
    mag = vals.abs().amax(dim=2)                               # [C, R]
    mag = torch.where(valid, mag, torch.full_like(mag, -1.0))  # padding never kept
    nnz = valid.sum(dim=1)                                     # [C]
    keep = torch.ceil(nnz.to(torch.float64) * keep_frac).to(torch.int64)
    # Stable argsort on -mag: equal magnitudes stay in ascending row order.
    order = torch.argsort(-mag, dim=1, stable=True)            # [C, R]
    rank_kept = torch.arange(r, device=dev)[None, :] < keep[:, None]
    keep_mask = torch.zeros_like(valid).scatter_(1, order, rank_kept)
    r_new = max(min_width, _round_up(max(1, int(keep.max()) if c else 1), row_align))
    slot = torch.cumsum(keep_mask, dim=1) - 1                  # ascending row order
    ci, ri = keep_mask.nonzero(as_tuple=True)
    out_rows = torch.full((c, r_new), sentinel, dtype=rows.dtype, device=dev)
    out_vals = torch.zeros((c, r_new) + tuple(vals.shape[2:]), dtype=vals.dtype, device=dev)
    out_rows[ci, slot[ci, ri]] = rows[ci, ri]
    out_vals[ci, slot[ci, ri]] = vals[ci, ri]
    return out_rows, out_vals


def quantize_tree(tree: XMRTree, *, tier: str = "int8",
                  prune_keep: float = 0.5) -> QuantizedTree:
    """Compress every layer of ``tree``, on the tree's device. ``int8`` and
    ``fp8`` quantize in place; ``int8_pruned`` first re-packs each chunk to
    its top ``prune_keep`` fraction of rows (:func:`prune_chunks`)."""
    dtype = tier_dtype(tier)
    qlayers: List[QuantLayerArrays] = []
    for lay in tree.layers:
        rows = vals = None
        if tier == "int8_pruned":
            rows, vals = prune_chunks(lay.chunk_rows, lay.chunk_vals, prune_keep,
                                      sentinel=tree.d)
        qlayers.append(quantize_layer(lay, dtype, rows=rows, vals=vals))
    return QuantizedTree(layers=qlayers, n_cols=tree.n_cols, branching=tree.branching,
                         d=tree.d, tier=tier)


def dequantize_tree(qtree: QuantizedTree) -> XMRTree:
    """f32 reconstruction of ``qtree`` (chunked methods only)."""
    return XMRTree(
        layers=[dequantize_layer(l, d=qtree.d) for l in qtree.layers],
        n_cols=qtree.n_cols,
        branching=qtree.branching,
        d=qtree.d,
    )


def quantize_index(index, *, tier: str = "int8", prune_keep: float = 0.5):
    """Compress the parts of a :class:`~repro_torch.index.partition.
    PartitionedIndex`: the serving tier's entry point.

    The router head stays f32 (a few percent of the weights, and its beam
    feeds every partition). Each partition is quantized after the cut, and
    its manifest row rebuilt so that ``memory_bytes`` and ``content_hash``
    describe the compressed bytes resident, with ``tier`` and ``dtype``
    recorded (manifest schema v2).
    """
    from repro_torch.index.partition import _content_hash

    dtype = tier_dtype(tier)
    qparts = [quantize_tree(p, tier=tier, prune_keep=prune_keep) for p in index.parts]
    infos = [
        dataclasses.replace(
            info,
            memory_bytes=qp.memory_bytes(),
            content_hash=_content_hash(qp),
            tier=tier,
            dtype=DTYPE_NAMES[dtype],
        )
        for info, qp in zip(index.manifest.partitions, qparts)
    ]
    manifest = dataclasses.replace(index.manifest, partitions=infos)
    return dataclasses.replace(index, parts=qparts, manifest=manifest)
