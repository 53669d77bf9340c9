"""XMR tree model + beam-search inference (paper §3, Algorithm 1).

Counterpart of ``repro.core.tree``. An :class:`XMRTree` holds one layer of
chunked tensors per tree level on one device; ``infer`` runs the beam
search, with each level's masked product through one of the reference's
methods: ``vanilla`` (per-column baseline), ``mscm_dense`` (gather + einsum,
the exact oracle), ``mscm_searchsorted`` (binary search, no dense table),
``mscm_pallas``/``mscm_pallas_pregather`` (the per-block CUDA kernels of the
online path), ``mscm_pallas_grouped`` (the grouped CUDA kernel of the batch
path) or ``mscm_pallas_grouped_q`` (the same kernel over the int8/fp8 tiles
of a :class:`~repro_torch.quant.storage.QuantizedTree`). Kernels run on a
GPU, their plain versions on the CPU. The method strings are the
reference's, so one configuration drives both packages.

Label layout: the children of node p at level l are [p*B, (p+1)*B) at
level l+1, so chunk id == parent id.

Ids are int64 throughout (PyTorch's index type); the reference holds them
as int32, with the same values.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import mscm as mscm_lib
from repro_torch.core.beam import NEG_INF, beam_select, combine_scores
from repro_torch.core.chunked import ChunkedLayer, ColumnELLLayer
from repro_torch.sparse.csr import CSC

METHODS = (
    "vanilla",
    "mscm_dense",
    "mscm_searchsorted",
    "mscm_pallas",
    "mscm_pallas_pregather",
    "mscm_pallas_grouped",
    "mscm_pallas_grouped_q",
)

#: Methods that read the dense [n, d+1] query table (the others read the
#: ELL rows and must not allocate it: 1.02 GB at 64 queries and d = 4M).
_NEEDS_DENSE = (
    "mscm_dense", "mscm_pallas", "mscm_pallas_pregather", "mscm_pallas_grouped",
    "mscm_pallas_grouped_q",
)

#: Methods that run the grouped kernel, which keeps the beam id-sorted.
_GROUPED = ("mscm_pallas_grouped", "mscm_pallas_grouped_q")


def check_method(method: str) -> None:
    """Raise unless ``method`` is one this port runs."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point places the tree on: CUDA unless the caller
    names another. With no GPU and no explicit device this raises; it never
    carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


@dataclasses.dataclass
class TreeLayerArrays:
    """Device tensors for one level."""

    chunk_rows: torch.Tensor  # int32 [C, R]
    chunk_vals: torch.Tensor  # f32 [C, R, B]
    col_rows: torch.Tensor    # int32 [L, Rc] (vanilla baseline layout)
    col_vals: torch.Tensor    # f32 [L, Rc]

    def to(self, device: torch.device) -> "TreeLayerArrays":
        return TreeLayerArrays(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )


@dataclasses.dataclass
class XMRTree:
    layers: List[TreeLayerArrays]
    n_cols: Tuple[int, ...]     # true (unpadded) label count per level
    branching: Tuple[int, ...]  # B per level
    d: int

    @property
    def depth(self) -> int:
        return len(self.layers)

    @property
    def n_labels(self) -> int:
        return self.n_cols[-1]

    @property
    def device(self) -> torch.device:
        return self.layers[0].chunk_vals.device

    @classmethod
    def from_weight_matrices(
        cls,
        weights: Sequence[CSC],
        branching: int | Sequence[int],
        *,
        device: str | torch.device | None = None,
    ) -> "XMRTree":
        """Build from per-level CSC weight matrices W^(l), l = 2..depth, on
        ``device`` (CUDA unless named; see :func:`resolve_device`)."""
        dev = resolve_device(device)
        bs = (
            [int(branching)] * len(weights)
            if np.isscalar(branching)
            else [int(b) for b in branching]
        )
        layers, ncols = [], []
        for w, b in zip(weights, bs):
            ch = ChunkedLayer.from_csc(w, b)
            col = ColumnELLLayer.from_csc(w, b)
            layers.append(
                TreeLayerArrays(
                    chunk_rows=torch.from_numpy(ch.rows).to(dev),
                    chunk_vals=torch.from_numpy(ch.vals).to(dev),
                    col_rows=torch.from_numpy(col.rows).to(dev),
                    col_vals=torch.from_numpy(col.vals).to(dev),
                )
            )
            ncols.append(w.shape[1])
        return cls(layers=layers, n_cols=tuple(ncols), branching=tuple(bs),
                   d=weights[0].shape[0])

    def to(self, device: str | torch.device) -> "XMRTree":
        """Copy of the tree on ``device`` (the tree itself if already there)."""
        dev = torch.device(device)
        if dev == self.device or (dev.index is None and dev.type == self.device.type):
            return self
        return dataclasses.replace(self, layers=[l.to(dev) for l in self.layers])

    def memory_bytes(self) -> int:
        """Bytes of the chunk tiles, their rows and (quantized) scales."""
        return sum(
            t.numel() * t.element_size()
            for l in self.layers
            for t in (l.chunk_rows, l.chunk_vals, getattr(l, "chunk_scales", None))
            if t is not None
        )

    # -- split / extract (label-space partitioning, repro_torch.index) -------
    def head(self, level: int) -> "XMRTree":
        """The top ``level`` stored layers as a tree of their own: the
        router. Its leaves are the nodes of level ``level - 1``, the chunk
        ids of layer ``level``, so ``head(level).infer(..., beam=b, topk=b)``
        gives the unpartitioned traversal's beam after ``level`` levels."""
        if not 1 <= level < self.depth:
            raise ValueError(f"head level must be in [1, {self.depth}); got {level}")
        return XMRTree(
            layers=list(self.layers[:level]),
            n_cols=self.n_cols[:level],
            branching=self.branching[:level],
            d=self.d,
        )

    def extract(self, level: int, chunk_start: int, chunk_end: int) -> "XMRTree":
        """The sub-tree owning chunks ``[chunk_start, chunk_end)`` of layer
        ``level`` down to the leaves, as a tree of its own.

        Each layer keeps the ELL pad widths R/Rc, so a column scores the same
        through the sub-tree as through the whole tree, and gains one
        **phantom chunk** (rows all the sentinel ``d``, values 0, so its
        logits are exactly 0) and ``B`` phantom columns: beam entries the
        partition does not own are parked there, their children fall at or
        past the local label count, and the phantom-column mask pins them to
        ``NEG_INF`` at every level. Every layer is a fresh allocation (the
        slice and the phantom concatenated).
        """
        if not 1 <= level < self.depth:
            raise ValueError(f"extract level must be in [1, {self.depth}); got {level}")
        if not 0 <= chunk_start < chunk_end:
            raise ValueError(f"bad chunk range [{chunk_start}, {chunk_end})")
        layers, ncols = [], []
        c0, c1 = chunk_start, chunk_end
        for li in range(level, self.depth):
            lay = self.layers[li]
            b = self.branching[li]
            c_global = lay.chunk_rows.shape[0]
            # The last partition's range can overrun the ragged global tail
            # at deeper levels (fewer real chunks than chunk_end * B): clamp.
            c1 = min(c1, c_global)
            if c0 >= c1:
                raise ValueError(
                    f"chunk range start {c0} has no real chunks at layer {li} "
                    f"({c_global} total)"
                )
            n_local = min(c1 * b, self.n_cols[li]) - c0 * b
            if n_local <= 0:
                raise ValueError(
                    f"chunk range [{c0}, {c1}) holds no real columns at layer {li}"
                )
            cr, cv = lay.chunk_rows[c0:c1], lay.chunk_vals[c0:c1]
            col_r, col_v = lay.col_rows[c0 * b:c1 * b], lay.col_vals[c0 * b:c1 * b]
            layers.append(TreeLayerArrays(
                chunk_rows=torch.cat([cr, torch.full_like(cr[:1], self.d)]),
                chunk_vals=torch.cat([cv, torch.zeros_like(cv[:1])]),
                col_rows=torch.cat([col_r, col_r.new_full((b,) + col_r.shape[1:], self.d)]),
                col_vals=torch.cat([col_v, col_v.new_zeros((b,) + col_v.shape[1:])]),
            ))
            ncols.append(n_local)
            c0, c1 = c0 * b, c1 * b
        return XMRTree(
            layers=layers,
            n_cols=tuple(ncols),
            branching=self.branching[level:],
            d=self.d,
        )

    def infer(
        self,
        x_idx: torch.Tensor,  # int [n, Q] sorted, sentinel-padded
        x_val: torch.Tensor,  # f32 [n, Q]
        *,
        beam: int = 10,
        topk: int = 10,
        method: str = "mscm_dense",
        score_mode: str = "prod",
        qt: int = 8,
        init_parent_ids: torch.Tensor | None = None,
        init_scores: torch.Tensor | None = None,
        clamp_chunks: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam-search inference. Returns (scores [n, k], labels [n, k]).

        ``init_parent_ids``/``init_scores`` ([n, b]) start the search from an
        external beam instead of the root; ``clamp_chunks`` parks parents
        past the last chunk on the last chunk. Inputs are moved to the
        tree's device; nothing here synchronises with it.
        """
        check_method(method)
        dev = self.device
        x_idx = torch.as_tensor(x_idx, device=dev)
        x_val = torch.as_tensor(x_val, device=dev)
        if init_parent_ids is not None:
            init_parent_ids = torch.as_tensor(init_parent_ids, device=dev)
            init_scores = torch.as_tensor(init_scores, device=dev)
        return _tree_infer(
            self.layers, self.n_cols, self.branching, self.d, x_idx, x_val,
            init_parent_ids, init_scores, beam=beam, topk=topk, method=method,
            score_mode=score_mode, qt=qt, clamp_chunks=clamp_chunks,
        )


def _masked_matmul(
    layer: TreeLayerArrays,
    x_idx: torch.Tensor,
    x_val: torch.Tensor,
    x_dense: torch.Tensor | None,
    block_q: torch.Tensor,
    block_c: torch.Tensor,
    branching: int,
    d: int,
    method: str,
) -> torch.Tensor:
    """Dispatch one level's masked product A = M ⊙ (X W) (paper eq. 6)."""
    if method == "vanilla":
        return mscm_lib.vanilla_columns(
            x_idx, x_val, layer.col_rows, layer.col_vals, block_q, block_c, branching, d
        )
    if method == "mscm_dense":
        return mscm_lib.mscm_dense_lookup(
            x_dense, layer.chunk_rows, layer.chunk_vals, block_q, block_c
        )
    if method == "mscm_searchsorted":
        return mscm_lib.mscm_searchsorted(
            x_idx, x_val, layer.chunk_rows, layer.chunk_vals, block_q, block_c, d
        )
    if method in ("mscm_pallas", "mscm_pallas_pregather"):
        from repro_torch.kernels import ops

        variant = "pregather" if method.endswith("pregather") else "auto"
        return ops.mscm_pallas(
            x_dense, layer.chunk_rows, layer.chunk_vals, block_q, block_c, variant=variant
        )
    check_method(method)
    raise ValueError(f"{method} is dispatched in level_combined, with its epilogue")


def _scales_of(layer) -> torch.Tensor:
    scales = getattr(layer, "chunk_scales", None)
    if scales is None:
        raise ValueError(
            "method 'mscm_pallas_grouped_q' reads int8/fp8 chunk tiles and their "
            "scales: quantize the tree first (repro_torch.quant.quantize_tree)"
        )
    return scales


def level_combined(
    layer: TreeLayerArrays,
    branching: int,
    d: int,
    x_idx: torch.Tensor,          # int [n, Q] ELL rows
    x_val: torch.Tensor,          # f32 [n, Q]
    x_dense: torch.Tensor | None, # f32 [n, d+1] for the methods that read it
    parent_ids: torch.Tensor,     # int [n, b] chunk ids (already clamped)
    parent_scores: torch.Tensor,  # f32 [n, b]
    *,
    method: str,
    score_mode: str,
    qt: int = 8,
) -> torch.Tensor:
    """One level's combined child scores σ(logit) ⊗ parent — f32 [n, b, B]."""
    n, b_cur = parent_ids.shape
    block_q = torch.arange(n, device=parent_ids.device)[:, None].expand(n, b_cur).reshape(-1)
    block_c = parent_ids.reshape(-1)
    if method == "mscm_pallas_grouped":
        from repro_torch.kernels import ops

        # Grouping, tile product and the σ⊗parent epilogue in one kernel
        # dispatch: the combined scores are the only output per level.
        return ops.mscm_grouped_level(
            x_dense, layer.chunk_rows, layer.chunk_vals, block_q, block_c,
            parent_scores.reshape(-1), qt=qt, mode=score_mode,
        ).reshape(n, b_cur, branching)
    if method == "mscm_pallas_grouped_q":
        from repro_torch.quant import kernels as qkernels

        # The same grouping and fused epilogue over the int8/fp8 tiles,
        # dequantized against their scale row as the kernel stages them.
        return qkernels.mscm_grouped_q_level(
            x_dense, layer.chunk_rows, layer.chunk_vals, _scales_of(layer), block_q,
            block_c, parent_scores.reshape(-1), qt=qt, mode=score_mode,
        ).reshape(n, b_cur, branching)
    logits = _masked_matmul(
        layer, x_idx, x_val, x_dense, block_q, block_c, branching, d, method
    ).reshape(n, b_cur, branching)
    return combine_scores(parent_scores, logits, score_mode)


def owned_level_combined(
    layer: TreeLayerArrays,
    branching: int,
    d: int,
    x_idx: torch.Tensor,
    x_val: torch.Tensor,
    x_dense: torch.Tensor | None,
    parent_ids: torch.Tensor,     # int [n, b] GLOBAL chunk ids at this level
    parent_scores: torch.Tensor,  # f32 [n, b]
    chunk_start: int,             # the partition's first global chunk
    chunk_count: int,             # the partition's real chunk count
    *,
    method: str,
    score_mode: str,
    qt: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`level_combined` on a partition's sliced layer, for a global beam.

    Rows whose chunk lies in ``[chunk_start, chunk_start + chunk_count)`` are
    owned; every other row is parked on the phantom chunk (index
    ``chunk_count``, which :meth:`XMRTree.extract` appends) and returns
    exactly ``NEG_INF``. Owned rows go through the in-tree arithmetic, so
    they are the bits the whole tree gives them. Returns ``(combined [n, b,
    B], owned [n, b])``: the one continuation point of the planner's level
    and pipelined modes.
    """
    owned = (parent_ids >= chunk_start) & (parent_ids < chunk_start + chunk_count)
    local_ids = torch.where(owned, parent_ids - chunk_start, chunk_count)
    local_scores = torch.where(owned, parent_scores, NEG_INF)
    combined = level_combined(
        layer, branching, d, x_idx, x_val, x_dense, local_ids, local_scores,
        method=method, score_mode=score_mode, qt=qt,
    )
    return torch.where(owned[..., None], combined, NEG_INF), owned


def _tree_infer(
    layers: Sequence[TreeLayerArrays],
    n_cols: Tuple[int, ...],
    branching: Tuple[int, ...],
    d: int,
    x_idx: torch.Tensor,
    x_val: torch.Tensor,
    init_parent_ids: torch.Tensor | None = None,
    init_scores: torch.Tensor | None = None,
    *,
    beam: int,
    topk: int,
    method: str,
    score_mode: str,
    qt: int = 8,
    clamp_chunks: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    n = x_idx.shape[0]
    dev = x_idx.device
    x_dense = mscm_lib.scatter_dense(x_idx, x_val, d) if method in _NEEDS_DENSE else None
    if init_parent_ids is not None:
        # Continuation from an external beam.
        parent_ids = init_parent_ids.to(torch.int64)
        scores = init_scores.to(torch.float32)
    else:
        # Layer 1 is the root (Alg. 1 line 3): its children form chunk 0 of
        # the first stored level.
        parent_ids = torch.zeros((n, 1), dtype=torch.int64, device=dev)
        scores = (
            torch.ones((n, 1), dtype=torch.float32, device=dev)
            if score_mode == "prod"
            else torch.zeros((n, 1), dtype=torch.float32, device=dev)
        )
    for li, layer in enumerate(layers):
        chunk_ids = parent_ids
        if clamp_chunks:
            chunk_ids = parent_ids.clamp(max=layer.chunk_rows.shape[0] - 1)
        is_last = li == len(layers) - 1
        next_b = min(topk if is_last else beam, n_cols[li])
        with obs.span("tree.level", level=li):
            combined = level_combined(
                layer, branching[li], d, x_idx, x_val, x_dense, chunk_ids, scores,
                method=method, score_mode=score_mode, qt=qt,
            )
        with obs.span("tree.beam_select", device=dev):
            parent_ids, scores = beam_select(chunk_ids, combined, n_cols[li], next_b)
            if method in _GROUPED and not is_last:
                # Keep the beam id-ascending so the next level's block list is
                # already chunk-major within each query; selection is canonical,
                # so the order cannot change results.
                parent_ids, perm = torch.sort(parent_ids, dim=1)
                scores = scores.gather(1, perm)
    return scores, parent_ids
