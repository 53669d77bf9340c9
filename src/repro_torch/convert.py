"""Carry a tree's weights across from the reference package.

:func:`tree_from_numpy` takes each level's arrays as numpy — e.g.
``np.asarray`` of a reference ``TreeLayerArrays``' ``chunk_rows``,
``chunk_vals``, ``col_rows`` and ``col_vals`` — and returns the port's
:class:`~repro_torch.core.tree.XMRTree` with the same values.
:func:`quantized_tree_from_numpy` does the same for a quantized tree
(``chunk_rows``, ``chunk_vals`` codes, ``chunk_scales``), with fp8 codes
crossing as their uint8 bit patterns, so no fp8 numpy type is needed.
:func:`trained_model_from_numpy` carries a trained model across: its tree
as :func:`tree_from_numpy` does and its label tree structure copied, so a
model the reference trained serves in the port.
:func:`partitioned_index_from_numpy` carries a label-partitioned index
across (router head, parts, quantized ones included, and manifest), so both
packages serve the same partitions.
:func:`lm_params_from_numpy` carries an LM's parameter pytree (or its cache)
across with the same keys, shapes and dtypes, bf16 and fp8 leaves included,
and :func:`vocab_head_from_numpy` a vocab-tree head.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.tree import TreeLayerArrays, XMRTree, resolve_device
from repro_torch.index.partition import PartitionedIndex, PartitionManifest
from repro_torch.models.xmr_head import VocabTreeHead
from repro_torch.quant.storage import QUANT_DTYPES, QuantizedTree, QuantLayerArrays, tier_dtype
from repro_torch.trees.cluster import TreeStructure
from repro_torch.trees.train import TrainedXMRModel

LAYER_FIELDS = ("chunk_rows", "chunk_vals", "col_rows", "col_vals")
_DTYPES = {
    "chunk_rows": np.int32, "chunk_vals": np.float32,
    "col_rows": np.int32, "col_vals": np.float32,
}


def _tensor(a, dtype, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(dev)


def tree_from_numpy(
    layers: Sequence[Mapping[str, np.ndarray]],
    n_cols: Sequence[int],
    branching: Sequence[int],
    d: int,
    *,
    device: str | torch.device | None = None,
) -> XMRTree:
    """Build the port's tree from per-level arrays (keys :data:`LAYER_FIELDS`)
    on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    if not len(layers) == len(n_cols) == len(branching):
        raise ValueError(
            f"{len(layers)} layers, {len(n_cols)} n_cols, {len(branching)} branching"
        )
    out = []
    for arrays in layers:
        missing = set(LAYER_FIELDS) - set(arrays)
        if missing:
            raise ValueError(f"layer arrays lack {sorted(missing)}")
        out.append(TreeLayerArrays(**{
            f: _tensor(arrays[f], _DTYPES[f], dev) for f in LAYER_FIELDS
        }))
    return XMRTree(layers=out, n_cols=tuple(int(c) for c in n_cols),
                   branching=tuple(int(b) for b in branching), d=int(d))


STRUCTURE_FIELDS = ("label_perm", "level_sizes", "branching", "n_labels")


def trained_model_from_numpy(
    layers: Sequence[Mapping[str, np.ndarray]],
    n_cols: Sequence[int],
    branching: Sequence[int],
    d: int,
    structure: Mapping[str, Any],
    *,
    device: str | torch.device | None = None,
) -> TrainedXMRModel:
    """The port's :class:`TrainedXMRModel` from a trained model's arrays:
    the tree's per-level arrays as for :func:`tree_from_numpy`, and its
    ``TreeStructure`` fields (keys :data:`STRUCTURE_FIELDS`, e.g.
    ``dataclasses.asdict`` of the reference's), copied."""
    missing = set(STRUCTURE_FIELDS) - set(structure)
    if missing:
        raise ValueError(f"structure lacks {sorted(missing)}")
    tree = tree_from_numpy(layers, n_cols, branching, d, device=device)
    ts = TreeStructure(
        label_perm=np.array(structure["label_perm"], dtype=np.int64),
        level_sizes=tuple(int(s) for s in structure["level_sizes"]),
        branching=int(structure["branching"]),
        n_labels=int(structure["n_labels"]),
    )
    if len(ts.label_perm) != ts.level_sizes[-1] or tuple(tree.n_cols) != ts.level_sizes:
        raise ValueError(f"structure of {ts.level_sizes} levels and {len(ts.label_perm)} leaf "
                         f"slots does not fit a tree of {tree.n_cols} columns")
    return TrainedXMRModel(tree=tree, structure=ts)


QUANT_LAYER_FIELDS = ("chunk_rows", "chunk_vals", "chunk_scales")


def quantized_tree_from_numpy(
    layers: Sequence[Mapping[str, np.ndarray]],
    n_cols: Sequence[int],
    branching: Sequence[int],
    d: int,
    tier: str,
    *,
    device: str | torch.device | None = None,
) -> QuantizedTree:
    """Build the port's :class:`QuantizedTree` from per-level arrays (keys
    :data:`QUANT_LAYER_FIELDS`) on ``device`` (CUDA unless named).
    ``chunk_vals`` holds int8 codes, or for ``tier="fp8"`` the uint8 bit
    patterns of the fp8-e4m3 codes (``.view(np.uint8)`` of the reference's)."""
    dev = resolve_device(device)
    if not len(layers) == len(n_cols) == len(branching):
        raise ValueError(
            f"{len(layers)} layers, {len(n_cols)} n_cols, {len(branching)} branching"
        )
    qdtype, _ = QUANT_DTYPES[tier_dtype(tier)]
    raw = np.uint8 if qdtype == torch.float8_e4m3fn else np.int8
    out = []
    for arrays in layers:
        missing = set(QUANT_LAYER_FIELDS) - set(arrays)
        if missing:
            raise ValueError(f"layer arrays lack {sorted(missing)}")
        codes = np.asarray(arrays["chunk_vals"])
        if codes.dtype != raw:
            raise TypeError(f"tier {tier!r} codes cross as {np.dtype(raw)}; got {codes.dtype}")
        out.append(QuantLayerArrays(
            chunk_rows=_tensor(arrays["chunk_rows"], np.int32, dev),
            chunk_vals=_tensor(codes, raw, dev).view(qdtype),
            chunk_scales=_tensor(arrays["chunk_scales"], np.float32, dev),
        ))
    return QuantizedTree(layers=out, n_cols=tuple(int(c) for c in n_cols),
                         branching=tuple(int(b) for b in branching), d=int(d), tier=tier)


TREE_KEYS = ("layers", "n_cols", "branching", "d")


def partitioned_index_from_numpy(
    head: Mapping[str, Any],
    parts: Sequence[Mapping[str, Any]],
    manifest_json: str,
    n_cols: Sequence[int],
    *,
    device: str | torch.device | None = None,
) -> PartitionedIndex:
    """The port's :class:`PartitionedIndex` from a partitioned index's arrays.

    ``head`` and each of ``parts`` hold a tree's keys :data:`TREE_KEYS`
    (``layers`` as for :func:`tree_from_numpy`); a part whose manifest row
    names a tier other than ``exact`` holds a quantized tree's layers, as for
    :func:`quantized_tree_from_numpy`. ``manifest_json`` is the reference
    manifest's ``to_json()`` and ``n_cols`` the whole tree's column counts.
    """
    manifest = PartitionManifest.from_json(manifest_json)
    if len(parts) != manifest.n_partitions:
        raise ValueError(f"{len(parts)} parts for a manifest of {manifest.n_partitions}")
    for t in (head, *parts):
        missing = set(TREE_KEYS) - set(t)
        if missing:
            raise ValueError(f"tree arrays lack {sorted(missing)}")

    def tree(t, tier="exact"):
        args = (t["layers"], t["n_cols"], t["branching"], t["d"])
        if tier == "exact":
            return tree_from_numpy(*args, device=device)
        return quantized_tree_from_numpy(*args, tier, device=device)

    return PartitionedIndex(
        head=tree(head),
        parts=[tree(p, info.tier) for p, info in zip(parts, manifest.partitions)],
        manifest=manifest,
        n_cols=tuple(int(c) for c in n_cols),
        branching=tuple(manifest.branching),
    )


# numpy dtypes (by name, as ``ml_dtypes`` names them) that torch reads only
# through an integer view of their bytes
_RAW_NUMPY = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}


def _leaf_from_numpy(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    raw = _RAW_NUMPY.get(a.dtype.name)
    if raw is not None:
        return torch.from_numpy(np.array(a, order="C").view(raw[0])).view(raw[1]).to(dev)
    return torch.from_numpy(np.array(a, order="C")).to(dev)


def lm_params_from_numpy(params: Any, device: str | torch.device | None = None) -> Any:
    """The port's parameter pytree from the reference's (numpy leaves, e.g.
    from ``jax.device_get``): the same nested dicts, lists and tuples, each
    leaf a tensor of the same shape and dtype on ``device`` (CUDA unless
    named). bf16 and fp8 leaves cross as their bytes. A decode cache crosses
    the same way."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _leaf_from_numpy(x, dev)

    return conv(params)


def vocab_head_from_numpy(wc: np.ndarray, chunks: np.ndarray, n_vocab: int, *,
                          device: str | torch.device | None = None) -> VocabTreeHead:
    """The port's :class:`VocabTreeHead` from a reference head's ``wc``
    [d, C], ``chunks`` [C, d, B] and ``n_vocab``, on ``device``."""
    dev = resolve_device(device)
    return VocabTreeHead(wc=_leaf_from_numpy(wc, dev), chunks=_leaf_from_numpy(chunks, dev),
                         n_vocab=int(n_vocab))
