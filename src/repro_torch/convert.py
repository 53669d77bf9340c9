"""Carry a tree's weights across from the reference package.

:func:`tree_from_numpy` takes each level's arrays as numpy — e.g.
``np.asarray`` of a reference ``TreeLayerArrays``' ``chunk_rows``,
``chunk_vals``, ``col_rows`` and ``col_vals`` — and returns the port's
:class:`~repro_torch.core.tree.XMRTree` with the same values.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.tree import TreeLayerArrays, XMRTree, resolve_device

LAYER_FIELDS = ("chunk_rows", "chunk_vals", "col_rows", "col_vals")
_DTYPES = {
    "chunk_rows": np.int32, "chunk_vals": np.float32,
    "col_rows": np.int32, "col_vals": np.float32,
}


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
            f: torch.from_numpy(np.array(arrays[f], dtype=_DTYPES[f], order="C")).to(dev)
            for f in LAYER_FIELDS
        }))
    return XMRTree(layers=out, n_cols=tuple(int(c) for c in n_cols),
                   branching=tuple(int(b) for b in branching), d=int(d))
