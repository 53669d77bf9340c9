"""Distributed XMR inference: queries x label-space sharding (counterpart of
``repro.core.distributed``).

The paper's §6.1 parallelism on a ``("data", "model")`` mesh of device
slots (:func:`repro_torch.distributed.sharding.partition_mesh`):

* ``data``: queries split by rows;
* ``model``: the LEAF level's chunks split by contiguous range (at 100M
  labels the leaf weights are the model; the upper levels are <= 1/B of it
  and are replicated).

Each (query, surviving parent) block is owned by exactly one model slot, so
every slot scores its blocks, takes a canonical local top-k, and a canonical
global top-k over the gathered candidates completes the beam: k · slots
candidates a query cross, not the score row. Where the reference runs the
slots as one ``shard_map`` program, the port loops over them, each slot on
its own CUDA stream. Like the reference, it runs the dense lookup
(``mscm_dense_lookup``), no kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import mscm as mscm_lib
from repro_torch.core.beam import NEG_INF, beam_step, topk_canonical
from repro_torch.core.tree import TreeLayerArrays, XMRTree
from repro_torch.distributed.sharding import DeviceMesh, Slot, row_slices, send


def shard_leaf_level(tree: XMRTree, mesh: DeviceMesh) -> Tuple[np.ndarray, np.ndarray]:
    """Place the tree over ``mesh``: the upper levels on every slot, the leaf
    level's chunks split over ``"model"`` in contiguous ranges. Returns
    ``(upper, leaf)``, object arrays shaped like the mesh: ``upper[r, m]`` the
    upper layers and ``leaf[r, m]`` model slot m's leaf shard, on device
    ``mesh.devices[r, m]`` (one copy per distinct device)."""
    devices = mesh.devices
    n_model = devices.shape[1]
    lay = tree.layers[-1]
    c = lay.chunk_rows.shape[0]
    if c % n_model:
        raise ValueError(f"the leaf level's {c} chunks do not split over {n_model} model slots")
    c_local = c // n_model
    upper_on: Dict[torch.device, list] = {}
    leaf_on: Dict[Tuple[torch.device, int], TreeLayerArrays] = {}
    upper = np.empty(devices.shape, dtype=object)
    leaf = np.empty(devices.shape, dtype=object)
    for (r, m), dev in np.ndenumerate(devices):
        if dev not in upper_on:
            upper_on[dev] = [l.to(dev) for l in tree.layers[:-1]]
        if (dev, m) not in leaf_on:
            rng = slice(m * c_local, (m + 1) * c_local)
            leaf_on[dev, m] = TreeLayerArrays(
                chunk_rows=lay.chunk_rows[rng].to(dev),
                chunk_vals=lay.chunk_vals[rng].to(dev),
                col_rows=lay.col_rows.to(dev),
                col_vals=lay.col_vals.to(dev),
            )
        upper[r, m], leaf[r, m] = upper_on[dev], leaf_on[dev, m]
    return upper, leaf


def _shard_topk(tree: XMRTree, upper, leaf: TreeLayerArrays, m: int, xi, xv, *,
                beam: int, topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model slot m's canonical local top-k of its queries: the upper levels
    on the replicated layers, then the leaf blocks it owns."""
    n, dev = xi.shape[0], xi.device
    xd = mscm_lib.scatter_dense(xi, xv, tree.d)
    parent = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    scores = torch.ones((n, 1), dtype=torch.float32, device=dev)
    for li, lay in enumerate(upper):
        bc = parent.shape[1]
        bq = torch.arange(n, device=dev).repeat_interleave(bc)
        logits = mscm_lib.mscm_dense_lookup(
            xd, lay.chunk_rows, lay.chunk_vals, bq, parent.reshape(-1)
        ).reshape(n, bc, tree.branching[li])
        parent, scores = beam_step(parent, scores, logits, tree.n_cols[li],
                                   min(beam, tree.n_cols[li]))
    li = len(upper)
    b = tree.branching[li]
    c_local = leaf.chunk_vals.shape[0]
    bc = parent.shape[1]
    bq = torch.arange(n, device=dev).repeat_interleave(bc)
    flat_parent = parent.reshape(-1)
    owner = flat_parent // c_local
    local_c = (flat_parent - m * c_local).clamp(0, c_local - 1)
    logits = mscm_lib.mscm_dense_lookup(
        xd, leaf.chunk_rows, leaf.chunk_vals, bq, local_c).reshape(n, bc, b)
    mine = (owner == m).reshape(n, bc, 1)
    child = flat_parent.reshape(n, bc, 1) * b + torch.arange(b, device=dev)
    comb = torch.where(mine & (child < tree.n_cols[li]),
                       torch.sigmoid(logits) * scores[..., None], NEG_INF)
    # Canonical (score desc, id asc), as beam_select: the shard boundary
    # cannot reorder ties.
    return topk_canonical(comb.reshape(n, -1), child.reshape(n, -1),
                          min(topk, tree.n_cols[li]))


def sharded_infer(
    tree: XMRTree,
    upper: np.ndarray,
    leaf_sharded: np.ndarray,
    x_idx: torch.Tensor,
    x_val: torch.Tensor,
    mesh: DeviceMesh,
    *,
    beam: int = 10,
    topk: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed Algorithm 1: query rows split over ``"data"``, leaf chunks
    over ``"model"`` (placed by :func:`shard_leaf_level`). Returns ``(scores
    [n, k], leaf ids [n, k])`` on the queries' device, ready on the caller's
    stream."""
    n_data, n_model = mesh.devices.shape
    caller = Slot.current(x_idx.device)
    out_s, out_i = [], []
    for r, (r0, r1) in enumerate(row_slices(x_idx.shape[0], n_data)):
        cand_i, cand_s = [], []
        for m in range(n_model):
            slot = Slot.new(mesh.devices[r, m])
            xi, xv = send((x_idx[r0:r1], x_val[r0:r1]), caller, slot)
            with slot.enter():
                loc = _shard_topk(tree, upper[r, m], leaf_sharded[r, m], m, xi, xv,
                                  beam=beam, topk=topk)
            loc_i, loc_s = send(loc, slot, caller)
            cand_i.append(loc_i)
            cand_s.append(loc_s)
        # Candidate gather over the model slots + canonical global top-k.
        g_i, g_s = topk_canonical(torch.cat(cand_s, dim=1), torch.cat(cand_i, dim=1),
                                  cand_i[0].shape[1])
        out_s.append(g_s)
        out_i.append(g_i)
    return torch.cat(out_s), torch.cat(out_i)
