"""PyTorch port, label-partitioned index: partition, manifest, placement.

Each case runs the reference (``repro.index``) and the port
(``repro_torch.index``) on the same seeded tree (the size of
``tests/test_partition.py``: d = 150, B = 8, levels [8, 64, 512], 11
queries). Layouts, ranges, manifests and packings are integer or text
outputs: the port's are equal to the reference's, ``to_json()`` character
for character, content hashes included, for exact, int8 and fp8 indexes.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import XMRTree as JTree
from repro.index import (
    PartitionManifest as JManifest,
    assign_partitions as j_assign,
    default_split_level as j_split_level,
    partition_tree as j_partition,
    rebalance as j_rebalance,
    rebalance_bounds as j_rebalance_bounds,
)
from repro.quant import quantize_index as j_quantize_index
from repro.sparse import random_sparse_csc, random_sparse_csr
from repro_torch.convert import partitioned_index_from_numpy
from repro_torch.core.tree import XMRTree
from repro_torch.index import (
    PartitionManifest,
    ScatterGatherPlanner,
    assign_partitions,
    default_split_level,
    partition_tree,
    place,
    rebalance,
    rebalance_bounds,
)
from repro_torch.quant import quantize_index, quantize_tree
from repro_torch.sparse.csr import CSC
from tests.conftest import make_tree_weights

LAYER_FIELDS = ("chunk_rows", "chunk_vals", "col_rows", "col_vals")


def port_csc(w):
    return CSC(w.indptr, w.indices, w.data, tuple(w.shape))


def both_trees(ws, branching):
    return (JTree.from_weight_matrices(ws, branching),
            XMRTree.from_weight_matrices([port_csc(w) for w in ws], branching, device="cpu"))


@pytest.fixture(scope="module")
def trees():
    rng = np.random.default_rng(42)
    d, B = 150, 8
    ws = make_tree_weights(rng, d, [8, 64, 512], B)
    jt, tt = both_trees(ws, B)
    x = random_sparse_csr(11, d, 16, rng)
    xi, xv = x.to_ell()
    return jt, tt, xi, xv


def ref_tree_arrays(tree):
    """A reference tree (quantized or not) as the numpy dict
    ``partitioned_index_from_numpy`` takes; fp8 codes as uint8 bits."""
    layers = []
    for lay in tree.layers:
        fields = [f.name for f in dataclasses.fields(lay)]
        arrays = {}
        for f in fields:
            a = np.asarray(getattr(lay, f))
            arrays[f] = a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a
        layers.append(arrays)
    return dict(layers=layers, n_cols=tree.n_cols, branching=tree.branching, d=tree.d)


def carry_index(jidx):
    """The reference's partitioned index, carried into the port."""
    return partitioned_index_from_numpy(
        ref_tree_arrays(jidx.head), [ref_tree_arrays(p) for p in jidx.parts],
        jidx.manifest.to_json(), jidx.n_cols, device="cpu")


def assert_same_tree(port, ref):
    assert port.n_cols == tuple(ref.n_cols) and port.branching == tuple(ref.branching)
    assert port.d == ref.d and len(port.layers) == len(ref.layers)
    for pl, jl in zip(port.layers, ref.layers):
        for f in LAYER_FIELDS:
            np.testing.assert_array_equal(getattr(pl, f).numpy(), np.asarray(getattr(jl, f)))


# ---------------------------------------------------------------------------
# 1. head, extract and the phantom chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", [1, 2])
def test_head_matches_reference(trees, level):
    jt, tt, _, _ = trees
    assert_same_tree(tt.head(level), jt.head(level))


@pytest.mark.parametrize("level,c0,c1", [(1, 0, 2), (1, 3, 8), (1, 7, 8), (2, 10, 33),
                                         (2, 0, 64)])
def test_extract_and_phantom_match_reference(trees, level, c0, c1):
    jt, tt, _, _ = trees
    sub = tt.extract(level, c0, c1)
    assert_same_tree(sub, jt.extract(level, c0, c1))
    for li, lay in enumerate(sub.layers):
        b = sub.branching[li]
        # One phantom chunk (rows all d, values 0) and B phantom columns.
        assert torch.all(lay.chunk_rows[-1] == tt.d) and torch.all(lay.chunk_vals[-1] == 0)
        assert torch.all(lay.col_rows[-b:] == tt.d) and torch.all(lay.col_vals[-b:] == 0)
        # A fresh allocation, not a view of the whole tree's layer.
        whole = tt.layers[level + li].chunk_vals
        assert lay.chunk_vals.untyped_storage().data_ptr() != whole.untyped_storage().data_ptr()


def test_head_extract_validation_and_quantized_refusal(trees):
    _, tt, _, _ = trees
    for call in (lambda: tt.head(0), lambda: tt.head(3), lambda: tt.extract(1, 5, 3),
                 lambda: tt.extract(3, 0, 1)):
        with pytest.raises(ValueError):
            call()
    q = quantize_tree(tt, tier="int8")
    for call in (lambda: q.head(1), lambda: q.extract(1, 0, 2)):
        with pytest.raises(TypeError, match="quantize_index"):
            call()


@pytest.mark.parametrize("n_partitions", [1, 2, 8, 9, 64])
def test_default_split_level_matches_reference(trees, n_partitions):
    jt, tt, _, _ = trees
    assert default_split_level(tt, n_partitions) == j_split_level(jt, n_partitions)


# ---------------------------------------------------------------------------
# 2. partition_tree: ranges, bounds, validation, manifest text
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_partitions,level", [(1, None), (2, None), (3, None), (4, None),
                                                (4, 2), (5, 2)])
def test_partition_matches_reference(trees, n_partitions, level):
    jt, tt, _, _ = trees
    j, t = j_partition(jt, n_partitions, level=level), partition_tree(tt, n_partitions,
                                                                     level=level)
    assert t.manifest.to_json() == j.manifest.to_json()
    assert t.label_ranges() == j.label_ranges() and t.n_cols == tuple(j.n_cols)
    assert_same_tree(t.head, j.head)
    for tp, jp in zip(t.parts, j.parts):
        assert_same_tree(tp, jp)


def test_uneven_label_ranges_match_reference():
    """L not divisible by B, P not dividing the chunk count: the ragged tail
    lands in the last partition, in both packages."""
    rng = np.random.default_rng(7)
    d = 90
    ws = [random_sparse_csc(d, 6, 8, rng), random_sparse_csc(d, 42, 8, rng)]
    jt, tt = both_trees(ws, [6, 8])
    j, t = j_partition(jt, 4), partition_tree(tt, 4)
    assert t.manifest.to_json() == j.manifest.to_json()
    sizes = [p.n_labels for p in t.manifest.partitions]
    assert sum(sizes) == 42 and sizes[-1] < max(sizes)


@pytest.mark.parametrize("bounds", [[0, 1, 2, 8], [0, 3, 3, 5, 8], [1, 3, 5, 7, 8],
                                    [0, 5, 6, 7, 9]])
def test_bad_bounds_raise_as_in_reference(trees, bounds):
    jt, tt, _, _ = trees
    with pytest.raises(ValueError):
        j_partition(jt, 4, bounds=bounds)
    with pytest.raises(ValueError, match="strictly increasing"):
        partition_tree(tt, 4, bounds=bounds)


def test_explicit_bounds_match_reference(trees):
    jt, tt, _, _ = trees
    bounds = [0, 1, 2, 7, 8]
    j, t = j_partition(jt, 4, bounds=bounds), partition_tree(tt, 4, bounds=bounds)
    assert t.manifest.to_json() == j.manifest.to_json()
    assert [p.chunk_start for p in t.manifest.partitions] == bounds[:-1]


@pytest.mark.parametrize("kwargs", [dict(n_partitions=9, level=1), dict(n_partitions=513),
                                    dict(n_partitions=0)])
def test_partition_validation(trees, kwargs):
    jt, tt, _, _ = trees
    with pytest.raises(ValueError):
        j_partition(jt, **kwargs)
    with pytest.raises(ValueError):
        partition_tree(tt, **kwargs)


@pytest.mark.parametrize("tier", ["int8", "int8_pruned", "fp8"])
def test_quantized_manifest_json_matches_reference(trees, tier):
    """quantize_index: f32 head, each part quantized after the cut, its row
    rebuilt (memory_bytes, content_hash over the codes' bytes, tier,
    dtype) as the reference writes it; fp8 hashed as its bit pattern under
    the name ``float8_e4m3fn``."""
    jt, tt, _, _ = trees
    j = j_quantize_index(j_partition(jt, 4), tier=tier)
    t = quantize_index(partition_tree(tt, 4), tier=tier)
    assert t.manifest.to_json() == j.manifest.to_json()
    assert t.head.layers[0].chunk_vals.dtype == torch.float32
    assert all(p.tier == tier for p in t.manifest.partitions)


def test_manifest_roundtrip_and_v1_read(trees):
    jt, tt, _, _ = trees
    m = partition_tree(tt, 3).manifest
    assert PartitionManifest.from_json(m.to_json()) == m
    # A v1 document: no tier/dtype columns. Both packages read it the same.
    doc = json.loads(j_partition(jt, 3).manifest.to_json())
    doc["version"] = 1
    for p in doc["partitions"]:
        del p["tier"], p["dtype"]
    text = json.dumps(doc)
    t, j = PartitionManifest.from_json(text), JManifest.from_json(text)
    assert t.to_json() == j.to_json() and t.version == 2
    assert all(p.tier == "exact" and p.dtype == "float32" for p in t.partitions)
    doc["version"] = 7
    with pytest.raises(ValueError, match="version"):
        PartitionManifest.from_json(json.dumps(doc))


def test_manifest_memory_and_hashes(trees):
    _, tt, _, _ = trees
    m = partition_tree(tt, 4).manifest
    assert m.max_partition_bytes() < m.total_memory_bytes / 4 * 1.5
    assert m.shrink_ratio() > 2.0
    hashes = [p.content_hash for p in m.partitions]
    assert len(set(hashes)) == 4
    assert [p.content_hash for p in partition_tree(tt, 4).manifest.partitions] == hashes


@pytest.mark.parametrize("tier", ["exact", "int8", "fp8"])
def test_carried_index_equals_port_cut(trees, tier):
    """``convert.partitioned_index_from_numpy`` carries the reference's
    index across; it is the port's own cut of the same tree, code for
    code."""
    jt, tt, _, _ = trees
    jidx, tidx = j_partition(jt, 3), partition_tree(tt, 3)
    if tier != "exact":
        jidx, tidx = j_quantize_index(jidx, tier=tier), quantize_index(tidx, tier=tier)
    got = carry_index(jidx)
    assert got.manifest == tidx.manifest and got.n_cols == tidx.n_cols
    for gp, tp in zip([got.head] + got.parts, [tidx.head] + tidx.parts):
        for gl, tl in zip(gp.layers, tp.layers):
            for f in ("chunk_rows", "chunk_vals", "chunk_scales"):
                if hasattr(tl, f):
                    a, b = getattr(gl, f), getattr(tl, f)
                    assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8),
                                                              b.view(torch.uint8))


# ---------------------------------------------------------------------------
# 3. occupancy, placement, rebalance
# ---------------------------------------------------------------------------

def test_hit_counts_match_reference(trees):
    jt, tt, _, _ = trees
    rng = np.random.default_rng(3)
    labels = rng.integers(-1, tt.n_labels + 3, size=(11, 10))
    j, t = j_partition(jt, 4), partition_tree(tt, 4)
    np.testing.assert_array_equal(t.hit_counts(labels), j.hit_counts(labels))
    assert t.hit_counts(labels).dtype == np.int64


@pytest.mark.parametrize("mem,bins", [([100, 90, 40, 30, 20, 10], 2), ([5, 5, 5, 5], 3),
                                      ([1, 9, 3, 7, 2, 8], 4), ([10], 1)])
def test_assign_partitions_matches_reference(mem, bins):
    assert assign_partitions(mem, bins) == j_assign(mem, bins)


def test_assign_partitions_validation():
    with pytest.raises(ValueError):
        assign_partitions([1, 2], 0)


def test_place_one_device(trees):
    """One device: everything on one model column, the coordinator on that
    device with a slot of its own; the planner stays bitwise through it."""
    _, tt, xi, xv = trees
    idx = partition_tree(tt, 2)
    pm = place(idx, shards=1, devices=["cpu"])
    assert pm.n_model == 1 and pm.n_data == 1 and pm.assignments == [0, 0]
    assert pm.slots[0][0] is pm.slots[1][0]  # column-mates share the slot
    assert pm.coordinator.device == torch.device("cpu")
    assert sum(pm.column_loads(idx.manifest)) == sum(
        p.memory_bytes for p in idx.manifest.partitions)
    xi, xv = torch.from_numpy(xi), torch.from_numpy(xv)
    got = ScatterGatherPlanner(idx, beam=6, topk=5, placement=pm).infer(xi, xv)
    want = tt.infer(xi, xv, beam=6, topk=5)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_place_repeated_device_mesh(trees):
    """A device named four times is a 2x2 mesh of four slots: the port's
    counterpart of the reference's forced host devices."""
    _, tt, _, _ = trees
    idx = partition_tree(tt, 4)
    pm = place(idx, shards=2, devices=["cpu"] * 4)
    assert pm.mesh.shape == {"data": 2, "model": 2} and pm.mesh.axis_names == ("data", "model")
    assert pm.assignments == j_assign([p.memory_bytes for p in idx.manifest.partitions], 2)
    slots = {id(s) for col in pm.slots for s in col}
    assert len(slots) == 4 and all(len(col) == 2 for col in pm.slots)
    # Four slots used of four: the coordinator takes devices[0].
    assert pm.coordinator.device == torch.device("cpu")
    with pytest.raises(ValueError, match="device slots"):
        place(idx, shards=3, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        place(idx, shards=0, devices=["cpu"])


def test_place_occupancy_weighting(trees):
    """Observed load shares, not memory, drive the packing when given: a
    partition serving nearly everything sits alone on a column."""
    _, tt, _, _ = trees
    idx = partition_tree(tt, 4)
    pm = place(idx, shards=1, devices=["cpu"] * 2, occupancy=[0.94, 0.02, 0.02, 0.02])
    assert pm.n_model == 2 and pm.assignments.count(pm.assignments[0]) == 1
    mem = place(idx, shards=1, devices=["cpu"] * 2)
    assert mem.assignments.count(mem.assignments[0]) == 2  # bytes packing pairs it
    for occ in ([0.5, 0.5], [-1.0, 1.0, 0.5, 0.5]):
        with pytest.raises(ValueError):
            place(idx, devices=["cpu"], occupancy=occ)


@pytest.mark.parametrize("occupancy", [[0.25, 0.25, 0.25, 0.25], [0.70, 0.10, 0.10, 0.10],
                                       [0.55, 0.15, 0.15, 0.15], [0.0, 0.0, 0.1, 0.9]])
def test_rebalance_matches_reference(trees, occupancy):
    jt, tt, _, _ = trees
    jm, tm = j_partition(jt, 4).manifest, partition_tree(tt, 4).manifest
    assert rebalance_bounds(tm, occupancy) == j_rebalance_bounds(jm, occupancy)
    assert (rebalance(tt, tm, occupancy).manifest.to_json()
            == j_rebalance(jt, jm, occupancy).manifest.to_json())


def test_rebalance_stays_bitwise_and_validates(trees):
    _, tt, xi, xv = trees
    idx = partition_tree(tt, 4)
    idx2 = rebalance(tt, idx.manifest, [0.55, 0.15, 0.15, 0.15])
    assert [p.chunk_end - p.chunk_start for p in idx2.manifest.partitions] != [2, 2, 2, 2]
    xi, xv = torch.from_numpy(xi), torch.from_numpy(xv)
    want = tt.infer(xi, xv, beam=10, topk=5)
    for sync in ("level", "pipelined"):
        s, l = ScatterGatherPlanner(idx2, beam=10, topk=5, sync=sync).infer(xi, xv)
        assert torch.equal(l, want[1]) and torch.equal(s, want[0])
    for occ in ([0.5, 0.5], [0.0, 0.0, 0.0, 0.0]):
        with pytest.raises(ValueError):
            rebalance_bounds(idx.manifest, occ)


def test_reference_and_port_index_serve_alike(trees):
    """Both packages' planners on the carried partitions: scores within
    rtol 1e-5 / atol 1e-6, labels equal outside near-ties."""
    from repro.index import ScatterGatherPlanner as JPlanner
    from repro_torch.parity import check_ranking

    jt, _, xi, xv = trees
    jidx = j_partition(jt, 3)
    sj, lj = JPlanner(jidx, beam=6, topk=5).infer(jnp.asarray(xi), jnp.asarray(xv))
    st, lt = ScatterGatherPlanner(carry_index(jidx), beam=6, topk=5).infer(
        torch.from_numpy(xi), torch.from_numpy(xv))
    check_ranking(st.numpy(), lt.numpy(), np.asarray(sj), np.asarray(lj))
