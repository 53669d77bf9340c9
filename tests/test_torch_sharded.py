"""PyTorch port, multi-device dispatch: the sharded and partitioned engines on
a mesh of device slots, ``sharded_infer``, and the partitioned engine behind
the micro-batcher.

The reference forces host devices (``XLA_FLAGS=--xla_force_host_platform_
device_count``) in a subprocess; the port names one device more than once
(``devices=["cpu"] * 4``), each entry a slot of the mesh. Splitting a
bucket's rows changes each row's position in the level's tensors, and on
the CPU torch's sigmoid rounds by position (see ``test_torch_planner.py``),
so the sharded engines are held bitwise against one slot on equal
sub-batches (each half of the bucket served alone); on the card they are
bitwise outright (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import XMRTree as JTree
from repro.serving import BatchPolicy as JPolicy
from repro.serving import MicroBatcher as JBatcher
from repro.serving import ServeConfig as JConfig
from repro.serving import XMRServingEngine as JEngine
from repro.sparse import random_sparse_csc, random_sparse_csr
from repro_torch.core.distributed import shard_leaf_level, sharded_infer
from repro_torch.core.tree import XMRTree
from repro_torch.distributed.sharding import partition_mesh, replica_mesh, row_slices
from repro_torch.parity import check_ranking
from repro_torch.serving import (
    BatchPolicy,
    MicroBatcher,
    PartitionConfig,
    ServeConfig,
    XMRServingEngine,
)
from repro_torch.sparse.csr import CSC, CSR

TIMEOUT_S = 60
CPU4 = ["cpu"] * 4


def port_csc(w):
    return CSC(w.indptr, w.indices, w.data, tuple(w.shape))


def port_csr(x):
    return CSR(x.indptr, x.indices, x.data, tuple(x.shape))


@pytest.fixture(scope="module")
def setup():
    """The reference sharded tests' tree: d = 120, B = 8, levels [8, 64,
    500], 41 queries (a ragged tail of buckets)."""
    rng = np.random.default_rng(5)
    d, B = 120, 8
    ws = [random_sparse_csc(d, n, 10, rng, sibling_groups=B) for n in (8, 64, 500)]
    jt = JTree.from_weight_matrices(ws, B)
    tt = XMRTree.from_weight_matrices([port_csc(w) for w in ws], B, device="cpu")
    return jt, tt, random_sparse_csr(41, d, 15, rng)


def one_slot(tt):
    return XMRServingEngine(tt, ServeConfig(ell_width=32, max_batch=64), device="cpu")


@pytest.mark.parametrize("partition", [None, PartitionConfig(partitions=2),
                                       PartitionConfig(partitions=2, partition_sync="pipelined",
                                                       beam_cache=8)])
def test_sharded_engines_bitwise_one_slot_on_equal_sub_batches(setup, partition):
    """``shards=2`` (replicated, or over partitions on a 2x2 mesh): each half
    of a bucket is bitwise what one slot serves for that half alone."""
    _, tt, q = setup
    cfg = ServeConfig(ell_width=32, max_batch=64, shards=2,
                      partition=partition or PartitionConfig())
    eng = XMRServingEngine(tt, cfg, devices=CPU4)
    want_mesh = {"data": 2} if partition is None else {"data": 2, "model": 2}
    assert eng.mesh.shape == want_mesh
    assert eng.bucket_for(1) == 2 and eng.bucket_for(3) == 4  # never below shards
    ref = one_slot(tt)
    xi, xv = eng.marshal_rows(port_csr(q), np.arange(41), 64)
    s, l = eng._run(xi, xv)
    for r0, r1 in row_slices(64, 2):
        s_r, l_r = ref._run(xi[r0:r1], xv[r0:r1])
        assert torch.equal(l[r0:r1], l_r) and torch.equal(s[r0:r1], s_r)
    s_b, l_b = eng.serve_batch(port_csr(q))
    np.testing.assert_array_equal(s_b, s[:41].numpy())
    np.testing.assert_array_equal(l_b, l[:41].numpy())


def test_sharded_online_bitwise_one_slot(setup):
    """``serve_online`` with ``shards=2``: each query rides a bucket of 2 split
    into halves of one row, which is what one slot serves online."""
    _, tt, q = setup
    eng = XMRServingEngine(tt, ServeConfig(ell_width=32, max_batch=64, shards=2), devices=CPU4)
    s, l = eng.serve_online(port_csr(q), limit=12)
    s_1, l_1 = one_slot(tt).serve_online(port_csr(q), limit=12)
    np.testing.assert_array_equal(l, l_1)
    np.testing.assert_array_equal(s, s_1)


def test_sharded_engine_validation(setup):
    _, tt, _ = setup
    for shards in (3, 128):
        with pytest.raises(ValueError, match="shards"):
            XMRServingEngine(tt, ServeConfig(max_batch=64, shards=shards), devices=CPU4)
    with pytest.raises(ValueError, match="device slots"):
        XMRServingEngine(tt, ServeConfig(shards=4), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="device slots"):
        replica_mesh(3, devices=["cpu"])
    mesh = partition_mesh(2, 2, devices=CPU4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.axis_names == ("data", "model")


def test_partitioned_engine_matches_reference_and_unpartitioned(setup):
    """``partitions=2`` on two slots: bitwise the port's unpartitioned engine
    (the ``level`` mode keeps every row's position), and the reference's
    ranking within tolerance, with the reference's manifest."""
    jt, tt, q = setup
    eng = XMRServingEngine(tt, ServeConfig(ell_width=32, max_batch=64,
                                           partition=PartitionConfig(partitions=2)),
                           devices=["cpu"] * 2)
    assert eng.mesh.shape == {"data": 1, "model": 2}
    s, l = eng.serve_batch(port_csr(q))
    s_1, l_1 = one_slot(tt).serve_batch(port_csr(q))
    np.testing.assert_array_equal(l, l_1)
    np.testing.assert_array_equal(s, s_1)
    with pytest.warns(DeprecationWarning):
        jeng = JEngine(jt, JConfig(ell_width=32, max_batch=64, partitions=2))
    s_j, l_j = jeng.serve_batch(q)
    check_ranking(s, l, s_j, l_j)
    m = eng.index.manifest
    assert m.to_json() == jeng.index.manifest.to_json()
    assert m.max_partition_bytes() / m.total_memory_bytes < 0.75 and m.shrink_ratio() > 1.3
    assert len(eng.planner.profile(*eng.marshal_rows(port_csr(q), np.arange(8), 8))) == 2


@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_infer_matches_reference_single_device(n_model):
    """The port's ``sharded_infer`` over 2 and 4 model slots (2 data rows)
    against the reference's single-device ``XMRTree.infer``: what
    ``tests/test_distributed_xmr.py`` asserts of the reference's mesh."""
    rng = np.random.default_rng(9)
    x = random_sparse_csr(16, 120, 15, rng)
    xi, xv = x.to_ell()
    # The leaf level's 64 chunks split evenly over the model slots.
    ws = [random_sparse_csc(120, n, 10, rng, sibling_groups=8) for n in (8, 64, 512)]
    jt = JTree.from_weight_matrices(ws, 8)
    tt = XMRTree.from_weight_matrices([port_csc(w) for w in ws], 8, device="cpu")
    s_j, l_j = jt.infer(jnp.asarray(xi), jnp.asarray(xv), beam=10, topk=5)
    mesh = partition_mesh(2, n_model, devices=["cpu"] * (2 * n_model))
    upper, leaf = shard_leaf_level(tt, mesh)
    assert leaf[0, 0].chunk_vals.shape[0] == 64 // n_model
    s, l = sharded_infer(tt, upper, leaf, torch.from_numpy(xi), torch.from_numpy(xv), mesh,
                         beam=10, topk=5)
    check_ranking(s.numpy(), l.numpy(), np.asarray(s_j), np.asarray(l_j))
    with pytest.raises(ValueError, match="do not split"):
        shard_leaf_level(tt, partition_mesh(1, 3, devices=["cpu"] * 3))


def _batch_in_order(mb, queries):
    """Submit every query before start (so the batches form alike in both
    packages), start, collect, stop; every wait bounded."""
    try:
        futs = [mb.submit(*queries.row(i)) for i in range(queries.shape[0])]
        mb.start()
        res = [f.result(timeout=TIMEOUT_S) for f in futs]
    finally:
        mb.stop()
    return np.stack([r[0] for r in res]), np.stack([r[1] for r in res])


def test_partitioned_batcher_summary_matches_reference(setup):
    """A pipelined, cached, partitioned engine behind a ``MicroBatcher``:
    the summary's partition occupancy and beam-cache counters equal the
    reference's on the same batches, and both record the pipeline stall."""
    jt, tt, q = setup
    kw = dict(ell_width=32, max_batch=64)
    part = dict(partitions=2, partition_sync="pipelined", beam_cache=16)
    with pytest.warns(DeprecationWarning):
        jeng = JEngine(jt, JConfig(**kw, **part))
    eng = XMRServingEngine(tt, ServeConfig(**kw, partition=PartitionConfig(**part)),
                           devices=["cpu"] * 2)
    jmb = JBatcher(jeng, JPolicy(max_batch=8, max_wait_ms=1.0), warmup_on_start=False)
    s_j, l_j = _batch_in_order(jmb, q)
    mb = MicroBatcher(eng, BatchPolicy(max_batch=8, max_wait_ms=1.0), warmup_on_start=False)
    s, l = _batch_in_order(mb, port_csr(q))
    check_ranking(s, l, s_j, l_j)
    got, want = mb.metrics.summary(), jmb.metrics.summary()
    assert got["batches"] == want["batches"] == 6
    assert got["partition_occupancy"] == want["partition_occupancy"]
    assert abs(sum(got["partition_occupancy"]) - 1.0) < 1e-3
    for key in ("hits", "misses", "evictions", "entries", "capacity"):
        assert got["beam_cache"][key] >= 0
    assert got["beam_cache"]["misses"] >= 1 and 0.0 <= got["beam_cache"]["hit_rate"] <= 1.0
    assert got["pipeline_stall_avg_ms"] >= 0.0 and "pipeline_stall_p99_ms" in got
    assert set(want) == set(got)
    assert "replica_occupancy" not in got


def test_partitioned_sharded_batcher_replica_rows(setup):
    """``partitions=2, shards=2`` on four slots through the batcher: results
    within the CPU's sigmoid tail of one slot's, occupancy per partition and
    per replica as the reference's formulas give them (real rows fill the
    bucket head, so replica occupancy never rises)."""
    _, tt, q = setup
    eng = XMRServingEngine(tt, ServeConfig(ell_width=32, max_batch=64, shards=2,
                                           partition=PartitionConfig(partitions=2)),
                           devices=CPU4)
    mb = MicroBatcher(eng, BatchPolicy(max_batch=16, max_wait_ms=5.0), warmup_on_start=False)
    s, l = _batch_in_order(mb, port_csr(q))
    s_1, l_1 = one_slot(tt).serve_batch(port_csr(q))
    check_ranking(s, l, s_1, l_1, rtol=2.0 ** -22, atol=0.0)
    summ = mb.metrics.summary()
    assert len(summ["partition_occupancy"]) == 2
    occ = summ["replica_occupancy"]
    assert len(occ) == 2 and occ[0] >= occ[1]
    hits = eng.partition_hit_counts(l)
    assert hits.sum() == l.size
