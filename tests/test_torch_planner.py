"""PyTorch port, scatter-gather planner: the three sync modes, the hot-beam
cache, the transport seam and the quantized index.

The tree is ``tests/test_partition.py``'s size (d = 150, B = 8, levels
[8, 64, 512], 11 queries). Two contracts:

* against the port's own unpartitioned ``infer``, on the CPU: bitwise, for
  every method, P in {1, 2, 3, 4}, beam, score mode and QT, in the ``level``
  and ``pipelined`` modes (each partition's owned rows go through the
  in-tree arithmetic on the same query batch, so there is no batch-size
  effect to allow for); ``final`` dominates the exact result;
* against the reference's planner on the same partitions (carried with
  ``convert.partitioned_index_from_numpy``): scores within rtol 1e-5 /
  atol 1e-6, labels equal wherever the reference's score gap exceeds that
  (``repro_torch.parity``). The selection helpers, which see no float sum,
  are held bitwise against the reference's on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import XMRTree as JTree
from repro.index import ScatterGatherPlanner as JPlanner
from repro.index import partition_tree as j_partition
from repro.index import planner as jplanner
from repro.quant import quantize_index as j_quantize_index
from repro.sparse import random_sparse_csc, random_sparse_csr
from repro_torch.core.tree import XMRTree, owned_level_combined
from repro_torch.index import (
    HotBeamCache,
    ScatterGatherPlanner,
    partition_tree,
    reference_topk_width,
)
from repro_torch.index import planner as tplanner
from repro_torch.parity import check_ranking
from repro_torch.quant import dequantize_tree, quantize_index
from repro_torch.sparse.csr import CSC
from tests.beam_transport import LocalTransport
from tests.conftest import make_tree_weights
from tests.test_torch_partition import carry_index

METHODS = ("vanilla", "mscm_dense", "mscm_searchsorted", "mscm_pallas",
           "mscm_pallas_pregather", "mscm_pallas_grouped")


def port_csc(w):
    return CSC(w.indptr, w.indices, w.data, tuple(w.shape))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    d, B = 150, 8
    ws = make_tree_weights(rng, d, [8, 64, 512], B)
    jt = JTree.from_weight_matrices(ws, B)
    tt = XMRTree.from_weight_matrices([port_csc(w) for w in ws], B, device="cpu")
    x = random_sparse_csr(11, d, 16, rng)
    xi, xv = x.to_ell()
    return jt, tt, xi, xv


def tensors(xi, xv):
    return torch.from_numpy(xi), torch.from_numpy(xv)


def assert_bitwise(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


#: On the CPU, torch's elementwise sigmoid takes the last ``numel mod 2 x
#: vector width`` elements of a tensor through its scalar path, which rounds
#: some inputs 1 ULP apart from the vectorized body: a score's last bit then
#: depends on its position in the level's ``[n, b, B]`` tensor. The pipelined
#: mode scores a row at its place in its partition's local beam, not in the
#: global one, so there the methods that combine through ``torch.sigmoid`` on
#: that tensor (all but the grouped one, whose plain version works on [T, QT,
#: B] tiles of 64 elements and never has a tail) may differ by 1 ULP on the
#: CPU: held within 2 ULP, labels equal outside near-ties of that size. On the
#: card every method is bitwise (tests/test_torch_cuda.py).
CPU_ULP_RTOL = 2.0 ** -22


def assert_planner_bits(got, want, method, sync):
    """Bitwise, but for the CPU's sigmoid tail in the pipelined mode."""
    if sync != "pipelined" or method == "mscm_pallas_grouped":
        return assert_bitwise(got, want)
    check_ranking(got[0].numpy(), got[1].numpy(), want[0].numpy(), want[1].numpy(),
                  rtol=CPU_ULP_RTOL, atol=0.0)


# ---------------------------------------------------------------------------
# 1. level and pipelined: bitwise the port's unpartitioned traversal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync", ["level", "pipelined"])
@pytest.mark.parametrize("n_partitions", [1, 2, 3, 4])
@pytest.mark.parametrize("method", METHODS)
def test_bitwise_unpartitioned_every_method(setup, method, n_partitions, sync):
    _, tt, xi, xv = setup
    xi, xv = tensors(xi, xv)
    pl = ScatterGatherPlanner(partition_tree(tt, n_partitions), beam=10, topk=5,
                              method=method, sync=sync)
    assert_planner_bits(pl.infer(xi, xv), tt.infer(xi, xv, beam=10, topk=5, method=method),
                        method, sync)


@pytest.mark.parametrize("sync", ["level", "pipelined"])
@pytest.mark.parametrize("beam,score_mode,qt", [
    (1, "prod", 8), (6, "prod", 4), (6, "logsum", 8), (12, "logsum", 4), (12, "prod", 8),
])
@pytest.mark.parametrize("method", ["mscm_dense", "mscm_pallas_grouped"])
def test_bitwise_beam_mode_qt(setup, method, beam, score_mode, qt, sync):
    _, tt, xi, xv = setup
    xi, xv = tensors(xi, xv)
    kw = dict(beam=beam, topk=5, method=method, score_mode=score_mode, qt=qt)
    pl = ScatterGatherPlanner(partition_tree(tt, 3), sync=sync, **kw)
    assert_planner_bits(pl.infer(xi, xv), tt.infer(xi, xv, **kw), method, sync)


@pytest.mark.parametrize("sync", ["level", "pipelined"])
def test_width_clamp(setup, sync):
    """beam=1, topk=10: the last level's candidates (b·B = 8) are fewer than
    topk, and the merge keeps the reference's clamp."""
    _, tt, xi, xv = setup
    xi, xv = tensors(xi, xv)
    s, l = ScatterGatherPlanner(partition_tree(tt, 3), beam=1, topk=10, sync=sync).infer(xi, xv)
    want = tt.infer(xi, xv, beam=1, topk=10)
    assert s.shape[1] == reference_topk_width(tt.n_cols, tt.branching, 1, 10) == 8
    assert_planner_bits((s, l), want, "mscm_dense", sync)


@pytest.mark.parametrize("sync", ["level", "pipelined"])
def test_deeper_split_and_ragged_tree(setup, sync):
    _, tt, xi, xv = setup
    xi_t, xv_t = tensors(xi, xv)
    idx = partition_tree(tt, 4, level=2)
    assert idx.level == 2 and idx.head.depth == 2
    pl = ScatterGatherPlanner(idx, beam=6, topk=5, method="mscm_searchsorted", sync=sync)
    assert_planner_bits(pl.infer(xi_t, xv_t),
                        tt.infer(xi_t, xv_t, beam=6, topk=5, method="mscm_searchsorted"),
                        "mscm_searchsorted", sync)
    # A ragged tree: L not divisible by B, uneven chunk ranges.
    rng = np.random.default_rng(11)
    ws = [random_sparse_csc(90, 6, 8, rng), random_sparse_csc(90, 42, 8, rng)]
    rt = XMRTree.from_weight_matrices([port_csc(w) for w in ws], [6, 8], device="cpu")
    x = random_sparse_csr(15, 90, 12, rng)
    ri, rv = tensors(*x.to_ell())
    s, l = ScatterGatherPlanner(partition_tree(rt, 4), beam=5, topk=7, sync=sync).infer(ri, rv)
    assert_planner_bits((s, l), rt.infer(ri, rv, beam=5, topk=7), "mscm_dense", sync)
    assert int(l.max()) < 42


def test_final_mode_dominates_exact(setup):
    _, tt, xi, xv = setup
    xi, xv = tensors(xi, xv)
    s, l = ScatterGatherPlanner(partition_tree(tt, 4), beam=4, topk=5, sync="final").infer(xi, xv)
    ref_s, _ = tt.infer(xi, xv, beam=4, topk=5)
    assert s.shape == ref_s.shape
    assert torch.all(s >= ref_s)
    assert int(l.max()) < tt.n_labels  # no phantom leaks


def test_tier_overrides_match_a_planner_built_at_that_beam(setup):
    _, tt, xi, xv = setup
    xi, xv = tensors(xi, xv)
    idx = partition_tree(tt, 2)
    for sync in ("level", "pipelined", "final"):
        full = ScatterGatherPlanner(idx, beam=10, topk=5, sync=sync)
        narrow = ScatterGatherPlanner(idx, beam=5, qt=4, topk=5, sync=sync)
        assert_bitwise(full.infer(xi, xv, beam=5, qt=4), narrow.infer(xi, xv))


# ---------------------------------------------------------------------------
# 2. against the reference, on the same partitions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync", ["level", "pipelined", "final"])
@pytest.mark.parametrize("n_partitions", [2, 4])
@pytest.mark.parametrize("method", ["mscm_dense", "mscm_pallas_grouped", "vanilla"])
def test_matches_reference_planner(setup, method, n_partitions, sync):
    jt, _, xi, xv = setup
    jidx = j_partition(jt, n_partitions)
    kw = dict(beam=6, topk=5, method=method, sync=sync)
    sj, lj = JPlanner(jidx, **kw).infer(jnp.asarray(xi), jnp.asarray(xv))
    st, lt = ScatterGatherPlanner(carry_index(jidx), **kw).infer(*tensors(xi, xv))
    check_ranking(st.numpy(), lt.numpy(), np.asarray(sj), np.asarray(lj))


def _owned_inputs(jt, xi, xv, n_partitions, pid):
    """A partition's owned candidates at the first partitioned level, from
    the reference's router beam: (ids, combined, owned) as numpy, plus
    (n_cols, n_chunks, next_b)."""
    from repro.core.mscm import scatter_dense
    from repro.core.tree import owned_level_combined as j_owned

    jidx = j_partition(jt, n_partitions)
    xi, xv = jnp.asarray(xi), jnp.asarray(xv)
    sc, ids = jidx.head.infer(xi, xv, beam=10, topk=10)
    info, part, li = jidx.manifest.partitions[pid], jidx.parts[pid], jidx.level
    lay = part.layers[0]
    comb, own = j_owned(lay, jidx.branching[li], jidx.d, xi, xv, scatter_dense(xi, xv, jidx.d),
                        ids, sc, jnp.int32(info.chunk_start),
                        jnp.int32(lay.chunk_rows.shape[0] - 1), method="mscm_dense",
                        score_mode="prod")
    return (np.array(ids), np.array(comb), np.array(own),
            (jidx.n_cols[li], jidx.n_cols[li - 1], 10))


@pytest.mark.parametrize("pid", [0, 7])
def test_local_select_with_repeated_junk_ids_matches_reference(setup, pid):
    """P = 8, one chunk each at the split: each partition owns one row of
    the router beam of 8, so 7 rows are unowned and its local beam of 10
    holds 8 real candidates and repeated junk ids (same id, same NEG_INF).
    The packed-key select still gives the reference's bits."""
    jt, _, xi, xv = setup
    ids, comb, own, (n_cols, n_chunks, next_b) = _owned_inputs(jt, xi, xv, 8, pid)
    assert (~own).sum(axis=1).min() >= 2  # several unowned rows in every query
    kw = dict(n_cols=n_cols, n_chunks=n_chunks, next_b=next_b)
    ji, js = jplanner._local_select(jnp.asarray(ids), jnp.asarray(comb), jnp.asarray(own), **kw)
    ti, ts = tplanner._local_select(torch.from_numpy(ids).long(), torch.from_numpy(comb),
                                    torch.from_numpy(own), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    assert (ti.numpy() >= n_chunks * 8).sum() >= 1  # junk ids made the local beam


def test_reconcile_and_merge_match_reference(setup):
    """The pipelined exchange's pieces on the same inputs: the merge of eight
    local beams (junk ids repeated within and across them) and the reconcile
    of the winners against each speculative beam, bitwise the reference's."""
    jt, _, xi, xv = setup
    beams = []
    for pid in range(8):
        ids, comb, own, (n_cols, n_chunks, next_b) = _owned_inputs(jt, xi, xv, 8, pid)
        beams.append(jplanner._local_select(jnp.asarray(ids), jnp.asarray(comb),
                                            jnp.asarray(own), n_cols=n_cols,
                                            n_chunks=n_chunks, next_b=next_b))
    j_ids, j_sc = jplanner._merge_beams(tuple(b[0] for b in beams), tuple(b[1] for b in beams),
                                        width=10)
    t_beams = [(torch.from_numpy(np.array(i)).long(), torch.from_numpy(np.array(s)))
               for i, s in beams]
    t_ids, t_sc = tplanner._merge_beams([b[0] for b in t_beams], [b[1] for b in t_beams],
                                        width=10)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_sc.numpy().view(np.int32), np.asarray(j_sc).view(np.int32))
    rng = np.random.default_rng(0)
    spec_comb = rng.random((11, 10, 8)).astype(np.float32)
    for pid, (spec_i, _) in enumerate(t_beams):
        args = (pid * 8, 8)  # the partition's chunks one level down
        jc, jo = jplanner._reconcile(j_ids, beams[pid][0], jnp.asarray(spec_comb), *args)
        tc, to = tplanner._reconcile(t_ids, spec_i, torch.from_numpy(spec_comb), *args)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tc.numpy().view(np.int32), np.asarray(jc).view(np.int32))


def test_owned_level_combined_matches_reference_on_carried_parts(setup):
    """One partition's owned slice through the same continuation point in
    both packages: the owned mask equal, the scores within tolerance,
    unowned rows exactly NEG_INF."""
    from repro.core.mscm import scatter_dense as j_scatter
    from repro.core.tree import owned_level_combined as j_owned
    from repro_torch.core.mscm import scatter_dense

    jt, _, xi, xv = setup
    jidx = j_partition(jt, 4)
    tidx = carry_index(jidx)
    ids, _, _, _ = _owned_inputs(jt, xi, xv, 4, 1)
    sc = np.linspace(1.0, 0.1, ids.size, dtype=np.float32).reshape(ids.shape)
    info, li = jidx.manifest.partitions[1], jidx.level
    jl, tl = jidx.parts[1].layers[0], tidx.parts[1].layers[0]
    c_real = int(jl.chunk_rows.shape[0]) - 1
    jc, jo = j_owned(jl, 8, jidx.d, jnp.asarray(xi), jnp.asarray(xv),
                     j_scatter(jnp.asarray(xi), jnp.asarray(xv), jidx.d), jnp.asarray(ids),
                     jnp.asarray(sc), jnp.int32(info.chunk_start), jnp.int32(c_real),
                     method="mscm_pallas_grouped", score_mode="prod")
    txi, txv = tensors(xi, xv)
    tc, to = owned_level_combined(tl, 8, tidx.d, txi, txv, scatter_dense(txi, txv, tidx.d),
                                  torch.from_numpy(ids).long(), torch.from_numpy(sc),
                                  info.chunk_start, c_real, method="mscm_pallas_grouped",
                                  score_mode="prod")
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    assert torch.all(tc[~to] == np.float32(-1e30))


# ---------------------------------------------------------------------------
# 3. the hot-beam cache
# ---------------------------------------------------------------------------

def test_cache_hit_bitwise_identical_to_cold(setup):
    _, tt, xi, xv = setup
    xi, xv = tensors(xi, xv)
    want = tt.infer(xi, xv, beam=10, topk=5)
    pl = ScatterGatherPlanner(partition_tree(tt, 4), beam=10, topk=5, sync="pipelined",
                              cache_entries=32)
    cold = pl.infer(xi, xv)
    misses = pl.cache.misses
    assert misses > 0
    hot = pl.infer(xi, xv)
    assert pl.cache.misses == misses and pl.cache.hits >= xi.shape[0]
    assert_planner_bits(cold, want, "mscm_dense", "pipelined")
    assert_bitwise(hot, cold)


@pytest.mark.parametrize("sync", ["level", "pipelined"])
def test_cache_partition_skip_is_bitwise(sync):
    """Narrow beams routed into few partitions: the cache skips the others
    (fewer owner sets than partitions) and no bit changes."""
    rng = np.random.default_rng(3)
    d, B = 120, 8
    ws = make_tree_weights(rng, d, [8, 64, 512], B)
    tt = XMRTree.from_weight_matrices([port_csc(w) for w in ws], B, device="cpu")
    xi, xv = tensors(*random_sparse_csr(9, d, 16, rng).to_ell())
    want = tt.infer(xi, xv, beam=2, topk=5)
    pl = ScatterGatherPlanner(partition_tree(tt, 4), beam=2, topk=5, sync=sync,
                              cache_entries=16)
    assert_planner_bits(pl.infer(xi, xv), want, "mscm_dense", sync)
    stats = pl.cache_stats()
    assert stats["misses"] > 0 and sum(stats["owner_counts"]) > 0
    # Each query's beam of 2 touches at most 2 of the 4 partitions.
    _, ids = pl._route(xi, xv, beam=2, qt=8)
    assert all(len(pl.cache.active_partitions(row[None].numpy())) <= 2 for row in ids)


def test_cache_lru_and_validation():
    cache = HotBeamCache(2, [0, 4, 8])
    assert cache.active_partitions(np.array([[0, 1]])) == [0]
    assert cache.active_partitions(np.array([[4, 5]])) == [1]
    assert cache.active_partitions(np.array([[1, 6]])) == [0, 1]  # evicts the first
    assert cache.evictions == 1
    assert cache.active_partitions(np.array([[4, 5]])) == [1]  # still resident: a hit
    assert cache.hits == 1
    stats = cache.stats()
    assert stats["entries"] == 2 and stats["capacity"] == 2
    assert abs(cache.occupancy().sum() - 1.0) < 1e-9
    # No valid id: every partition stays active.
    assert HotBeamCache(4, [0, 4, 8]).active_partitions(np.array([[99, -1]])) == [0, 1]
    for args in ((0, [0, 4]), (4, [0])):
        with pytest.raises(ValueError):
            HotBeamCache(*args)


def test_planner_validation(setup):
    _, tt, _, _ = setup
    idx = partition_tree(tt, 2)
    with pytest.raises(ValueError, match="sync"):
        ScatterGatherPlanner(idx, sync="speculative")
    with pytest.raises(ValueError, match="final"):
        ScatterGatherPlanner(idx, sync="final", cache_entries=8)
    with pytest.raises(ValueError, match="method"):
        ScatterGatherPlanner(idx, method="mscm_magic")
    with pytest.raises(ValueError, match="pipelined"):
        ScatterGatherPlanner(idx, sync="level", transport=LocalTransport(idx))
    with pytest.raises(ValueError, match="beam_cache"):
        ScatterGatherPlanner(idx, sync="pipelined", cache_entries=4,
                             transport=LocalTransport(idx))


# ---------------------------------------------------------------------------
# 4. the BeamTransport seam
# ---------------------------------------------------------------------------

def test_transport_drives_the_exchange_bitwise(setup):
    _, tt, xi, xv = setup
    xi, xv = tensors(xi, xv)
    idx = partition_tree(tt, 3)
    pl = ScatterGatherPlanner(idx, beam=10, topk=5, sync="pipelined",
                              transport=LocalTransport(idx))
    over = pl.infer(xi, xv)
    assert pl.last_degraded is None
    pl.set_transport(None)
    assert_bitwise(over, pl.infer(xi, xv))  # the same exchange, in process
    assert_planner_bits(over, tt.infer(xi, xv, beam=10, topk=5), "mscm_dense", "pipelined")
    with pytest.raises(ValueError, match="partitions"):
        pl.set_transport(LocalTransport(partition_tree(tt, 2)))


def test_transport_degraded_replay(setup):
    """A partition lost at the first step: the batch replays over the
    survivors, the lost label range is stamped on ``last_degraded`` and
    never served, and every label served keeps its exact score bits."""
    _, tt, xi, xv = setup
    xi, xv = tensors(xi, xv)
    idx = partition_tree(tt, 4)
    tr = LocalTransport(idx, lose=1)
    pl = ScatterGatherPlanner(idx, beam=10, topk=5, sync="pipelined", transport=tr)
    s, l = pl.infer(xi, xv)
    lo, hi = idx.manifest.partitions[1].label_start, idx.manifest.partitions[1].label_end
    assert tr.begins == 2  # one replay
    assert pl.last_degraded == {"partitions": [1], "label_ranges": [(lo, hi)]}
    assert not torch.any((l >= lo) & (l < hi))
    ref_s, ref_l = tt.infer(xi, xv, beam=10, topk=5)
    for q in range(xi.shape[0]):
        exact = dict(zip(ref_l[q].tolist(), ref_s[q].tolist()))
        for lab, sc in zip(l[q].tolist(), s[q].tolist()):
            if lab in exact:
                assert sc == exact[lab]


# ---------------------------------------------------------------------------
# 5. a quantize_index'ed index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync", ["level", "pipelined"])
@pytest.mark.parametrize("tier", ["int8", "fp8", "int8_pruned"])
def test_quantized_index_bitwise_dequantized_parts(setup, tier, sync):
    """``mscm_pallas_grouped_q`` over the quantized parts (the router head
    f32 through ``mscm_pallas_grouped``) is bitwise the f32 planner on the
    dequantized parts."""
    import dataclasses

    _, tt, xi, xv = setup
    xi, xv = tensors(xi, xv)
    q = quantize_index(partition_tree(tt, 4), tier=tier)
    deq = dataclasses.replace(q, parts=[dequantize_tree(p) for p in q.parts])
    got = ScatterGatherPlanner(q, beam=10, topk=5, method="mscm_pallas_grouped_q",
                               sync=sync).infer(xi, xv)
    want = ScatterGatherPlanner(deq, beam=10, topk=5, method="mscm_pallas_grouped",
                                sync=sync).infer(xi, xv)
    assert_bitwise(got, want)


@pytest.mark.parametrize("sync", ["level", "pipelined"])
@pytest.mark.parametrize("tier", ["int8", "fp8", "int8_pruned"])
def test_quantized_index_bitwise_unpartitioned_f32_head(setup, tier, sync):
    """The quantized index against the unpartitioned tree with the router
    levels f32 and, below them, the whole tree's codes dequantized:
    per-(chunk, column) scales (and a per-chunk re-pack) make the cut's
    codes the whole tree's, so it is bitwise."""
    from repro_torch.quant import quantize_tree

    _, tt, xi, xv = setup
    xi, xv = tensors(xi, xv)
    q = quantize_index(partition_tree(tt, 4), tier=tier)
    deq = dequantize_tree(quantize_tree(tt, tier=tier))
    whole = XMRTree(layers=tt.layers[:q.level] + deq.layers[q.level:], n_cols=tt.n_cols,
                    branching=tt.branching, d=tt.d)
    got = ScatterGatherPlanner(q, beam=10, topk=5, method="mscm_pallas_grouped_q",
                               sync=sync).infer(xi, xv)
    assert_bitwise(got, whole.infer(xi, xv, beam=10, topk=5, method="mscm_pallas_grouped"))


def test_quantized_index_matches_reference(setup):
    jt, _, xi, xv = setup
    jidx = j_quantize_index(j_partition(jt, 4), tier="int8")
    kw = dict(beam=10, topk=5, method="mscm_pallas_grouped_q", sync="pipelined")
    sj, lj = JPlanner(jidx, **kw).infer(jnp.asarray(xi), jnp.asarray(xv))
    st, lt = ScatterGatherPlanner(carry_index(jidx), **kw).infer(*tensors(xi, xv))
    check_ranking(st.numpy(), lt.numpy(), np.asarray(sj), np.asarray(lj))


def test_profile_and_hit_counts(setup):
    _, tt, xi, xv = setup
    xi, xv = tensors(xi, xv)
    pl = ScatterGatherPlanner(partition_tree(tt, 4), beam=10, topk=10)
    _, l = pl.infer(xi, xv)
    hits = pl.hit_counts(l.numpy())
    assert hits.sum() == l.numel() and len(hits) == 4
    prof = pl.profile(xi, xv)
    assert len(prof) == 4 and all(ms >= 0 for ms in prof)
