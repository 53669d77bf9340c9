"""PyTorch port, tree inference: the port's beam search against the reference.

Both packages score the same queries on the same weights, through the same
method. The port runs on the CPU (each kernel's plain version); the
reference's Pallas kernels run in interpret mode, as its own tests run them.
Scores agree within ``rtol=1e-5, atol=1e-6`` (the tolerance ``test_tree.py``
uses across methods); labels agree wherever the reference's score gap to a
neighbour exceeds that tolerance (``repro_torch.parity.check_ranking``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import XMRTree as JTree
from repro.sparse import random_sparse_csc, random_sparse_csr
from repro_torch.convert import LAYER_FIELDS, tree_from_numpy
from repro_torch.core import mscm as TM
from repro_torch.core.tree import XMRTree
from repro_torch.parity import check_ranking as assert_same_ranking
from repro_torch.sparse.csr import CSC
from tests.conftest import brute_force_scores, make_tree_weights

#: The methods this file holds against the reference, besides the grouped one.
ONLINE_METHODS = ("vanilla", "mscm_searchsorted", "mscm_pallas", "mscm_pallas_pregather")


def port_csc(w):
    return CSC(w.indptr, w.indices, w.data, tuple(w.shape))


def both_trees(ws, branching):
    return (JTree.from_weight_matrices(ws, branching),
            XMRTree.from_weight_matrices([port_csc(w) for w in ws], branching, device="cpu"))


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(1234)
    d, B = 150, 8
    ws = make_tree_weights(rng, d, [8, 64, 512], B)
    jt, tt = both_trees(ws, B)
    x = random_sparse_csr(12, d, 18, rng)
    xi, xv = x.to_ell()
    return jt, tt, ws, x, xi, xv


def _run(jt, tt, xi, xv, **kw):
    sj, lj = jt.infer(jnp.asarray(xi), jnp.asarray(xv), **kw)
    st, lt = tt.infer(torch.from_numpy(xi), torch.from_numpy(xv), **kw)
    return (st.numpy(), lt.numpy()), (np.asarray(sj), np.asarray(lj))


@pytest.mark.parametrize("score_mode", ["prod", "logsum"])
def test_dense_matches_reference(small, score_mode):
    jt, tt, _, _, xi, xv = small
    got, want = _run(jt, tt, xi, xv, beam=10, topk=5, method="mscm_dense",
                     score_mode=score_mode)
    assert_same_ranking(*got, *want)


@pytest.mark.parametrize("beam,qt,score_mode", [
    (1, 4, "prod"), (1, 8, "prod"), (10, 4, "prod"), (10, 8, "prod"), (10, 8, "logsum"),
])
def test_grouped_matches_reference(small, beam, qt, score_mode):
    jt, tt, _, _, xi, xv = small
    got, want = _run(jt, tt, xi, xv, beam=beam, topk=5, method="mscm_pallas_grouped",
                     qt=qt, score_mode=score_mode)
    assert_same_ranking(*got, *want)


@pytest.mark.parametrize("score_mode", ["prod", "logsum"])
@pytest.mark.parametrize("method", ONLINE_METHODS)
def test_methods_match_reference(small, method, score_mode):
    jt, tt, _, _, xi, xv = small
    got, want = _run(jt, tt, xi, xv, beam=10, topk=5, method=method, score_mode=score_mode)
    assert_same_ranking(*got, *want)


def test_vanilla_and_searchsorted_build_no_dense_table(small, monkeypatch):
    """Only the methods that read the dense query table build it."""
    jt, tt, _, _, xi, xv = small
    want = _run(jt, tt, xi, xv, beam=10, topk=5, method="mscm_dense")[1]

    def no_table(*args):
        raise AssertionError("scatter_dense called")

    monkeypatch.setattr(TM, "scatter_dense", no_table)
    for method in ("vanilla", "mscm_searchsorted"):
        s, l = tt.infer(torch.from_numpy(xi), torch.from_numpy(xv), beam=10, topk=5,
                        method=method)
        assert_same_ranking(s.numpy(), l.numpy(), *want)
    with pytest.raises(AssertionError, match="scatter_dense"):
        tt.infer(torch.from_numpy(xi), torch.from_numpy(xv), method="mscm_pallas")


def test_exact_search_equals_brute_force(small):
    _, tt, ws, x, xi, xv = small
    ref = brute_force_scores(x.to_dense(), ws)
    ref_top = np.argsort(-ref, axis=1, kind="stable")[:, :5]
    s, l = tt.infer(torch.from_numpy(xi), torch.from_numpy(xv), beam=512, topk=5,
                    method="mscm_pallas_grouped")
    assert_same_ranking(s.numpy(), l.numpy(), np.take_along_axis(ref, ref_top, 1), ref_top)


def _odd_tree(kind):
    rng = np.random.default_rng(99)
    if kind == "ragged":  # L % B != 0 (phantom columns) and beam % qt != 0
        d = 80
        ws = [random_sparse_csc(d, 6, 8, rng), random_sparse_csc(d, 42, 8, rng)]
        branching, kw = [6, 8], dict(beam=5, topk=7, qt=4)
    else:
        d = 90
        ws = make_tree_weights(rng, d, [4, 32], 8)
        branching, kw = [4, 8], dict(beam=3, topk=4, qt=8)
    jt, tt = both_trees(ws, branching)
    x = random_sparse_csr(20, d, 12, rng)
    return jt, tt, ws, x.to_ell(), kw


@pytest.mark.parametrize("kind", ["ragged", "nonuniform"])
def test_grouped_ragged_and_nonuniform_trees(kind):
    jt, tt, ws, (xi, xv), kw = _odd_tree(kind)
    got, want = _run(jt, tt, xi, xv, method="mscm_pallas_grouped", **kw)
    assert_same_ranking(*got, *want)
    assert got[1].max() < ws[-1].shape[1]


@pytest.mark.parametrize("method", ONLINE_METHODS)
@pytest.mark.parametrize("kind", ["ragged", "nonuniform"])
def test_methods_on_ragged_and_nonuniform_trees(kind, method):
    jt, tt, ws, (xi, xv), kw = _odd_tree(kind)
    kw.pop("qt")
    got, want = _run(jt, tt, xi, xv, method=method, **kw)
    assert_same_ranking(*got, *want)
    assert got[1].max() < ws[-1].shape[1]


def test_continuation_with_clamped_chunks(small):
    """An external beam with ids past the last chunk: clamp_chunks parks
    them on the last chunk in both packages."""
    jt, tt, _, _, xi, xv = small
    rng = np.random.default_rng(5)
    init_ids = rng.integers(0, 12, size=(xi.shape[0], 3)).astype(np.int32)  # 8 chunks
    init_s = rng.random((xi.shape[0], 3)).astype(np.float32)
    sj, lj = jt.infer(jnp.asarray(xi), jnp.asarray(xv), beam=6, topk=4,
                      method="mscm_dense", init_parent_ids=jnp.asarray(init_ids),
                      init_scores=jnp.asarray(init_s), clamp_chunks=True)
    for method in ("mscm_dense", "mscm_pallas_grouped") + ONLINE_METHODS:
        st, lt = tt.infer(torch.from_numpy(xi), torch.from_numpy(xv), beam=6, topk=4,
                          method=method, init_parent_ids=torch.from_numpy(init_ids),
                          init_scores=torch.from_numpy(init_s), clamp_chunks=True)
        assert_same_ranking(st.numpy(), lt.numpy(), np.asarray(sj), np.asarray(lj))


def test_tree_from_numpy_round_trip(small):
    jt, tt, _, _, xi, xv = small
    layers = [{f: np.asarray(getattr(l, f)) for f in LAYER_FIELDS} for l in jt.layers]
    conv = tree_from_numpy(layers, jt.n_cols, jt.branching, jt.d, device="cpu")
    assert (conv.n_cols, conv.branching, conv.d) == (tt.n_cols, tt.branching, tt.d)
    for a, b in zip(conv.layers, tt.layers):
        for f in LAYER_FIELDS:
            ta, tb = getattr(a, f), getattr(b, f)
            assert ta.dtype == tb.dtype
            assert torch.equal(ta, tb)
    assert conv.memory_bytes() == jt.memory_bytes()
    for method in ("mscm_pallas_grouped",) + ONLINE_METHODS:
        got, want = _run(jt, conv, xi, xv, beam=10, topk=5, method=method)
        assert_same_ranking(*got, *want)
    with pytest.raises(ValueError):
        tree_from_numpy(layers[:1], jt.n_cols, jt.branching, jt.d, device="cpu")


def test_entry_points_need_a_gpu_or_explicit_cpu(small, monkeypatch):
    jt, _, ws, _, _, _ = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layers = [{f: np.asarray(getattr(l, f)) for f in LAYER_FIELDS} for l in jt.layers]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        XMRTree.from_weight_matrices([port_csc(w) for w in ws], 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tree_from_numpy(layers, jt.n_cols, jt.branching, jt.d)


@pytest.mark.parametrize("method", ["mscm_pallas_grouped_q"])
def test_unported_methods_raise(small, method):
    """Every method is ported; the quantized one raises on an f32 tree,
    which has no scales to dequantize with."""
    _, tt, _, _, xi, xv = small
    with pytest.raises(ValueError, match="quantize_tree"):
        tt.infer(torch.from_numpy(xi), torch.from_numpy(xv), method=method)
    with pytest.raises(ValueError, match="unknown method"):
        tt.infer(torch.from_numpy(xi), torch.from_numpy(xv), method="mscm_pallas_grouped_q8")
