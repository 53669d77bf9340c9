"""PyTorch port, layout slice: the numpy modules give the reference's arrays.

Sparse formats, chunk tiles, the column layout, the tree structure, the
paper shapes, benchmark queries and the benchmark model builder are each
run from the same seed in both packages and compared bitwise. The port also
imports with ``jax`` blocked and loads nothing of ``repro``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.chunked import ChunkedLayer as JChunked, ColumnELLLayer as JColumn
from repro.data import xmr_data as jdata
from repro.sparse import csr as jcsr
from repro.trees.cluster import build_tree_structure as j_build_tree_structure
from repro_torch.core.chunked import ChunkedLayer, ColumnELLLayer
from repro_torch.data import xmr_data as tdata
from repro_torch.data.build import build_benchmark_tree
from repro_torch.sparse import csr as tcsr
from repro_torch.trees.cluster import build_tree_structure

REPO = Path(__file__).resolve().parents[1]


def _same_sparse(a, b):
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)
    assert a.indices.dtype == b.indices.dtype and a.data.dtype == b.data.dtype
    assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("d,L,B,nnz", [(150, 64, 8, 10), (80, 42, 8, 8), (60, 6, 6, 5)])
def test_random_csc_and_chunk_tiles_match(d, L, B, nnz):
    wj = jcsr.random_sparse_csc(d, L, nnz, np.random.default_rng(7), sibling_groups=B)
    wt = tcsr.random_sparse_csc(d, L, nnz, np.random.default_rng(7), sibling_groups=B)
    _same_sparse(wj, wt)
    cj, ct = JChunked.from_csc(wj, B), ChunkedLayer.from_csc(wt, B)
    np.testing.assert_array_equal(cj.rows, ct.rows)
    np.testing.assert_array_equal(cj.vals, ct.vals)
    assert ct.R % 8 == 0 and ct.memory_bytes() == cj.memory_bytes()
    np.testing.assert_array_equal(ct.to_dense()[:, :L], wt.to_dense())
    colj, colt = JColumn.from_csc(wj, B), ColumnELLLayer.from_csc(wt, B)
    np.testing.assert_array_equal(colj.rows, colt.rows)
    np.testing.assert_array_equal(colj.vals, colt.vals)


@pytest.mark.parametrize("width", [None, 1, 7, 64])
def test_random_csr_and_ell_match(width):
    xj = jcsr.random_sparse_csr(30, 200, 12, np.random.default_rng(3))
    xt = tcsr.random_sparse_csr(30, 200, 12, np.random.default_rng(3))
    _same_sparse(xj, xt)
    rows = np.array([0, 29, 5, 5, 17])
    for got, want in zip(tcsr.rows_to_ell(xt, rows, width), jcsr.rows_to_ell(xj, rows, width)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for got, want in zip(xt.to_ell(width), xj.to_ell(width)):
        np.testing.assert_array_equal(got, want)


def test_tree_structure_and_shapes_match():
    for n_labels, b in [(512, 8), (42, 8), (32**4, 32), (1000, 10)]:
        sj, st = j_build_tree_structure(n_labels, b), build_tree_structure(n_labels, b)
        assert st.level_sizes == sj.level_sizes and st.depth == sj.depth
        np.testing.assert_array_equal(st.label_perm, sj.label_perm)
    assert {k: tuple(vars(v).values()) for k, v in tdata.PAPER_SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in jdata.PAPER_SHAPES.items()
    }
    assert tuple(vars(tdata.ENTERPRISE_SHAPE).values()) == tuple(
        vars(jdata.ENTERPRISE_SHAPE).values()
    )
    shape_j = jdata.PAPER_SHAPES["eurlex-4k"]
    shape_t = tdata.PAPER_SHAPES["eurlex-4k"]
    _same_sparse(
        tdata.benchmark_queries(shape_t, 20, np.random.default_rng(5)),
        jdata.benchmark_queries(shape_j, 20, np.random.default_rng(5)),
    )


def test_benchmark_tree_matches_reference():
    from benchmarks.common import build_benchmark_tree as j_build

    shape_j = jdata.XMRShape("tiny", 300, 8**3, 16, 20, 10)
    shape_t = tdata.XMRShape("tiny", 300, 8**3, 16, 20, 10)
    tj = j_build(shape_j, 8, np.random.default_rng(0), upper_nnz=12)
    tt = build_benchmark_tree(shape_t, 8, np.random.default_rng(0), upper_nnz=12, device="cpu")
    assert (tt.n_cols, tt.branching, tt.d) == (tj.n_cols, tj.branching, tj.d)
    assert tt.memory_bytes() == tj.memory_bytes()
    for lj, lt in zip(tj.layers, tt.layers):
        for f in ("chunk_rows", "chunk_vals", "col_rows", "col_vals"):
            np.testing.assert_array_equal(getattr(lt, f).numpy(), np.asarray(getattr(lj, f)))


def test_import_with_jax_blocked():
    """``repro_torch`` imports with jax unavailable and loads nothing of
    ``repro`` or ``jax``."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch, repro_torch.convert, repro_torch.data.build\n"
        "import repro_torch.kernels, repro_torch.kernels.build, repro_torch.serving\n"
        "import repro_torch.trees, repro_torch.core.tree\n"
        "bad = sorted(m for m, v in sys.modules.items()\n"
        "             if v is not None and m.split('.')[0] in ('repro', 'jax', 'jaxlib'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("d,L,B,nnz", [(150, 64, 8, 10), (60, 6, 6, 5)])
def test_csc_from_dense_nnz_and_tile_occupancy_match(d, L, B, nnz):
    """``CSC.from_dense`` and ``CSC.nnz``, ``ChunkedLayer.nnz_dense_tile``
    and ``ChunkedLayer.occupancy``: the reference's values, bitwise."""
    w = jcsr.random_sparse_csc(d, L, nnz, np.random.default_rng(2), sibling_groups=B).to_dense()
    wj, wt = jcsr.CSC.from_dense(w), tcsr.CSC.from_dense(w)
    _same_sparse(wj, wt)
    assert wt.nnz == wj.nnz == int((w != 0).sum())
    np.testing.assert_array_equal(wt.to_dense(), w)
    cj, ct = JChunked.from_csc(wj, B), ChunkedLayer.from_csc(wt, B)
    assert ct.nnz_dense_tile == cj.nnz_dense_tile == ct.C * ct.R * ct.B
    assert ct.occupancy() == cj.occupancy()
    assert ct.occupancy() == pytest.approx(wt.nnz / ct.nnz_dense_tile)
