"""PyTorch port, MSCM kernels and the grouped level around them.

The reference's functions and the port's run on the same seeded inputs.
Integer outputs (tile bounds, the four grouping outputs, host grouping) are
compared bitwise; f32 results within ``rtol=1e-5, atol=1e-6``. The
reference's grouped Pallas kernel runs in interpret mode; the port's
wrapper takes its plain version because the tensors lie on the CPU. The
CUDA kernel itself is held against the plain version on a GPU by
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mscm as JM
from repro.core.chunked import ChunkedLayer
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mscm_kernel import group_blocks_by_chunk as j_group_host
from repro.kernels.mscm_kernel import mscm_grouped as j_mscm_grouped
from repro.sparse import random_sparse_csc, random_sparse_csr
from repro_torch.core import mscm as TM
from repro_torch.kernels import mscm_kernel as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL, ATOL = 1e-5, 1e-6
T = torch.from_numpy


def _mk(seed, n=6, d=90, C=5, B=8, nnz_w=8, nnz_x=10, A=13):
    rng = np.random.default_rng(seed)
    w = random_sparse_csc(d, C * B, nnz_w, rng, sibling_groups=B)
    ch = ChunkedLayer.from_csc(w, B)
    x = random_sparse_csr(n, d, nnz_x, rng)
    xi, xv = x.to_ell()
    bq = rng.integers(0, n, size=A).astype(np.int32)
    bc = rng.integers(0, C, size=A).astype(np.int32)
    ps = rng.random(A).astype(np.float32)
    return dict(xi=xi, xv=xv, d=d, rows=ch.rows, vals=ch.vals, bq=bq, bc=bc, ps=ps)


def test_scatter_dense_bitwise():
    m = _mk(0)
    xi = m["xi"].copy()
    xi[0, -1] = m["d"] + 5  # out of range: dropped by both
    want = np.asarray(JM.scatter_dense(jnp.asarray(xi), jnp.asarray(m["xv"]), m["d"]))
    got = TM.scatter_dense(T(xi), T(m["xv"]), m["d"]).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, -1] == 0).all()


@pytest.mark.parametrize("seed", [1, 2])
def test_dense_lookup_and_ref_match(seed):
    m = _mk(seed)
    xd_j = JM.scatter_dense(jnp.asarray(m["xi"]), jnp.asarray(m["xv"]), m["d"])
    xd_t = TM.scatter_dense(T(m["xi"]), T(m["xv"]), m["d"])
    args_j = [jnp.asarray(m[k]) for k in ("rows", "vals", "bq", "bc")]
    args_t = [T(m[k]) for k in ("rows", "vals", "bq", "bc")]
    want = np.asarray(jref.mscm_ref(xd_j, *args_j))
    np.testing.assert_allclose(tref.mscm_ref(xd_t, *args_t).numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(TM.mscm_dense_lookup(xd_t, *args_t).numpy(),
                               np.asarray(JM.mscm_dense_lookup(xd_j, *args_j)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        TM.gather_query_rows(xd_t, args_t[0], args_t[2], args_t[3]).numpy(),
        np.asarray(JM.gather_query_rows(xd_j, args_j[0], args_j[2], args_j[3])))
    # the marching-pointer oracle agrees with the dense one
    q, c = int(m["bq"][0]), int(m["bc"][0])
    nz = m["xi"][q] < m["d"]
    z = tref.block_ref_marching(m["xi"][q][nz], m["xv"][q][nz], m["rows"][c], m["vals"][c], m["d"])
    np.testing.assert_allclose(z, want[0], rtol=RTOL, atol=ATOL)


def test_grouped_tile_bound_matches():
    for a in (1, 7, 64, 640):
        for qt in (1, 4, 8):
            for c in (1, 5, 1024):
                assert tops.grouped_tile_bound(a, qt, c) == jops.grouped_tile_bound(a, qt, c)


@pytest.mark.parametrize("qt", [1, 4, 8])
def test_grouping_bitwise(qt):
    """All four device-grouping outputs and the host grouping equal the
    reference's, including ragged last tiles."""
    rng = np.random.default_rng(qt)
    group = jax.jit(jops.group_blocks_device, static_argnums=(1, 2))
    for _ in range(4):
        a = int(rng.integers(1, 40))
        c = int(rng.integers(1, 12))
        bc = rng.integers(0, c, size=a).astype(np.int32)
        want = [np.asarray(x) for x in group(jnp.asarray(bc), qt, c)]
        got = [x.numpy() for x in tops.group_blocks_device(T(bc), qt, c)]
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        for g, w in zip(tk.group_blocks_by_chunk(bc, qt), j_group_host(bc, qt)):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_sort_and_unsort():
    rng = np.random.default_rng(3)
    bc = rng.integers(0, 5, size=17).astype(np.int32)
    bq = np.arange(17, dtype=np.int32)
    jq, jc, jo = jops.sort_blocks_by_chunk(jnp.asarray(bq), jnp.asarray(bc))
    tq, tc, to = tops.sort_blocks_by_chunk(T(bq), T(bc))
    for g, w in ((tq, jq), (tc, jc), (to, jo)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = rng.random((17, 4)).astype(np.float32)
    np.testing.assert_array_equal(tops.unsort(T(x)[to], to).numpy(), x)


@pytest.mark.parametrize("mode", ["none", "prod", "logsum"])
def test_grouped_plain_matches_pallas_interpret(mode):
    rng = np.random.default_rng(11)
    t, qt, r, b, c = 5, 4, 16, 8, 3
    xg = rng.random((t, qt, r)).astype(np.float32)
    vals = rng.standard_normal((c, r, b)).astype(np.float32)
    tc = np.sort(rng.integers(0, c, size=t)).astype(np.int32)
    ps = rng.random((t, qt)).astype(np.float32)
    p_j = None if mode == "none" else jnp.asarray(ps)
    p_t = None if mode == "none" else T(ps)
    want = j_mscm_grouped(jnp.asarray(xg), jnp.asarray(vals), jnp.asarray(tc), p_j,
                          mode=mode, interpret=True)
    before = tk.GROUPED_LAUNCHES
    got = tk.mscm_grouped(T(xg), T(vals), T(tc).long(), p_t, mode=mode)
    assert tk.GROUPED_LAUNCHES == before  # CPU tensors never launch the kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        got.numpy(), tk.mscm_grouped_plain(T(xg), T(vals), T(tc), p_t, mode=mode).numpy())


@pytest.mark.parametrize("mode,qt", [("none", 4), ("prod", 8), ("logsum", 2)])
def test_grouped_level_matches_reference(mode, qt):
    m = _mk(20 + qt, A=17)
    xd_j = JM.scatter_dense(jnp.asarray(m["xi"]), jnp.asarray(m["xv"]), m["d"])
    xd_t = TM.scatter_dense(T(m["xi"]), T(m["xv"]), m["d"])
    ps_j = None if mode == "none" else jnp.asarray(m["ps"])
    ps_t = None if mode == "none" else T(m["ps"])
    want = jops.mscm_pallas_grouped(
        xd_j, *[jnp.asarray(m[k]) for k in ("rows", "vals", "bq", "bc")], ps_j,
        qt=qt, mode=mode, interpret=True)
    got = tops.mscm_pallas_grouped(
        xd_t, *[T(m[k]) for k in ("rows", "vals", "bq", "bc")], ps_t, qt=qt, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_grouped_wrapper_rejects_bad_arguments():
    xg, vals = torch.zeros(2, 4, 8), torch.zeros(3, 8, 6)
    tc, ps = torch.zeros(2, dtype=torch.int64), torch.zeros(2, 4)
    with pytest.raises(ValueError, match="parent_scores"):
        tk.mscm_grouped(xg, vals, tc, None, mode="prod")
    with pytest.raises(ValueError, match="mode"):
        tk.mscm_grouped(xg, vals, tc, ps, mode="max")
    with pytest.raises(TypeError):
        tk.mscm_grouped(xg, vals, tc.int(), ps, mode="prod")
    with pytest.raises(TypeError):
        tk.mscm_grouped(xg.double(), vals, tc, ps, mode="prod")
    with pytest.raises(ValueError, match="shape"):
        tk.mscm_grouped(xg, torch.zeros(3, 7, 6), tc, ps, mode="prod")
    with pytest.raises(ValueError, match="parent_scores"):
        tk.mscm_grouped(xg, vals, tc, torch.zeros(2, 3), mode="prod")

