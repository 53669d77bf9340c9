"""PyTorch port, MSCM kernels and the grouped level around them.

The reference's functions and the port's run on the same seeded inputs.
Integer outputs (tile bounds, the four grouping outputs, host grouping,
cost counters) are compared bitwise; f32 results within ``rtol=1e-5,
atol=1e-6`` (the tolerance ``test_kernels.py`` uses), bf16 inputs within
``2e-2`` as there. The reference's Pallas kernels run in interpret mode; the
port's wrappers take their plain versions because the tensors lie on the
CPU. The CUDA kernels themselves are held against the plain versions on a
GPU by ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mscm as JM
from repro.core.chunked import ChunkedLayer, ColumnELLLayer
from repro.kernels import mscm_kernel as jk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mscm_kernel import group_blocks_by_chunk as j_group_host
from repro.kernels.mscm_kernel import mscm_grouped as j_mscm_grouped
from repro.sparse import random_sparse_csc, random_sparse_csr
from repro_torch import obs
from repro_torch.core import mscm as TM
from repro_torch.kernels import mscm_kernel as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL, ATOL = 1e-5, 1e-6
T = torch.from_numpy


def _mk(seed, n=6, d=90, C=5, B=8, nnz_w=8, nnz_x=10, A=13, L=None):
    """Seeded inputs; ``L`` columns (default C*B) with L % B != 0 make a
    ragged layer, whose column layout has phantom columns."""
    rng = np.random.default_rng(seed)
    w = random_sparse_csc(d, L or C * B, nnz_w, rng, sibling_groups=B)
    ch = ChunkedLayer.from_csc(w, B)
    col = ColumnELLLayer.from_csc(w, B)
    x = random_sparse_csr(n, d, nnz_x, rng)
    xi, xv = x.to_ell()
    bq = rng.integers(0, n, size=A).astype(np.int32)
    bc = rng.integers(0, ch.C, size=A).astype(np.int32)
    ps = rng.random(A).astype(np.float32)
    return dict(xi=xi, xv=xv, d=d, rows=ch.rows, vals=ch.vals, bq=bq, bc=bc, ps=ps,
                col_rows=col.rows, col_vals=col.vals, B=B, w=w)


def _dense(m):
    """The dense query table of ``m`` in both packages."""
    return (JM.scatter_dense(jnp.asarray(m["xi"]), jnp.asarray(m["xv"]), m["d"]),
            TM.scatter_dense(T(m["xi"]), T(m["xv"]), m["d"]))


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
    before = obs.total("launches.mscm_grouped")
    got = tk.mscm_grouped(T(xg), T(vals), T(tc).long(), p_t, mode=mode)
    assert obs.total("launches.mscm_grouped") == before  # CPU tensors never launch the kernel
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



def _padded_tiles(seed, t=6, qt=4, r=16, b=8, c=3, live=3):
    """Seeded grouped inputs and a ``tile_src`` whose tiles from ``live`` on
    are padding (as ``group_blocks_device`` leaves them, at the tail), the
    last live tile part full."""
    rng = np.random.default_rng(seed)
    xg = T(rng.random((t, qt, r)).astype(np.float32))
    vals = T(rng.standard_normal((c, r, b)).astype(np.float32))
    tc = T(np.sort(rng.integers(0, c, size=t))).long()
    ps = T(rng.random((t, qt)).astype(np.float32))
    src = torch.arange(t * qt).reshape(t, qt)
    src[live:] = -1
    src[live - 1, qt // 2:] = -1
    return xg, vals, tc, ps, src


@pytest.mark.parametrize("mode", ["none", "prod", "logsum"])
def test_grouped_plain_zeroes_padding_tiles(mode):
    """Padding tiles (tile_src[t, 0] < 0) give zeros; live tiles, padding
    slots included, are the result without tile_src, bitwise."""
    xg, vals, tc, ps, src = _padded_tiles(40)
    p = None if mode == "none" else ps
    got = tk.mscm_grouped(xg, vals, tc, p, mode=mode, tile_src=src)
    old = tk.mscm_grouped_plain(xg, vals, tc, p, mode=mode)
    live = src[:, 0] >= 0
    assert torch.equal(got[live], old[live])
    assert not got[~live].any()
    assert torch.equal(got, tk.mscm_grouped_plain(xg, vals, tc, p, mode=mode, tile_src=src))


def test_grouped_wrapper_rejects_bad_tile_src():
    xg, vals, tc, ps, src = _padded_tiles(41)
    with pytest.raises(ValueError, match="tile_src"):
        tk.mscm_grouped(xg, vals, tc, ps, mode="prod", tile_src=src[:, :2])
    with pytest.raises(TypeError, match="tile_src"):
        tk.mscm_grouped(xg, vals, tc, ps, mode="prod", tile_src=src.int())


@pytest.mark.parametrize("mode,qt", [("none", 4), ("prod", 8), ("logsum", 2)])
def test_grouped_level_passes_tile_src(mode, qt):
    """The level hands its product the grouping's tile_src, and its [A, B]
    still matches the reference's."""
    m = _mk(60 + qt, A=19)
    xd_j, xd_t = _dense(m)
    ps_j = None if mode == "none" else jnp.asarray(m["ps"])
    ps_t = None if mode == "none" else T(m["ps"])
    seen = []

    def product(xg, tc, ps, tile_src):
        seen.append(tile_src)
        return tk.mscm_grouped(xg, T(m["vals"]), tc, ps, mode=mode, tile_src=tile_src)

    got = tops.mscm_grouped_level(xd_t, *[T(m[k]) for k in ("rows", "vals", "bq", "bc")], ps_t,
                                  qt=qt, mode=mode, product=product)
    want_src = tops.group_blocks_device(T(m["bc"]).long(), qt, m["vals"].shape[0])[1]
    assert len(seen) == 1 and torch.equal(seen[0], want_src)
    want = jops.mscm_pallas_grouped(
        xd_j, *[jnp.asarray(m[k]) for k in ("rows", "vals", "bq", "bc")], ps_j,
        qt=qt, mode=mode, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# The grouped kernel's launch plan. (T, QT, R, B): the path's leaf level, the
# pruned tier's R, the card tests' edge shapes, a tile over 227 KB, a grid
# that needs more CTAs than the card holds, QT = 1; then shapes past the caps
# the plan had before row groups and windows: QT = 24 (a short row group)
# and 32, B = 1024 at QT = 16, B = 4096 at QT = 1 and 17, and R in passes.
GROUPED_PLAN_SHAPES = [(640, 8, 496, 32), (640, 8, 248, 32), (1, 4, 8, 6), (1, 4, 8, 8),
                       (3, 16, 100, 70), (5, 2, 37, 8), (4, 16, 1040, 72), (100_000, 8, 496, 32),
                       (7, 1, 4, 1), (300, 16, 600, 72), (300, 16, 1300, 64),
                       (640, 32, 496, 32), (40, 24, 496, 32), (640, 16, 496, 1024),
                       (640, 1, 496, 4096), (3, 17, 40, 4096), (16, 16, 1300, 1000),
                       (9, 24, 100, 1030)]

# The plans grouped_launch_plan gave before row groups and windows, (T, QT,
# R, B), elem_bytes ->
# (pass_rows, passes, warp_rows, slab_rows, slabs, stages, grid, bulk_xg,
# bulk_tile, bulk_scales, smem_bytes): every shape under its caps keeps its
# plan, the last eight at the old largest B for each QT.
OLD_GROUPED_PLANS = {
    ((640, 8, 496, 32), 4): (496, 1, 64, 128, 4, 2, 132, True, True, False, 168672),
    ((640, 8, 496, 32), 1): (496, 1, 64, 128, 4, 2, 264, True, True, True, 73440),
    ((640, 8, 248, 32), 4): (248, 1, 32, 64, 4, 2, 264, True, True, False, 89312),
    ((640, 8, 248, 32), 1): (248, 1, 32, 64, 4, 2, 264, True, True, True, 41696),
    ((1, 4, 8, 6), 4): (8, 1, 4, 8, 1, 2, 1, True, True, False, 2464),
    ((1, 4, 8, 6), 1): (8, 1, 4, 8, 1, 2, 1, True, True, False, 2176),
    ((1, 4, 8, 8), 4): (8, 1, 4, 8, 1, 2, 1, True, True, False, 2848),
    ((1, 4, 8, 8), 1): (8, 1, 4, 8, 1, 2, 1, True, True, True, 2464),
    ((3, 16, 100, 70), 4): (100, 1, 16, 32, 4, 2, 3, True, True, False, 107744),
    ((3, 16, 100, 70), 1): (100, 1, 16, 32, 4, 2, 3, True, False, False, 65760),
    ((5, 2, 37, 8), 4): (37, 1, 8, 16, 3, 2, 5, False, True, False, 4320),
    ((5, 2, 37, 8), 1): (37, 1, 8, 16, 3, 2, 5, False, False, True, 2560),
    ((4, 16, 1040, 72), 4): (544, 2, 68, 136, 4, 1, 4, True, True, False, 231168),
    ((4, 16, 1040, 72), 1): (544, 2, 68, 136, 4, 2, 4, True, True, True, 187936),
    ((100000, 8, 496, 32), 4): (496, 1, 64, 128, 4, 2, 3125, True, True, False, 168672),
    ((100000, 8, 496, 32), 1): (496, 1, 64, 128, 4, 2, 3125, True, True, True, 73440),
    ((7, 1, 4, 1), 4): (4, 1, 4, 8, 1, 2, 7, True, True, False, 736),
    ((7, 1, 4, 1), 1): (4, 1, 4, 8, 1, 2, 7, True, False, False, 736),
    ((300, 16, 600, 72), 4): (544, 2, 68, 136, 4, 1, 132, True, True, False, 231168),
    ((300, 16, 600, 72), 1): (544, 2, 68, 136, 4, 2, 132, True, True, True, 187936),
    ((300, 16, 1300, 64), 4): (608, 3, 76, 152, 4, 1, 132, True, True, False, 230112),
    ((300, 16, 1300, 64), 1): (608, 3, 76, 152, 4, 2, 132, True, True, True, 191456),
    ((640, 1, 496, 1412), 4): (32, 16, 4, 8, 4, 1, 132, True, True, False, 232304),
    ((640, 1, 496, 1412), 1): (32, 16, 4, 8, 4, 2, 132, True, True, True, 147712),
    ((640, 1, 5000, 1412), 4): (32, 157, 4, 8, 4, 1, 132, True, True, False, 232304),
    ((640, 1, 5000, 1412), 1): (32, 157, 4, 8, 4, 2, 132, True, True, True, 147712),
    ((640, 4, 496, 888), 4): (32, 16, 4, 8, 4, 1, 132, True, True, False, 232384),
    ((640, 4, 496, 888), 1): (32, 16, 4, 8, 4, 2, 132, True, True, True, 179616),
    ((640, 4, 5000, 888), 4): (32, 157, 4, 8, 4, 1, 132, True, True, False, 232384),
    ((640, 4, 5000, 888), 1): (32, 157, 4, 8, 4, 2, 132, True, True, True, 179616),
    ((640, 8, 496, 592), 4): (32, 16, 4, 8, 4, 1, 132, True, True, False, 232224),
    ((640, 8, 496, 592), 1): (32, 16, 4, 8, 4, 2, 132, True, True, True, 197728),
    ((640, 8, 5000, 592), 4): (32, 157, 4, 8, 4, 1, 132, True, True, False, 232224),
    ((640, 8, 5000, 592), 1): (32, 157, 4, 8, 4, 2, 132, True, True, True, 197728),
    ((640, 16, 496, 353), 4): (32, 16, 4, 8, 4, 1, 132, True, True, False, 231920),
    ((640, 16, 496, 353), 1): (32, 16, 4, 8, 4, 2, 132, True, False, False, 212800),
    ((640, 16, 5000, 353), 4): (32, 157, 4, 8, 4, 1, 132, True, True, False, 231920),
    ((640, 16, 5000, 353), 1): (32, 157, 4, 8, 4, 2, 132, True, False, False, 212800),
}


def grouped_ranges(plan, r):
    """(pass, warp, slab, first row, rows) of every warp range that
    csrc/mscm_grouped.cu computes: warp w takes rows [w * warp_rows,
    (w + 1) * warp_rows) of each pass."""
    for ps in range(plan.passes):
        r0 = ps * plan.pass_rows
        nr = min(plan.pass_rows, r - r0)
        for w in range(8):
            w0, k1 = w * plan.warp_rows, min(nr, (w + 1) * plan.warp_rows)
            if w0 < k1:
                yield ps, w, w0 // plan.slab_rows, r0 + w0, k1 - w0


@pytest.mark.parametrize("elem_bytes", [4, 1])
@pytest.mark.parametrize("shape", GROUPED_PLAN_SHAPES)
def test_grouped_plan_covers_every_row_once(shape, elem_bytes):
    """Every row of R in one warp range of one pass; every output (row of
    QT, column of B) of a tile in exactly one item; no CTA walks more than
    GROUPED_MAX_TILES items."""
    t, qt, r, b = shape
    plan = tk.grouped_launch_plan(t, qt, r, b, elem_bytes)
    seen = np.zeros(r, np.int64)
    for ps, _, slab, first, n in grouped_ranges(plan, r):
        seen[first:first + n] += 1
        local = first - ps * plan.pass_rows
        assert slab < plan.slabs <= 4
        assert (local + n - 1) // plan.slab_rows == slab  # a warp's rows lie in one slab
    np.testing.assert_array_equal(seen, 1)
    assert plan.warp_rows % 4 == 0 and plan.slab_rows == 2 * plan.warp_rows
    assert plan.passes == -(-r // plan.pass_rows)
    items = plan.items(t)
    assert items == t * plan.row_groups * plan.windows
    assert 1 <= plan.grid <= items and plan.grid * tk.GROUPED_MAX_TILES >= items
    assert plan.stages in (1, 2)
    assert plan.group_rows == min(qt, tk.GROUPED_MAX_QT)
    out = np.zeros((min(t, 2), qt, b), np.int64)
    for v in range(min(t, 2) * plan.row_groups * plan.windows):
        ti, row0, h, col0, cols = tk.grouped_item(plan, v, qt, b)
        assert 1 <= h <= plan.group_rows and 1 <= cols <= plan.window_cols
        out[ti, row0:row0 + h, col0:col0 + cols] += 1
    np.testing.assert_array_equal(out, 1)


@pytest.mark.parametrize("elem_bytes", [4, 1])
@pytest.mark.parametrize("shape", GROUPED_PLAN_SHAPES)
def test_grouped_plan_bulk_copies_are_16_byte_aligned(shape, elem_bytes):
    """Every bulk copy (the query rows of xg [T, QT, R] of an item's row
    group, the tile rows of vals [C, R, B] by slab, or by row of a window,
    the scale row of scales [C, B] of a window) starts and ends on 16
    bytes, for any tile t and chunk c."""
    t, qt, r, b = shape
    plan = tk.grouped_launch_plan(t, qt, r, b, elem_bytes)
    xr = -(-plan.pass_rows // 4) * 4
    for v in range(plan.row_groups * plan.windows):
        _, row0, h, col0, cols = tk.grouped_item(plan, v, qt, b)
        for i in (0, 1, 7):
            for ps in range(plan.passes):
                r0 = ps * plan.pass_rows
                nr = min(plan.pass_rows, r - r0)
                if plan.bulk_xg:
                    copies = ([((i * qt + row0) * r, h * nr)] if xr == r else
                              [((i * qt + row0 + q) * r + r0, nr) for q in range(h)])
                    for start, n in copies:
                        assert start * 4 % 16 == 0 and n * 4 % 16 == 0
                if plan.bulk_tile:
                    for j in range(plan.slabs):
                        rows = min(plan.slab_rows, nr - j * plan.slab_rows)
                        first = i * r + r0 + j * plan.slab_rows
                        if rows <= 0:
                            continue
                        if plan.windows == 1:
                            copies = [(first * b, rows * b)]
                        else:
                            copies = [((first + k) * b + col0, cols) for k in range(rows)]
                        for start, n in copies:
                            assert start * elem_bytes % 16 == 0 and n * elem_bytes % 16 == 0
            if plan.bulk_scales:
                assert (i * b + col0) * 4 % 16 == 0 and cols * 4 % 16 == 0
    assert not (elem_bytes == 4 and plan.bulk_scales)  # f32 tiles have no scale row


def test_grouped_plan_unaligned_shapes_take_ordinary_loads():
    assert not tk.grouped_launch_plan(3, 16, 100, 70, 1).bulk_tile    # 7,000-byte int8 tiles
    assert not tk.grouped_launch_plan(3, 16, 100, 70, 1).bulk_scales  # 280-byte scale rows
    assert tk.grouped_launch_plan(3, 16, 100, 70, 4).bulk_tile
    assert not tk.grouped_launch_plan(5, 2, 37, 8, 4).bulk_xg          # R % 4 != 0
    none = tk.grouped_launch_plan(640, 8, 496, 32, 1, aligned=False)   # a misaligned view
    assert not (none.bulk_xg or none.bulk_tile or none.bulk_scales)
    main = tk.grouped_launch_plan(640, 8, 496, 32, 1)
    assert main.bulk_xg and main.bulk_tile and main.bulk_scales
    # Windows of B = 1030: rows of 1,030 codes (or 4,120 bytes of f32) are
    # off 16 bytes, so a window's rows go by ordinary loads in both.
    for elem_bytes in (1, 4):
        plan = tk.grouped_launch_plan(9, 24, 100, 1030, elem_bytes)
        assert plan.windows > 1 and not plan.bulk_tile


@pytest.mark.parametrize("elem_bytes", [4, 1])
@pytest.mark.parametrize("shape", GROUPED_PLAN_SHAPES)
def test_grouped_plan_fits_shared_memory(shape, elem_bytes):
    """Within 227 KB; passes only when an item does not fit, and the same
    windows and passes for f32 and int8/fp8 tiles (the same order of sums)."""
    t, qt, r, b = shape
    plan = tk.grouped_launch_plan(t, qt, r, b, elem_bytes)
    assert plan.smem_bytes <= tk.GROUPED_SMEM_LIMIT
    assert plan.smem_bytes == tk.grouped_smem_bytes(plan.group_rows, plan.window_cols,
                                                    elem_bytes, plan.pass_rows, plan.stages)
    f32 = tk.grouped_launch_plan(t, qt, r, b, 4)
    assert (plan.pass_rows, plan.window_cols) == (f32.pass_rows, f32.window_cols)
    if plan.passes > 1:
        assert tk.grouped_smem_bytes(plan.group_rows, plan.window_cols, 4, r,
                                     1) > tk.GROUPED_SMEM_LIMIT
        assert plan.pass_rows % 32 == 0
    if plan.windows > 1:
        assert plan.window_cols % tk.GROUPED_WINDOW_STEP == 0
        assert plan.pass_rows >= min(r, 128) and f32.stages == 2


def test_grouped_plan_rejects_qt_above_the_cap():
    """QT has no cap: above GROUPED_MAX_QT a tile runs as row groups of 16
    rows, the last one short, and B as wide as one window takes stays one
    window. The plan still rejects what no kernel runs: R < 1, T < 0, an
    unknown element size."""
    assert tk.grouped_launch_plan(640, tk.GROUPED_MAX_QT, 496, 32, 4).grid == 132
    for qt, groups in ((17, 2), (24, 2), (32, 2), (33, 3)):
        for elem_bytes in (4, 1):
            plan = tk.grouped_launch_plan(640, qt, 496, 32, elem_bytes)
            assert (plan.group_rows, plan.row_groups, plan.windows) == (16, groups, 1)
            same = tk.grouped_launch_plan(640, 16, 496, 32, elem_bytes)
            assert plan._replace(grid=same.grid, row_groups=1) == same
            assert plan.items(640) == 640 * groups
    with pytest.raises(ValueError):
        tk.grouped_launch_plan(640, 8, 0, 32, 4)
    with pytest.raises(ValueError):
        tk.grouped_launch_plan(640, 8, 496, 32, 2)
    with pytest.raises(ValueError):
        tk.grouped_launch_plan(-1, 8, 496, 32, 4)
    with pytest.raises(ValueError):
        tk.grouped_launch_plan(640, 0, 496, 32, 4)
    wide = tk.grouped_launch_plan(1, 16, 64, 20_000, 4)
    assert wide.windows > 1 and wide.smem_bytes <= tk.GROUPED_SMEM_LIMIT


@pytest.mark.parametrize("qt,b_max", [(1, 1412), (4, 888), (8, 592), (16, 353)])
@pytest.mark.parametrize("r", [496, 5000])
def test_grouped_plan_rejects_b_past_its_limit(qt, b_max, r):
    """B has no limit: up to the widest B whose warps' partials [8, QT, B]
    and one pass of 32 rows fit (the old limit), the plan is the old one, one
    window; one column more goes in windows of a multiple of 16 columns,
    two stages of at least 128 rows, within shared memory."""
    for elem_bytes in (4, 1):
        at = tk.grouped_launch_plan(640, qt, r, b_max, elem_bytes)
        assert tuple(at)[:11] == OLD_GROUPED_PLANS[(640, qt, r, b_max), elem_bytes]
        assert (at.row_groups, at.windows, at.window_cols) == (1, 1, b_max)
        past = tk.grouped_launch_plan(640, qt, r, b_max + 1, elem_bytes)
        assert past.windows > 1 and past.window_cols % 16 == 0
        assert past.window_cols * past.windows >= b_max + 1
        assert past.window_cols * (past.windows - 1) < b_max + 1
        assert past.smem_bytes <= tk.GROUPED_SMEM_LIMIT
        assert past.stages == 2 and past.pass_rows >= 128


@pytest.mark.parametrize("key", sorted(OLD_GROUPED_PLANS), ids=str)
def test_grouped_plan_under_the_old_caps_is_unchanged(key):
    """Row groups and windows change no plan the kernel ran before them:
    one row group, one window, and every old field as it was."""
    (t, qt, r, b), elem_bytes = key
    plan = tk.grouped_launch_plan(t, qt, r, b, elem_bytes)
    assert tuple(plan)[:11] == OLD_GROUPED_PLANS[key]
    assert (plan.group_rows, plan.row_groups, plan.window_cols, plan.windows) == (qt, 1, b, 1)
    assert plan.args()[:6] == (plan.pass_rows, plan.warp_rows, plan.slab_rows,
                               int(plan.bulk_xg) | 2 * int(plan.bulk_tile)
                               | 4 * int(plan.bulk_scales), plan.stages, plan.grid)


def grouped_by_items(plan, xg, vals, tc, ps, mode, tile_src, product):
    """The grouped product as the kernel cuts it: ``product`` (the plain
    version) on each item of a live tile (a tile is live when its first
    slot is, whatever its row group holds), zeros for padding tiles'."""
    t, qt, _ = xg.shape
    b = vals.shape[2]
    out = torch.full((t, qt, b), float("nan"))
    for v in range(plan.items(t)):
        ti, row0, h, col0, cols = tk.grouped_item(plan, v, qt, b)
        rows, cs = slice(row0, row0 + h), slice(col0, col0 + cols)
        if tile_src is not None and tile_src[ti, 0] < 0:
            out[ti, rows, cs] = 0.0
            continue
        p = None if ps is None else ps[ti:ti + 1, rows]
        out[ti, rows, cs] = product(xg[ti:ti + 1, rows], vals[:, :, cs], tc[ti:ti + 1], p,
                                    mode=mode)[0]
    return out


@pytest.mark.parametrize("mode", ["none", "prod", "logsum"])
@pytest.mark.parametrize("b", [1024, 4096])
@pytest.mark.parametrize("qt", [17, 24, 32])
def test_grouped_items_reassemble_the_plain_output(qt, b, mode):
    """The plan's row groups and windows, with the plain version standing
    in for the kernel on each item, give the whole plain output bitwise:
    padding tiles, a live tile whose second row group is all padding slots,
    a short last row group (QT = 17, 24) and a narrow last window. Inputs
    are small integers, so every order of the f32 sums is exact. Except in
    ``prod``: torch's CPU sigmoid takes a vector loop or a scalar tail by
    tensor length, which differ by 1 ulp, so there the logits are held
    bitwise and the scores within 2 ulp (rtol 2.4e-7)."""
    t, r, c = 5, 24, 3
    g = torch.Generator().manual_seed(qt * b)
    xg = torch.randint(-3, 4, (t, qt, r), generator=g).float()
    vals = torch.randint(-3, 4, (c, r, b), generator=g).float()
    tc = torch.tensor([0, 1, 1, 2, 2])
    ps = torch.rand(t, qt, generator=g) + 0.5
    src = torch.arange(t * qt).reshape(t, qt)
    src[1, 16:] = -1  # a live tile whose second row group holds only padding slots
    src[3:] = -1      # padding tiles
    xg[3:] = 0.0
    p = None if mode == "none" else ps
    # int8/fp8 plans take the same row groups, windows and passes
    # (test_grouped_plan_fits_shared_memory), so they cut the same items.
    plan = tk.grouped_launch_plan(t, qt, r, b, 4)
    assert plan.row_groups == 2 and plan.windows > 1
    got = grouped_by_items(plan, xg, vals, tc, p, mode, src, tk.mscm_grouped_plain)
    want = tk.mscm_grouped_plain(xg, vals, tc, p, mode=mode, tile_src=src)
    if mode == "prod":
        torch.testing.assert_close(got, want, rtol=2.4e-7, atol=0.0)
        got = grouped_by_items(plan, xg, vals, tc, None, "none", src, tk.mscm_grouped_plain)
        want = tk.mscm_grouped_plain(xg, vals, tc, None, mode="none", tile_src=src)
    assert torch.equal(got, want)
    assert got[1, 16:].abs().sum() > 0  # the padding slots of a live tile are computed


# ---------------------------------------------------------------------------
# The online path: fused and pregather kernels, mscm_pallas
# ---------------------------------------------------------------------------

def _sorted_blocks(m):
    order = np.argsort(m["bc"], kind="stable")
    return m["bq"][order], m["bc"][order]


@pytest.mark.parametrize("seed", [30, 31])
def test_fused_plain_matches_pallas_interpret(seed):
    m = _mk(seed, A=17)
    xd_j, xd_t = _dense(m)
    bq, bc = _sorted_blocks(m)
    want = jk.mscm_fused(xd_j, jnp.asarray(m["rows"]), jnp.asarray(m["vals"]),
                         jnp.asarray(bq), jnp.asarray(bc), interpret=True)
    before = obs.total("launches.mscm_fused")
    got = tk.mscm_fused(xd_t, T(m["rows"]), T(m["vals"]), T(bq).long(), T(bc).long())
    assert obs.total("launches.mscm_fused") == before  # CPU tensors never launch the kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        got.numpy(), tk.mscm_fused_plain(xd_t, T(m["rows"]), T(m["vals"]), T(bq), T(bc)).numpy())


@pytest.mark.parametrize("seed", [32, 33])
def test_pregather_plain_matches_pallas_interpret(seed):
    m = _mk(seed, A=17)
    xd_j, xd_t = _dense(m)
    bq, bc = _sorted_blocks(m)
    xg_j = JM.gather_query_rows(xd_j, jnp.asarray(m["rows"]), jnp.asarray(bq), jnp.asarray(bc))
    xg_t = TM.gather_query_rows(xd_t, T(m["rows"]), T(bq), T(bc))
    want = jk.mscm_pregather(xg_j, jnp.asarray(m["vals"]), jnp.asarray(bc), interpret=True)
    before = obs.total("launches.mscm_pregather")
    got = tk.mscm_pregather(xg_t, T(m["vals"]), T(bc).long())
    assert obs.total("launches.mscm_pregather") == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_fused_clips_rows_and_clamps_ids():
    """Row indices past the table are clipped to its last column and block
    ids past the last query or chunk are clamped, as the reference's gathers
    clip and clamp."""
    m = _mk(34, C=3, A=6)
    xd_j, xd_t = _dense(m)
    rows = m["rows"].copy()
    rows[0, :3] = m["d"] + 7
    x = np.asarray(xd_j).copy()
    x[:, -1] = 0.5  # a nonzero last column makes the clip visible
    bq = np.array([0, 1, 2, 3, 5, 5], np.int32)
    bc = np.array([0, 0, 1, 2, 2, 2], np.int32)
    want = jk.mscm_fused(jnp.asarray(x), jnp.asarray(rows), jnp.asarray(m["vals"]),
                         jnp.asarray(bq), jnp.asarray(bc), interpret=True)
    got = tk.mscm_fused(T(x), T(rows), T(m["vals"]), T(bq).long(), T(bc).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    bq_past, bc_past = T(bq).long() + 10, T(bc).long() + 10
    np.testing.assert_array_equal(
        tk.mscm_fused(T(x), T(rows), T(m["vals"]), bq_past, bc_past).numpy(),
        tk.mscm_fused(T(x), T(rows), T(m["vals"]), torch.full_like(bq_past, 5),
                      torch.full_like(bc_past, 2)).numpy())


@pytest.mark.parametrize("variant", ["fused", "pregather"])
@pytest.mark.parametrize("sort", [True, False])
def test_mscm_pallas_matches_reference(variant, sort):
    m = _mk(40 + sort, n=5, d=96, C=6, B=4, A=12)
    xd_j, xd_t = _dense(m)
    want = jops.mscm_pallas(xd_j, *[jnp.asarray(m[k]) for k in ("rows", "vals", "bq", "bc")],
                            variant=variant, sort=sort, interpret=True)
    got = tops.mscm_pallas(xd_t, *[T(m[k]) for k in ("rows", "vals", "bq", "bc")],
                           variant=variant, sort=sort)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.mscm_ref(xd_j, *[jnp.asarray(m[k]) for k in
                                                      ("rows", "vals", "bq", "bc")])),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["fused", "pregather"])
def test_mscm_pallas_duplicate_chunks(variant):
    """Many queries hitting the same chunk (the revisit fast path)."""
    m = _mk(42, n=8, d=80, C=3, B=8)
    xd_j, xd_t = _dense(m)
    bq, bc = np.arange(8, dtype=np.int32), np.zeros(8, np.int32)
    want = jops.mscm_pallas(xd_j, jnp.asarray(m["rows"]), jnp.asarray(m["vals"]),
                            jnp.asarray(bq), jnp.asarray(bc), variant=variant, interpret=True)
    got = tops.mscm_pallas(xd_t, T(m["rows"]), T(m["vals"]), T(bq), T(bc), variant=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _bf16(x):
    """numpy f32 -> (jax bf16, torch bf16), rounded by each framework."""
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = T(np.array(x, np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(xj).view(np.uint16),
                                  xt.view(torch.int16).numpy().view(np.uint16))
    return xj, xt


@pytest.mark.parametrize("variant", ["fused", "pregather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mscm_pallas_dtype_sweep(variant, dtype):
    """bf16 query table and weights (mirrors ``test_kernels.py``'s sweep):
    products and sums in f32, f32 output."""
    m = _mk(43, n=4, d=64, C=3, B=8, nnz_w=6, nnz_x=8, A=8)
    xd_j, xd_t = _dense(m)
    vals_j, vals_t = jnp.asarray(m["vals"]), T(m["vals"])
    if dtype == "bfloat16":
        xd_j, xd_t = _bf16(np.asarray(xd_j))
        vals_j, vals_t = _bf16(m["vals"])
    args_j = (jnp.asarray(m["rows"]), vals_j, jnp.asarray(m["bq"]), jnp.asarray(m["bc"]))
    want = np.asarray(jref.mscm_ref(xd_j.astype(jnp.float32), args_j[0],
                                    vals_j.astype(jnp.float32), *args_j[2:]))
    ref = np.asarray(jops.mscm_pallas(xd_j, *args_j, variant=variant, interpret=True),
                     np.float32)
    got = tops.mscm_pallas(xd_t, T(m["rows"]), vals_t, T(m["bq"]), T(m["bc"]),
                           variant=variant)
    assert got.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("above", [False, True])
def test_auto_variant_switch_at_vmem_row_limit(monkeypatch, above):
    """``variant="auto"`` picks the kernel by the reference's rule: fused up
    to ``VMEM_ROW_LIMIT`` columns of the table, pregather above it."""
    m = _mk(44)
    xd_j, xd_t = _dense(m)
    dp = xd_t.shape[1]
    calls = []

    def spy(module, name, tag):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: calls.append(tag) or fn(*a, **k))

    for module, tag in ((jops, "ref"), (tops, "port")):
        monkeypatch.setattr(module, "VMEM_ROW_LIMIT", dp - 1 if above else dp)
        spy(module, "mscm_fused", (tag, "fused"))
        spy(module, "mscm_pregather", (tag, "pregather"))
    # The unjitted reference, so that the patched limit and spies are read.
    want = jops.mscm_pallas.__wrapped__(
        xd_j, *[jnp.asarray(m[k]) for k in ("rows", "vals", "bq", "bc")], interpret=True)
    got = tops.mscm_pallas(xd_t, *[T(m[k]) for k in ("rows", "vals", "bq", "bc")])
    variant = "pregather" if above else "fused"
    assert calls == [("ref", variant), ("port", variant)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="variant"):
        tops.mscm_pallas(xd_t, *[T(m[k]) for k in ("rows", "vals", "bq", "bc")],
                         variant="tiled")


def test_block_wrappers_reject_bad_arguments():
    x, rows, vals = torch.zeros(2, 10), torch.zeros(3, 8, dtype=torch.int32), torch.zeros(3, 8, 6)
    bq = bc = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        tk.mscm_fused(x, rows, vals, bq.int(), bc)
    with pytest.raises(TypeError):
        tk.mscm_fused(x, rows.long(), vals, bq, bc)
    with pytest.raises(TypeError):
        tk.mscm_fused(x.bfloat16(), rows, vals, bq, bc)
    with pytest.raises(TypeError):
        tk.mscm_fused(x.double(), rows, vals.double(), bq, bc)
    with pytest.raises(ValueError, match="shape"):
        tk.mscm_fused(x, rows[:, :7], vals, bq, bc)
    with pytest.raises(ValueError, match="shape"):
        tk.mscm_fused(x, rows, vals, bq[:3], bc)
    with pytest.raises(ValueError, match="shape"):
        tk.mscm_pregather(torch.zeros(4, 7), vals, bc)
    with pytest.raises(TypeError):
        tk.mscm_pregather(torch.zeros(4, 8), vals, bc.int())
    with pytest.raises(ValueError, match="expected"):
        tk.mscm_pregather(torch.zeros(4, 8), vals[0], bc)


# ---------------------------------------------------------------------------
# The per-block kernel's launch plan (index arithmetic of csrc/mscm_block.cu)
# ---------------------------------------------------------------------------

def plan_slabs(plan, r):
    """(rank, slab, first row, rows) of every slab one cluster stages, as
    csrc/mscm_block.cu walks them: CTA ``rank`` takes rows from
    ``rank * rows_per_slice`` in slabs of ``slab_rows``."""
    for rank in range(plan.cluster):
        row0 = rank * plan.rows_per_slice
        nrows = min(r, row0 + plan.rows_per_slice) - row0
        for j, first in enumerate(range(0, nrows, plan.slab_rows)):
            yield rank, j, row0 + first, min(plan.slab_rows, nrows - first)


# (A, R, B): online, one block, batch, and the edge shapes of the card tests;
# then B past the width one window takes (1,022 in f32 and bf16).
PLAN_SHAPES = [(10, 496, 32), (1, 496, 32), (640, 496, 32), (132, 496, 32), (66, 496, 32),
               (1, 8, 6), (5, 37, 8), (3, 1037, 70), (200, 1040, 72), (200, 1037, 70),
               (6, 24, 16), (0, 496, 32), (10, 496, 2048), (1, 496, 2048), (640, 496, 2048),
               (3, 1037, 2048), (10, 496, 1023), (1, 64, 40_000)]

# The plans block_launch_plan gave before windows, (A, R, B), elem_bytes ->
# (cluster, rows_per_slice, slab_rows, stages, bulk, smem_bytes), the last
# six at its widest B, 1,022.
OLD_BLOCK_PLANS = {
    ((10, 496, 32), 4): (8, 64, 64, 1, True, 10784),
    ((10, 496, 32), 2): (8, 64, 64, 1, True, 6560),
    ((1, 496, 32), 4): (8, 64, 64, 1, True, 10784),
    ((1, 496, 32), 2): (8, 64, 64, 1, True, 6560),
    ((640, 496, 32), 4): (1, 496, 496, 1, True, 69536),
    ((640, 496, 32), 2): (1, 496, 496, 1, True, 36800),
    ((132, 496, 32), 4): (1, 496, 496, 1, True, 69536),
    ((132, 496, 32), 2): (1, 496, 496, 1, True, 36800),
    ((66, 496, 32), 4): (2, 248, 248, 1, True, 35808),
    ((66, 496, 32), 2): (2, 248, 248, 1, True, 19440),
    ((1, 8, 6), 4): (2, 4, 4, 1, True, 544),
    ((1, 8, 6), 2): (1, 8, 8, 1, True, 560),
    ((5, 37, 8), 4): (5, 8, 8, 1, False, 864),
    ((5, 37, 8), 2): (5, 8, 8, 1, False, 720),
    ((3, 1037, 70), 4): (8, 132, 132, 1, False, 42528),
    ((3, 1037, 70), 2): (8, 136, 136, 1, False, 24368),
    ((200, 1040, 72), 4): (1, 1040, 152, 2, True, 94640),
    ((200, 1040, 72), 2): (1, 1040, 264, 2, True, 83856),
    ((200, 1037, 70), 4): (1, 1040, 260, 1, False, 79392),
    ((200, 1037, 70), 2): (1, 1040, 520, 1, False, 80432),
    ((6, 24, 16), 4): (6, 4, 4, 1, True, 1344),
    ((6, 24, 16), 2): (3, 8, 8, 1, True, 1360),
    ((0, 496, 32), 4): (8, 64, 64, 1, True, 10784),
    ((0, 496, 32), 2): (8, 64, 64, 1, True, 6560),
    ((10, 496, 1022), 4): (8, 64, 4, 2, True, 98224),
    ((10, 496, 1022), 2): (8, 64, 8, 2, True, 98256),
    ((1, 496, 1022), 4): (8, 64, 4, 2, True, 98224),
    ((1, 496, 1022), 2): (8, 64, 8, 2, True, 98256),
    ((640, 64, 1022), 4): (1, 64, 4, 2, True, 98224),
    ((640, 64, 1022), 2): (1, 64, 8, 2, True, 98256),
}


@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_block_plan_covers_every_row_once(shape, elem_bytes):
    a, r, b = shape
    plan = tk.block_launch_plan(a, r, b, elem_bytes)
    assert 1 <= plan.cluster <= tk.MAX_CLUSTER
    assert plan.grid(a) == a * plan.cluster * plan.windows
    if a >= tk.H100_SMS:
        assert plan.cluster == 1
    seen = np.zeros(r, np.int64)
    slices = {}
    for rank, _, first, n in plan_slabs(plan, r):
        assert 1 <= n <= plan.slab_rows
        seen[first:first + n] += 1
        slices.setdefault(rank, []).append((first, n))
    np.testing.assert_array_equal(seen, 1)  # every row in exactly one slice
    assert sorted(slices) == list(range(plan.cluster))  # no slice empty
    for rank, slabs in slices.items():  # each slice contiguous, from rank * rps
        assert slabs[0][0] == rank * plan.rows_per_slice
        assert all(f0 + n0 == f1 for (f0, n0), (f1, _) in zip(slabs, slabs[1:]))
    assert plan.smem_bytes <= tk.BLOCK_SMEM_BUDGET
    assert plan.smem_bytes == tk.block_smem_bytes(plan.window_cols, elem_bytes, plan.slab_rows,
                                                  plan.stages)
    # Windows cover B once: all of it in one, or a multiple of 16 columns each.
    assert plan.windows == -(-b // plan.window_cols)
    assert plan.windows == 1 or (plan.window_cols % 16 == 0 and b > 1022)


def test_block_plan_splits_the_online_shape_over_a_cluster():
    online = tk.block_launch_plan(10, 496, 32, 4)
    assert (online.cluster, online.grid(10)) == (8, 80)  # 80 SMs pull bytes, not 10
    assert tk.block_launch_plan(1, 496, 32, 4).cluster == 8
    assert tk.block_launch_plan(640, 496, 32, 4).cluster == 1
    assert tk.block_launch_plan(131, 496, 32, 4).cluster == 1


@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_block_plan_bulk_copies_are_16_byte_aligned(shape, elem_bytes):
    """Every copy of the bulk path (tile slab of vals [C, R, B], query values
    of xg [A, R], int32 rows of rows [C, R]) starts and ends on 16 bytes,
    for any chunk c and block a."""
    a, r, b = shape
    plan = tk.block_launch_plan(a, r, b, elem_bytes)
    if not plan.bulk:
        return
    for c_or_a in (0, 1, 7):
        for _, _, first, n in plan_slabs(plan, r):
            for row_bytes in (elem_bytes, 4) + ((b * elem_bytes,) if plan.windows == 1 else ()):
                assert (c_or_a * r + first) * row_bytes % 16 == 0
                assert n * row_bytes % 16 == 0
            for w in range(1, plan.windows):  # a window's tile rows: one copy a row
                col0, cols = w * plan.window_cols, min(plan.window_cols, b - w * plan.window_cols)
                for k in range(first, first + n):
                    assert ((c_or_a * r + k) * b + col0) * elem_bytes % 16 == 0
                    assert cols * elem_bytes % 16 == 0
    assert plan.stages == 1 or plan.slab_rows < plan.rows_per_slice  # a ring only to stream


@pytest.mark.parametrize("shape,elem_bytes", [((3, 1037, 70), 4), ((5, 37, 8), 2),
                                              ((200, 1037, 70), 4), ((1, 1037, 70), 2)])
def test_block_plan_unaligned_shapes_take_ordinary_loads(shape, elem_bytes):
    a, r, b = shape
    plan = tk.block_launch_plan(a, r, b, elem_bytes)
    assert not plan.bulk and plan.stages == 1
    assert not tk.block_launch_plan(10, 496, 32, 4, aligned=False).bulk  # a misaligned view
    assert tk.block_launch_plan(10, 496, 32, 4).bulk


def test_block_plan_streams_large_tiles_through_a_ring():
    plan = tk.block_launch_plan(200, 1040, 72, 4)  # a 299.5 KB f32 tile, one CTA a block
    assert plan.cluster == 1 and plan.bulk and plan.stages == 2
    assert plan.slab_rows < plan.rows_per_slice
    assert plan.smem_bytes <= tk.BLOCK_SMEM_BUDGET
    # B = 40,000 fits no slab of one window: windows of a multiple of 16
    # columns instead, each within the budget.
    wide = tk.block_launch_plan(1, 64, 40_000, 4)
    assert wide.windows > 1 and wide.smem_bytes <= tk.BLOCK_SMEM_BUDGET
    with pytest.raises(ValueError):
        tk.block_launch_plan(1, 0, 32, 4)
    with pytest.raises(ValueError):
        tk.block_launch_plan(1, 64, 32, 3)


@pytest.mark.parametrize("key", sorted(OLD_BLOCK_PLANS), ids=str)
def test_block_plan_under_the_old_cap_is_unchanged(key):
    """Windows change no plan the kernel ran before them: one window of all
    B columns and every old field as it was, up to the old widest B."""
    (a, r, b), elem_bytes = key
    plan = tk.block_launch_plan(a, r, b, elem_bytes)
    assert tuple(plan)[:6] == OLD_BLOCK_PLANS[key]
    assert (plan.window_cols, plan.windows) == (b, 1)
    assert plan.args() == tuple(plan.args()[:5]) + (b,)


@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("b", [1023, 2048, 4096])
def test_block_plan_takes_b_past_the_old_cap(b, elem_bytes):
    """Past 1,022 columns the plan cuts B into the fewest windows that fit,
    each a multiple of 16 columns, and keeps the slices of R it had."""
    for a in (1, 10, 640):
        plan = tk.block_launch_plan(a, 496, b, elem_bytes)
        narrow = tk.block_launch_plan(a, 496, 32, elem_bytes)
        assert plan.windows > 1 and plan.window_cols % 16 == 0
        assert plan.window_cols * (plan.windows - 1) < b <= plan.window_cols * plan.windows
        assert (plan.cluster, plan.rows_per_slice) == (narrow.cluster, narrow.rows_per_slice)
        assert plan.smem_bytes <= tk.BLOCK_SMEM_BUDGET
        assert plan.bulk == (b * elem_bytes % 16 == 0)


# ---------------------------------------------------------------------------
# The plain-tensor methods: searchsorted, vanilla, cost counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["uniform", "ragged"])
def test_searchsorted_and_vanilla_match_reference(case):
    """Against the reference and the dense oracle. The ragged layer (L % B
    != 0) has phantom columns, and its block list names chunks past the
    last, which both packages clamp."""
    if case == "uniform":
        m = _mk(50, n=6, d=120, C=5, B=8, nnz_w=10, nnz_x=15, A=12)
    else:
        m = _mk(51, n=6, d=100, C=6, B=8, nnz_w=9, nnz_x=14, A=14, L=43)
        m["bc"][:3] = [6, 7, 9]  # 6 chunks: past the last one
    d, B = m["d"], m["B"]
    xi_j, xv_j = jnp.asarray(m["xi"]), jnp.asarray(m["xv"])
    xi_t, xv_t = T(m["xi"]), T(m["xv"])
    ids_j = [jnp.asarray(m[k]) for k in ("bq", "bc")]
    ids_t = [T(m[k]) for k in ("bq", "bc")]
    want_ss = JM.mscm_searchsorted(xi_j, xv_j, jnp.asarray(m["rows"]), jnp.asarray(m["vals"]),
                                   *ids_j, d)
    got_ss = TM.mscm_searchsorted(xi_t, xv_t, T(m["rows"]), T(m["vals"]), *ids_t, d)
    np.testing.assert_allclose(got_ss.numpy(), np.asarray(want_ss), rtol=RTOL, atol=ATOL)
    want_v = JM.vanilla_columns(xi_j, xv_j, jnp.asarray(m["col_rows"]),
                                jnp.asarray(m["col_vals"]), *ids_j, B, d)
    got_v = TM.vanilla_columns(xi_t, xv_t, T(m["col_rows"]), T(m["col_vals"]), *ids_t, B, d)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=RTOL, atol=ATOL)
    # Within range all three iterators compute the same product.
    xd_t = TM.scatter_dense(xi_t, xv_t, d)
    ok = m["bc"] < m["rows"].shape[0]
    dense = TM.mscm_dense_lookup(xd_t, T(m["rows"]), T(m["vals"]), *ids_t).numpy()
    np.testing.assert_allclose(got_ss.numpy()[ok], dense[ok], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_v.numpy()[ok], dense[ok], rtol=RTOL, atol=ATOL)


def test_cost_counters_equal():
    for method in ("marching", "binsearch", "searchsorted", "hash", "dense", "dense_lookup"):
        for nnz_x, nnz_k, n in ((10, 1000, 1), (1000, 10, 100), (0, 0, 0), (4, 1024, 3)):
            assert (TM.iterator_cost(method, nnz_x, nnz_k, n_queries=n)
                    == JM.iterator_cost(method, nnz_x, nnz_k, n_queries=n))
    with pytest.raises(ValueError):
        TM.iterator_cost("bogus", 1, 1)
    rng = np.random.default_rng(52)
    w = random_sparse_csc(256, 32, 16, rng, sibling_groups=32, sibling_overlap=0.9)
    ch = ChunkedLayer.from_csc(w, 32)
    got = TM.chunk_vs_column_traversals(ch.R, w.col_nnz(), 32)
    assert got == JM.chunk_vs_column_traversals(ch.R, w.col_nnz(), 32)
    assert got[0] < got[1]


def test_build_temporary_file_named_by_process_and_thread():
    """Two threads (or processes) building one library never write one
    temporary file: its name carries the pid and the thread id."""
    import os
    import threading
    from pathlib import Path

    from repro_torch.kernels import build

    lib = Path("/nonexistent/libx-0123.so")
    names = {}
    together = threading.Barrier(2, timeout=30)  # both alive: distinct thread ids

    def name():
        names[threading.get_ident()] = build._tmp_path(lib)
        together.wait()

    threads = [threading.Thread(target=name) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    names[threading.get_ident()] = build._tmp_path(lib)
    assert len(set(names.values())) == len(names) == 3
    for ident, path in names.items():
        assert path.parent == lib.parent
        assert path.name == f"{lib.name}.{os.getpid()}.{ident}.tmp"
    assert not build._LOCK.locked()
