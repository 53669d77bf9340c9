"""The device generator: shapes, determinism, the layout's invariants."""

import numpy as np
import pytest
import torch

from xmrbench import gen


def _tree(cfg, seed=7):
    geom = gen.Geometry.of(cfg)
    return geom, gen.make_tree(geom, seed, "cpu")


def test_shapes_and_types(tiny_config):
    geom, levels = _tree(tiny_config)
    assert geom.shapes() == [(1, 24, 3), (3, 40, 4), (11, 40, 5)]
    for (c, r, b), lev in zip(geom.shapes(), levels):
        k = min(geom.col_nnz, r)
        assert lev.chunk_rows.shape == (c, r) and lev.chunk_rows.dtype == torch.int32
        assert lev.chunk_vals.shape == (c, r, b) and lev.chunk_vals.dtype == torch.float32
        assert lev.col_rows.shape == (c * b, k) and lev.col_rows.dtype == torch.int32
        assert lev.col_vals.shape == (c * b, k) and lev.col_vals.dtype == torch.float32


def test_deterministic_by_seed(tiny_config):
    _, a = _tree(tiny_config, 3)
    _, b = _tree(tiny_config, 3)
    _, c = _tree(tiny_config, 2**31 + 11)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x.chunk_rows, y.chunk_rows)
        assert torch.equal(x.chunk_vals, y.chunk_vals)
        assert torch.equal(x.col_rows, y.col_rows)
    assert not torch.equal(a[-1].chunk_vals, c[-1].chunk_vals)


def test_rows_sorted_distinct_in_range(tiny_config):
    geom, levels = _tree(tiny_config)
    for lev in levels:
        r = lev.chunk_rows.long()
        assert (r[:, 1:] > r[:, :-1]).all()
        assert r.min() >= 0 and r.max() < geom.d


def test_padded_columns_empty_live_columns_full(tiny_config):
    geom, levels = _tree(tiny_config)
    for (c, r, b), n, lev in zip(geom.shapes(), geom.n_cols, levels):
        k = min(geom.col_nnz, r)
        per_col = (lev.chunk_vals != 0).sum(1).reshape(-1)          # [C * B]
        assert (per_col[:n] == k).all()
        assert (per_col[n:] == 0).all()
        assert (lev.col_rows[n:] == geom.d).all() and (lev.col_vals[n:] == 0).all()


def test_column_layout_matches_tiles(tiny_config):
    geom, levels = _tree(tiny_config)
    for (c, r, b), n, lev in zip(geom.shapes(), geom.n_cols, levels):
        dense = np.zeros((geom.d, c * b))
        for ci in range(c):
            dense[lev.chunk_rows[ci].numpy()[:, None], np.arange(ci * b, ci * b + b)] += \
                lev.chunk_vals[ci].numpy()
        from_cols = np.zeros_like(dense)
        for j in range(n):
            from_cols[lev.col_rows[j].numpy(), j] += lev.col_vals[j].numpy()
        np.testing.assert_array_equal(dense, from_cols)
        assert (lev.col_rows[:n, 1:] > lev.col_rows[:n, :-1]).all()


def test_pool(tiny_config):
    geom, levels = _tree(tiny_config)
    mix = {"path_share": 0.5, "targets": {"dist": "uniform"}}
    pool = gen.make_pool(geom, levels, mix, 300, 5, "cpu")
    again = gen.make_pool(geom, levels, mix, 300, 5, "cpu")
    np.testing.assert_array_equal(pool.ids, again.ids)
    np.testing.assert_array_equal(pool.vals, again.vals)
    assert pool.ids.shape == (300, geom.query_nnz) and pool.ids.dtype == np.int32
    assert (np.diff(pool.ids, axis=1) > 0).all()
    assert pool.ids.min() >= 0 and pool.ids.max() < geom.d
    assert (pool.vals >= 0.1).all()
    assert pool.targets.min() >= 0 and pool.targets.max() < geom.n_labels
    # Each query holds rows of its target's leaf column, positive weights first.
    hits = []
    for q in range(300):
        leaf = int(pool.targets[q])
        sup = levels[-1].col_rows[leaf].numpy()[levels[-1].col_vals[leaf].numpy() > 0]
        hits.append(len(np.intersect1d(sup, pool.ids[q])) >= min(len(sup), 5))
    assert np.mean(hits) > 0.99


def test_share_holds_a_range_and_a_spare_chunk(tiny_share):
    geom, levels = _tree(tiny_share)
    assert [l.held for l in levels] == [(0, 1), (0, 3), (4, 11)]
    leaf = levels[-1]
    k = min(geom.col_nnz, 40)
    assert leaf.chunk_rows.shape == (8, 40) and leaf.chunk_vals.shape == (8, 40, 5)
    assert leaf.col_rows.shape == (40, k)
    # The spare chunk: rows d, no nonzeros.
    assert (leaf.chunk_rows[7] == geom.d).all() and (leaf.chunk_vals[7] == 0).all()
    assert (leaf.col_rows[35:] == geom.d).all() and (leaf.col_vals[35:] == 0).all()
    # Held chunk i is global chunk 4 + i: global columns past n_cols = 52 are empty.
    per_col = (leaf.chunk_vals[:7] != 0).sum(1).reshape(-1)
    glob = 20 + np.arange(35)
    assert (per_col[glob < 52] == k).all() and (per_col[glob >= 52] == 0).all()
    r = leaf.chunk_rows[:7].long()
    assert (r[:, 1:] > r[:, :-1]).all() and r.max() < geom.d


def test_share_pool(tiny_share, tiny_config):
    geom, levels = _tree(tiny_share)
    mix = {"path_share": 0.5, "targets": {"dist": "uniform"}}
    pool = gen.make_pool(geom, levels, mix, 600, 5, "cpu")
    assert pool.targets.min() >= 0 and pool.targets.max() < geom.n_labels
    assert (pool.targets < 20).any() and (pool.targets >= 20).any()
    assert (np.diff(pool.ids, axis=1) > 0).all() and pool.ids.max() < geom.d
    leaf = levels[-1]
    for q in np.flatnonzero(pool.targets >= 20)[:100]:
        col = int(pool.targets[q]) - 20
        sup = leaf.col_rows[col].numpy()[leaf.col_vals[col].numpy() > 0]
        assert len(np.intersect1d(sup, pool.ids[q])) >= min(len(sup), 4)
    # The whole tree's pool is drawn as before: a share changes no draw there.
    whole = gen.make_pool(gen.Geometry.of(tiny_config), gen.make_tree(
        gen.Geometry.of(tiny_config), 7, "cpu"), mix, 50, 5, "cpu")
    assert whole.ids.shape == (50, geom.query_nnz)


def test_bad_geometry(tiny_config):
    tiny_config["n_cols"] = [3, 13, 52]
    with pytest.raises(ValueError):
        gen.Geometry.of(tiny_config)
    tiny_config["n_cols"] = [3, 11, 52]
    for held in ([4, 12], [5, 5], [-1, 3]):
        with pytest.raises(ValueError):
            gen.Geometry.of(dict(tiny_config, leaf_chunks=held))
