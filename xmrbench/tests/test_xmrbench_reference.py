"""The plain reference against brute force on tiny trees, ties included."""

import numpy as np
import torch

from xmrbench import gen, reference

MIX = {"path_share": 0.5, "targets": {"dist": "uniform"}}


def _setup(cfg, seed=11, n=40):
    geom = gen.Geometry.of(cfg)
    levels = gen.make_tree(geom, seed, "cpu")
    pool = gen.make_pool(geom, levels, MIX, n, seed, "cpu")
    return geom, levels, pool


def _dense(geom, levels):
    """Each level's [d, C * B] weight matrix, float64."""
    out = []
    for (c, r, b), lev in zip(geom.shapes(), levels):
        w = np.zeros((geom.d, c * b))
        h0, h1 = lev.held
        for ci in range(h0, h1):
            w[lev.chunk_rows[ci - h0].numpy()[:, None], np.arange(ci * b, ci * b + b)] += \
                lev.chunk_vals[ci - h0].numpy()
        out.append(w)
    return out


def _brute(geom, dense, ids, vals, beam, topk):
    """Beam search one query at a time with Python sorts; at a held range
    of the last level, only the held chunks' children (-inf fills the
    rest)."""
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))  # noqa: E731
    s_out, l_out = [], []
    for qi, qv in zip(ids, vals):
        x = np.zeros(geom.d)
        x[qi] = qv
        beam_set = [(0, 1.0)]
        for li, (w, b) in enumerate(zip(dense, geom.branching)):
            logits = x @ w
            h0, h1 = geom.held(li)
            cand = [(p * sig(logits[c * b + j]) if h0 <= c < h1 else -np.inf, c * b + j)
                    for c, p in beam_set for j in range(b) if c * b + j < geom.n_cols[li]]
            cand.sort(key=lambda t: (-t[0], t[1]))
            keep = min(topk if li == len(dense) - 1 else beam, geom.n_cols[li])
            beam_set = [(i, s) for s, i in cand[:keep]]
        l_out.append([i for i, _ in beam_set])
        s_out.append([s for _, s in beam_set])
    return np.array(s_out), np.array(l_out)


def _run(geom, levels, pool, beam, topk, ids=None, vals=None):
    ids = pool.ids if ids is None else ids
    vals = pool.vals if vals is None else vals
    return reference.search(levels, geom.n_cols, geom.branching, torch.from_numpy(ids),
                            torch.from_numpy(vals), beam=beam, topk=topk, block=16)


def test_matches_brute_force(tiny_config):
    geom, levels, pool = _setup(tiny_config)
    s, l = _run(geom, levels, pool, 4, 5)
    bs, bl = _brute(geom, _dense(geom, levels), pool.ids, pool.vals, 4, 5)
    np.testing.assert_array_equal(l.numpy(), bl)
    np.testing.assert_allclose(s.numpy(), bs, rtol=1e-12)


def test_wide_beam_is_exhaustive(tiny_config):
    geom, levels, pool = _setup(tiny_config, seed=4)
    s, l = _run(geom, levels, pool, 64, 7)
    dense = _dense(geom, levels)
    leaves = torch.arange(geom.n_labels).expand(len(pool), -1)
    every = reference.path_scores(levels, geom.branching, torch.from_numpy(pool.ids),
                                  torch.from_numpy(pool.vals), leaves).numpy()
    for q in range(len(pool)):
        order = sorted(range(geom.n_labels), key=lambda i: (-every[q, i], i))[:7]
        np.testing.assert_array_equal(l[q].numpy(), order)
    _, bl = _brute(geom, dense, pool.ids, pool.vals, 64, 7)
    np.testing.assert_array_equal(l.numpy(), bl)


def test_ties_break_by_id(tiny_config):
    geom, levels, pool = _setup(tiny_config)
    used = np.unique(np.concatenate([lev.chunk_rows.numpy().ravel() for lev in levels]))
    free = np.setdiff1d(np.arange(geom.d), used)[:geom.query_nnz].astype(np.int32)
    ids = np.tile(free, (3, 1))
    vals = np.ones_like(ids, dtype=np.float32)
    s, l = _run(geom, levels, pool, 4, 5, ids, vals)
    # Every logit is 0: each level's beam is the lowest ids, scores 0.5 ** depth.
    np.testing.assert_array_equal(l.numpy(), np.tile(np.arange(5), (3, 1)))
    np.testing.assert_array_equal(s.numpy(), np.full((3, 5), 0.5 ** 3))
    bs, bl = _brute(geom, _dense(geom, levels), ids, vals, 4, 5)
    np.testing.assert_array_equal(l.numpy(), bl)


def test_path_scores_match_beam_scores(tiny_config):
    geom, levels, pool = _setup(tiny_config)
    s, l = _run(geom, levels, pool, 4, 5)
    p = reference.path_scores(levels, geom.branching, torch.from_numpy(pool.ids),
                              torch.from_numpy(pool.vals), l)
    np.testing.assert_allclose(p.numpy(), s.numpy(), rtol=1e-12)


def test_control_rounds(tiny_config):
    geom, levels, pool = _setup(tiny_config)
    s, _ = _run(geom, levels, pool, 4, 5)
    c, _ = reference.search(levels, geom.n_cols, geom.branching, torch.from_numpy(pool.ids),
                            torch.from_numpy(pool.vals), beam=4, topk=5,
                            value_dtype=torch.bfloat16)
    gap = ((c.double() - s).abs() / s).max().item()
    assert 1e-4 < gap < 1e-1


def test_share_matches_brute_force(tiny_share):
    """One chip's share: the global beam over the whole levels, then the
    held leaf chunks' children only; empty answers where none is held."""
    geom, levels, pool = _setup(tiny_share, n=120)
    s, l = _run(geom, levels, pool, 4, 5)
    bs, bl = _brute(geom, _dense(geom, levels), pool.ids, pool.vals, 4, 5)
    empty = np.isinf(bs)
    assert empty.all(1).any() and (~empty).all(1).any()
    np.testing.assert_array_equal(np.isinf(s.numpy()), empty)
    np.testing.assert_array_equal(l.numpy()[~empty], bl[~empty])
    np.testing.assert_allclose(s.numpy()[~empty], bs[~empty], rtol=1e-12)
    p = reference.path_scores(levels, geom.branching, torch.from_numpy(pool.ids),
                              torch.from_numpy(pool.vals), l)
    np.testing.assert_allclose(p.numpy()[~empty], s.numpy()[~empty], rtol=1e-12)
    held = (l.numpy() >= 20)
    assert np.isnan(p.numpy()[~held]).all()
