"""The work count against counts by hand."""

import pytest

from xmrbench import hw, work

SHAPES = [(1, 24, 3), (3, 40, 4), (11, 40, 5)]
N_COLS = [3, 11, 52]


def test_chunks_per_query():
    assert work.chunks_per_query(N_COLS, beam=4) == (1, 3, 4)
    assert work.chunks_per_query(N_COLS, beam=20) == (1, 3, 11)


def test_distinct_chunks():
    assert work.distinct_chunks(1, 4, 11) == pytest.approx(4)
    assert work.distinct_chunks(2, 4, 11) == pytest.approx(11 * (1 - (7 / 11) ** 2))
    assert work.distinct_chunks(5, 3, 3) == 3
    assert work.distinct_chunks(1000, 1, 11) == pytest.approx(11)
    for n in (1, 3, 40):
        assert work.distinct_chunks(n, 2.5, 64) <= min(n * 2.5, 64)


def test_bucket_by_hand():
    w = work.bucket_work(SHAPES, N_COLS, 2, beam=4, topk=5, query_nnz=30)
    # level 1: 2 blocks, 1 chunk; level 2: 6 blocks, 3 chunks; level 3: 8
    # blocks, each query's 4 distinct of 11 chunks: 11 * (1 - (7/11)^2) expected
    d3 = 11 * (1 - (7 / 11) ** 2)
    flops = 2 * (24 * 3 * 2 + 40 * 4 * 6 + 40 * 5 * 8)
    tiles = 1 * 24 * (4 * 3 + 4) + 3 * 40 * (4 * 4 + 4) + d3 * 40 * (4 * 5 + 4)
    kernel = (2 * 24 * 4 + 1 * 24 * 3 * 4 + 2 * 3 * 4
              + 6 * 40 * 4 + 3 * 40 * 4 * 4 + 6 * 4 * 4
              + 8 * 40 * 4 + d3 * 40 * 5 * 4 + 8 * 5 * 4)
    assert w.flops == flops
    assert w.nbytes == pytest.approx(tiles + 2 * 30 * 8 + 2 * 5 * 8)
    assert w.kernel_bytes == pytest.approx(kernel)


def test_distinct_chunks_cap():
    w = work.bucket_work(SHAPES, N_COLS, 100, beam=4, topk=5, query_nnz=30)
    tiles = 1 * 24 * 16 + 3 * 40 * 20 + 11 * 40 * 24
    assert w.nbytes == pytest.approx(tiles + 100 * 30 * 8 + 100 * 5 * 8)


def test_held_share_of_the_last_level():
    """Holding 5 of the last level's 11 chunks, a query visits 4 * 5/11 of
    them on average; the levels above are whole."""
    whole = work.bucket_work(SHAPES, N_COLS, 2, beam=4, topk=5, query_nnz=30)
    w = work.bucket_work(SHAPES, N_COLS, 2, beam=4, topk=5, query_nnz=30, held=[1, 3, 5])
    q = 4 * 5 / 11
    d3 = work.distinct_chunks(2, q, 5)
    assert w.flops == pytest.approx(whole.flops - 2 * 40 * 5 * (8 - 2 * q))
    assert w.nbytes == pytest.approx(whole.nbytes - (11 * (1 - (7 / 11) ** 2) - d3) * 40 * 24)


def test_call_splits_into_buckets():
    kw = dict(beam=4, topk=5, query_nnz=30)
    call = work.call_work(SHAPES, N_COLS, 20, max_batch=8, **kw)
    parts = [work.bucket_work(SHAPES, N_COLS, n, **kw) for n in (8, 8, 4)]
    assert call.flops == sum(p.flops for p in parts)
    assert call.nbytes == sum(p.nbytes for p in parts)
    assert call.kernel_bytes == sum(p.kernel_bytes for p in parts)


def test_least_seconds():
    assert hw.least_seconds(67e12, 0) == 1.0
    assert hw.least_seconds(0, 3.35e12) == 1.0
    assert hw.least_seconds(67e12, 6.7e12) == 2.0
