"""PyTorch port, micro-batching front end: the port's ``MicroBatcher`` and
``RequestQueue`` against the port's own per-query serving, and against the
reference's batcher on the same queries.

The counterparts of ``tests/test_serving.py``'s queue, batcher, warm-up,
fault and auto-queue-depth tests that need no ``shards`` and no planner:

1. the CSR helpers (``rows_to_ell_loop``, ``from_dense``, ``slice_rows``,
   ``row_nnz``, ``nnz``) bitwise against ``repro.sparse.csr``;
2. the queue's size, deadline and close-flush triggers and its
   non-blocking poll;
3. micro-batched results bitwise equal to the port's ``serve_online``
   (bucket padding invisible, ``label_perm`` applied), and agreeing with
   the reference's batcher by the rule of ``repro_torch.parity`` (scores
   within rtol 1e-5 / atol 1e-6, labels equal outside near-ties);
4. ``start()`` warms every bucket, a ready batch is dispatched before the
   worker waits for the one in flight, a dispatch fault fails only its
   batch;
5. the ``queue_depth="auto"`` probe: floor at ``max_batch``, a zero drain
   time, no deadline, ``stop()`` during the probe.

Both engines serve with ``method="mscm_dense"`` (the CPU's ``"auto"`` in
both packages). Every wait has a bound of its own.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from repro.core import XMRTree as JTree
from repro.serving import BatchPolicy as JBatchPolicy
from repro.serving import MicroBatcher as JMicroBatcher
from repro.serving import Query as JQuery
from repro.serving import ServeConfig as JConfig
from repro.serving import XMRServingEngine as JEngine
from repro.sparse import csr as jcsr
from repro.sparse import random_sparse_csr
from repro_torch.core.tree import XMRTree
from repro_torch.parity import check_ranking
from repro_torch.serving import (
    AdmissionPolicy,
    BatchPolicy,
    MicroBatcher,
    Query,
    ServeConfig,
    XMRServingEngine,
)
from repro_torch.serving.batcher import (
    TRIGGER_DEADLINE,
    TRIGGER_FLUSH,
    TRIGGER_SIZE,
    RequestQueue,
    _device_ready,
    _InFlight,
    _Request,
)
from repro_torch.sparse import csr as tcsr
from tests.conftest import make_tree_weights
from tests.test_torch_tree import port_csc

KNOBS = dict(ell_width=32, max_batch=64, method="mscm_dense")
TIMEOUT = 60  # seconds: the bound of every wait in this file


def port_csr(x):
    return tcsr.CSR(x.indptr, x.indices, x.data, tuple(x.shape))


def results(futs):
    return [f.result(timeout=TIMEOUT) for f in futs]


# ---------------------------------------------------------------------------
# 1. CSR helpers, bitwise against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [None, 1, 4, 64])
def test_rows_to_ell_loop_matches_reference_and_vectorized(rng, width):
    x = random_sparse_csr(40, 300, 12, rng)
    t = port_csr(x)
    for rows in (np.arange(40), np.array([0, 39, 7, 7, 20]), np.zeros(0, np.int64)):
        want = jcsr.rows_to_ell_loop(x, rows, width)
        for got in (tcsr.rows_to_ell_loop(t, rows, width), tcsr.rows_to_ell(t, rows, width)):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_csr_helpers_match_reference(rng):
    dense = rng.standard_normal((9, 30)).astype(np.float32)
    dense[rng.random((9, 30)) < 0.7] = 0.0
    dense[4] = 0.0  # an empty row
    j, t = jcsr.CSR.from_dense(dense), tcsr.CSR.from_dense(dense)
    for name in ("indptr", "indices", "data"):
        assert getattr(t, name).dtype == getattr(j, name).dtype
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.shape == j.shape and t.nnz == j.nnz
    np.testing.assert_array_equal(t.row_nnz(), j.row_nnz())
    np.testing.assert_array_equal(t.to_dense(), dense)
    sel = np.array([8, 4, 0, 4])
    js, ts = j.slice_rows(sel), t.slice_rows(sel)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    assert ts.shape == js.shape == (4, 30)
    idx, val = tcsr.rows_to_ell(tcsr.CSR.from_dense(np.zeros((3, 10), np.float32)),
                                np.arange(3), 4)
    assert (idx == 10).all() and (val == 0).all()


# ---------------------------------------------------------------------------
# 2. RequestQueue triggers (no worker thread)
# ---------------------------------------------------------------------------

def _req(t=None):
    return _Request(
        idx=np.zeros(1, np.int32), val=np.zeros(1, np.float32), future=Future(),
        t_enqueue=time.perf_counter() if t is None else t,
    )


def test_size_trigger_fires_immediately():
    q = RequestQueue()
    for _ in range(20):
        q.put(_req())
    t0 = time.perf_counter()
    batch, trigger = q.next_batch(16, max_wait_s=10.0)
    assert trigger == TRIGGER_SIZE and len(batch) == 16
    assert time.perf_counter() - t0 < 1.0
    assert len(q) == 4


def test_deadline_trigger_fires_after_wait():
    q = RequestQueue()
    for _ in range(3):
        q.put(_req())
    t0 = time.perf_counter()
    batch, trigger = q.next_batch(16, max_wait_s=0.05)
    assert trigger == TRIGGER_DEADLINE and len(batch) == 3
    assert time.perf_counter() - t0 >= 0.04


def test_close_flushes_partial_batch():
    q = RequestQueue()
    q.put(_req())
    q.close()
    batch, trigger = q.next_batch(16, max_wait_s=60.0)
    assert trigger == TRIGGER_FLUSH and len(batch) == 1
    batch, _ = q.next_batch(16, max_wait_s=60.0)
    assert batch is None
    with pytest.raises(RuntimeError):
        q.put(_req())


def test_nonblocking_poll_returns_empty():
    q = RequestQueue()
    q.put(_req())
    assert q.next_batch(16, max_wait_s=60.0, block=False) == ([], "")


# ---------------------------------------------------------------------------
# 3. micro-batching against per-query serving and the reference's batcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving_setup():
    """``tests/test_serving.py``'s tree and queries, in both packages."""
    rng = np.random.default_rng(7)
    d, B = 200, 8
    ws = make_tree_weights(rng, d, [8, 64, 512], B)
    jt = JTree.from_weight_matrices(ws, B)
    tree = XMRTree.from_weight_matrices([port_csc(w) for w in ws], B, device="cpu")
    engine = XMRServingEngine(tree, ServeConfig(**KNOBS), device="cpu")
    engine.warmup(d, batch_sizes=(1, 2, 4, 8, 16))
    xq = random_sparse_csr(45, d, 15, rng)  # 45: a ragged tail
    queries = port_csr(xq)
    ref_s, ref_l = engine.serve_online(queries)
    return engine, queries, ref_s, ref_l, jt, xq


def test_microbatch_bitwise_equals_per_query(serving_setup):
    engine, queries, ref_s, ref_l, *_ = serving_setup
    mb = MicroBatcher(engine, BatchPolicy(max_batch=16, max_wait_ms=5.0))
    futs = mb.submit_csr(queries)  # before start: deterministic coalescing
    try:
        mb.start()
        res = results(futs)
    finally:
        mb.stop()
    np.testing.assert_array_equal(np.stack([r[0] for r in res]).view(np.uint32),
                                  ref_s.view(np.uint32))
    np.testing.assert_array_equal(np.stack([r[1] for r in res]), ref_l)
    s = mb.metrics.summary()
    assert s["count"] == 45 and s["triggers"][TRIGGER_SIZE] == 2
    assert mb.metrics.batch_sizes == [16, 16, 13]
    assert mb.metrics.bucket_sizes == [16, 16, 16]


def test_batcher_matches_reference_batcher(serving_setup):
    """The port's batcher and the reference's, on the same queries, same
    policy: the same coalescing, results by the cross-framework rule."""
    engine, queries, _, _, jt, xq = serving_setup
    out = {}
    for name, mb, qs, query in (
        ("ref", JMicroBatcher(JEngine(jt, JConfig(**KNOBS)),
                              JBatchPolicy(max_batch=16, max_wait_ms=5.0)), xq, JQuery),
        ("port", MicroBatcher(engine, BatchPolicy(max_batch=16, max_wait_ms=5.0)), queries,
         Query),
    ):
        futs = [mb.submit(query(*qs.row(i), qid=i)) for i in range(qs.shape[0])]
        try:
            mb.start()
            out[name] = (results(futs), mb.metrics)
        finally:
            mb.stop()
    (ref, ref_m), (got, got_m) = out["ref"], out["port"]
    assert [r.qid for r in got] == [r.qid for r in ref] == list(range(45))
    assert all(r.ok and r.beam_tier == 0 for r in got)
    check_ranking(np.stack([r.scores for r in got]), np.stack([r.ids for r in got]),
                  np.stack([r.scores for r in ref]), np.stack([r.ids for r in ref]),
                  "port batcher vs reference batcher")
    assert got_m.batch_sizes == ref_m.batch_sizes and got_m.triggers == ref_m.triggers
    assert got_m.bucket_sizes == ref_m.bucket_sizes


def test_bucket_padding_invisible(serving_setup):
    """13 requests pad to the 16-bucket; results equal the unpadded run."""
    engine, queries, ref_s, ref_l, *_ = serving_setup
    sub = queries.slice_rows(np.arange(13))
    xi, xv = engine.marshal_rows(sub, np.arange(13), bucket=16)
    assert xi.shape[0] == 16
    s, l = engine._run(xi, xv)
    np.testing.assert_array_equal(s.numpy()[:13], ref_s[:13])
    np.testing.assert_array_equal(l.numpy()[:13], ref_l[:13])
    assert (xi.numpy()[13:] == queries.shape[1]).all()  # padding: empty queries


def test_deadline_batches_resolve_without_size_trigger(serving_setup):
    engine, queries, ref_s, ref_l, *_ = serving_setup
    mb = MicroBatcher(engine, BatchPolicy(max_batch=16, max_wait_ms=10.0))
    try:
        mb.start()
        res = results(mb.submit_csr(queries.slice_rows(np.arange(3))))
    finally:
        mb.stop()
    np.testing.assert_array_equal(np.stack([r[0] for r in res]), ref_s[:3])
    np.testing.assert_array_equal(np.stack([r[1] for r in res]), ref_l[:3])
    trig = mb.metrics.summary()["triggers"]
    assert TRIGGER_SIZE not in trig
    assert TRIGGER_DEADLINE in trig or TRIGGER_FLUSH in trig


def test_serve_batch_matches_online(serving_setup):
    engine, queries, ref_s, ref_l, *_ = serving_setup
    s, l = engine.serve_batch(queries)
    np.testing.assert_array_equal(s, ref_s)
    np.testing.assert_array_equal(l, ref_l)


def test_label_perm_applied_through_batcher(serving_setup):
    engine, queries, ref_s, ref_l, *_ = serving_setup
    perm = np.arange(engine.tree.n_labels)[::-1].copy()
    eng2 = XMRServingEngine(engine.tree, engine.config, label_perm=perm, device="cpu")
    with MicroBatcher(eng2, BatchPolicy(max_batch=16, max_wait_ms=5.0)) as mb:
        res = results(mb.submit_csr(queries))
    np.testing.assert_array_equal(np.stack([r[1] for r in res]), perm[ref_l])


def test_amortized_batch_stats_stay_out_of_percentiles(serving_setup):
    engine, queries, *_ = serving_setup
    eng = XMRServingEngine(engine.tree, engine.config, device="cpu")
    eng.serve_batch(queries)
    summ = eng.latency_summary()
    assert summ["count"] == 0 and "p99_ms" not in summ
    assert summ["amortized"]["calls"] == 1 and summ["amortized"]["queries"] == 45
    eng.serve_online(queries, limit=5)
    summ = eng.latency_summary()
    assert summ["count"] == 5 and "p99_ms" in summ and summ["amortized"]["calls"] == 1


# ---------------------------------------------------------------------------
# 4. warm-up at start, dispatch before finalize, dispatch faults
# ---------------------------------------------------------------------------

def _recording(monkeypatch, eng):
    """Record the bucket and tier of every ``_run`` of ``eng``."""
    keys = []
    real_run = eng._run

    def run(xi, xv, tier=0):
        keys.append(eng.bucket_key(xi.shape[0], tier))
        return real_run(xi, xv, tier=tier)

    monkeypatch.setattr(eng, "_run", run)
    return keys


def test_start_warms_buckets_nothing_new_in_serving_path(serving_setup, monkeypatch):
    """start() runs every bucket the policy can form; live traffic then
    dispatches only keys it warmed."""
    engine, queries, *_ = serving_setup
    eng = XMRServingEngine(engine.tree, ServeConfig(**KNOBS), device="cpu")
    keys = _recording(monkeypatch, eng)
    mb = MicroBatcher(eng, BatchPolicy(max_batch=8, max_wait_ms=2.0))
    try:
        mb.start()
        warmed = set(keys)
        assert warmed == {(b, 0) for b in (1, 2, 4, 8)}
        results(mb.submit_csr(queries.slice_rows(np.arange(13))))
    finally:
        mb.stop()
    assert set(keys) == warmed and len(keys) > len(warmed)


def test_warmup_on_start_opt_out(serving_setup, monkeypatch):
    engine, *_ = serving_setup
    eng = XMRServingEngine(engine.tree, ServeConfig(**KNOBS), device="cpu")
    keys = _recording(monkeypatch, eng)
    mb = MicroBatcher(eng, BatchPolicy(max_batch=8), warmup_on_start=False)
    try:
        mb.start()
        assert keys == []
    finally:
        mb.stop()


class _NeverDone:
    """A CUDA event stand-in whose work never completes."""

    def query(self):
        return False


def test_ready_batch_dispatches_before_blocking_on_inflight(serving_setup):
    """A deadline-expired batch comes back from the worker's poll while the
    batch in flight is still on the device, not after _finalize."""
    engine, *_ = serving_setup
    mb = MicroBatcher(engine, BatchPolicy(max_batch=16, max_wait_ms=1.0),
                      warmup_on_start=False)
    stuck = _InFlight(reqs=[], scores=None, labels=None, done=_NeverDone(),
                      t_dequeue=0.0, bucket=1, trigger=TRIGGER_SIZE)
    assert not _device_ready(stuck)
    mb.queue.put(_req(t=time.perf_counter() - 1.0))  # deadline long past
    t0 = time.perf_counter()
    reqs, trigger = mb._poll_ready(stuck, 1e-3)
    assert trigger == TRIGGER_DEADLINE and len(reqs) == 1
    assert time.perf_counter() - t0 < 0.5
    mb.queue.close()


def test_cpu_dispatch_is_ready_at_once(serving_setup):
    """On an engine the caller put on the CPU the batch has finished when
    _dispatch returns: no event, ready, results on the host."""
    engine, queries, ref_s, ref_l, *_ = serving_setup
    mb = MicroBatcher(engine, BatchPolicy(max_batch=16), warmup_on_start=False)
    reqs = [_Request(*queries.row(i), future=Future(), t_enqueue=time.perf_counter())
            for i in range(5)]
    inflight = mb._dispatch(reqs, TRIGGER_SIZE)
    assert inflight.done is None and _device_ready(inflight)
    assert inflight.bucket == 8 and inflight.scores.shape[0] == 5
    mb._finalize(inflight)
    np.testing.assert_array_equal(np.stack([r.future.result(0)[0] for r in reqs]), ref_s[:5])
    mb.queue.close()


def test_dispatch_fault_fails_only_its_batch(serving_setup, monkeypatch):
    engine, queries, ref_s, ref_l, *_ = serving_setup
    eng = XMRServingEngine(engine.tree, engine.config, device="cpu")
    calls = {"n": 0}
    real_run = eng._run

    def flaky_run(xi, xv, tier=0):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected device fault")
        return real_run(xi, xv, tier=tier)

    monkeypatch.setattr(eng, "_run", flaky_run)
    mb = MicroBatcher(eng, BatchPolicy(max_batch=16, max_wait_ms=5.0), warmup_on_start=False)
    futs = mb.submit_csr(queries)  # 45 -> batches 16/16/13; batch 2 faults
    try:
        mb.start()
        outcomes = []
        for i, f in enumerate(futs):
            try:
                s, l = f.result(timeout=TIMEOUT)
                np.testing.assert_array_equal(s, ref_s[i])
                np.testing.assert_array_equal(l, ref_l[i])
                outcomes.append("ok")
            except RuntimeError as exc:
                assert "injected device fault" in str(exc)
                outcomes.append("fault")
        assert outcomes == ["ok"] * 16 + ["fault"] * 16 + ["ok"] * 13
        s, l = mb.submit(*queries.row(0)).result(timeout=TIMEOUT)  # still serving
        np.testing.assert_array_equal(s, ref_s[0])
    finally:
        mb.stop()


# ---------------------------------------------------------------------------
# 5. queue_depth="auto" and the lifecycle lock
# ---------------------------------------------------------------------------

def _auto_mb(engine, secs, monkeypatch, *, max_batch=16, deadline_ms=None):
    """A batcher with a fixed drain-rate probe (not started)."""
    monkeypatch.setattr(engine, "measure_batch_seconds",
                        lambda batch, iters=3, tier=0: secs)
    return MicroBatcher(engine, BatchPolicy(max_batch=max_batch, max_wait_ms=2.0),
                        admission=AdmissionPolicy(max_queue_depth="auto",
                                                  deadline_ms=deadline_ms))


def test_auto_depth_floors_at_max_batch_when_drain_is_slow(serving_setup, monkeypatch):
    engine, *_ = serving_setup
    assert _auto_mb(engine, 1e3, monkeypatch)._auto_queue_depth() == 16


def test_auto_depth_zero_drain_time_is_finite(serving_setup, monkeypatch):
    engine, *_ = serving_setup
    depth = _auto_mb(engine, 0.0, monkeypatch)._auto_queue_depth()
    assert isinstance(depth, int) and depth >= 16


def test_auto_depth_deadline_none_uses_coalescing_budget(serving_setup, monkeypatch):
    """No deadline: ten deadline-trigger windows (10 x 2 ms); with one, the
    deadline. 16 ms per 16-query bucket is a drain rate of 1000 QPS."""
    engine, *_ = serving_setup
    assert _auto_mb(engine, 0.016, monkeypatch)._auto_queue_depth() == 20
    assert _auto_mb(engine, 0.016, monkeypatch,
                    deadline_ms=50.0)._auto_queue_depth() == 50


def test_stop_during_auto_probe_waits_probe_out(serving_setup, monkeypatch):
    """stop() racing start()'s probe waits for it, then joins the worker."""
    engine, *_ = serving_setup
    probe_entered, release_probe = threading.Event(), threading.Event()

    def blocking_probe(batch, iters=3, tier=0):
        probe_entered.set()
        assert release_probe.wait(timeout=TIMEOUT), "probe never released"
        return 1e-3

    monkeypatch.setattr(engine, "measure_batch_seconds", blocking_probe)
    mb = MicroBatcher(engine, BatchPolicy(max_batch=16, max_wait_ms=2.0),
                      admission=AdmissionPolicy(max_queue_depth="auto"),
                      warmup_on_start=False)
    starter = threading.Thread(target=mb.start)
    stopper = threading.Thread(target=mb.stop)
    try:
        starter.start()
        assert probe_entered.wait(timeout=TIMEOUT)
        stopper.start()
        time.sleep(0.05)
        assert not mb.queue.closed  # stop() is parked on the lifecycle lock
    finally:
        release_probe.set()
        starter.join(timeout=TIMEOUT)
        if stopper.ident is None:  # an assertion above fired first
            stopper.start()
        stopper.join(timeout=TIMEOUT)
    assert not starter.is_alive() and not stopper.is_alive()
    assert isinstance(mb.admission.max_queue_depth, int)
    assert mb.queue.closed and mb._thread is None
