"""PyTorch port, admission control: the port's overload policy against the
reference's, scenario by scenario.

The counterparts of ``tests/test_admission.py``. Each scenario runs in both
packages on the same tree and queries, with every request enqueued before
``start()`` so that admission and coalescing are deterministic, and must
give the same shed counts, the same ``shed_by_priority`` and the same
status for every ``qid``: ``reject`` and weighted ``shed-oldest`` at a
bounded queue, deadlines that expire before dispatch, and ``stream``. The
requests the port serves are bitwise its own per-query results.
``AdmissionPolicy`` refuses what the reference refuses, with its errors.
Both engines serve with ``method="mscm_dense"``.
"""

import threading
import time
import types
import warnings

import numpy as np
import pytest

import repro.serving as J
import repro_torch.serving as T
from repro.core import XMRTree as JTree
from repro.sparse import random_sparse_csr
from repro_torch.core.tree import XMRTree
from repro_torch.serving.api import (
    STATUS_DEADLINE_EXCEEDED,
    STATUS_OK,
    STATUS_OVERLOADED,
)
from tests.conftest import make_tree_weights
from tests.test_torch_batcher import port_csr
from tests.test_torch_tree import port_csc

KNOBS = dict(ell_width=32, max_batch=64, method="mscm_dense")
TIMEOUT = 60  # seconds: the bound of every wait in this file


@pytest.fixture(scope="module")
def setup():
    """``tests/test_admission.py``'s tree and queries, in both packages:
    name -> (serving module, engine, queries), and the port's per-query
    results."""
    rng = np.random.default_rng(11)
    d, B = 200, 8
    ws = make_tree_weights(rng, d, [8, 64, 512], B)
    jeng = J.XMRServingEngine(JTree.from_weight_matrices(ws, B), J.ServeConfig(**KNOBS))
    tree = XMRTree.from_weight_matrices([port_csc(w) for w in ws], B, device="cpu")
    teng = T.XMRServingEngine(tree, T.ServeConfig(**KNOBS), device="cpu")
    for eng in (jeng, teng):
        eng.warmup_buckets(d, 16)
    xq = random_sparse_csr(40, d, 15, rng)
    tq = port_csr(xq)
    ref_s, ref_l = teng.serve_online(tq)
    pkgs = {"ref": types.SimpleNamespace(mod=J, engine=jeng, queries=xq),
            "port": types.SimpleNamespace(mod=T, engine=teng, queries=tq)}
    return pkgs, ref_s, ref_l


def _batcher(p, admission=None, max_batch=16, engine=None):
    return p.mod.MicroBatcher(engine or p.engine,
                              p.mod.BatchPolicy(max_batch=max_batch, max_wait_ms=5.0),
                              admission=admission, warmup_on_start=False)


def _run(p, admission, plan, **kw):
    """Submit ``plan`` (qid, row, priority, deadline_ms) as ``Query``s before
    start, then serve. Returns ({qid: result}, metrics summary)."""
    mb = _batcher(p, admission, **kw)
    futs = [mb.submit(p.mod.Query(*p.queries.row(row), qid=qid, priority=prio,
                                  deadline_ms=dl))
            for qid, row, prio, dl in plan]
    try:
        mb.start()
        res = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        mb.stop()
    return {r.qid: r for r in res}, mb.metrics.summary()


def _both(setup, policy, plan, **kw):
    """The scenario in both packages; asserts the same statuses, shed and
    deadline counts, and the port's served rows bitwise its per-query
    results. Returns the port's results and summary."""
    pkgs, ref_s, ref_l = setup
    out = {name: _run(p, p.mod.AdmissionPolicy(**policy), plan, **kw)
           for name, p in pkgs.items()}
    (jres, jsum), (tres, tsum) = out["ref"], out["port"]
    assert {q: r.status for q, r in tres.items()} == {q: r.status for q, r in jres.items()}
    for key in ("offered", "shed", "shed_rate", "shed_by_priority", "deadline_missed",
                "count", "batches"):
        assert tsum.get(key) == jsum.get(key), key
    rows = {qid: row for qid, row, _, _ in plan}
    for qid, r in tres.items():
        if r.ok:
            np.testing.assert_array_equal(r.scores.view(np.uint32),
                                          ref_s[rows[qid]].view(np.uint32))
            np.testing.assert_array_equal(r.ids, ref_l[rows[qid]])
        else:
            assert r.ids is None and r.scores is None
    return tres, tsum


def _plan(n, prio=lambda i: 0, deadline=lambda i: None):
    return [(i, i % 40, prio(i), deadline(i)) for i in range(n)]


# ---------------------------------------------------------------------------
# 1. bounded queue + shed policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shed_policy,served", [("reject", [0, 1]), ("shed-oldest", [2, 3])])
def test_bounded_queue_sheds_as_reference(setup, shed_policy, served):
    res, summ = _both(setup, dict(max_queue_depth=2, shed_policy=shed_policy), _plan(4))
    assert [q for q, r in res.items() if r.ok] == served
    for q, r in res.items():
        if not r.ok:
            assert r.status == STATUS_OVERLOADED and r.http_status == 429
            assert isinstance(r.error, T.Overloaded) and isinstance(r.error, T.ServingError)
            assert r.error.policy == shed_policy and r.error.queue_depth == 2
    assert summ["shed"] == 2 and summ["shed_rate"] == pytest.approx(0.5)


@pytest.mark.parametrize("shed_policy", ["reject", "shed-oldest"])
def test_flood_before_start_sheds_as_reference(setup, shed_policy):
    """120 requests at a bound of 8: 112 shed, the 8 survivors served."""
    res, summ = _both(setup, dict(max_queue_depth=8, shed_policy=shed_policy), _plan(120),
                      max_batch=8)
    served = sorted(q for q, r in res.items() if r.ok)
    assert served == (list(range(8)) if shed_policy == "reject" else list(range(112, 120)))
    assert summ["shed"] == 112 and summ["offered"] == 120 and summ["batches"] == 1


def test_weighted_shed_prefers_low_priority(setup):
    """The victim is the oldest request of the lowest priority present."""
    prios = [0, 2, 0, 1, 1]
    res, summ = _both(setup, dict(max_queue_depth=3, shed_policy="shed-oldest"),
                      _plan(5, prio=lambda i: prios[i]))
    assert [r.status for r in res.values()] == [STATUS_OVERLOADED, STATUS_OK,
                                                STATUS_OVERLOADED, STATUS_OK, STATUS_OK]
    assert summ["shed_by_priority"] == {0: 2}


def test_weighted_shed_rejects_outranked_arrival(setup):
    prios = [5, 5, 1]
    res, summ = _both(setup, dict(max_queue_depth=2, shed_policy="shed-oldest"),
                      _plan(3, prio=lambda i: prios[i]))
    assert [r.ok for r in res.values()] == [True, True, False]
    assert summ["shed_by_priority"] == {1: 1}


def test_priority_served_results_identical(setup):
    """Priorities steer shedding only: served results stay bitwise."""
    res, _ = _both(setup, {}, _plan(10, prio=lambda i: i % 3), max_batch=8)
    assert all(r.ok for r in res.values())


def test_admission_policy_validation_matches_reference():
    for kw in (dict(shed_policy="drop-random"), dict(max_queue_depth=0),
               dict(max_queue_depth="adaptive")):
        with pytest.raises(ValueError) as want:
            J.AdmissionPolicy(**kw)
        with pytest.raises(ValueError) as got:
            T.AdmissionPolicy(**kw)
        assert str(got.value) == str(want.value)
    T.AdmissionPolicy(max_queue_depth="auto")  # accepted


@pytest.mark.parametrize("form", ["flat", "nested"])
def test_admission_defaults_from_serve_config(setup, form):
    pkgs, *_ = setup
    knobs = dict(queue_depth=7, shed_policy="shed-oldest", deadline_ms=50.0)
    if form == "flat":
        with pytest.warns(DeprecationWarning, match="deprecated"):
            cfg = T.ServeConfig(**KNOBS, **knobs)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            cfg = T.ServeConfig(**KNOBS, admission=T.AdmissionConfig(**knobs))
    eng = T.XMRServingEngine(pkgs["port"].engine.tree, cfg, device="cpu")
    mb = T.MicroBatcher(eng, warmup_on_start=False)
    assert mb.admission == T.AdmissionPolicy(7, "shed-oldest", 50.0)
    mb.queue.close()


# ---------------------------------------------------------------------------
# 2. capacity-aware queue depth ("auto")
# ---------------------------------------------------------------------------

def test_auto_queue_depth_resolves_on_start(setup):
    pkgs, *_ = setup
    p = pkgs["port"]
    cfg = T.ServeConfig(**KNOBS, admission=T.AdmissionConfig(
        queue_depth="auto", shed_policy="shed-oldest", deadline_ms=100.0))
    eng = T.XMRServingEngine(p.engine.tree, cfg, device="cpu")
    mb = T.MicroBatcher(eng, T.BatchPolicy(max_batch=8, max_wait_ms=1.0))
    assert mb.admission.max_queue_depth == "auto"
    try:
        mb.start()
        depth = mb.admission.max_queue_depth
        assert isinstance(depth, int) and depth >= 8  # never below max_batch
        mb.submit(*p.queries.row(0)).result(timeout=TIMEOUT)
    finally:
        mb.stop()


# ---------------------------------------------------------------------------
# 3. deadlines, checked at dispatch
# ---------------------------------------------------------------------------

def test_expired_requests_never_reach_device(setup, monkeypatch):
    """Born-expired requests fail with DeadlineExceeded (HTTP 504) in both
    packages; their live batchmates are served; the port's device never
    sees the dead ones."""
    pkgs, *_ = setup
    eng = T.XMRServingEngine(pkgs["port"].engine.tree, T.ServeConfig(**KNOBS), device="cpu")
    rows = []
    real_run = eng._run

    def counting_run(xi, xv, tier=0):
        rows.append(int((xi[:, 0] != eng.tree.d).sum()))  # non-empty queries
        return real_run(xi, xv, tier=tier)

    monkeypatch.setattr(eng, "_run", counting_run)
    plan = _plan(6, deadline=lambda i: 0.0 if i % 2 == 0 else None)
    res, summ = _both(setup, {}, plan)
    assert [r.status for r in res.values()] == [STATUS_DEADLINE_EXCEEDED, STATUS_OK] * 3
    assert summ["deadline_missed"] == 3 and summ["shed"] == 0
    dead = res[0].error
    assert isinstance(dead, T.DeadlineExceeded) and dead.deadline_ms == pytest.approx(0.0)
    assert res[0].http_status == 504

    mb = T.MicroBatcher(eng, T.BatchPolicy(max_batch=16, max_wait_ms=1.0),
                        warmup_on_start=False)
    fut = mb.submit(*pkgs["port"].queries.row(0), deadline_ms=0.0)
    try:
        mb.start()
        assert isinstance(fut.exception(timeout=TIMEOUT), T.DeadlineExceeded)
    finally:
        mb.stop()
    assert rows == [] and mb.metrics.summary()["deadline_missed"] == 1


# ---------------------------------------------------------------------------
# 4. streaming
# ---------------------------------------------------------------------------

def _stream(p, admission, start_when, **kw):
    """``list(mb.stream(queries, **kw))``, the batcher started from another
    thread once ``start_when(mb)`` holds (or after ``TIMEOUT``)."""
    mb = p.mod.MicroBatcher(p.engine, p.mod.BatchPolicy(max_batch=16, max_wait_ms=2.0),
                            admission=admission, warmup_on_start=False)

    def starter():
        t_end = time.perf_counter() + TIMEOUT
        while not start_when(mb) and time.perf_counter() < t_end:
            time.sleep(1e-3)
        mb.start()

    th = threading.Thread(target=starter)
    th.start()
    try:
        out = list(mb.stream(p.queries, **kw))
    finally:
        th.join(timeout=TIMEOUT)
        mb.stop()
    assert not th.is_alive()
    return out, mb.metrics.summary()


@pytest.mark.parametrize("case", ["all", "shed", "expired"])
def test_stream_matches_reference(setup, case):
    """Every query comes back exactly once as a QueryResult; shed and
    expired ones as error results, the same qids in both packages."""
    pkgs, ref_s, ref_l = setup
    n = 40
    admission = {"all": {}, "shed": dict(max_queue_depth=4), "expired": {}}[case]
    kw = dict(deadline_ms=0.0) if case == "expired" else {}
    out = {}
    for name, p in pkgs.items():
        res, summ = _stream(p, p.mod.AdmissionPolicy(**admission),
                            lambda mb: mb.metrics.offered == n, **kw)
        assert sorted(r.index for r in res) == list(range(n))
        out[name] = ({r.qid: r.status for r in res}, summ, res)
    (jst, jsum, _), (tst, tsum, tres) = out["ref"], out["port"]
    assert tst == jst
    assert (tsum["shed"], tsum["deadline_missed"]) == (jsum["shed"], jsum["deadline_missed"])
    want_ok = {"all": n, "shed": 4, "expired": 0}[case]
    assert sum(s == STATUS_OK for s in tst.values()) == want_ok
    for r in tres:
        if r.ok:
            assert r.error is None
            np.testing.assert_array_equal(r.scores, ref_s[r.index])
            np.testing.assert_array_equal(r.labels, ref_l[r.index])
        else:
            assert isinstance(r.error, (T.Overloaded, T.DeadlineExceeded))
            assert r.scores is None and r.labels is None
