"""PyTorch port, HTTP gateway over a fleet of worker processes: exactness,
typed errors, degraded serving and supervised recovery, and the exchange
across frameworks.

The counterparts of the process tests of ``tests/test_fleet_gateway.py``
and ``tests/test_chaos.py``. Every fleet here is real: worker processes
(``python -m repro_torch.serving.fleet.worker --device cpu``, one thread
each), behind a ``MicroBatcher`` and a ``ServingGateway`` on localhost.

Exactness on the CPU: a fleet result is bitwise the in-process pipelined
engine's on the same batch (the same arithmetic on the same shapes). The
fleets serve ``mscm_pallas_grouped``, whose CPU plain version rounds no
element by its position, so they are also bitwise the unpartitioned engine
and, degraded, survivor-exact against an exhaustive search. HTTP clients
post one query at a time, so every batch is a bucket of 1 and is compared
with ``serve_online``. Across frameworks (a JAX coordinator with port
workers, and the reverse, on ``tests/test_fleet_gateway.py``'s queries):
labels equal, scores within rtol 1e-5 / atol 1e-6 of the coordinator's
own unpartitioned engine.

The gateway's status mapping (400, 404, 429, 503 after shutdown, 504) is
held against the reference's gateway on cheap in-process engines.
"""

import os
import re
import threading
import time

import numpy as np
import pytest

from repro.core import XMRTree as JTree
from repro.serving import AdmissionPolicy as JAdmissionPolicy
from repro.serving import BatchPolicy as JBatchPolicy
from repro.serving import MicroBatcher as JMicroBatcher
from repro.serving import PartitionConfig as JPartitionConfig
from repro.serving import Query as JQuery
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingGateway as JServingGateway
from repro.serving import XMRServingEngine as JEngine
from repro.serving import fleet as jfleet
from repro.sparse import random_sparse_csr
from repro_torch.core.tree import XMRTree
from repro_torch.serving import (
    AdmissionPolicy,
    BatchPolicy,
    FleetConfig,
    MicroBatcher,
    PartitionConfig,
    Query,
    ServeConfig,
    ServingGateway,
    WorkerUnavailable,
    XMRServingEngine,
)
from repro_torch.serving.fleet import (
    STATE_UP,
    FaultInjector,
    FleetSupervisor,
    PartitionFleet,
    launch_workers,
)
from repro_torch.sparse.csr import CSR
from tests.conftest import make_tree_weights
from tests.test_fleet_gateway import _get, _post
from tests.test_torch_fleet import _exhaustive, assert_survivor_exact, bits
from tests.test_torch_tree import port_csc

METHOD = "mscm_pallas_grouped"
KNOBS = dict(ell_width=32, max_batch=64)
# Worker processes: one thread each (the suite runs under several workers).
ENV = dict(os.environ, OMP_NUM_THREADS="1")
RTOL, ATOL = 1e-5, 1e-6


def port_csr(x):
    return CSR(x.indptr, x.indices, x.data, tuple(x.shape))


@pytest.fixture(scope="module")
def small_setup():
    """``tests/test_fleet_gateway.py``'s tree and queries in both packages."""
    rng = np.random.default_rng(11)
    d, B = 200, 8
    ws = make_tree_weights(rng, d, [8, 64, 512], B)
    jt = JTree.from_weight_matrices(ws, B)
    tt = XMRTree.from_weight_matrices([port_csc(w) for w in ws], B, device="cpu")
    jq = random_sparse_csr(20, d, 15, rng)
    return jt, tt, jq, port_csr(jq)


def engine(tree, partitions=1, method=METHOD, **fleet_kw):
    part = PartitionConfig(partitions=partitions, partition_sync="pipelined") \
        if partitions > 1 else PartitionConfig()
    return XMRServingEngine(tree, ServeConfig(method=method, partition=part,
                                              fleet=FleetConfig(**fleet_kw), **KNOBS),
                            device="cpu")


def assert_bitwise(s, l, s_want, l_want, what=""):
    assert np.array_equal(np.asarray(l), np.asarray(l_want)), what
    assert np.array_equal(bits(s), bits(s_want)), f"{what}: not bitwise"


# ---------------------------------------------------------------------------
# 1. a P = 2 fleet of processes behind the gateway: bitwise, then a kill
# ---------------------------------------------------------------------------

def test_fleet_gateway_bitwise_and_worker_failure(small_setup):
    _, tt, _, q = small_setup
    online = engine(tt).serve_online(q)
    piped_online = engine(tt, 2).serve_online(q)
    piped_batch = engine(tt, 2).serve_batch(q)
    assert_bitwise(*piped_online, *online, "in-process pipelined vs unpartitioned")
    eng = engine(tt, 2, degraded_policy="reject")
    with PartitionFleet.launch(2, device="cpu", env=ENV) as fleet:
        fleet.attach(eng)
        assert eng.planner.transport is fleet and fleet.degraded_policy == "reject"
        assert_bitwise(*eng.serve_batch(q), *piped_batch, "fleet serve_batch")
        with MicroBatcher(eng, BatchPolicy(max_batch=8, max_wait_ms=5.0)) as mb, \
                ServingGateway(mb, fleet=fleet) as gw:
            code, doc = _get(gw.url, "/healthz")
            assert code == 200 and doc["status"] == "ok"
            assert doc["workers"] == {"worker0": True, "worker1": True}
            for i in range(q.shape[0]):
                code, doc = _post(gw.url, Query(*q.row(i), qid=i).to_wire())
                assert code == 200 and doc["status"] == "ok" and doc["qid"] == i, doc
                assert doc["timing"]["e2e_ms"] > 0
                got_s, got_l = np.asarray(doc["scores"], np.float32), np.asarray(doc["ids"])
                assert_bitwise(got_s, got_l, piped_online[0][i], piped_online[1][i], f"q{i}")
                assert_bitwise(got_s, got_l, online[0][i], online[1][i], f"q{i} unpartitioned")
            code, doc = _get(gw.url, "/metrics")
            assert code == 200 and doc["count"] == q.shape[0]
            assert len(doc["partition_occupancy"]) == 2
            assert "fleet" not in doc  # no supervisor attached

            # Kill a worker: a typed 503 naming it within the bound.
            fleet.handles[0].kill()
            t0 = time.perf_counter()
            code, doc = _post(gw.url, Query(*q.row(0), qid=99).to_wire())
            assert code == 503 and doc["status"] == "worker_unavailable", doc
            assert "worker0" in doc["detail"]
            assert time.perf_counter() - t0 < 60.0
            code, doc = _get(gw.url, "/healthz")
            assert code == 503 and doc["status"] == "degraded"
            assert doc["workers"] == {"worker0": False, "worker1": True}
            assert doc["degraded_policy"] == "reject"
        with pytest.raises(WorkerUnavailable, match="worker0"):
            eng.serve_batch(q)


# ---------------------------------------------------------------------------
# 2. serve_partial: degraded, survivor-exact; the supervisor restores it
# ---------------------------------------------------------------------------

def test_degraded_serving_end_to_end(small_setup):
    """P = 3: a worker killed on its first ``step`` degrades the batch
    mid-exchange, which replays over the survivors: no label of the dead
    range, every score bitwise an exhaustive search's; the wire carries
    ``degraded`` and the missing range, ``/healthz`` stays 200; a cascade
    serves from one survivor; none left fails typed."""
    _, tt, _, q = small_setup
    full = engine(tt).serve_batch(q)
    xi, xv = engine(tt).marshal_rows(q, np.arange(q.shape[0]), q.shape[0])
    exhaustive = _exhaustive(tt, xi, xv, METHOD)
    eng = engine(tt, 3)
    with PartitionFleet.launch(3, device="cpu", env=ENV) as fleet:
        fleet.attach(eng)
        assert fleet.degraded_policy == "serve_partial"
        ranges = eng.index.label_ranges()
        assert_bitwise(*eng.serve_batch(q), *full, "full fleet")
        assert eng.last_degraded() is None

        # A corrupt frame does not kill the worker process.
        h2 = fleet.handles[2]
        h2.conn.fault = FaultInjector().rule("corrupt", op="ping", nth=1)
        with pytest.raises(WorkerUnavailable):
            h2.conn.call("ping")
        h2.conn.fault = None
        h2.conn.reconnect()
        assert h2.conn.call("ping")[0]["ok"] and h2.alive()

        h0 = fleet.handles[0]
        h0.conn.fault = FaultInjector().rule("kill", op="step", nth=1,
                                             callback=lambda: h0.kill(grace_s=0.0))
        s, l = eng.serve_batch(q)
        info = eng.last_degraded()
        assert info is not None and info["partitions"] == [0]
        assert [tuple(r) for r in info["label_ranges"]] == [ranges[0]]
        assert fleet.down_pids() == [0]
        assert_survivor_exact(s, l, [ranges[0]], exhaustive)

        with MicroBatcher(eng, BatchPolicy(max_batch=4, max_wait_ms=2.0)) as mb, \
                ServingGateway(mb, fleet=fleet) as gw:
            code, doc = _post(gw.url, Query(*q.row(0), qid=0).to_wire())
            assert code == 200 and doc["status"] == "ok" and doc["degraded"] is True, doc
            assert doc["missing_labels"] == [list(ranges[0])]
            assert_survivor_exact(np.asarray(doc["scores"], np.float32)[None],
                                  np.asarray(doc["ids"])[None], [ranges[0]], exhaustive[:1])
            code, hdoc = _get(gw.url, "/healthz")
            assert code == 200 and hdoc["status"] == "degraded", hdoc
            assert hdoc["workers"]["worker0"] is False
            assert hdoc["degraded_policy"] == "serve_partial"
            code, mdoc = _get(gw.url, "/metrics")
            assert code == 200 and mdoc["degraded_served"] >= 1

        fleet.handles[1].kill(grace_s=0.0)
        s, l = eng.serve_batch(q)
        assert eng.last_degraded()["partitions"] == [0, 1]
        assert fleet.down_pids() == [0, 1]
        assert_survivor_exact(s, l, [ranges[0], ranges[1]], exhaustive)

        fleet.handles[2].kill(grace_s=0.0)
        t0 = time.perf_counter()
        with pytest.raises(WorkerUnavailable):
            eng.serve_batch(q)
        assert time.perf_counter() - t0 < 60.0


def test_supervisor_respawns_real_worker_and_restores_exactness(small_setup):
    _, tt, _, q = small_setup
    full = engine(tt).serve_batch(q)
    eng = engine(tt, 2)
    cfg = FleetConfig(poll_interval_s=0.05, ping_timeout_s=2.0, suspect_after=1,
                      backoff_base_s=0.05, restart_budget=5)
    with PartitionFleet.launch(2, device="cpu", env=ENV) as fleet:
        fleet.attach(eng)
        with FleetSupervisor(fleet, cfg) as sup, \
                MicroBatcher(eng, BatchPolicy(max_batch=8, max_wait_ms=2.0)) as mb, \
                ServingGateway(mb, fleet=fleet) as gw:
            assert fleet.supervisor is sup
            assert_bitwise(*eng.serve_batch(q), *full, "before the kill")
            old_pid = fleet.handles[0].proc.pid
            fleet.handles[0].proc.kill()  # SIGKILL behind the fleet's back
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline:
                st = sup.states()["worker0"]
                if st["state"] == STATE_UP and st["restarts"] >= 1 and not fleet.down_pids():
                    break
                time.sleep(0.05)
            st = sup.states()["worker0"]
            assert st["state"] == STATE_UP and st["restarts"] >= 1, st
            assert fleet.handles[0].proc.pid != old_pid
            s, l = eng.serve_batch(q)
            assert eng.last_degraded() is None
            assert_bitwise(s, l, *full, "after the respawn")
            code, hdoc = _get(gw.url, "/healthz")
            assert code == 200 and hdoc["status"] == "ok"
            assert {w["state"] for w in hdoc["supervision"].values()} == {STATE_UP}
            code, mdoc = _get(gw.url, "/metrics")
            assert mdoc["fleet"]["up"] == 2 and mdoc["fleet"]["restarts_total"] >= 1
            assert mdoc["fleet"]["degraded_policy"] == "serve_partial"


# ---------------------------------------------------------------------------
# 3. across frameworks: the same frames both ways
# ---------------------------------------------------------------------------

def _addresses(handles):
    """Free the workers' launch connections (a worker serves one stream at
    a time) and return their addresses."""
    for h in handles:
        h.conn.close()
    return [(h.conn.host, h.conn.port) for h in handles]


def test_port_workers_answer_a_jax_coordinator(small_setup):
    jt, _, jq, _ = small_setup
    js, jl = JEngine(jt, JServeConfig(**KNOBS)).serve_batch(jq)
    handles = launch_workers(2, device="cpu", env=ENV)
    try:
        je = JEngine(jt, JServeConfig(partition=JPartitionConfig(
            partitions=2, partition_sync="pipelined"), **KNOBS))
        with jfleet.PartitionFleet.connect(_addresses(handles)) as fleet:
            fleet.attach(je)
            s, l = je.serve_batch(jq)
            assert je.last_degraded() is None
    finally:
        for h in handles:
            h.kill()
    np.testing.assert_array_equal(l, jl)
    np.testing.assert_allclose(s, js, rtol=RTOL, atol=ATOL)


def test_jax_workers_answer_a_port_coordinator(small_setup):
    _, tt, _, q = small_setup
    ts, tl = engine(tt, method="auto").serve_batch(q)
    handles = jfleet.launch_workers(2, env=dict(ENV, JAX_PLATFORMS="cpu"))
    try:
        eng = engine(tt, 2, method="auto")
        with PartitionFleet.connect(_addresses(handles)) as fleet:
            fleet.attach(eng)
            s, l = eng.serve_batch(q)
            assert eng.last_degraded() is None
    finally:
        for h in handles:
            h.kill()
    np.testing.assert_array_equal(l, tl)
    np.testing.assert_allclose(s, ts, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# 4. the gateway's status mapping, against the reference's gateway
# ---------------------------------------------------------------------------

def _packages(small_setup):
    jt, tt, jq, q = small_setup
    return {
        "port": (lambda **kw: engine(tt, method="auto", **kw), q, MicroBatcher, BatchPolicy,
                 AdmissionPolicy, ServingGateway, Query),
        "ref": (lambda **kw: JEngine(jt, JServeConfig(**KNOBS)), jq, JMicroBatcher,
                JBatchPolicy, JAdmissionPolicy, JServingGateway, JQuery),
    }


def _status_docs(pkg):
    """(code, status, detail) of each request a gateway maps, in order; the
    waits a detail quotes are masked (they are this run's timings)."""
    make, queries, MB, _, _, GW, Q = pkg
    eng = make()
    out = []
    idx, val = queries.row(0)
    with MB(eng, warmup_on_start=False) as mb, GW(mb) as gw:
        code, doc = _post(gw.url, {"v": 1})
        out.append((code, doc["status"], doc["detail"]))
        wire = Q(idx=idx, val=val).to_wire()
        wire["v"] = 99
        code, doc = _post(gw.url, wire)
        out.append((code, doc["status"], doc["detail"]))
        code, doc = _post(gw.url, Q(idx=idx, val=val, qid=1, deadline_ms=0.0).to_wire())
        out.append((code, doc["status"], re.sub(r"waited [0-9.]+ ms", "waited # ms",
                                                doc["detail"])))
        out.append(_get(gw.url, "/nope"))
        code, doc = _get(gw.url, "/healthz")
        out.append((code, doc))
        mb.stop()  # a closed queue: no request is admitted
        code, doc = _post(gw.url, Q(idx=idx, val=val).to_wire())
        out.append((code, doc["status"], doc["detail"]))
        out.append(_get(gw.url, "/healthz"))
    return out


def test_gateway_status_mapping_matches_reference(small_setup):
    """400 (malformed, wrong version), 504 (born expired), 404, healthz
    without a fleet, then 503 and ``closed`` after shutdown: the same
    codes and documents as the reference's gateway."""
    pkgs = _packages(small_setup)
    got, want = _status_docs(pkgs["port"]), _status_docs(pkgs["ref"])
    assert got == want
    assert [g[0] for g in got] == [400, 400, 504, 404, 200, 503, 503]
    assert got[-1][1]["status"] == "closed" and "workers" not in got[4][1]


def test_gateway_maps_overloaded_to_429(small_setup):
    _, tt, _, q = small_setup
    eng = engine(tt)
    want = eng.serve_online(q)
    real_run = eng._run

    def slow_run(xi, xv, tier=0):
        time.sleep(0.05)  # stretch the batch so that the queue must fill
        return real_run(xi, xv, tier=tier)

    eng._run = slow_run
    codes, bodies, lock = [], [], threading.Lock()
    mb = MicroBatcher(eng, BatchPolicy(max_batch=1, max_wait_ms=0.5),
                      admission=AdmissionPolicy(max_queue_depth=1),
                      warmup_on_start=False).start()
    try:
        with ServingGateway(mb) as gw:
            def fire(i):
                code, doc = _post(gw.url, Query(*q.row(i % q.shape[0]), qid=i).to_wire())
                with lock:
                    codes.append(code)
                    bodies.append(doc)

            threads = [threading.Thread(target=fire, args=(i,)) for i in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        mb.stop()
    assert codes.count(429) >= 1 and codes.count(200) >= 1, codes
    for code, doc in zip(codes, bodies):
        if code == 429:
            assert doc["status"] == "overloaded" and "shed" in doc["detail"]
        else:
            i = doc["qid"] % q.shape[0]
            assert code == 200
            assert_bitwise(np.asarray(doc["scores"], np.float32), np.asarray(doc["ids"]),
                           want[0][i], want[1][i], f"q{i}")
