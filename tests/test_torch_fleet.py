"""PyTorch port, partition fleet: the RPC frames, fault injection, ``load``
payloads, the partition runner and the supervisor against the reference's.

The counterparts of ``tests/test_fleet_gateway.py`` and
``tests/test_chaos.py`` that need no worker process (the process fleet is
in ``test_torch_gateway.py``):

1. frames: ``encode_frame`` gives the reference's bytes for the same header
   and arrays, and frames cross between the packages both ways (a large
   frame, sent buffer by buffer, included);
2. ``partition_payload`` gives the reference's encoded ``load`` frame, byte
   for byte, for an exact and a quantized index carried over from the
   reference; fp8 is refused with the reference's message;
3. ``FaultInjector``: drop, delay, truncate and corrupt give the reference's
   typed failures; the connection's lock, poisoning and reaping;
4. ``PartitionRunner`` in process: bitwise the in-process pipelined planner
   (the same arithmetic on the same shapes), against the reference's runner
   within the stated tolerance, and survivor-exact when a partition is down
   (the grouped method, bitwise on the CPU, against an exhaustive search);
5. the worker's connection loop on sockets in threads of this process:
   ``attach`` syncs ``degraded_policy``, and a corrupt frame does not kill it;
6. ``FleetSupervisor`` driven by ``poll_once`` on stub fleets, in both
   packages: the same ``states()`` and ``metrics()`` after every sweep.
"""

import contextlib
import socket
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import XMRTree as JTree
from repro.index import ScatterGatherPlanner as JPlanner
from repro.index import partition_tree as j_partition
from repro.quant import quantize_index as j_quantize_index
from repro.serving import FleetConfig as JFleetConfig
from repro.serving.admission import WorkerUnavailable as JWorkerUnavailable
from repro.serving.fleet import rpc as jrpc
from repro.serving.fleet import supervisor as jsup
from repro.serving.fleet.launcher import partition_payload as j_payload
from repro.serving.fleet.worker import PartitionRunner as JRunner
from repro.sparse import random_sparse_csr
from repro_torch.core.tree import XMRTree
from repro_torch.index import BeamTransport, ScatterGatherPlanner, partition_tree
from repro_torch.parity import check_ranking
from repro_torch.quant import quantize_index
from repro_torch.serving import (
    FleetConfig,
    PartitionConfig,
    ServeConfig,
    WorkerUnavailable,
    XMRServingEngine,
)
from repro_torch.serving.fleet import (
    STATE_FAILED,
    STATE_RESTARTING,
    STATE_SUSPECT,
    STATE_UP,
    FaultInjector,
    PartitionFleet,
    WorkerHandle,
    partition_payload,
)
from repro_torch.serving.fleet import rpc as trpc
from repro_torch.serving.fleet import supervisor as tsup
from repro_torch.serving.fleet.launcher import launch_workers
from repro_torch.serving.fleet.worker import PartitionRunner, _serve_connection
from tests.conftest import make_tree_weights
from tests.test_torch_partition import carry_index
from tests.test_torch_planner import assert_planner_bits
from tests.test_torch_tree import port_csc

# Port vs reference scores: f32 sums in other orders (the repo's rule).
RTOL, ATOL = 1e-5, 1e-6


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


@pytest.fixture(scope="module")
def world():
    """``tests/test_chaos.py``'s property tree (d = 96, B = 4) in both
    packages, partitioned P = 3 by the reference and carried over."""
    rng = np.random.default_rng(7)
    d, B = 96, 4
    ws = make_tree_weights(rng, d, [4, 16, 64], B)
    jt = JTree.from_weight_matrices(ws, B)
    tt = XMRTree.from_weight_matrices([port_csc(w) for w in ws], B, device="cpu")
    jidx = j_partition(jt, 3)
    x = random_sparse_csr(9, d, 10, rng)
    xi, xv = x.to_ell()
    return jt, tt, jidx, carry_index(jidx), xi, xv


# ---------------------------------------------------------------------------
# 1. frames
# ---------------------------------------------------------------------------

def _frame_cases():
    rng = np.random.default_rng(3)
    return {
        "ping": ({"op": "ping"}, []),
        "begin": ({"op": "begin", "beam": 5}, [
            rng.integers(0, 99, (4, 32)).astype(np.int32),
            rng.standard_normal((4, 32)).astype(np.float32),
            rng.integers(0, 9, (4, 3)).astype(np.int32),
            rng.random((4, 3)).astype(np.float32)]),
        "dtypes": ({"op": "load", "n_cols": [4, 16], "tier": "int8"}, [
            rng.integers(-127, 128, (2, 3, 4)).astype(np.int8),
            np.float32(2.5).reshape(()), np.zeros((0, 5), np.float32),
            np.arange(6, dtype=np.int64).reshape(2, 3), np.array([True, False]),
            np.arange(12, dtype=np.float16).reshape(3, 4).T]),  # non-contiguous
        "reply": ({"ok": False, "error": "KeyError: 'runner' — é"}, []),
    }


@pytest.mark.parametrize("case", list(_frame_cases()))
def test_encode_frame_bytes_match_reference(case):
    header, arrays = _frame_cases()[case]
    assert trpc.encode_frame(header, arrays) == jrpc.encode_frame(header, arrays)


def _round_trip(sender, receiver, header, arrays):
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=sender.send_frame, args=(a, header, arrays))
        t.start()
        got = receiver.recv_frame(b)
        t.join(timeout=60)
        assert not t.is_alive()
        return got
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("direction", ["port->ref", "ref->port", "port->port"])
@pytest.mark.parametrize("size", ["beam", "large"])
def test_frames_cross_between_packages(direction, size):
    """Either package reads the other's frames: a beam frame (joined) and a
    3 MB frame (the port sends it buffer by buffer)."""
    sender, receiver = {"port->ref": (trpc, jrpc), "ref->port": (jrpc, trpc),
                        "port->port": (trpc, trpc)}[direction]
    rng = np.random.default_rng(5)
    n = 8 if size == "beam" else 400_000
    arrays = [rng.integers(0, 1 << 20, (n, 2)).astype(np.int32),
              rng.standard_normal((n,)).astype(np.float32)]
    header = {"op": "step", "level": 2}
    got_h, got_a = _round_trip(sender, receiver, header, arrays)
    assert got_h == header
    for g, w in zip(got_a, arrays):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        assert g.flags.owndata and g.flags.aligned


def test_recv_frame_refuses_oversized_length():
    assert trpc.MAX_FRAME_BYTES == jrpc.MAX_FRAME_BYTES
    msgs = []
    for pkg in (trpc, jrpc):
        a, b = socket.socketpair()
        try:
            a.sendall(struct.pack(">Q", pkg.MAX_FRAME_BYTES + 1))
            with pytest.raises(ValueError) as err:
                pkg.recv_frame(b)
            msgs.append(str(err.value))
        finally:
            a.close()
            b.close()
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# 2. load payloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["exact", "int8", "int8_pruned"])
def test_partition_payload_matches_reference(world, tier):
    """The port's encoded ``load`` frame is the reference's, byte for byte,
    for every partition of the same index (quantized by the reference, then
    carried over): header keys in the same order, 4 arrays a layer exact, 3
    quantized."""
    jt, _, jidx, tidx, _, _ = world
    if tier != "exact":
        jidx = j_quantize_index(jidx, tier=tier)
        tidx = carry_index(jidx)
    kw = dict(beam=5, topk=4, method="mscm_pallas_grouped", score_mode="logsum", qt=4)
    for pid in range(jidx.n_partitions):
        t_head, t_arr = partition_payload(tidx, pid, **kw)
        j_head, j_arr = j_payload(jidx, pid, **kw)
        assert list(t_head) == list(j_head)
        assert len(t_arr) == len(j_arr) == (4 if tier == "exact" else 3) * (jt.depth - 1)
        assert trpc.encode_frame(t_head, t_arr) == jrpc.encode_frame(j_head, j_arr)


def test_partition_payload_refuses_fp8(world):
    _, _, jidx, tidx, _, _ = world
    with pytest.raises(ValueError) as t_err:
        partition_payload(quantize_index(tidx, tier="fp8"), 1, beam=5, topk=4,
                          method="mscm_pallas_grouped_q")
    with pytest.raises(ValueError) as j_err:
        j_payload(j_quantize_index(jidx, tier="fp8"), 1, beam=5, topk=4,
                  method="mscm_pallas_grouped_q")
    assert str(t_err.value) == str(j_err.value)
    assert "serve fp8 in-process" in str(t_err.value)


# ---------------------------------------------------------------------------
# 3. fault injection and connection semantics
# ---------------------------------------------------------------------------

class FakeWorker:
    """Minimal frame server of one package's RPC (``tests/test_fleet_gateway.
    py``'s): replies ``{"ok": True, "op", "seq"}`` to every op, ``seq``
    counting requests served; ``{"sleep": s}`` delays the reply. Like the
    real worker it drops a connection on a corrupt frame and accepts again."""

    def __init__(self, rpc=trpc):
        self.rpc = rpc
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(4)
        self.port = self.srv.getsockname()[1]
        self.seq = 0
        self.frames = []  # every request, as received
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return  # server closed
            try:
                while True:
                    header, arrays = self.rpc.recv_frame(conn)
                    self.frames.append((header, arrays))
                    delay = float(header.get("sleep", 0.0))
                    if delay:
                        time.sleep(delay)
                    seq, self.seq = self.seq, self.seq + 1
                    self.rpc.send_frame(conn, {"ok": True, "op": header.get("op"), "seq": seq},
                                        [np.asarray([seq], np.int64)] * 2)
            except (EOFError, OSError, ValueError):
                pass
            finally:
                conn.close()

    def close(self):
        try:
            self.srv.close()
        except OSError:
            pass


def _cause(cause: str) -> str:
    """A failure's cause, with the two ways a peer drops a stream (an EOF,
    or a reset when the dropped frame's tail was still unread) as one."""
    if cause.startswith("connection closed after") or "reset by peer" in cause:
        return "peer dropped the stream"
    return cause


def _fault_outcome(rpc, action):
    """One ping through ``action`` on the first call, then a reconnect and a
    clean ping: (error type and message or "ok", seconds at least 0.3,
    requests the server saw, the second ping's ok)."""
    w = FakeWorker(rpc)
    kw = dict(phase="recv", seconds=0.3) if action == "delay" else {}
    fault = rpc.FaultInjector().rule(action, op="ping", nth=1, **kw)
    conn = rpc.WorkerConnection("127.0.0.1", w.port, timeout_s=0.5 if action == "drop" else 5.0,
                                name="w0", fault=fault)
    try:
        t0 = time.perf_counter()
        try:
            conn.call("ping")
            first = "ok"
        except (JWorkerUnavailable, WorkerUnavailable) as exc:
            first = f"{type(exc).__name__}: {_cause(exc.cause)}"
        slow = time.perf_counter() - t0 >= 0.3
        time.sleep(0.05)  # the server drops the bad stream and accepts again
        conn.reconnect()
        header, _ = conn.call("ping")
        return first, slow, w.seq, header["ok"]
    finally:
        conn.close()
        w.close()


@pytest.mark.parametrize("action", ["drop", "delay", "truncate", "corrupt"])
def test_fault_injection_matches_reference(action):
    """Each fault gives the reference's typed failure (drop: a timeout;
    truncate: the stream closed locally; corrupt: the peer drops the
    stream), and the connection recovers after a reconnect."""
    got, want = _fault_outcome(trpc, action), _fault_outcome(jrpc, action)
    assert got == want
    first, slow, seq, ok = got
    assert ok
    assert first == {"drop": "WorkerUnavailable: timed out", "delay": "ok",
                     "truncate": "WorkerUnavailable: connection closed",
                     "corrupt": "WorkerUnavailable: peer dropped the stream"}[action]
    assert slow == (action in ("delay", "drop"))  # drop waits out the 0.5 s timeout


def test_fault_kill_rule_and_validation():
    killed = []
    w = FakeWorker()
    fault = FaultInjector().rule("kill", op="step", nth=2, callback=lambda: killed.append(1))
    conn = trpc.WorkerConnection("127.0.0.1", w.port, timeout_s=5.0, fault=fault)
    try:
        for i in range(3):
            conn.call("step")
            assert len(killed) == (1 if i >= 1 else 0)
    finally:
        conn.close()
        w.close()
    for pkg in (trpc, jrpc):
        with pytest.raises(ValueError, match="unknown fault action"):
            pkg.FaultInjector().rule("explode")
        with pytest.raises(ValueError, match="only apply on send"):
            pkg.FaultInjector().rule("corrupt", phase="recv")


def test_corrupt_reply_is_typed_and_closes_connection():
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        try:
            trpc.recv_frame(conn)
            conn.sendall(struct.pack(">Q", trpc.MAX_FRAME_BYTES + 1))
            time.sleep(1.0)
        finally:
            conn.close()
            srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    conn = trpc.WorkerConnection("127.0.0.1", srv.getsockname()[1], timeout_s=10.0, name="w0")
    with pytest.raises(WorkerUnavailable, match="corrupt frame"):
        conn.call("ping")
    with pytest.raises(WorkerUnavailable, match="connection closed"):
        conn.send("ping")
    with pytest.raises(WorkerUnavailable, match="connection closed"):
        conn.recv("ping")
    t.join(timeout=10)


def test_lock_serializes_concurrent_callers():
    """Pings racing beam ops on one connection never interleave frames."""
    w = FakeWorker()
    conn = trpc.WorkerConnection("127.0.0.1", w.port, timeout_s=30.0, name="w0")
    errors = []

    def hammer(op, n):
        try:
            for _ in range(n):
                header, arrays = conn.call(op)
                assert header["op"] == op, f"{op} got {header['op']} reply"
                assert len(arrays) == 2
        except (AssertionError, WorkerUnavailable) as exc:
            errors.append(exc)

    threads = [threading.Thread(target=hammer, args=(op, 50)) for op in ("begin", "ping", "step")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    conn.close()
    w.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_fanout_failure_resets_streams_no_stale_replies():
    """A mid-exchange timeout resets every stream: the next exchange gets
    fresh replies, never the abandoned one's buffered reply."""
    a, b = FakeWorker(), FakeWorker()
    fleet = PartitionFleet([
        WorkerHandle(trpc.WorkerConnection("127.0.0.1", w.port, timeout_s=1.0, name=f"w{i}"))
        for i, w in enumerate((a, b))
    ])
    try:
        with pytest.raises(WorkerUnavailable):
            fleet._exchange("echo", [{"sleep": 1.5}, {}], [[], []])
        time.sleep(1.2)  # worker0 finishes the abandoned request and accepts again
        replies = fleet._exchange("echo", [{}, {}], [[], []])
        assert [h["seq"] for h, _ in replies] == [1, 1]
    finally:
        for h in fleet.handles:
            h.conn.close()
        a.close()
        b.close()


def test_fleet_beam_frames_are_the_reference_fleets():
    """What the coordinator sends is the reference fleet's, byte for byte,
    for the same beams: ids ``<i4`` (the port's router gives int64), scores
    ``<f4``, and a tier override in the begin header only when set."""
    from repro.serving import fleet as jfleet
    from repro_torch.serving import fleet as tfleet

    rng = np.random.default_rng(9)
    xi = rng.integers(0, 50, (3, 8)).astype(np.int32)
    xv = rng.random((3, 8)).astype(np.float32)
    ids = rng.integers(0, 40, (3, 4))
    sc = rng.random((3, 4)).astype(np.float32)
    wire = {}
    for name, pkg, rpc, id_dtype in (("port", tfleet, trpc, np.int64),
                                     ("ref", jfleet, jrpc, np.int32)):
        workers = [FakeWorker(rpc) for _ in range(2)]
        fleet = pkg.PartitionFleet([
            pkg.WorkerHandle(rpc.WorkerConnection("127.0.0.1", w.port, name=f"w{i}"))
            for i, w in enumerate(workers)])
        try:
            fleet.begin(xi, xv, ids.astype(id_dtype), sc)
            fleet.step(2, ids.astype(id_dtype))
            fleet.begin(xi, xv, ids.astype(id_dtype), sc, beam=3, qt=4)
        finally:
            for h in fleet.handles:
                h.conn.close()
            for w in workers:
                w.close()
        wire[name] = [trpc.encode_frame(h, a) for w in workers for h, a in w.frames]
        frames = workers[0].frames
    assert wire["port"] == wire["ref"] and len(wire["port"]) == 6
    assert [h for h, _ in frames] == [{"op": "begin"}, {"level": 2, "op": "step"},
                                      {"beam": 3, "qt": 4, "op": "begin"}]
    assert [a.dtype.str for a in frames[0][1]] == ["<i4", "<f4", "<i4", "<f4"]


def test_launch_workers_reaps_all_procs_on_failure(monkeypatch):
    """A failure at worker i must not orphan processes i..n-1."""
    import repro_torch.serving.fleet.launcher as launcher_mod

    spawned = []
    real_popen = launcher_mod.subprocess.Popen

    def tracking_popen(*args, **kwargs):
        proc = real_popen(*args, **kwargs)
        spawned.append(proc)
        return proc

    def failing_announce(proc, timeout_s, name):
        raise WorkerUnavailable(name, "launch", "forced announce failure")

    monkeypatch.setattr(launcher_mod.subprocess, "Popen", tracking_popen)
    monkeypatch.setattr(launcher_mod, "_read_announce", failing_announce)
    with pytest.raises(WorkerUnavailable):
        launch_workers(3, device="cpu", env={"OMP_NUM_THREADS": "1", "PATH": ""})
    assert len(spawned) == 3
    for proc in spawned:
        assert proc.poll() is not None, "worker process orphaned"
        assert proc.args[-2:] == ["--device", "cpu"]


def test_worker_without_a_card_fails_before_announcing():
    """No device named and no card: the worker exits before it announces,
    and the launch fails typed; nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device resolves")
    with pytest.raises(WorkerUnavailable, match="no announcement"):
        launch_workers(1, env={"OMP_NUM_THREADS": "1", "PATH": ""}, startup_timeout_s=60)


# ---------------------------------------------------------------------------
# 4. the partition runner in process
# ---------------------------------------------------------------------------

class RunnerTransport(BeamTransport):
    """``PartitionRunner``s behind the transport protocol, in process, with a
    fixed down-set (``tests/test_chaos.py``'s ``_InProcTransport``)."""

    def __init__(self, runners, down=()):
        self.runners, self.down, self.live = runners, set(down), None

    @property
    def n_partitions(self):
        return len(self.runners)

    def down_partitions(self):
        return sorted(self.down)

    def begin(self, x_idx, x_val, parent_ids, scores, *, beam=None, qt=None):
        self.live = [p for p in range(len(self.runners)) if p not in self.down]
        return [self.runners[p].begin(x_idx, x_val, parent_ids, scores, beam=beam, qt=qt)
                for p in self.live]

    def step(self, level, winner_ids):
        return [self.runners[p].step(level, winner_ids) for p in self.live]


def runners_for(index, **kw):
    return [PartitionRunner(*partition_payload(index, pid, **kw), device="cpu")
            for pid in range(index.n_partitions)]


@pytest.mark.parametrize("tier,method", [
    ("exact", "mscm_dense"), ("exact", "mscm_pallas_grouped"), ("exact", "vanilla"),
    ("int8", "mscm_pallas_grouped_q")])
@pytest.mark.parametrize("n_partitions", [2, 3])
def test_runner_bitwise_in_process_pipelined(world, method, n_partitions, tier):
    """Runners fed their ``load`` payloads serve bitwise the in-process
    pipelined planner on the same index, at the full beam and at a tier's
    narrower one (the begin header's override)."""
    _, tt, _, _, xi, xv = world
    idx = partition_tree(tt, n_partitions)
    if tier != "exact":
        idx = quantize_index(idx, tier=tier)
    kw = dict(beam=6, topk=5, method=method)
    xi_t, xv_t = torch.from_numpy(xi), torch.from_numpy(xv)
    remote = ScatterGatherPlanner(idx, sync="pipelined", **kw,
                                  transport=RunnerTransport(runners_for(idx, **kw)))
    local = ScatterGatherPlanner(idx, sync="pipelined", **kw)
    for beam in (None, 3):
        got, want = remote.infer(xi_t, xv_t, beam=beam), local.infer(xi_t, xv_t, beam=beam)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert remote.last_degraded is None


@pytest.mark.parametrize("method", ["mscm_dense", "mscm_pallas_grouped"])
def test_runner_matches_reference_runner(world, method):
    """On the reference's own payloads, the port's runner and the
    reference's give the same beams at every exchange: ids equal outside
    near-ties, scores within rtol 1e-5 / atol 1e-6; the planners over them
    give the unpartitioned ranking (2 ULP on the CPU but for the grouped
    method, as ``tests/test_torch_planner.py`` allows)."""
    jt, tt, jidx, tidx, xi, xv = world
    kw = dict(beam=6, topk=5, method=method)
    payloads = [j_payload(jidx, pid, **kw) for pid in range(jidx.n_partitions)]
    t_run = [PartitionRunner(h, a, device="cpu") for h, a in payloads]
    j_run = [JRunner(h, a) for h, a in payloads]
    jpl = JPlanner(jidx, sync="pipelined", **kw)
    s, l = jpl._route(jnp.asarray(xi), jnp.asarray(xv), beam=6, qt=8)
    ids, sc = np.asarray(l), np.asarray(s)
    t_beams = [r.begin(xi, xv, ids, sc) for r in t_run]
    j_beams = [r.begin(xi, xv, ids, sc) for r in j_run]
    for li in range(jidx.level, jt.depth):
        if li > jidx.level:
            t_beams = [r.step(li, winners) for r in t_run]
            j_beams = [r.step(li, winners) for r in j_run]
        for (ti, ts), (ji, js) in zip(t_beams, j_beams):
            assert ti.dtype == np.int32 and ts.dtype == np.float32
            assert ti.shape == ji.shape
            check_ranking(ts, ti, np.asarray(js), np.asarray(ji), rtol=RTOL, atol=ATOL)
        # The reference's merge of the reference's beams: both runners
        # continue from the same winners.
        width = min(jpl.topk if li == jt.depth - 1 else jpl.beam, jidx.n_cols[li])
        cat_s = np.concatenate([np.asarray(s_) for _, s_ in j_beams], axis=1)
        cat_i = np.concatenate([np.asarray(i_) for i_, _ in j_beams], axis=1)
        order = np.lexsort((cat_i, -cat_s), axis=1)[:, :width]
        winners = np.take_along_axis(cat_i, order, 1).astype(np.int32)
    over = ScatterGatherPlanner(tidx, sync="pipelined", **kw,
                                transport=RunnerTransport(t_run))
    xi_t, xv_t = torch.from_numpy(xi), torch.from_numpy(xv)
    assert_planner_bits(over.infer(xi_t, xv_t), tt.infer(xi_t, xv_t, beam=6, topk=5,
                                                         method=method), method, "pipelined")


def _exhaustive(tree, xi_t, xv_t, method):
    """Every label's exact score bits, by row: beam >= every level's width."""
    n = tree.n_labels
    s, l = tree.infer(xi_t, xv_t, beam=n, topk=n, method=method)
    sb = bits(s.numpy())
    return [{int(l[i, k]): int(sb[i, k]) for k in range(n)} for i in range(l.shape[0])]


def assert_survivor_exact(s, l, missing, exhaustive):
    """No label of a dead range; every score the exhaustive search's bits."""
    s, l = np.asarray(s), np.asarray(l)
    for row in range(l.shape[0]):
        sb = bits(s[row])
        for k, label in enumerate(l[row]):
            assert not any(lo <= label < hi for lo, hi in missing), (row, int(label))
            assert sb[k] == exhaustive[row][int(label)], f"row {row} label {label}"


@pytest.mark.parametrize("dead", [0, 1, 2])
def test_degraded_runner_transport_is_survivor_exact(world, dead):
    """One partition down: the dead range is stamped and never served, and
    every served score is bitwise the exhaustive search's (the grouped
    method, whose CPU plain version has no position-dependent rounding)."""
    _, tt, _, _, xi, xv = world
    method = "mscm_pallas_grouped"
    idx = partition_tree(tt, 3)
    kw = dict(beam=5, topk=5, method=method)
    pl = ScatterGatherPlanner(idx, sync="pipelined", **kw,
                              transport=RunnerTransport(runners_for(idx, **kw), down={dead}))
    xi_t, xv_t = torch.from_numpy(xi), torch.from_numpy(xv)
    s, l = pl.infer(xi_t, xv_t)
    info = pl.last_degraded
    assert info is not None and info["partitions"] == [dead]
    assert [tuple(r) for r in info["label_ranges"]] == [idx.label_ranges()[dead]]
    assert_survivor_exact(s.numpy(), l.numpy(), info["label_ranges"],
                          _exhaustive(tt, xi_t, xv_t, method))


# ---------------------------------------------------------------------------
# 5. the worker's connection loop, on sockets in threads of this process
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def thread_workers(n, device="cpu"):
    """``n`` workers serving ``_serve_connection`` on localhost sockets in
    threads of this process (what a worker's ``main`` runs, without the
    process). Yields their addresses."""
    servers, threads = [], []

    def serve(srv, state):
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            try:
                if _serve_connection(conn, state):
                    return
            finally:
                conn.close()

    for _ in range(n):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        t = threading.Thread(target=serve, args=(srv, {"runner": None, "device": device}),
                             daemon=True)
        t.start()
        servers.append(srv)
        threads.append(t)
    try:
        yield [("127.0.0.1", s.getsockname()[1]) for s in servers]
    finally:
        for s in servers:
            try:
                s.shutdown(socket.SHUT_RDWR)  # wakes a thread blocked in accept()
            except OSError:
                pass
            s.close()
        for t in threads:
            t.join(timeout=10)


def partitioned_engine(tree, partitions, method="mscm_pallas_grouped", **fleet_kw):
    return XMRServingEngine(tree, ServeConfig(
        ell_width=32, max_batch=16, method=method,
        partition=PartitionConfig(partitions=partitions, partition_sync="pipelined"),
        fleet=FleetConfig(**fleet_kw)), device="cpu")


@pytest.mark.parametrize("policy", ["reject", "serve_partial"])
def test_attach_syncs_degraded_policy_and_serves_bitwise(world, policy):
    """``attach`` takes the engine's ``fleet.degraded_policy`` (the
    reference's rule) and refuses a bad one; the thread-served fleet is
    bitwise the in-process pipelined engine."""
    _, tt, _, _, xi, xv = world
    from repro_torch.sparse.csr import CSR

    rng = np.random.default_rng(2)
    q = random_sparse_csr(7, tt.d, 10, rng)
    q = CSR(q.indptr, q.indices, q.data, tuple(q.shape))
    want = partitioned_engine(tt, 2, degraded_policy=policy).serve_batch(q)
    eng = partitioned_engine(tt, 2, degraded_policy=policy)
    with thread_workers(2) as addrs, PartitionFleet.connect(addrs) as fleet:
        other = "reject" if policy == "serve_partial" else "serve_partial"
        fleet.degraded_policy = other
        assert fleet.attach(eng) is fleet and eng.fleet is fleet
        assert fleet.degraded_policy == policy == eng.config.degraded_policy
        assert eng.planner.transport is fleet
        got = eng.serve_batch(q)
        assert np.array_equal(got[1], want[1]) and np.array_equal(bits(got[0]), bits(want[0]))
        assert fleet.ping() == {f"worker{i}@{h}:{p}": True for i, (h, p) in enumerate(addrs)}
        eng.config.fleet.degraded_policy = "best_effort"
        with pytest.raises(ValueError, match="degraded_policy"):
            fleet.attach(eng)
        for bad in (dict(partition_sync="level"), dict(beam_cache=4)):
            e = XMRServingEngine(tt, ServeConfig(ell_width=32, max_batch=16, partition=(
                PartitionConfig(partitions=2, **{"partition_sync": "pipelined", **bad}))),
                device="cpu")
            with pytest.raises(ValueError, match="pipelined" if "partition_sync" in bad
                               else "beam_cache"):
                fleet.attach(e)
        with pytest.raises(ValueError, match="unpartitioned"):
            fleet.attach(XMRServingEngine(tt, ServeConfig(), device="cpu"))


def test_worker_survives_corrupt_frame_and_reports_errors(world):
    """A corrupt frame drops only the stream; an op before ``load`` and an
    unknown op reply typed errors and the worker keeps serving."""
    with thread_workers(1) as [(host, port)]:
        conn = trpc.WorkerConnection(host, port, timeout_s=10.0, name="w0")
        try:
            conn.fault = FaultInjector().rule("corrupt", op="ping", nth=1)
            with pytest.raises(WorkerUnavailable):
                conn.call("ping")
            conn.fault = None
            conn.reconnect()
            header, _ = conn.call("ping")
            assert header["ok"] and header["loaded"] is False
            with pytest.raises(trpc.RemoteError, match="unknown op 'bogus'"):
                conn.call("bogus")
            with pytest.raises(trpc.RemoteError, match="AttributeError"):  # no runner
                conn.call("step", {"level": 2}, [np.zeros((1, 1), np.int32)])
            assert conn.call("shutdown")[0]["ok"]
        finally:
            conn.close()


# ---------------------------------------------------------------------------
# 6. the supervisor's state machine, in both packages
# ---------------------------------------------------------------------------

class _StubConn:
    def __init__(self, handle, error):
        self.lock = threading.RLock()
        self.timeout_s = 1.0
        self._handle, self._error = handle, error

    def call(self, op, header=None, arrays=(), timeout_s=None):
        if not self._handle.ping_ok:
            raise self._error("stub", op, "injected probe failure")
        return {"ok": True}, []


class _StubHandle:
    def __init__(self, error):
        self.dead = False
        self.ping_ok = True
        self.conn = _StubConn(self, error)

    def alive(self):
        return not self.dead


class _StubFleet:
    """What the supervisor reads and calls of a fleet
    (``tests/test_chaos.py``'s stub), raising one package's typed error."""

    def __init__(self, error, n=1, respawn_failures=0):
        self._error = error
        self._state_lock = threading.Lock()
        self._down = set()
        self.handles = [_StubHandle(error) for _ in range(n)]
        self.degraded_policy = "serve_partial"
        self.supervisor = None
        self.respawn_calls = 0
        self.respawn_failures = respawn_failures

    def mark_down(self, pid):
        with self._state_lock:
            self._down.add(pid)

    def respawn_worker(self, pid):
        self.respawn_calls += 1
        if self.respawn_calls <= self.respawn_failures:
            raise self._error(f"worker{pid}", "launch", "forced failure")
        with self._state_lock:
            self._down.discard(pid)
        self.handles[pid].dead = False
        self.handles[pid].ping_ok = True


def _suspect_blip(f, sweep):
    f.handles[0].ping_ok = False
    sweep()
    f.handles[0].ping_ok = True
    sweep()


def _restart_after_probes(f, sweep):
    f.handles[0].ping_ok = False
    for _ in range(3):
        sweep()  # SUSPECT, RESTARTING (marked down), attempt 1 fails
    sweep(0.01)  # inside the backoff: no attempt
    sweep(0.02)  # attempt 2 fails, backoff doubles
    sweep(0.05)  # attempt 3 succeeds


def _dead_until_failed(f, sweep):
    f.handles[1].dead = True
    for _ in range(5):
        sweep()


def _marked_down(f, sweep):
    f.mark_down(0)  # a failed exchange
    f.handles[1].ping_ok = False
    for _ in range(3):
        sweep()


SCENARIOS = {
    "suspect_blip": (dict(suspect_after=3), dict(), _suspect_blip),
    "restart_after_probes": (dict(suspect_after=2, backoff_base_s=0.02, restart_budget=5),
                             dict(respawn_failures=2), _restart_after_probes),
    "dead_until_failed": (dict(restart_budget=2, backoff_base_s=0.0, backoff_max_s=0.0),
                          dict(n=2, respawn_failures=10 ** 9), _dead_until_failed),
    "marked_down": (dict(suspect_after=1), dict(n=2, respawn_failures=1), _marked_down),
}


def _drive(mod, config_cls, error, scenario, monkeypatch):
    cfg, fleet_kw, script = SCENARIOS[scenario]
    clock = [1000.0]
    monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
    fleet = _StubFleet(error, **fleet_kw)
    sup = mod.FleetSupervisor(fleet, config_cls(**cfg))
    trace = [(sup.states(), sup.metrics())]

    def sweep(advance=0.0):
        clock[0] += advance
        sup.poll_once()
        trace.append((sup.states(), sup.metrics(), sorted(fleet._down), fleet.respawn_calls))

    script(fleet, sweep)
    return trace


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_supervisor_state_machine_matches_reference(scenario, monkeypatch):
    got = _drive(tsup, FleetConfig, WorkerUnavailable, scenario, monkeypatch)
    want = _drive(jsup, JFleetConfig, JWorkerUnavailable, scenario, monkeypatch)
    assert got == want
    final = {w["state"] for w in got[-1][0].values()}
    assert final <= set(tsup.WORKER_STATES)
    expect = {"suspect_blip": {STATE_UP}, "restart_after_probes": {STATE_UP},
              "dead_until_failed": {STATE_UP, STATE_FAILED},
              "marked_down": {STATE_UP, STATE_RESTARTING}}[scenario]
    assert final == expect, got[-1]
    if scenario == "suspect_blip":
        assert got[1][0]["worker0"]["state"] == STATE_SUSPECT


def test_supervisor_lifecycle():
    fleet = _StubFleet(WorkerUnavailable, n=2)
    with tsup.FleetSupervisor(fleet, FleetConfig(poll_interval_s=0.01)) as sup:
        assert fleet.supervisor is sup
        with pytest.raises(RuntimeError, match="already started"):
            sup.start()
        fleet.handles[1].dead = True
        deadline = time.monotonic() + 10
        while fleet.respawn_calls == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert fleet.supervisor is None
    assert fleet.respawn_calls >= 1 and sup.metrics()["restarts_total"] >= 1
