"""The serving engine's CUDA graphs (``XMRServingEngine._run``): where they
engage, and on the card that a replay is bitwise the eager traversal.

On the CPU: the rule (``_graphable``) on a plain tree and on one chip's share
through the planner (the router head and one partition of the leaf level), and off it
with replicas (``shards=2``), a placement, a beam cache and a transport,
where every run stays eager and no graph is captured or replayed.

On the card (skipped without one, from the fixture): each engine's replays
held bitwise to the eager traversal of the same engine (``_traverse``:
``tree.infer`` / ``planner.infer``) on the f32 and int8 tiers at buckets 1
and 64, over distinct queries back to back, each answer read again after the
later calls; a run on another stream eager; the memory ``warmup_buckets``
adds; no CUDA event recorded by ``obs`` while a graph is captured, and each
replay counting the launches its capture counted. The file imports nothing
of JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.tree import XMRTree
from repro_torch.index import ScatterGatherPlanner, partition_tree
from repro_torch.serving import PartitionConfig, QuantConfig, ServeConfig, XMRServingEngine
from repro_torch.sparse.csr import random_sparse_csr, random_sparse_csc

from beam_transport import LocalTransport

#: A whole tree of 3, 11 and 52 labels (ragged chunks at both lower levels).
D, LEVELS, BRANCHING = 3000, (3, 11, 52), (3, 4, 5)
SERVE = {"beam": 4, "topk": 5, "method": "mscm_pallas_grouped", "max_batch": 64,
         "ell_width": 64}


def _counts():
    return obs.total("graph.capture"), obs.total("graph.replay")


def _share(tree):
    """One chip's share of ``tree``: the levels above the leaves whole, as the
    router head, and as the only partition the leaf level's chunks [4, 11),
    cut as ``partition_tree`` cuts the second of two partitions."""
    split = tree.depth - 1
    cut = partition_tree(tree, 2, level=split, bounds=[0, 4, tree.n_cols[split - 1]])
    info = dataclasses.replace(cut.manifest.partitions[1], pid=0)
    manifest = dataclasses.replace(cut.manifest, n_partitions=1, partitions=[info])
    return dataclasses.replace(cut, parts=cut.parts[1:], manifest=manifest)


def _with_planner(eng, index=None, **kw):
    """``eng`` serving ``index`` (its own by default) through a planner."""
    c = eng.config
    eng.index = eng.index if index is None else index
    eng.planner = ScatterGatherPlanner(eng.index, beam=c.beam, topk=c.topk, method=eng.method,
                                       score_mode=c.score_mode, qt=c.qt, **kw)
    return eng


class _Pool:
    """Distinct random queries, handed out in order."""

    def __init__(self, n, d, seed):
        self.csr = random_sparse_csr(n, d, 30, np.random.default_rng(seed))
        self.at = 0

    def next(self, n):
        rows = np.arange(self.at, self.at + n)
        self.at += n
        return self.csr.slice_rows(rows)


def _engine(whole, device, *, tier="exact", pool=200, seed=3, d=D):
    """An engine on ``device`` over the whole tree or (``whole`` False) one
    chip's share of it through the planner, its partition quantized as
    ``quantize_index`` leaves it on a quantized tier; and distinct queries."""
    from repro_torch.quant.storage import quantize_index

    rng = np.random.default_rng(seed)
    ws = [random_sparse_csc(d, n, 8, rng, sibling_groups=b) for n, b in zip(LEVELS, BRANCHING)]
    tree = XMRTree.from_weight_matrices(ws, BRANCHING, device=device)
    serve = dict(SERVE)
    if tier != "exact":
        serve.update(method="auto", quant=QuantConfig(tier=tier))
    if whole:
        eng = XMRServingEngine(tree, ServeConfig(**serve), device=device)
    else:
        index = _share(tree)
        eng = XMRServingEngine(index.head, ServeConfig(**serve), device=device)
        if tier != "exact":
            index = quantize_index(index, tier=tier)
        _with_planner(eng, index)
    return eng, _Pool(pool, d, seed + 1)


def _batch(eng, queries, bucket):
    """The next ``bucket`` distinct queries, marshaled as ``_run`` takes them."""
    return eng.marshal_rows(queries.next(bucket), np.arange(bucket), bucket)


def _bitwise(got, want, what):
    s, l = got
    s0, l0 = want
    assert torch.equal(s.view(torch.int32), s0.view(torch.int32)), what
    assert torch.equal(l, l0), what


# ---------------------------------------------------------------------------
# the rule, on the CPU
# ---------------------------------------------------------------------------

def _rule_engine(case):
    if case in ("tree", "share", "cache", "transport"):
        eng, queries = _engine(case == "tree", "cpu")
        if case == "cache":
            _with_planner(eng, cache_entries=8)
        elif case == "transport":
            _with_planner(eng, sync="pipelined")
            eng.planner.set_transport(LocalTransport(eng.index, beam=4, topk=5,
                                                     method=eng.method))
        return eng, queries
    plain, queries = _engine(True, "cpu")
    if case == "shards":
        cfg = ServeConfig(**SERVE, shards=2)
    else:  # a placement over two partitions
        cfg = ServeConfig(**SERVE, partition=PartitionConfig(partitions=2))
    return XMRServingEngine(plain.tree, cfg, devices=["cpu"] * 2), queries


@pytest.mark.parametrize("case,graphable", [
    ("tree", True), ("share", True), ("shards", False), ("placement", False),
    ("cache", False), ("transport", False)])
def test_rule_and_eager_on_the_cpu(case, graphable):
    """``_graphable`` holds for a plain tree and a placement-less share, and
    not with replicas, a placement, a beam cache or a transport; on the CPU
    every run is eager all the same: nothing captured or replayed, and
    ``_run`` gives ``_traverse``'s bits, through the warm-up, batch and
    online calls."""
    eng, queries = _rule_engine(case)
    assert eng._graphable() is graphable
    before = _counts()
    eng.warmup_buckets(D, 4)
    csr = queries.next(6)
    assert eng.serve_batch(csr)[1].shape == eng.serve_online(csr)[1].shape == (6, 5)
    xi, xv = eng.marshal_rows(csr, np.arange(6), eng.bucket_for(6))
    for _ in range(3):
        _bitwise(eng._run(xi, xv), eng._traverse(xi, xv, 0), case)
    assert _counts() == before
    assert eng._graphs == {}


# ---------------------------------------------------------------------------
# the graphs, on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [1, 64])
@pytest.mark.parametrize("tier", ["exact", "int8"])
@pytest.mark.parametrize("whole", [True, False], ids=["tree", "share"])
def test_replay_bitwise_the_eager_traversal(cuda_device, whole, tier, bucket):
    """The warm-up runs the key once eagerly and captures it once; every
    later ``_run`` replays it. Calls of distinct queries back to back, with
    no wait between them: each answer is bitwise the eager traversal of the
    same queries on the same engine (a stale input would give the last
    call's answer), and still is after every later replay (no output
    aliases the graph's)."""
    eng, queries = _engine(whole, cuda_device, tier=tier)
    assert eng._graphable()
    c0, r0 = _counts()
    eng.warmup(D, (bucket,))  # eager, then captured and replayed
    c0, r0 = c0 + 1, r0 + 1
    assert _counts() == (c0, r0)
    calls = 50 if bucket == 1 else 3
    got = []
    for _ in range(calls):
        xi, xv = _batch(eng, queries, bucket)
        got.append((xi, xv, eng._run(xi, xv)))
    assert _counts() == (c0, r0 + calls)
    torch.cuda.synchronize()
    held = [(s.clone(), l.clone()) for _, _, (s, l) in got]
    assert len({s.data_ptr() for _, _, (s, _) in got}) == calls
    for i, (xi, xv, out) in enumerate(got):
        _bitwise(out, eng._traverse(xi, xv, 0), f"call {i}")
    for _ in range(2):  # more replays over the last call's queries
        eng._run(xi, xv)
    torch.cuda.synchronize()
    for i, ((_, _, out), h) in enumerate(zip(got, held)):
        _bitwise(out, h, f"call {i} after later replays")
    assert len({tuple(l[0].tolist()) for _, _, (_, l) in got}) > 1


@pytest.mark.cuda
def test_serving_paths_replay_and_match_eager(cuda_device):
    """``serve_batch`` (double buffered over buckets of 64, 64 and 8) and
    ``serve_online`` on a share through the planner, after the warm-up has
    captured each key: every bucket is a replay, and the answers are
    bitwise the eager traversal of the same buckets."""
    eng, queries = _engine(False, cuda_device, pool=400)
    eng.warmup(D, (1, 8, 64))
    csr = queries.next(136)
    c0, r0 = _counts()
    s_b, l_b = eng.serve_batch(csr)
    s_o, l_o = eng.serve_online(csr, limit=20)
    assert _counts() == (c0, r0 + 3 + 20)
    want_s, want_l = [], []
    for start, count in ((0, 64), (64, 64), (128, 8)):
        xi, xv = eng.marshal_rows(csr, np.arange(start, start + count), count)
        s, l = eng._traverse(xi, xv, 0)
        want_s.append(s.cpu().numpy())
        want_l.append(l.cpu().numpy())
    np.testing.assert_array_equal(s_b.view(np.uint32), np.concatenate(want_s).view(np.uint32))
    np.testing.assert_array_equal(l_b, np.concatenate(want_l))
    # Online rows ride buckets of 1: on the card a score's bits do not
    # depend on the batch it rides in.
    np.testing.assert_array_equal(s_o.view(np.uint32), s_b[:20].view(np.uint32))
    np.testing.assert_array_equal(l_o, l_b[:20])


@pytest.mark.cuda
def test_other_stream_runs_eagerly(cuda_device):
    """The engine's graphs share one pool, so they replay only on the stream
    the first was recorded from: on a side stream a key captured on the
    default stream runs eagerly, and a key first run there is never
    captured, however often it runs; both give the eager bits."""
    eng, queries = _engine(True, cuda_device)
    eng.warmup(D, (4,))  # bucket 4 captured on the default stream
    xi, xv = _batch(eng, queries, 4)
    want = eng._run(xi, xv)
    xi8, xv8 = _batch(eng, queries, 8)
    want8 = eng._traverse(xi8, xv8, 0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    c0, r0 = _counts()
    with torch.cuda.stream(side):
        got = eng._run(xi, xv)
        got8 = [eng._run(xi8, xv8) for _ in range(3)]
    torch.cuda.current_stream().wait_stream(side)
    assert _counts() == (c0, r0)
    assert len(eng._graphs) == 1
    _bitwise(got, want, "side stream, a key captured on the default stream")
    for i, out in enumerate(got8):
        _bitwise(out, want8, f"side stream, a new key, run {i}")


@pytest.mark.cuda
def test_warmup_buckets_adds_at_most_the_largest_working_set(cuda_device):
    """``warmup_buckets`` up to 64 on a share with two 16.8 MB query tables
    a bucket of 64 (d = 2^16): the memory it leaves allocated is the graphs'
    static inputs and outputs, and the memory it leaves reserved (every
    key's graph in the one pool) is at most the largest bucket's eager
    working set and a few small segments, not the sum over the seven
    buckets (about twice the largest)."""
    d = 1 << 16
    eng, _ = _engine(False, cuda_device, d=d)
    xi, xv = eng._empty_batch(64, d)
    eng._traverse(xi, xv, 0)  # builds the kernels; the key stays unwarmed
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng._traverse(xi, xv, 0)
    torch.cuda.synchronize()
    working = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    c0, _ = _counts()
    eng.warmup_buckets(d, 64)
    torch.cuda.synchronize()
    assert _counts()[0] == c0 + 7
    assert torch.cuda.memory_allocated() - allocated <= working
    assert torch.cuda.memory_reserved() - reserved <= working + (16 << 20)


@pytest.mark.cuda
def test_no_cuda_event_while_capturing(cuda_device, monkeypatch):
    """Tracing on: the eager run's device spans record their events, the
    capturing run's record none while the stream captures (its spans are
    entered once, with no device interval), and a replay enters no stage
    span; ``serve.run`` wraps every call and counts the capture and the
    replays, and a replay's ``serve.run`` the launches its capture counted,
    which are the eager run's."""
    recorded = []

    class Event(torch.cuda.Event):
        def record(self, stream=None):
            recorded.append(torch.cuda.is_current_stream_capturing())
            return super().record(stream)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    eng, queries = _engine(False, cuda_device)
    xi, xv = _batch(eng, queries, 8)
    obs.clear()
    try:
        with obs.recording():
            for _ in range(3):
                eng._run(xi, xv)
        spans = obs.spans()
    finally:
        obs.clear()
    assert recorded and not any(recorded)
    runs = [s for s in spans if s.name == "serve.run"]
    assert len(runs) == 3 and all(s.parent is None for s in runs)
    eager, capture, replay = ([s for s in spans if s.call == r.sid and s is not r] for r in runs)
    assert {s.name for s in eager} == {s.name for s in capture}
    assert any(s.device_ms is not None for s in eager)
    assert all(s.device_ms is None for s in capture)
    assert replay == []
    assert runs[0].counts.get("graph.capture", 0) == 0
    assert runs[1].counts == {"graph.capture": 1, "graph.replay": 1}

    def launched(within):
        out = {}
        for s in within:
            for name, n in s.counts.items():
                out[name] = out.get(name, 0) + n
        return out

    assert launched(eager) == launched(capture) == {"launches.mscm_grouped": 3}
    assert runs[2].counts == {"graph.replay": 1, "launches.mscm_grouped": 3}
