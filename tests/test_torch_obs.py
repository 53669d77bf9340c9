"""``repro_torch.obs``: spans and counters, off and on, and the span tree of
the serving engine's calls (a plain engine, and one chip's share of a
label-partitioned tree through the scatter-gather planner, as the
benchmark's ``xmrbench`` lays it out), on the CPU."""

import collections
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from xmrbench import gen, harness  # noqa: E402

TINY = {
    "d": 3000, "branching": [3, 4, 5], "n_cols": [3, 11, 52], "n_labels": 52,
    "chunk_rows": [24, 40, 40], "col_nnz": 8, "query_nnz": 30, "dtype": "float32",
    "serve": {"beam": 4, "topk": 5, "method": "mscm_pallas_grouped", "max_batch": 8,
              "ell_width": 64},
}
#: One chip's share: the last level's chunks [4, 11) of 11, the levels above whole.
SHARE = dict(TINY, leaf_chunks=[4, 11])
MIX = {"path_share": 0.5, "targets": {"dist": "uniform"}}


@pytest.fixture(autouse=True)
def empty_buffer():
    obs.clear()
    yield
    obs.clear()


def _engine(cfg, seed=3):
    geom = gen.Geometry.of(cfg)
    levels = gen.make_tree(geom, seed, "cpu")
    pool = gen.make_pool(geom, levels, MIX, 40, seed, "cpu")
    engine = harness.build_engine(levels, geom, cfg["serve"], "cpu")
    return engine, harness.Traffic(pool, geom.d), geom


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.sid]


def test_off_records_nothing_and_hands_back_one_object():
    a, b = obs.span("x"), obs.span("y", device=torch.device("cpu"), level=3)
    assert a is b is obs.OFF
    before = obs.total("test.off")
    with a:
        with b:
            obs.count("test.off", 2)
    assert obs.spans() == []
    assert obs.total("test.off") == before + 2


def test_nesting_parents_and_call_ids():
    with obs.recording():
        assert obs.span("x") is not obs.OFF
        with obs.span("root", queries=2):
            with obs.span("a"):
                with obs.span("a.1"):
                    pass
            with obs.span("b"):
                pass
        with obs.span("root"):
            pass
    assert obs.span("x") is obs.OFF
    got = obs.spans()
    assert [s.name for s in got] == ["root", "a", "a.1", "b", "root"]
    r1, a, a1, b, r2 = got
    assert r1.parent is None and r2.parent is None
    assert (a.parent, a1.parent, b.parent) == (r1.sid, a.sid, r1.sid)
    assert {s.call for s in (r1, a, a1, b)} == {r1.sid} and r2.call == r2.sid != r1.sid
    assert r1.attrs == {"queries": 2}
    assert r1.start_ns <= a.start_ns <= a1.start_ns <= a1.end_ns <= a.end_ns
    assert a.end_ns <= b.start_ns <= b.end_ns <= r1.end_ns <= r2.start_ns
    assert all(s.device_ms is None for s in got)   # no CUDA device, no interval


def test_counts_land_in_the_innermost_span_and_the_total():
    before = obs.total("test.launches")
    with obs.recording():
        obs.count("test.launches")             # no span open: the total alone
        with obs.span("outer"):
            obs.count("test.launches")
            with obs.span("inner"):
                obs.count("test.launches", 3)
                obs.count("test.other")
    outer, inner = obs.spans()
    assert outer.counts == {"test.launches": 1}
    assert inner.counts == {"test.launches": 3, "test.other": 1}
    assert obs.total("test.launches") == before + 5


def test_tally_holds_this_threads_counts_in_the_block():
    """Tracing off: a tally gets what its own thread counts inside it, a
    nested tally's counts too, and nothing another thread counts meanwhile;
    every count still reaches the total."""
    before = obs.total("test.tally")
    obs.count("test.tally")                      # before the block
    with obs.tally() as got:
        obs.count("test.tally", 2)
        with obs.tally() as inner:
            obs.count("test.tally.inner")
        other = threading.Thread(target=obs.count, args=("test.tally", 5))
        other.start()
        other.join(timeout=60)
    obs.count("test.tally")                      # after it
    assert inner == {"test.tally.inner": 1}
    assert got == {"test.tally": 2, "test.tally.inner": 1}
    assert obs.total("test.tally") == before + 9


def test_full_buffer_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(obs, "_buffer", collections.deque(maxlen=3))
    with obs.recording():
        for i in range(5):
            with obs.span(f"s{i}"):
                pass
    assert [s.name for s in obs.spans()] == ["s2", "s3", "s4"]
    assert obs.dropped() == 2
    obs.clear()
    assert obs.spans() == [] and obs.dropped() == 0


def test_threads_keep_their_own_stacks():
    """More threads than cores, a short switch interval: every span's parent
    is its own thread's, and no count is lost."""
    n_threads, n_iter = 16, 200
    before = obs.total("test.threads")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for _ in range(n_iter):
                with obs.span("root", thread=t):
                    with obs.span("child", thread=t):
                        obs.count("test.threads")
        with obs.recording():
            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    got = obs.spans()
    by_sid = {s.sid: s for s in got}
    children = [s for s in got if s.name == "child"]
    assert len(children) == n_threads * n_iter
    assert all(by_sid[c.parent].attrs["thread"] == c.attrs["thread"] for c in children)
    assert all(c.counts == {"test.threads": 1} for c in children)
    assert obs.total("test.threads") == before + n_threads * n_iter


@pytest.mark.parametrize("cfg", [TINY, SHARE], ids=["plain", "planner"])
def test_serve_batch_span_tree(cfg):
    engine, traffic, geom = _engine(cfg)
    _, csr = traffic.next(20)
    with obs.recording():
        scores, labels = engine.serve_batch(csr)
    got = obs.spans()
    (root,) = [s for s in got if s.parent is None]
    buckets = 3                                            # 8 + 8 + 4 queries
    assert root.name == "serve.batch"
    assert root.attrs == {"engine": engine.serial, "queries": 20, "buckets": buckets}
    assert all(s.call == root.sid for s in got)
    stages = collections.Counter(s.name for s in _children(got, root))
    assert stages == {"serve.marshal": buckets, "serve.run": buckets,
                      "serve.copy_back": buckets, "serve.finalize": buckets + 1}
    names = collections.Counter(s.name for s in got)
    depth = len(geom.n_cols)
    planner = cfg is SHARE
    # One table a tree a bucket: the router's and the partition's on a share.
    assert names["mscm.table"] == buckets * (2 if planner else 1)
    assert names["tree.level"] == buckets * depth
    assert names["mscm.group"] == buckets * depth          # the grouped method's
    levels = sorted(s.attrs["level"] for s in got if s.name == "tree.level")
    assert levels == sorted(list(range(depth)) * buckets)
    if planner:
        assert names["plan.route"] == names["plan.inputs"] == buckets
        assert names["plan.gather_select"] == buckets
        assert names["tree.beam_select"] == buckets * (depth - 1)
    else:
        assert names["tree.beam_select"] == buckets * depth
        assert not any(n.startswith("plan.") for n in names)
    assert scores.shape == (20, cfg["serve"]["topk"])


@pytest.mark.parametrize("cfg", [TINY, SHARE], ids=["plain", "planner"])
def test_serve_online_span_tree(cfg):
    engine, traffic, geom = _engine(cfg)
    _, csr = traffic.next(3)
    with obs.recording():
        engine.serve_online(csr)
    got = obs.spans()
    (root,) = [s for s in got if s.parent is None]
    assert root.name == "serve.online"
    assert root.attrs == {"engine": engine.serial, "queries": 3, "buckets": 3}
    stages = collections.Counter(s.name for s in _children(got, root))
    assert stages == {"serve.marshal": 3, "serve.run": 3, "serve.wait": 3,
                      "serve.copy_back": 3, "serve.finalize": 1}
    names = collections.Counter(s.name for s in got)
    assert names["mscm.table"] == 3 * (2 if cfg is SHARE else 1)
    assert names["tree.level"] == 3 * len(geom.n_cols)


def test_latency_sample_lies_inside_the_root_span():
    """``serve_online``'s latency sample runs from marshaling to the answer
    on the host, on the spans' clock: inside the root, around its stages."""
    engine, traffic, _ = _engine(TINY)
    _, csr = traffic.next(1)
    with obs.recording():
        engine.serve_online(csr)
    got = obs.spans()
    (root,) = [s for s in got if s.parent is None]
    stages = [s for s in _children(got, root) if s.name != "serve.finalize"]
    (sample,) = engine.stats.per_query_ms
    assert stages[-1].end_ns - stages[0].start_ns <= sample * 1e6 <= root.host_ms * 1e6
    assert engine.latency_summary()["count"] == 1


@pytest.mark.parametrize("cfg", [TINY, SHARE], ids=["plain", "planner"])
def test_results_are_bitwise_with_tracing_on(cfg):
    engine, traffic, _ = _engine(cfg)
    _, csr = traffic.next(20)
    off = engine.serve_batch(csr), engine.serve_online(csr, limit=4)
    with obs.recording():
        on = engine.serve_batch(csr), engine.serve_online(csr, limit=4)
    assert obs.spans()
    for (s_off, l_off), (s_on, l_on) in zip(off, on):
        np.testing.assert_array_equal(l_on, l_off)
        np.testing.assert_array_equal(s_on.view(np.uint32), s_off.view(np.uint32))


def test_spans_share_the_profilers_clock():
    """Under a ``torch.profiler`` session every span is recorded and is a
    profiler event of its name that starts within 1 ms of it."""
    from torch.profiler import ProfilerActivity, profile

    engine, traffic, _ = _engine(SHARE)
    _, csr = traffic.next(9)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.serve_batch(csr)
    got = obs.spans()
    assert {s.name for s in got} >= {"serve.batch", "serve.marshal", "serve.run",
                                     "plan.route", "mscm.table", "tree.level"}
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        events[e.name()].append(e.start_ns())
    for s in got:
        assert min(abs(t - s.start_ns) for t in events[s.name]) < 1_000_000, s.name
    assert obs.span("x") is obs.OFF
