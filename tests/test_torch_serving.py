"""PyTorch port, serving engine: the port's engine against the reference's.

Both engines get the same ``ServeConfig`` knobs, weights and queries and
serve them in the batch and online settings; results agree under the rule
of ``test_torch_tree.py`` (scores within ``rtol=1e-5, atol=1e-6``, labels
equal wherever the reference's score gap exceeds that). Every config group
builds as the reference's (the fleet's too); the quantized tiers are held
against the reference in ``test_torch_quant.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import XMRTree as JTree
from repro.serving import ServeConfig as JConfig
from repro.serving import XMRServingEngine as JEngine
from repro.sparse import random_sparse_csr
from repro_torch.core.tree import XMRTree
from repro_torch.serving import LatencyStats, ServeConfig, XMRServingEngine, resolve_method
from repro_torch.sparse.csr import CSR
from tests.conftest import make_tree_weights
from tests.test_torch_tree import ONLINE_METHODS, assert_same_ranking, port_csc

KNOBS = dict(beam=10, topk=5, ell_width=32, max_batch=16)


def port_csr(x):
    return CSR(x.indptr, x.indices, x.data, tuple(x.shape))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(4321)
    d, B = 150, 8
    ws = make_tree_weights(rng, d, [8, 64, 512], B)
    jt = JTree.from_weight_matrices(ws, B)
    tt = XMRTree.from_weight_matrices([port_csc(w) for w in ws], B, device="cpu")
    xq = random_sparse_csr(40, d, 18, rng)
    tq = port_csr(xq)
    perm = rng.permutation(512)
    return jt, tt, xq, tq, perm


@pytest.mark.parametrize("method_port,method_ref,n", [
    ("auto", "auto", 40),
    ("mscm_dense", "mscm_dense", 40),
    ("mscm_pallas_grouped", "mscm_pallas_grouped", 24),
    ("mscm_pallas_grouped", "mscm_dense", 40),
])
def test_serve_batch_matches_reference(setup, method_port, method_ref, n):
    jt, tt, xq, tq, perm = setup
    ref = JEngine(jt, JConfig(method=method_ref, **KNOBS), label_perm=perm)
    eng = XMRServingEngine(tt, ServeConfig(method=method_port, **KNOBS), label_perm=perm,
                           device="cpu")
    xs = xq.slice_rows(np.arange(n))
    s_j, l_j = ref.serve_batch(xs)
    s_t, l_t = eng.serve_batch(port_csr(xs))
    assert_same_ranking(s_t, l_t, s_j, l_j)
    summary = eng.latency_summary()
    assert summary["count"] == 0 and summary["amortized"]["queries"] == n


def test_serve_online_matches_batch_and_reference(setup):
    jt, tt, xq, tq, perm = setup
    ref = JEngine(jt, JConfig(method="mscm_dense", **KNOBS), label_perm=perm)
    eng = XMRServingEngine(tt, ServeConfig(method="mscm_pallas_grouped", **KNOBS),
                           label_perm=perm, device="cpu")
    s_j, l_j = ref.serve_online(xq, limit=5)
    s_t, l_t = eng.serve_online(tq, limit=5)
    assert_same_ranking(s_t, l_t, s_j, l_j)
    s_b, l_b = eng.serve_batch(tq)
    np.testing.assert_array_equal(l_t, l_b[:5])
    np.testing.assert_allclose(s_t, s_b[:5], rtol=1e-5, atol=1e-6)
    summary = eng.latency_summary()
    assert summary["count"] == 5 and summary["amortized"]["calls"] == 1


@pytest.mark.parametrize("method", ONLINE_METHODS)
def test_serve_online_methods_match_reference(setup, method):
    """The online setting (bucket 1) through each method, in both packages."""
    jt, tt, xq, tq, perm = setup
    ref = JEngine(jt, JConfig(method=method, **KNOBS), label_perm=perm)
    eng = XMRServingEngine(tt, ServeConfig(method=method, **KNOBS), label_perm=perm,
                           device="cpu")
    eng.warmup(tt.d)
    s_j, l_j = ref.serve_online(xq, limit=4)
    s_t, l_t = eng.serve_online(tq, limit=4)
    assert_same_ranking(s_t, l_t, s_j, l_j)
    assert eng.latency_summary()["count"] == 4


@pytest.mark.parametrize("method", ONLINE_METHODS)
def test_serve_batch_methods_match_reference(setup, method):
    jt, tt, xq, tq, perm = setup
    ref = JEngine(jt, JConfig(method=method, **KNOBS), label_perm=perm)
    eng = XMRServingEngine(tt, ServeConfig(method=method, **KNOBS), label_perm=perm,
                           device="cpu")
    xs = xq.slice_rows(np.arange(20))
    s_j, l_j = ref.serve_batch(xs)
    s_t, l_t = eng.serve_batch(port_csr(xs))
    assert_same_ranking(s_t, l_t, s_j, l_j)


def test_warmup_and_probe_run(setup):
    _, tt, _, _, _ = setup
    eng = XMRServingEngine(tt, ServeConfig(method="mscm_pallas_grouped", **KNOBS), device="cpu")
    eng.warmup_buckets(tt.d, 12)
    assert [eng.bucket_for(n) for n in (1, 3, 9, 16, 40)] == [1, 4, 16, 16, 16]
    assert eng.measure_batch_seconds(4, iters=2) > 0


def test_resolve_method(monkeypatch):
    assert resolve_method("auto", "cpu") == "mscm_dense"
    assert resolve_method("auto", "cuda") == "mscm_pallas_grouped"
    assert resolve_method("mscm_dense", "cuda") == "mscm_dense"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_method("auto") == "mscm_dense"


def test_engine_needs_a_gpu_or_explicit_cpu(setup, monkeypatch):
    _, tt, _, _, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        XMRServingEngine(tt, ServeConfig())


@pytest.mark.parametrize("case", ["defaults", "nested", "flat", "bad_policy", "bad_group"])
def test_fleet_config_matches_reference(case):
    """``FleetConfig`` and the ``fleet`` group build as the reference's: the
    same fields and defaults, nested and from flat kwargs (with the
    reference's DeprecationWarning, word for word), the same refusal of an
    unknown ``degraded_policy``, and the read-side ``degraded_policy``."""
    from repro.serving import FleetConfig as JFleet
    from repro.serving.config import DEGRADED_POLICIES as J_POLICIES
    from repro_torch.serving import FleetConfig
    from repro_torch.serving.config import DEGRADED_POLICIES

    assert DEGRADED_POLICIES == J_POLICIES
    assert [(f.name, f.default) for f in dataclasses.fields(FleetConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JFleet)]
    kw = dict(degraded_policy="reject", poll_interval_s=0.05, suspect_after=1,
              restart_budget=3)
    if case == "defaults":
        c, j = ServeConfig(), JConfig()
    elif case == "nested":
        c, j = ServeConfig(fleet=FleetConfig(**kw)), JConfig(fleet=JFleet(**kw))
    elif case == "flat":
        with pytest.warns(DeprecationWarning) as t_warn:
            c = ServeConfig(partitions=2, **kw)
        with pytest.warns(DeprecationWarning) as j_warn:
            j = JConfig(partitions=2, **kw)
        assert [str(w.message) for w in t_warn] == [str(w.message) for w in j_warn]
    elif case == "bad_policy":
        with pytest.raises(ValueError) as t_err:
            FleetConfig(degraded_policy="best_effort")
        with pytest.raises(ValueError) as j_err:
            JFleet(degraded_policy="best_effort")
        assert str(t_err.value) == str(j_err.value)
        return
    else:
        with pytest.raises(TypeError, match="FleetConfig"):
            ServeConfig(fleet=object())
        return
    assert dataclasses.asdict(c.fleet) == dataclasses.asdict(j.fleet)
    assert c.degraded_policy == j.degraded_policy
    assert c.partitions == j.partitions


@pytest.mark.parametrize("case", ["shards", "flat_partitions", "partition_group"])
def test_multi_device_options_match_reference(case):
    """The options that raised until the partitioned index was ported build
    as the reference's: ``shards=2``; flat ``partitions=2``, routed into the
    partition group with the reference's DeprecationWarning; and a nested
    ``PartitionConfig``. Every field is the reference's."""
    from repro.serving import PartitionConfig as JPartition
    from repro_torch.serving import PartitionConfig

    assert [(f.name, f.default) for f in dataclasses.fields(PartitionConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JPartition)]
    if case == "shards":
        c, j = ServeConfig(shards=2), JConfig(shards=2)
    elif case == "flat_partitions":
        with pytest.warns(DeprecationWarning):
            c = ServeConfig(partitions=2)
        with pytest.warns(DeprecationWarning):
            j = JConfig(partitions=2)
    else:
        kw = dict(partitions=2, partition_sync="pipelined")
        c, j = ServeConfig(partition=PartitionConfig(**kw)), JConfig(partition=JPartition(**kw))
    for k in ("beam", "topk", "method", "ell_width", "max_batch", "score_mode", "qt", "shards",
              "partitions", "partition_level", "partition_sync", "beam_cache"):
        assert getattr(c, k) == getattr(j, k)
    for group in ("admission", "partition", "quant", "slo"):
        assert dataclasses.asdict(getattr(c, group)) == dataclasses.asdict(getattr(j, group))


@pytest.mark.parametrize("group,kwargs", [
    ("slo", dict(target_p99_ms=50.0)),
    ("admission", dict(queue_depth="auto", shed_policy="shed-oldest", deadline_ms=20.0)),
    ("slo", dict(target_p99_ms=5.0, tiers=((6, 8), (3, 4)), min_beam=2)),
])
def test_ported_groups_match_reference(group, kwargs):
    """The groups that once raised here build as the reference's: same
    fields and defaults, nested and routed from flat kwargs alike."""
    from repro.serving import config as jc
    from repro_torch.serving import config as tc

    name = {"admission": "AdmissionConfig", "slo": "SLOConfig"}[group]
    tcls, jcls = getattr(tc, name), getattr(jc, name)
    assert [(f.name, f.default) for f in dataclasses.fields(tcls)] == [
        (f.name, f.default) for f in dataclasses.fields(jcls)]
    nested = ServeConfig(**{group: tcls(**kwargs)})
    with pytest.warns(DeprecationWarning):
        flat = ServeConfig(**kwargs)
    with pytest.warns(DeprecationWarning):
        ref = JConfig(**kwargs)
    want = dataclasses.asdict(getattr(ref, group))
    assert dataclasses.asdict(getattr(nested, group)) == want
    assert dataclasses.asdict(getattr(flat, group)) == want


@pytest.mark.parametrize("method", ["mscm_pallas_grouped_q"])
def test_unported_methods_raise_at_engine_build(setup, method):
    """Every method is ported; the quantized one still refuses, at engine
    build, an f32 tree that no quant tier will quantize."""
    _, tt, _, _, _ = setup
    with pytest.raises(ValueError, match="QuantConfig"):
        XMRServingEngine(tt, ServeConfig(method=method), device="cpu")


def test_config_defaults_and_unknown_options():
    c, j = ServeConfig(partitions=1, fleet=None), JConfig()
    for k in ("beam", "topk", "method", "ell_width", "max_batch", "score_mode", "qt", "shards",
              "queue_depth", "shed_policy", "deadline_ms", "target_p99_ms", "tier"):
        assert getattr(c, k) == getattr(j, k)
    for group in ("admission", "partition", "fleet", "quant", "slo"):
        assert dataclasses.asdict(getattr(c, group)) == dataclasses.asdict(getattr(j, group))
    with pytest.raises(TypeError):
        ServeConfig(beem=3)


def test_latency_stats_keep_series_apart():
    st = LatencyStats()
    st.record(0.002)
    st.record(0.010, n_queries=5)
    st.record_amortized(0.004, 2)
    s = st.summary()
    assert s["count"] == 1 and s["avg_ms"] == pytest.approx(2.0)
    assert s["amortized"] == {"calls": 2, "queries": 7, "avg_ms_per_query": pytest.approx(2.0)}


@pytest.mark.parametrize("method", ["mscm_pallas_grouped", "mscm_pallas"])
def test_tall_tiles_and_wide_chunks_match_reference(method):
    """``ServeConfig(qt=32)`` on a one-level tree of branching 1024: query
    tiles past 16 rows and chunks past 1,022 columns, the shapes the
    kernels' plans once refused, serve as in the reference (its Pallas
    kernels in interpret mode; the port's plain versions, on the CPU)."""
    rng = np.random.default_rng(1024)
    d, B = 200, 1024
    ws = make_tree_weights(rng, d, [B], B, nnz_per_col=12)
    jt = JTree.from_weight_matrices(ws, B)
    tt = XMRTree.from_weight_matrices([port_csc(w) for w in ws], B, device="cpu")
    xq = random_sparse_csr(40, d, 16, rng)
    knobs = dict(beam=10, topk=10, ell_width=32, max_batch=64, qt=32, method=method)
    s_j, l_j = JEngine(jt, JConfig(**knobs)).serve_batch(xq)
    s_t, l_t = XMRServingEngine(tt, ServeConfig(**knobs), device="cpu").serve_batch(port_csr(xq))
    assert_same_ranking(s_t, l_t, s_j, l_j)
