"""PyTorch port, latency-SLO beam tiers: the port's ladder, policy and
at-tier serving against the reference's.

The counterparts of ``tests/test_slo.py`` that need no planner and no
transport:

1. ``SLOConfig`` refuses what the reference refuses, with its errors, and
   ``resolve_tiers`` gives the reference's ladder on the same configs; the
   engine refuses a tier that would change the result width;
2. ``BeamTierPolicy``, calibrated with the same costs, selects the
   reference's tier over a grid of queue depths and budgets, and clamps
   its costs monotone;
3. ``engine._run(tier=k)`` is bitwise a no-SLO engine at that tier's
   ``(beam, qt)``, tier 0 bitwise an engine without the group, and each
   tier agrees with the reference's by the rule of ``repro_torch.parity``;
   a degraded tier composes with the int8 storage tier;
4. the batcher degrades under pressure (monkeypatched costs, as the
   reference's test does) and serves full beam bitwise when the budget
   allows.
"""

import numpy as np
import pytest

import repro.serving as J
import repro.serving.slo as jslo
import repro_torch.serving as T
import repro_torch.serving.slo as tslo
from repro.core import XMRTree as JTree
from repro.sparse import random_sparse_csr
from repro_torch.core.tree import XMRTree
from repro_torch.parity import check_ranking
from tests.conftest import make_tree_weights
from tests.test_torch_batcher import port_csr
from tests.test_torch_tree import port_csc

METHOD = "mscm_dense"
TIMEOUT = 60  # seconds: the bound of every wait in this file


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


# ---------------------------------------------------------------------------
# 1. config validation + ladder resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(target_p99_ms=0.0), dict(target_p99_ms=-3.0), dict(min_beam=0),
    dict(tiers=((0, 8),)), dict(tiers=((4, 0),)), dict(tiers=((2, 8), (4, 8))),
    dict(tiers=((4, 8, 1),)),
])
def test_slo_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        J.SLOConfig(**kw)
    with pytest.raises(ValueError) as got:
        T.SLOConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("slo", [
    None,
    dict(target_p99_ms=5.0),
    dict(target_p99_ms=5.0, min_beam=4),
    dict(target_p99_ms=5.0, tiers=((6, 8), (3, 4))),
    dict(target_p99_ms=5.0, tiers=((4, 8), (2, 8))),
])
@pytest.mark.parametrize("beam", [10, 16, 1])
def test_resolve_tiers_matches_reference(slo, beam):
    def ladder(pkg, mod):
        kw = {} if slo is None else dict(slo=pkg.SLOConfig(**slo))
        return [(t.beam, t.qt) for t in mod.resolve_tiers(pkg.ServeConfig(beam=beam, qt=8, **kw))]

    try:
        want = ladder(J, jslo)
    except ValueError as exc:
        with pytest.raises(ValueError, match="narrower"):
            ladder(T, tslo)
        assert "narrower" in str(exc)
        return
    assert ladder(T, tslo) == want
    if slo is None:
        assert want == [(beam, 8)]


def test_resolve_tiers_auto_halving_ladder():
    cfg = T.ServeConfig(beam=10, qt=8, slo=T.SLOConfig(target_p99_ms=5.0))
    assert tslo.resolve_tiers(cfg) == (T.BeamTier(10, 8), T.BeamTier(5, 8),
                                       T.BeamTier(2, 8), T.BeamTier(1, 8))


def test_engine_rejects_width_changing_tier():
    """n_cols (4, 16), branching (4, 4), topk 10: beam 10 reaches width
    min(10, 16, 4*4) = 10, tier beam 2 only min(10, 16, 2*4) = 8."""
    rng = np.random.default_rng(3)
    ws = make_tree_weights(rng, 48, [4, 16], 4)
    tree = XMRTree.from_weight_matrices([port_csc(w) for w in ws], 4, device="cpu")

    def cfg(tiers):
        return T.ServeConfig(beam=10, topk=10, method=METHOD, ell_width=16,
                             slo=T.SLOConfig(target_p99_ms=50.0, tiers=tiers))

    with pytest.raises(ValueError, match="width"):
        T.XMRServingEngine(tree, cfg(((2, 8),)), device="cpu")
    eng = T.XMRServingEngine(tree, cfg(((4, 8),)), device="cpu")
    assert eng.tiers == (T.BeamTier(10, 8), T.BeamTier(4, 8))


# ---------------------------------------------------------------------------
# 2. BeamTierPolicy
# ---------------------------------------------------------------------------

def _policies(costs, target_ms=10.0, bucket=16):
    out = []
    for mod in (jslo, tslo):
        tiers = tuple(mod.BeamTier(8 >> k, 8) for k in range(len(costs)))
        it = iter(costs)
        out.append(mod.BeamTierPolicy(tiers, target_ms=target_ms, bucket=bucket)
                   .calibrate(lambda k: next(it)))
    return out


@pytest.mark.parametrize("costs,target_ms,bucket", [
    ([4.0, 2.0, 1.0], 10.0, 16),
    ([80.0, 0.01], 100.0, 16),
    ([2.0, 3.0, 1.0, 0.5], 7.5, 64),
    ([0.3, 0.3, 0.2, 0.1], 1.0, 8),
])
def test_policy_select_matches_reference(costs, target_ms, bucket):
    ref, port = _policies(costs, target_ms, bucket)
    assert port.cost_ms == ref.cost_ms and port.calibrated
    picks = []
    for depth in (0, 1, 7, 8, 15, 16, 32, 33, 80, 200, 10_000):
        for budget in (None, -5.0, 0.0, 0.5, 1.0, 3.0, 6.0, 9.99, 10.0, 50.0, 1e9):
            got = port.select(queue_depth=depth, budget_ms=budget)
            assert got == ref.select(queue_depth=depth, budget_ms=budget), (depth, budget)
            picks.append(got)
    assert len(set(picks)) > 1  # the grid reaches more than one tier


def test_policy_uncalibrated_always_full():
    pol = tslo.BeamTierPolicy((T.BeamTier(8, 8), T.BeamTier(4, 8)), target_ms=10.0, bucket=16)
    assert not pol.calibrated
    assert pol.select(queue_depth=10_000, budget_ms=0.01) == 0


def test_policy_select_degrades_with_backlog():
    _, pol = _policies([4.0, 2.0, 1.0])
    assert [pol.select(queue_depth=q, budget_ms=None) for q in (0, 32, 80, 10_000)] == [0, 1, 2, 2]
    assert pol.select(queue_depth=0, budget_ms=3.0) == 1
    assert pol.select(queue_depth=32, budget_ms=1e9) == 1  # clamped to the target


def test_policy_calibration_clamps_monotone():
    _, pol = _policies([2.0, 3.0, 1.0])
    assert pol.cost_ms == [2.0, 2.0, 1.0]


@pytest.mark.parametrize("kw", [dict(tiers=()), dict(target_ms=0.0), dict(bucket=0)])
def test_policy_constructor_validation_matches_reference(kw):
    args = dict(target_ms=10.0, bucket=16)
    args.update({k: v for k, v in kw.items() if k != "tiers"})
    for mod in (jslo, tslo):
        tiers = kw.get("tiers", (mod.BeamTier(8, 8),))
        with pytest.raises(ValueError):
            mod.BeamTierPolicy(tiers, **args)


# ---------------------------------------------------------------------------
# 3. at-tier exactness
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tier_world():
    """``tests/test_slo.py``'s tier tree, in both packages."""
    rng = np.random.default_rng(11)
    d, B = 128, 4
    ws = make_tree_weights(rng, d, [4, 16, 64], B)
    jt = JTree.from_weight_matrices(ws, B)
    tree = XMRTree.from_weight_matrices([port_csc(w) for w in ws], B, device="cpu")
    cfg = T.ServeConfig(beam=4, topk=8, method=METHOD, ell_width=24, max_batch=16,
                        slo=T.SLOConfig(target_p99_ms=100.0, tiers=((2, 8),)))
    engine = T.XMRServingEngine(tree, cfg, device="cpu")
    xq = random_sparse_csr(16, d, 12, rng)
    xi, xv = engine.marshal_rows(port_csr(xq), np.arange(16), 16)
    return jt, tree, engine, xq, xi, xv


def _plain(tree, beam, **kw):
    return T.XMRServingEngine(
        tree, T.ServeConfig(beam=beam, topk=8, method=kw.pop("method", METHOD), ell_width=24,
                            max_batch=16, **kw), device="cpu")


@pytest.mark.parametrize("tier,beam", [(0, 4), (1, 2)])
def test_engine_tier_dispatch_bitwise_at_tier(tier_world, tier, beam):
    """_run(tier) is bitwise a no-SLO engine at the tier's beam, agrees
    with the reference's engine at that tier, and keeps the panel width."""
    jt, tree, engine, xq, xi, xv = tier_world
    s, l = engine._run(xi, xv, tier=tier)
    s_b, l_b = _plain(tree, beam)._run(xi, xv)
    np.testing.assert_array_equal(_bits(s), _bits(s_b))
    np.testing.assert_array_equal(l.numpy(), l_b.numpy())
    assert s.shape == (16, 8)
    jeng = J.XMRServingEngine(jt, J.ServeConfig(
        beam=4, topk=8, method=METHOD, ell_width=24, max_batch=16,
        slo=J.SLOConfig(target_p99_ms=100.0, tiers=((2, 8),))))
    js, jl = jeng._run(*jeng.marshal_rows(xq, np.arange(16), 16), tier=tier)
    check_ranking(s.numpy(), l.numpy(), np.asarray(js), np.asarray(jl), f"tier {tier}")


def test_tier0_bitwise_identical_to_no_slo_engine(tier_world):
    jt, tree, engine, xq, xi, xv = tier_world
    plain = _plain(tree, 4)
    assert len(plain.tiers) == 1 and plain.bucket_key(13) == (16, 0)
    assert engine.bucket_key(13, 1) == (16, 1)
    s_a, l_a = engine._run(xi, xv, tier=0)
    s_b, l_b = plain._run(xi, xv)
    np.testing.assert_array_equal(_bits(s_a), _bits(s_b))
    np.testing.assert_array_equal(l_a.numpy(), l_b.numpy())


def test_degraded_tier_composes_with_quant_tier(tier_world):
    """A degraded tier on an int8 engine is bitwise the int8 engine's own
    result at the narrower beam."""
    jt, tree, engine, xq, xi, xv = tier_world
    q_slo = _plain(tree, 4, method="auto", quant=T.QuantConfig(tier="int8"),
                   slo=T.SLOConfig(target_p99_ms=100.0, tiers=((2, 8),)))
    assert q_slo.method == "mscm_pallas_grouped_q"
    for tier, beam in ((0, 4), (1, 2)):
        plain = _plain(tree, beam, method="auto", quant=T.QuantConfig(tier="int8"))
        s_a, l_a = q_slo._run(xi, xv, tier=tier)
        s_b, l_b = plain._run(xi, xv)
        np.testing.assert_array_equal(_bits(s_a), _bits(s_b))
        np.testing.assert_array_equal(l_a.numpy(), l_b.numpy())


def test_warmup_buckets_covers_every_tier(tier_world, monkeypatch):
    jt, tree, engine, xq, xi, xv = tier_world
    eng = _plain(tree, 4, slo=T.SLOConfig(target_p99_ms=100.0, tiers=((2, 8),)))
    keys = []
    real_run = eng._run
    monkeypatch.setattr(eng, "_run", lambda xi, xv, tier=0: (
        keys.append(eng.bucket_key(xi.shape[0], tier)), real_run(xi, xv, tier=tier))[1])
    eng.warmup_buckets(eng.tree.d, 12)
    assert keys == [(b, t) for t in (0, 1) for b in (1, 2, 4, 8, 16)]
    keys.clear()
    eng.warmup_buckets(eng.tree.d, 2, tiers=(1,))
    assert keys == [(1, 1), (2, 1)]
    assert eng.measure_batch_seconds(4, iters=1, tier=1) > 0 and keys[-1] == (4, 1)


# ---------------------------------------------------------------------------
# 4. micro-batcher end to end
# ---------------------------------------------------------------------------

def test_batcher_selects_degraded_tier_under_pressure(tier_world, monkeypatch):
    """A pre-filled queue and costs that cannot meet the target at full
    beam push the policy off tier 0; each result is bitwise a no-SLO
    engine's at its tier's beam on the same batch, and the summary grows
    the tier panel."""
    jt, tree, engine, xq, xi, xv = tier_world
    rng = np.random.default_rng(5)
    queries = port_csr(random_sparse_csr(48, 128, 12, rng))
    costs = {0: 80.0, 1: 0.01}
    monkeypatch.setattr(engine, "measure_batch_seconds",
                        lambda batch, iters=3, tier=0: 1e-3 * costs[tier])
    mb = T.MicroBatcher(engine, T.BatchPolicy(max_batch=16, max_wait_ms=2.0))
    futs = [mb.submit(T.Query(*queries.row(i), qid=i)) for i in range(48)]
    try:
        mb.start()
        res = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        mb.stop()
    assert all(r.ok for r in res)
    assert mb.tier_policy is not None and mb.tier_policy.cost_ms == [80.0, 0.01]
    assert 1 in {r.beam_tier for r in res}
    # Three size-triggered batches of 16: serve_batch at max_batch 16 forms
    # the same buckets, so each row is computed as the batcher computed it.
    assert mb.metrics.batch_sizes == [16, 16, 16]
    want = {t: _plain(tree, b).serve_batch(queries) for t, b in ((0, 4), (1, 2))}
    for r in res:
        s_w, l_w = want[r.beam_tier]
        np.testing.assert_array_equal(_bits(r.scores), _bits(s_w[r.qid]))
        np.testing.assert_array_equal(r.ids, l_w[r.qid])
    summary = mb.metrics.summary()
    assert summary["shed"] == 0 and summary["degraded_to_tier"] > 0
    assert 0.0 < summary["degraded_to_tier_rate"] <= 1.0
    assert set(summary["beam_tiers"]) <= {"0", "1"}


def test_batcher_full_beam_identical_with_and_without_slo(tier_world, monkeypatch):
    jt, tree, engine, xq, xi, xv = tier_world
    queries = port_csr(random_sparse_csr(12, 128, 12, np.random.default_rng(9)))
    monkeypatch.setattr(engine, "measure_batch_seconds", lambda batch, iters=3, tier=0: 1e-6)
    out = {}
    for name, eng in (("slo", engine), ("plain", _plain(tree, 4))):
        mb = T.MicroBatcher(eng, T.BatchPolicy(max_batch=16, max_wait_ms=2.0))
        try:
            mb.start()
            out[name] = [f.result(timeout=TIMEOUT) for f in mb.submit_csr(queries)]
        finally:
            mb.stop()
    for (s_a, l_a), (s_b, l_b) in zip(out["slo"], out["plain"]):
        np.testing.assert_array_equal(_bits(s_a), _bits(s_b))
        np.testing.assert_array_equal(l_a, l_b)
