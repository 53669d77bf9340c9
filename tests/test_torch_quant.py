"""PyTorch port, quantized serving tiers: the port's ``repro_torch.quant``
against the reference's ``repro.quant`` on the same seeded inputs.

Codes, scales, the pruned re-pack and the dequantized tiles are compared
bitwise (fp8 codes as their uint8 bit patterns). The reference's Pallas
kernel runs in interpret mode; the port's wrapper takes its plain version
because the tensors lie on the CPU. Scores agree within ``rtol=1e-5,
atol=1e-6`` (the tolerance of ``test_torch_kernels.py``), rankings by the
North-star rule (``repro_torch.parity.check_ranking``: labels equal
wherever the reference's score gap exceeds that tolerance). The CUDA kernel
is held against its plain version on a GPU by ``test_torch_cuda.py``.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as J
from repro.core import XMRTree as JTree
from repro.core import mscm as JM
from repro.serving import QuantConfig as JQuantConfig
from repro.serving import ServeConfig as JConfig
from repro.serving import XMRServingEngine as JEngine
from repro.sparse import random_sparse_csr
from repro_torch import obs
from repro_torch import quant as Q
from repro_torch.convert import quantized_tree_from_numpy
from repro_torch.core import mscm as TM
from repro_torch.core.tree import TreeLayerArrays, XMRTree
from repro_torch.kernels import mscm_kernel as tk
from repro_torch.parity import check_ranking
from repro_torch.quant import kernels as qk
from repro_torch.serving import QuantConfig, ServeConfig, XMRServingEngine
from tests.conftest import make_tree_weights
from tests.test_torch_serving import port_csr
from tests.test_torch_tree import port_csc

RTOL, ATOL = 1e-5, 1e-6
TIERS = ("int8", "int8_pruned", "fp8")
T = torch.from_numpy


@pytest.fixture(scope="module")
def quant_setup():
    """The reference's ``quant_setup``: d = 200, B = 8, levels 8/64/512."""
    rng = np.random.default_rng(29)
    d, B = 200, 8
    ws = make_tree_weights(rng, d, [8, 64, 512], B)
    jt = JTree.from_weight_matrices(ws, B)
    tt = XMRTree.from_weight_matrices([port_csc(w) for w in ws], B, device="cpu")
    queries = random_sparse_csr(16, d, 15, rng)
    xi, xv = queries.to_ell(32)
    return jt, tt, queries, xi, xv


def codes_np(codes) -> np.ndarray:
    """Codes as comparable numpy: int8 as they are, fp8 as uint8 bits."""
    if isinstance(codes, torch.Tensor):
        return (codes.view(torch.uint8) if codes.dtype == torch.float8_e4m3fn else codes).numpy()
    a = np.asarray(codes)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


def assert_bitwise_f32(got, want):
    got = np.ascontiguousarray(np.asarray(got, np.float32))
    want = np.ascontiguousarray(np.asarray(want, np.float32))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def assert_same_qlayer(t, j):
    np.testing.assert_array_equal(t.chunk_rows.numpy(), np.asarray(j.chunk_rows))
    np.testing.assert_array_equal(codes_np(t.chunk_vals), codes_np(j.chunk_vals))
    assert_bitwise_f32(t.chunk_scales.numpy(), j.chunk_scales)


def port_qtree(jq):
    """The reference's quantized tree carried across to the port."""
    layers = [{"chunk_rows": np.asarray(l.chunk_rows),
               "chunk_vals": codes_np(l.chunk_vals),
               "chunk_scales": np.asarray(l.chunk_scales)} for l in jq.layers]
    return quantized_tree_from_numpy(layers, jq.n_cols, jq.branching, jq.d, jq.tier,
                                     device="cpu")


def wide_range_vals(seed: int, c=6, r=24, b=8) -> np.ndarray:
    """Chunk tiles across twelve decades, with an all-zero column, ties in
    magnitude, and codes landing exactly on half-integers (round half even)."""
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal((c, r, b))
            * 10.0 ** rng.integers(-6, 6, size=(c, 1, b))).astype(np.float32)
    vals[:, :, 0] = 0.0
    vals[0, :, 1] = 0.0
    vals[0, :6, 1] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]  # scale 1: exact halves
    vals[1, 3:6, :] = vals[1, 2, :]                       # repeated rows
    return vals


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_layer_bitwise(quant_setup, dtype):
    jt, tt, *_ = quant_setup
    for jl, tl in zip(jt.layers, tt.layers):
        assert_same_qlayer(Q.quantize_layer(tl, dtype), J.quantize_layer(jl, dtype))


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_wide_range_bitwise(dtype, seed):
    vals = wide_range_vals(seed)
    rows = np.zeros(vals.shape[:2], np.int32)
    lay = dataclasses.make_dataclass("L", ["chunk_rows", "chunk_vals"])
    want = J.quantize_layer(lay(rows, vals), dtype)
    got = Q.quantize_layer(lay(T(rows), T(vals)), dtype)
    assert_same_qlayer(got, want)
    assert (got.chunk_scales[:, 0] == 1.0).all()          # zero column: scale 1
    deq = Q.dequantize_layer(got, d=5).chunk_vals
    assert (deq[:, :, 0] == 0).all()
    if dtype == "int8":
        np.testing.assert_array_equal(got.chunk_vals[0, :6, 1].numpy(), [127, 0, 2, 2, 0, -2])


def test_fp8_rounding_agrees_in_range():
    """torch.float8_e4m3fn and jnp.float8_e4m3fn round every f32 in
    [-464, 464] alike (outside it torch saturates and jax gives NaN): the
    fp8 grid, the midpoints between its points and one f32 step either side
    of them, and random values over every binade."""
    grid = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn).float()
    grid = torch.sort(grid[torch.isfinite(grid)]).values
    mids = (grid[1:] + grid[:-1]) / 2
    steps = torch.cat([torch.nextafter(mids, torch.tensor(np.inf)),
                       torch.nextafter(mids, torch.tensor(-np.inf))])
    rng = np.random.default_rng(7)
    rand = rng.uniform(-464, 464, 100_000) * 2.0 ** rng.integers(-20, 1, 100_000)
    x = torch.cat([grid, mids, steps, T(rand.astype(np.float32)),
                   torch.tensor([464.0, -464.0, 448.0, -448.0])])
    assert float(x.abs().max()) <= 464.0
    got = x.to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fp8_quantizer_stays_in_range(seed):
    """The scale maps each column's amax onto 448: the scaled values stay
    inside [-464, 464], where both casts agree, and the codes are finite."""
    vals = T(wide_range_vals(seed, c=40, r=64, b=16))
    q, scale = Q.quantize_chunks(vals, "fp8")
    scaled = vals / scale[:, None, :]
    assert float(scaled.abs().max()) <= 464.0
    codes = q.float()
    assert torch.isfinite(codes).all() and float(codes.abs().max()) <= 448.0


def prune_cases(quant_setup):
    jt, _, _, _, _ = quant_setup
    lay = jt.layers[-1]
    yield "leaf level", np.array(lay.chunk_rows), np.array(lay.chunk_vals), jt.d
    # Ties in magnitude, and an empty chunk (every row the sentinel).
    rng = np.random.default_rng(3)
    d, c, r, b = 50, 5, 16, 4
    rows = np.sort(rng.integers(0, d, size=(c, r)), axis=1).astype(np.int32)
    rows[:, 11:] = d
    rows[2] = d
    vals = rng.choice(np.array([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32), size=(c, r, b))
    vals[rows == d] = 0.0
    yield "ties and an empty chunk", rows, vals, d


@pytest.mark.parametrize("keep", [0.3, 0.5, 1.0])
def test_prune_chunks_bitwise(quant_setup, keep):
    for what, rows, vals, d in prune_cases(quant_setup):
        want_r, want_v = J.prune_chunks(rows, vals, keep, sentinel=d)
        got_r, got_v = Q.prune_chunks(T(rows), T(vals), keep, sentinel=d)
        assert got_r.dtype == torch.int32, what
        np.testing.assert_array_equal(got_r.numpy(), want_r, err_msg=what)
        assert_bitwise_f32(got_v.numpy(), want_v)


def test_prune_chunks_rejects_bad_keep_frac(quant_setup):
    _, tt, *_ = quant_setup
    lay = tt.layers[0]
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="keep_frac"):
            Q.prune_chunks(lay.chunk_rows, lay.chunk_vals, bad, sentinel=tt.d)


@pytest.mark.parametrize("tier", TIERS)
def test_quantize_and_dequantize_tree_bitwise(quant_setup, tier):
    jt, tt, *_ = quant_setup
    jq = J.quantize_tree(jt, tier=tier)
    tq = Q.quantize_tree(tt, tier=tier)
    assert isinstance(tq, Q.QuantizedTree) and tq.tier == tier
    for tl, jl in zip(tq.layers, jq.layers):
        assert_same_qlayer(tl, jl)
    assert tq.memory_bytes() == jq.memory_bytes()
    for tl, jl in zip(Q.dequantize_tree(tq).layers, J.dequantize_tree(jq).layers):
        assert isinstance(tl, TreeLayerArrays)
        np.testing.assert_array_equal(tl.chunk_rows.numpy(), np.asarray(jl.chunk_rows))
        assert_bitwise_f32(tl.chunk_vals.numpy(), jl.chunk_vals)
        np.testing.assert_array_equal(tl.col_rows.numpy(), np.asarray(jl.col_rows))
        np.testing.assert_array_equal(tl.col_vals.numpy(), np.asarray(jl.col_vals))
    # The reference's tree carried across is the port's own quantized tree.
    for tl, cl in zip(tq.layers, port_qtree(jq).layers):
        assert tl.chunk_vals.dtype == cl.chunk_vals.dtype
        assert_same_qlayer(cl, tl)


def test_quantized_tree_from_numpy_checks(quant_setup):
    jt, *_ = quant_setup
    jq = J.quantize_tree(jt, tier="fp8")
    layers = [{"chunk_rows": np.asarray(l.chunk_rows),
               "chunk_vals": np.asarray(l.chunk_vals).view(np.int8),
               "chunk_scales": np.asarray(l.chunk_scales)} for l in jq.layers]
    with pytest.raises(TypeError, match="uint8"):
        quantized_tree_from_numpy(layers, jq.n_cols, jq.branching, jq.d, "fp8", device="cpu")
    with pytest.raises(ValueError, match="lack"):
        quantized_tree_from_numpy([{"chunk_rows": layers[0]["chunk_rows"]}] * 3,
                                  jq.n_cols, jq.branching, jq.d, "int8", device="cpu")


# ---------------------------------------------------------------------------
# the kernel's plain version and the level around it
# ---------------------------------------------------------------------------

def grouped_inputs(seed, dtype, t=5, qt=4, r=16, b=8, c=3):
    rng = np.random.default_rng(seed)
    xg = rng.random((t, qt, r)).astype(np.float32)
    vals = (rng.standard_normal((c, r, b)) * 0.3).astype(np.float32)
    tc = np.sort(rng.integers(0, c, size=t)).astype(np.int32)
    ps = rng.random((t, qt)).astype(np.float32)
    jl = J.quantize_layer(
        dataclasses.make_dataclass("L", ["chunk_rows", "chunk_vals"])(
            np.zeros((c, r), np.int32), vals), dtype)
    return xg, jl.chunk_vals, jl.chunk_scales, tc, ps


def port_codes(codes) -> torch.Tensor:
    a = codes_np(codes)
    return T(a.copy()).view(torch.float8_e4m3fn) if a.dtype == np.uint8 else T(a.copy())


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("mode", ["none", "prod", "logsum"])
def test_grouped_q_plain_matches_pallas_interpret(mode, dtype):
    xg, q, s, tc, ps = grouped_inputs(11, dtype)
    p_j = None if mode == "none" else jnp.asarray(ps)
    p_t = None if mode == "none" else T(ps)
    want = J.mscm_grouped_q(jnp.asarray(xg), q, s, jnp.asarray(tc), p_j, mode=mode,
                            interpret=True)
    before = obs.total("launches.mscm_grouped_q")
    got = qk.mscm_grouped_q(T(xg), port_codes(q), T(np.array(s)), T(tc).long(), p_t,
                            mode=mode)
    assert obs.total("launches.mscm_grouped_q") == before  # CPU tensors never launch the kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("mode", ["none", "prod", "logsum"])
def test_grouped_q_plain_is_grouped_plain_on_dequantized_tiles(mode, dtype):
    """Bitwise, with a chunk id past C (clamped to the last chunk)."""
    xg, q, s, tc, ps = grouped_inputs(12, dtype)
    tc[-1] = 7
    vals, scales = port_codes(q), T(np.array(s))
    p = None if mode == "none" else T(ps)
    got = qk.mscm_grouped_q_plain(T(xg), vals, scales, T(tc).long(), p, mode=mode)
    deq = vals.float() * scales[:, None, :]
    want = tk.mscm_grouped_plain(T(xg), deq, T(tc).long(), p, mode=mode)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("mode", ["none", "prod", "logsum"])
def test_grouped_q_plain_zeroes_padding_tiles(mode, dtype):
    """Padding tiles give zeros; live tiles are the result without
    tile_src, bitwise, and the f32 plain version on the dequantized tiles."""
    xg, q, s, tc, ps = grouped_inputs(13, dtype)
    vals, scales = port_codes(q), T(np.array(s))
    t, qt = xg.shape[:2]
    src = torch.arange(t * qt).reshape(t, qt)
    src[t // 2:] = -1
    p = None if mode == "none" else T(ps)
    got = qk.mscm_grouped_q(T(xg), vals, scales, T(tc).long(), p, mode=mode, tile_src=src)
    old = qk.mscm_grouped_q_plain(T(xg), vals, scales, T(tc).long(), p, mode=mode)
    live = src[:, 0] >= 0
    assert torch.equal(got[live], old[live])
    assert not got[~live].any()
    deq = vals.float() * scales[:, None, :]
    assert torch.equal(got, tk.mscm_grouped_plain(T(xg), deq, T(tc).long(), p, mode=mode,
                                                  tile_src=src))


def test_grouped_q_wrapper_rejects_bad_arguments():
    xg, vals = torch.zeros(2, 4, 8), torch.zeros(3, 8, 6, dtype=torch.int8)
    s, tc, ps = torch.ones(3, 6), torch.zeros(2, dtype=torch.int64), torch.zeros(2, 4)
    qk.mscm_grouped_q(xg, vals, s, tc, ps, mode="prod")
    with pytest.raises(TypeError, match="vals"):
        qk.mscm_grouped_q(xg, vals.float(), s, tc, ps, mode="prod")
    with pytest.raises(TypeError, match="scales"):
        qk.mscm_grouped_q(xg, vals, s.double(), tc, ps, mode="prod")
    with pytest.raises(ValueError, match="scales"):
        qk.mscm_grouped_q(xg, vals, torch.ones(3, 5), tc, ps, mode="prod")
    with pytest.raises(ValueError, match="parent_scores"):
        qk.mscm_grouped_q(xg, vals, s, tc, None, mode="logsum")


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("mode,qt", [("none", 4), ("prod", 8), ("logsum", 2)])
def test_grouped_q_level_matches_reference(quant_setup, mode, qt, dtype):
    jt, tt, _, xi, xv = quant_setup
    jl = J.quantize_layer(jt.layers[-1], dtype)
    rng = np.random.default_rng(qt)
    a, c = 17, jl.chunk_rows.shape[0]
    bq = rng.integers(0, xi.shape[0], size=a).astype(np.int32)
    bc = rng.integers(0, c, size=a).astype(np.int32)
    ps = rng.random(a).astype(np.float32)
    xd_j = JM.scatter_dense(jnp.asarray(xi), jnp.asarray(xv), jt.d)
    xd_t = TM.scatter_dense(T(xi), T(xv), tt.d)
    want = J.kernels.mscm_pallas_grouped_q(
        xd_j, jl.chunk_rows, jl.chunk_vals, jl.chunk_scales, jnp.asarray(bq),
        jnp.asarray(bc), None if mode == "none" else jnp.asarray(ps),
        qt=qt, mode=mode, interpret=True)
    got = qk.mscm_pallas_grouped_q(
        xd_t, T(np.array(jl.chunk_rows)), port_codes(jl.chunk_vals),
        T(np.array(jl.chunk_scales)), T(bq), T(bc),
        None if mode == "none" else T(ps), qt=qt, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the traversal and the contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("score_mode", ["prod", "logsum"])
@pytest.mark.parametrize("tier", TIERS)
def test_quantized_infer_matches_reference(quant_setup, tier, score_mode):
    jt, _, _, xi, xv = quant_setup
    jq = J.quantize_tree(jt, tier=tier)
    kw = dict(beam=10, topk=5, method="mscm_pallas_grouped_q", score_mode=score_mode)
    sj, lj = jq.infer(jnp.asarray(xi), jnp.asarray(xv), **kw)
    st, lt = port_qtree(jq).infer(T(xi), T(xv), **kw)
    check_ranking(st.numpy(), lt.numpy(), np.asarray(sj), np.asarray(lj), tier)


@pytest.mark.parametrize("tier", TIERS)
def test_quantized_infer_is_grouped_on_dequantized_tree(quant_setup, tier):
    """The reference's kernel-parity contract, in the port: bitwise."""
    _, tt, _, xi, xv = quant_setup
    tq = Q.quantize_tree(tt, tier=tier)
    got = tq.infer(T(xi), T(xv), beam=10, topk=5, method="mscm_pallas_grouped_q")
    want = Q.dequantize_tree(tq).infer(T(xi), T(xv), beam=10, topk=5,
                                       method="mscm_pallas_grouped")
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def test_grouped_q_needs_a_quantized_tree(quant_setup):
    _, tt, _, xi, xv = quant_setup
    with pytest.raises(ValueError, match="quantize"):
        tt.infer(T(xi), T(xv), method="mscm_pallas_grouped_q")


def test_contract_metrics_match_reference(quant_setup):
    jt, _, _, xi, xv = quant_setup
    ref = jt.infer(jnp.asarray(xi), jnp.asarray(xv), beam=10, topk=5,
                   method="mscm_pallas_grouped")
    got = J.quantize_tree(jt, tier="int8_pruned", prune_keep=0.3).infer(
        jnp.asarray(xi), jnp.asarray(xv), beam=10, topk=5, method="mscm_pallas_grouped_q")
    (rs, rl), (gs, gl) = [(np.asarray(s), np.asarray(l)) for s, l in (ref, got)]
    assert Q.recall_at_k(rl, gl) == J.recall_at_k(rl, gl)
    assert Q.recall_at_k(rl, rl) == 1.0
    for k in (None, 3):
        assert Q.score_mae(rs, gs, k) == pytest.approx(J.score_mae(rs, gs, k), rel=1e-6)
    np.testing.assert_array_equal(Q.topk_scores(gs, 3).numpy(),
                                  np.asarray(J.topk_scores(gs, 3)))


# ---------------------------------------------------------------------------
# engine and config seams
# ---------------------------------------------------------------------------

KNOBS = dict(ell_width=32, max_batch=64)


@pytest.mark.parametrize("tier", TIERS)
def test_quant_engine_matches_reference(quant_setup, tier):
    jt, tt, queries, _, _ = quant_setup
    ref = JEngine(jt, JConfig(quant=JQuantConfig(tier=tier), **KNOBS))
    eng = XMRServingEngine(tt, ServeConfig(quant=QuantConfig(tier=tier), **KNOBS),
                           device="cpu")
    assert eng.method == ref.method == "mscm_pallas_grouped_q"
    assert isinstance(eng.tree, Q.QuantizedTree) and eng.tree.tier == tier
    assert eng.tree.memory_bytes() == ref.tree.memory_bytes()
    s_j, l_j = ref.serve_batch(queries)
    s_t, l_t = eng.serve_batch(port_csr(queries))
    check_ranking(s_t, l_t, s_j, l_j, tier)


def test_quant_tier_with_explicit_exact_method_raises(quant_setup):
    _, tt, *_ = quant_setup
    for method in ("mscm_dense", "mscm_pallas_grouped"):
        with pytest.raises(ValueError, match="mscm_pallas_grouped_q"):
            XMRServingEngine(tt, ServeConfig(method=method, quant=QuantConfig(tier="int8"),
                                             **KNOBS), device="cpu")
    eng = XMRServingEngine(tt, ServeConfig(method="mscm_pallas_grouped_q",
                                           quant=QuantConfig(tier="fp8"), **KNOBS),
                           device="cpu")
    assert eng.method == "mscm_pallas_grouped_q"


def test_quant_engine_needs_a_gpu_or_explicit_cpu(quant_setup, monkeypatch):
    _, tt, *_ = quant_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        XMRServingEngine(tt, ServeConfig(quant=QuantConfig(tier="int8")))


@pytest.mark.parametrize("kwargs,match", [
    (dict(tier="int4"), "tier"), (dict(tier="int8_pruned", prune_keep=0.0), "prune_keep"),
    (dict(prune_keep=1.5), "prune_keep"),
])
def test_quantconfig_validation(kwargs, match):
    for cfg in (QuantConfig, JQuantConfig):
        with pytest.raises(ValueError, match=match):
            cfg(**kwargs)


def test_serveconfig_flat_kwarg_shim():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg = ServeConfig(tier="int8_pruned", prune_keep=0.25)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert (cfg.quant.tier, cfg.tier, cfg.quant.prune_keep, cfg.prune_keep) == (
        "int8_pruned", "int8_pruned", 0.25, 0.25)
    base = QuantConfig(tier="fp8")
    with pytest.warns(DeprecationWarning):
        cfg = ServeConfig(quant=base, prune_keep=0.75)
    assert cfg.quant == QuantConfig(tier="fp8", prune_keep=0.75) and base.prune_keep == 0.5
    assert ServeConfig().quant == QuantConfig()
    with pytest.raises(TypeError, match="QuantConfig"):
        ServeConfig(quant="int8")
