"""PyTorch port on a GPU: the CUDA kernels and the traversal on the card.

Every test here needs a CUDA device and ``nvcc`` and skips without one
(from its fixture). The file imports nothing of JAX, so it runs on a GPU
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Each kernel is held against its plain version, the grouped ones with and
without padding tiles (``tile_src``); the quantized grouped kernel also
bitwise against the f32 grouped kernel on the dequantized tiles; every
kernel bitwise against a second launch; the traversal on the card against the same traversal on the CPU, by
the ranking rule of ``repro_torch.parity`` (scores within rtol 1e-5 / atol
1e-6, labels equal outside near-ties). The enterprise serving step at a
small geometry, card against CPU, is held by the same rule at rtol 1e-6 /
atol 1e-7 (sums of a few terms; see ``chip_smoke.py``'s ``ENTERPRISE``).
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.tree import XMRTree
from repro_torch.kernels import mscm_kernel as tk
from repro_torch.kernels import ops
from repro_torch.parity import check_ranking
from repro_torch.quant import kernels as qk
from repro_torch.quant.storage import quantize_chunks, quantize_tree
from repro_torch.sparse.csr import random_sparse_csc, random_sparse_csr

# R-term f32 sums in different orders (see chip_smoke.py).
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4
# bf16 inputs: the tolerance the reference's dtype sweep uses.
BF16_TOL = 2e-2


def launches(kernel: str) -> int:
    """Launches of the CUDA kernel ``mscm_<kernel>`` since import."""
    return obs.total(f"launches.mscm_{kernel}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version is true f32
    return torch.device("cuda")


# The grouped kernels' shapes (T, QT, R, B, C): chip_smoke.py's (the path's
# leaf level with fewer chunks, edge B = 6 and 8, QT*B over one pass of the
# threads with int8/fp8 tiles off 16 bytes) and two more plans.
GROUPED_SHAPES = [
    (640, 8, 496, 32, 300), (1, 4, 8, 6, 3), (1, 4, 8, 8, 3), (3, 16, 100, 70, 4),
    (5, 2, 37, 8, 3),        # R % 4 != 0: the query rows by ordinary loads
    (4, 16, 1040, 72, 5),    # a tile over 227 KB: R in passes through the buffers
    # More tiles than CTAs, in passes whose last pass has fewer slabs: one
    # stage in f32 (2 passes), two stages in int8/fp8 (3 passes).
    (300, 16, 600, 72, 40), (300, 16, 1300, 64, 40),
    # Past the old caps: QT = 32 and 24 in row groups of 16 (the last of 24
    # short; with padding, the last live tile's second half is padding),
    # B = 1024 at QT = 16 in windows, and both at once with rows of B off 16
    # bytes in int8/fp8.
    (40, 32, 496, 32, 30), (40, 24, 496, 32, 30), (20, 16, 496, 1024, 10),
    (6, 24, 100, 1030, 4),
]


def _grouped_inputs(device, shape, seed, dead):
    """Seeded inputs of the grouped kernels: xg, f32 tiles, sorted chunk ids
    naming chunk C (clamped), parent scores, and ``tile_src`` (None, or a
    fifth of the tiles live, the rest padding at the tail as the grouping
    leaves it, the last live tile part full)."""
    t, qt, r, b, c = shape
    g = torch.Generator().manual_seed(seed)
    xg = torch.rand(t, qt, r, generator=g)
    vals = torch.randn(c, r, b, generator=g)
    tc = torch.sort(torch.randint(0, c + 1, (t,), generator=g)).values
    ps = torch.rand(t, qt, generator=g)
    src = None
    if dead:
        live = max(1, t // 5) if t > 1 else 0
        src = torch.arange(t * qt).reshape(t, qt)
        src[live:] = -1
        if live:
            src[live - 1, qt // 2 + 1:] = -1
    return [x.to(device) if x is not None else None for x in (xg, vals, tc, ps, src)]


@pytest.mark.cuda
@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("shape", GROUPED_SHAPES)
def test_kernel_matches_plain(cuda_device, shape, dead):
    xg, vals, tc, ps, src = _grouped_inputs(cuda_device, shape, 0, dead)
    for mode in ("none", "prod", "logsum"):
        p = None if mode == "none" else ps
        before = launches("grouped")
        got = tk.mscm_grouped(xg, vals, tc, p, mode=mode, tile_src=src)
        assert launches("grouped") == before + 1
        want = tk.mscm_grouped_plain(xg, vals, tc, p, mode=mode, tile_src=src)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        if dead:
            assert not got[src[:, 0] < 0].any()  # padding tiles: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("shape", GROUPED_SHAPES)
def test_grouped_kernels_repeat_bitwise(cuda_device, shape, dead):
    """Fixed-order sums, no atomics: two launches agree bit for bit, in f32
    and int8, with and without padding tiles."""
    xg, vals, tc, ps, src = _grouped_inputs(cuda_device, shape, 6, dead)
    first = tk.mscm_grouped(xg, vals, tc, ps, mode="prod", tile_src=src)
    assert torch.equal(first, tk.mscm_grouped(xg, vals, tc, ps, mode="prod", tile_src=src))
    q, s = quantize_chunks(vals, "int8")
    first = qk.mscm_grouped_q(xg, q, s, tc, ps, mode="logsum", tile_src=src)
    assert torch.equal(first, qk.mscm_grouped_q(xg, q, s, tc, ps, mode="logsum", tile_src=src))


@pytest.mark.cuda
@pytest.mark.parametrize("score_mode", ["prod", "logsum"])
def test_traversal_on_card_matches_cpu(cuda_device, score_mode):
    rng = np.random.default_rng(1234)
    d, B = 150, 8
    ws = [random_sparse_csc(d, L, 10, rng, sibling_groups=B) for L in (8, 64, 512)]
    x = random_sparse_csr(12, d, 18, rng)
    xi, xv = (torch.from_numpy(a) for a in x.to_ell())
    cpu = XMRTree.from_weight_matrices(ws, B, device="cpu")
    gpu = XMRTree.from_weight_matrices(ws, B)  # the default device is the GPU
    assert gpu.device.type == "cuda"
    s0, l0 = cpu.infer(xi, xv, beam=10, topk=5, method="mscm_dense", score_mode=score_mode)
    before = launches("grouped")
    s1, l1 = gpu.infer(xi, xv, beam=10, topk=5, method="mscm_pallas_grouped",
                       score_mode=score_mode, qt=4)
    assert launches("grouped") == before + gpu.depth
    check_ranking(s1.cpu().numpy(), l1.cpu().numpy(), s0.numpy(), l0.numpy(), "grouped")


def _block_inputs(device, shape, dtype, seed=1):
    """Seeded inputs of the per-block kernels: query table, chunk rows (some
    past the table, clipped), tiles, and a sorted block list naming chunk C
    (clamped)."""
    a, n, dp, r, b, c = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, dp, generator=g).to(dtype)
    rows = torch.randint(0, dp + 3, (c, r), generator=g, dtype=torch.int32)
    vals = torch.randn(c, r, b, generator=g).to(dtype)
    bq = torch.randint(0, n, (a,), generator=g)
    bc = torch.sort(torch.randint(0, c + 1, (a,), generator=g)).values
    return tuple(t.to(device) for t in (x, rows, vals, bq, bc))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [  # (A, n, Dp, R, B, C)
    (10, 1, 5000, 496, 32, 300), (640, 64, 900, 96, 32, 40), (1, 1, 50, 8, 6, 3),
    (3, 2, 90, 1100, 70, 4), (5, 2, 70, 37, 8, 3),
    (1, 1, 5000, 496, 32, 300),       # one block, R split over a cluster of 8
    (3, 2, 2000, 1037, 70, 4),        # unaligned in f32 and bf16: ordinary loads
    (200, 2, 2000, 1040, 72, 40),     # one CTA a block, the tile through a ring of slabs
    # Past the old cap of 1,022 columns: windows, one bulk copy a row, then
    # rows of B off 16 bytes by ordinary loads.
    (10, 1, 5000, 496, 2048, 30), (1, 1, 5000, 496, 2048, 30), (640, 64, 900, 96, 2048, 40),
    (10, 1, 5000, 496, 1030, 20),
])
def test_block_kernels_match_plain(cuda_device, shape, dtype):
    a, n, dp, r, b, c = shape
    x, rows, vals, bq, bc = _block_inputs(cuda_device, shape, dtype)
    tol = dict(rtol=KERNEL_RTOL, atol=KERNEL_ATOL) if dtype == torch.float32 else dict(
        rtol=BF16_TOL, atol=BF16_TOL)
    before = launches("fused")
    got = tk.mscm_fused(x, rows, vals, bq, bc)
    assert launches("fused") == before + 1
    torch.testing.assert_close(got, tk.mscm_fused_plain(x, rows, vals, bq, bc), **tol)
    xg = x[bq[:, None], rows[bc.clamp(max=c - 1)].long().clamp(max=dp - 1)]
    before = launches("pregather")
    got = tk.mscm_pregather(xg, vals, bc)
    assert launches("pregather") == before + 1
    torch.testing.assert_close(got, tk.mscm_pregather_plain(xg, vals, bc), **tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(10, 1, 5000, 496, 32, 300), (640, 64, 900, 96, 32, 40),
                                   (3, 2, 2000, 1037, 70, 4), (200, 2, 2000, 1040, 72, 40),
                                   (10, 1, 5000, 496, 2048, 30)])
def test_block_kernels_repeat_bitwise(cuda_device, shape, dtype):
    """Fixed-order sums, no atomics: two launches on the same inputs agree
    bit for bit."""
    x, rows, vals, bq, bc = _block_inputs(cuda_device, shape, dtype, seed=5)
    assert torch.equal(tk.mscm_fused(x, rows, vals, bq, bc), tk.mscm_fused(x, rows, vals, bq, bc))
    xg = x[bq[:, None], rows[bc.clamp(max=vals.shape[0] - 1)].long().clamp(max=x.shape[1] - 1)]
    assert torch.equal(tk.mscm_pregather(xg, vals, bc), tk.mscm_pregather(xg, vals, bc))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fused", "pregather"])
def test_mscm_pallas_unsorted_on_card(cuda_device, variant):
    g = torch.Generator().manual_seed(2)
    x = torch.rand(4, 300, generator=g)
    rows = torch.randint(0, 300, (6, 40), generator=g, dtype=torch.int32)
    vals = torch.randn(6, 40, 16, generator=g)
    bq, bc = torch.randint(0, 4, (12,), generator=g), torch.randint(0, 6, (12,), generator=g)
    want = ops.mscm_pallas(x, rows, vals, bq, bc, variant=variant, sort=False)
    x, rows, vals, bq, bc = (t.to(cuda_device) for t in (x, rows, vals, bq, bc))
    for sort in (False, True):
        got = ops.mscm_pallas(x, rows, vals, bq, bc, variant=variant, sort=sort)
        torch.testing.assert_close(got.cpu(), want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("score_mode", ["prod", "logsum"])
@pytest.mark.parametrize("method", ["mscm_pallas", "mscm_pallas_pregather", "vanilla",
                                    "mscm_searchsorted"])
def test_online_traversal_on_card_matches_cpu(cuda_device, method, score_mode):
    rng = np.random.default_rng(4321)
    d, B = 150, 8
    ws = [random_sparse_csc(d, L, 10, rng, sibling_groups=B) for L in (8, 64, 512)]
    x = random_sparse_csr(6, d, 18, rng)
    xi, xv = (torch.from_numpy(a) for a in x.to_ell())
    cpu = XMRTree.from_weight_matrices(ws, B, device="cpu")
    gpu = XMRTree.from_weight_matrices(ws, B)
    for i in range(xi.shape[0]):  # one query at a time, as the online setting runs
        q = slice(i, i + 1)
        s0, l0 = cpu.infer(xi[q], xv[q], beam=10, topk=5, method=method, score_mode=score_mode)
        fused, pregather = launches("fused"), launches("pregather")
        s1, l1 = gpu.infer(xi[q], xv[q], beam=10, topk=5, method=method,
                           score_mode=score_mode)
        if method == "mscm_pallas":  # d + 1 columns: under the limit, so fused
            assert (launches("fused"), launches("pregather")) == (fused + gpu.depth, pregather)
        if method == "mscm_pallas_pregather":
            assert (launches("fused"), launches("pregather")) == (fused, pregather + gpu.depth)
        check_ranking(s1.cpu().numpy(), l1.cpu().numpy(), s0.numpy(), l0.numpy(), method)


@pytest.mark.cuda
@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("shape", GROUPED_SHAPES)
def test_grouped_q_kernel_matches_plain_and_dequantized(cuda_device, shape, dtype, dead):
    xg, f32, tc, ps, src = _grouped_inputs(cuda_device, shape, 3, dead)
    vals, scales = quantize_chunks(f32, dtype)
    deq = vals.float() * scales[:, None, :]
    for mode in ("none", "prod", "logsum"):
        p = None if mode == "none" else ps
        before = launches("grouped_q")
        got = qk.mscm_grouped_q(xg, vals, scales, tc, p, mode=mode, tile_src=src)
        assert launches("grouped_q") == before + 1
        want = qk.mscm_grouped_q_plain(xg, vals, scales, tc, p, mode=mode, tile_src=src)
        torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        # One routine: the dequantized tiles through the f32 kernel, bitwise.
        assert torch.equal(got, tk.mscm_grouped(xg, deq, tc, p, mode=mode, tile_src=src))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["int8", "int8_pruned", "fp8"])
def test_quantized_traversal_on_card_matches_cpu(cuda_device, tier):
    rng = np.random.default_rng(29)
    d, B = 200, 8
    ws = [random_sparse_csc(d, L, 10, rng, sibling_groups=B) for L in (8, 64, 512)]
    x = random_sparse_csr(16, d, 15, rng)
    xi, xv = (torch.from_numpy(a) for a in x.to_ell(32))
    cpu = quantize_tree(XMRTree.from_weight_matrices(ws, B, device="cpu"), tier=tier)
    gpu = quantize_tree(XMRTree.from_weight_matrices(ws, B), tier=tier)
    for lc, lg in zip(cpu.layers, gpu.layers):  # the card's codes are the CPU's
        assert torch.equal(lc.chunk_rows, lg.chunk_rows.cpu())
        assert torch.equal(lc.chunk_vals.view(torch.uint8), lg.chunk_vals.cpu().view(torch.uint8))
        assert torch.equal(lc.chunk_scales, lg.chunk_scales.cpu())
    s0, l0 = cpu.infer(xi, xv, beam=10, topk=5, method="mscm_pallas_grouped_q")
    before = launches("grouped_q")
    s1, l1 = gpu.infer(xi, xv, beam=10, topk=5, method="mscm_pallas_grouped_q", qt=4)
    assert launches("grouped_q") == before + gpu.depth
    check_ranking(s1.cpu().numpy(), l1.cpu().numpy(), s0.numpy(), l0.numpy(), tier)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["mscm_pallas_grouped", "mscm_pallas", "mscm_pallas_pregather"])
def test_wide_tree_and_tall_tiles_on_card(cuda_device, method):
    """``ServeConfig(qt=32)`` on a one-level tree of branching 1024: tiles
    of 32 rows in two row groups and chunks of 1,024 columns in windows, on
    the card, against ``mscm_dense`` on the card."""
    from repro_torch.serving import ServeConfig, XMRServingEngine

    rng = np.random.default_rng(77)
    d, B = 300, 1024
    tree = XMRTree.from_weight_matrices([random_sparse_csc(d, B, 12, rng)], B)
    x = random_sparse_csr(40, d, 20, rng)
    out = {}
    for m in (method, "mscm_dense"):
        eng = XMRServingEngine(tree, ServeConfig(beam=10, topk=10, method=m, qt=32,
                                                 max_batch=64, ell_width=32))
        counts = (launches("grouped"), launches("fused"), launches("pregather"))
        out[m] = eng.serve_batch(x)
        launched = [a - b for a, b in zip((launches("grouped"), launches("fused"),
                                           launches("pregather")), counts)]
        if m != "mscm_dense":
            assert sum(launched) == 1
    check_ranking(*out[method], *out["mscm_dense"], f"branching 1024, qt=32, {method}")


def _small_dataset():
    """The reference training test's dataset (128 labels, d = 256)."""
    from repro_torch.data import synthetic_labeled_dataset

    rng = np.random.default_rng(7)
    ds = synthetic_labeled_dataset(rng, n_labels=128, d=256, n_train=768, n_test=192,
                                   query_nnz=14)
    return ds, rng


@pytest.mark.cuda
def test_train_on_card_and_serve_through_grouped_kernel(cuda_device):
    """Train at the reference test's size on the card, then serve the test
    split through the grouped kernel: labels as ``mscm_dense``'s on the
    card, and the reference's quality bar."""
    from repro_torch.metrics import precision_at_k
    from repro_torch.serving import ServeConfig, XMRServingEngine
    from repro_torch.trees.train import train_xmr_model

    ds, rng = _small_dataset()
    model = train_xmr_model(ds.x_train, ds.y_train, ds.n_labels, branching=8, rng=rng,
                            nnz_per_col=48, steps=120)
    assert model.tree.device.type == "cuda" and model.tree.depth == 3
    xi, xv = (torch.from_numpy(a) for a in ds.x_test.to_ell(64))
    before = launches("grouped")
    s, l = model.predict(xi, xv, beam=16, topk=5, method="mscm_pallas_grouped")
    assert launches("grouped") == before + model.tree.depth
    s0, l0 = model.predict(xi, xv, beam=16, topk=5, method="mscm_dense")
    check_ranking(s, l, s0, l0, "trained tree, grouped vs mscm_dense")
    assert precision_at_k(l, ds.y_test, 1) > 0.25
    eng = XMRServingEngine(model.tree, ServeConfig(beam=16, topk=5, ell_width=64),
                           label_perm=model.structure.label_perm)
    assert eng.method == "mscm_pallas_grouped"
    s_e, l_e = eng.serve_batch(ds.x_test)
    check_ranking(s_e, l_e, s0, l0, "engine, method=auto")


@pytest.mark.cuda
def test_train_level_on_card_matches_cpu_and_ignores_tf32(cuda_device):
    """One level's five Adam steps on the card against the CPU's (sums in
    other orders: within 1e-5), and bitwise the same with TF32 allowed by
    the caller, since training forbids it locally."""
    from repro_torch.trees import train as ttrain

    ds, _ = _small_dataset()
    g = torch.Generator().manual_seed(3)
    xd = torch.from_numpy(ds.x_train.to_dense())
    y = (torch.rand(xd.shape[0], 64, generator=g) < 0.05).float()
    p = (torch.rand(xd.shape[0], 64, generator=g) < 0.5).float()
    want = ttrain._train_level(xd, y, p, steps=5)
    args = [a.to(cuda_device) for a in (xd, y, p)]
    got = ttrain._train_level(*args, steps=5)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        assert torch.equal(ttrain._train_level(*args, steps=5), got)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


def _serving_tree(seed=7, d=200, B=8):
    """``tests/test_serving.py``'s tree (levels 8, 64, 512) on the card."""
    rng = np.random.default_rng(seed)
    ws = [random_sparse_csc(d, L, 10, rng, sibling_groups=B) for L in (8, 64, 512)]
    return XMRTree.from_weight_matrices(ws, B), random_sparse_csr(45, d, 15, rng)


@pytest.mark.cuda
def test_microbatcher_on_card_bitwise_per_query(cuda_device):
    """The batcher's worker thread launches the grouped kernel on the
    card; its results are bitwise ``serve_online``'s on the card, and it
    launched depth x batches grouped kernels, nothing else."""
    from repro_torch.serving import BatchPolicy, MicroBatcher, Query, ServeConfig
    from repro_torch.serving import XMRServingEngine

    tree, queries = _serving_tree()
    eng = XMRServingEngine(tree, ServeConfig(ell_width=32, max_batch=64))
    assert eng.method == "mscm_pallas_grouped"
    ref_s, ref_l = eng.serve_online(queries)
    eng.warmup_buckets(tree.d, 16)  # what start() runs; counted apart from traffic
    mb = MicroBatcher(eng, BatchPolicy(max_batch=16, max_wait_ms=5.0), warmup_on_start=False)
    futs = [mb.submit(Query(*queries.row(i), qid=i)) for i in range(45)]
    before = (launches("grouped"), launches("fused"), launches("pregather"))
    try:
        mb.start()
        res = [f.result(timeout=60) for f in futs]
    finally:
        mb.stop()
    assert all(r.ok for r in res)
    np.testing.assert_array_equal(np.stack([r.scores for r in res]).view(np.uint32),
                                  ref_s.view(np.uint32))
    np.testing.assert_array_equal(np.stack([r.ids for r in res]), ref_l)
    after = (launches("grouped"), launches("fused"), launches("pregather"))
    assert [a - b for a, b in zip(after, before)] == [tree.depth * 3, 0, 0]


@pytest.mark.cuda
def test_device_ready_is_an_event_query(cuda_device):
    """A dispatch records a CUDA event behind its copies; ``_device_ready``
    queries it (True or False, never an exception); the results are read
    only after it, and equal the bucket's own results."""
    from concurrent.futures import Future

    from repro_torch.serving import BatchPolicy, MicroBatcher, ServeConfig, XMRServingEngine
    from repro_torch.serving.batcher import TRIGGER_SIZE, _device_ready, _Request

    tree, queries = _serving_tree()
    eng = XMRServingEngine(tree, ServeConfig(ell_width=32, max_batch=64))
    mb = MicroBatcher(eng, BatchPolicy(max_batch=16), warmup_on_start=False)
    reqs = [_Request(*queries.row(i), future=Future(), t_enqueue=0.0) for i in range(13)]
    torch.cuda._sleep(1 << 26)  # keep the stream busy past the dispatch
    inflight = mb._dispatch(reqs, TRIGGER_SIZE)
    assert isinstance(inflight.done, torch.cuda.Event)
    assert inflight.scores.device.type == "cpu" and inflight.scores.is_pinned()
    assert _device_ready(inflight) in (True, False)
    mb._finalize(inflight)
    assert _device_ready(inflight) is True
    s, l = eng.serve_batch(queries.slice_rows(np.arange(13)))
    np.testing.assert_array_equal(np.stack([r.future.result(0)[0] for r in reqs]), s)
    np.testing.assert_array_equal(np.stack([r.future.result(0)[1] for r in reqs]), l)
    mb.queue.close()


@pytest.mark.cuda
@pytest.mark.parametrize("tier,beam", [(0, 10), (1, 5), (2, 2)])
def test_tier_dispatch_on_card_bitwise_no_slo_engine(cuda_device, tier, beam):
    """Each tier of the auto ladder (beam 1 would narrow this tree's
    results to 8, so ``min_beam=2``) is bitwise a no-SLO engine at its
    beam, on the card."""
    from repro_torch.serving import ServeConfig, SLOConfig, XMRServingEngine

    tree, queries = _serving_tree()
    knobs = dict(topk=10, ell_width=32, max_batch=64)
    slo = XMRServingEngine(tree, ServeConfig(
        beam=10, slo=SLOConfig(target_p99_ms=50.0, min_beam=2), **knobs))
    assert [(t.beam, t.qt) for t in slo.tiers] == [(10, 8), (5, 8), (2, 8)]
    plain = XMRServingEngine(tree, ServeConfig(beam=beam, **knobs))
    xi, xv = slo.marshal_rows(queries, np.arange(45), 64)
    s_a, l_a = slo._run(xi, xv, tier=tier)
    s_b, l_b = plain._run(xi, xv)
    assert torch.equal(s_a.view(torch.int32), s_b.view(torch.int32))
    assert torch.equal(l_a, l_b)


@pytest.mark.cuda
def test_build_lock_two_threads_load_a_cleared_library(cuda_device, tmp_path, monkeypatch):
    """Two threads that first reach a kernel together run one ``nvcc`` and
    get one library; no temporary file is left behind."""
    import subprocess
    import threading

    from repro_torch.kernels import build

    calls = []
    real_popen = subprocess.Popen

    def popen(*args, **kwargs):
        calls.append(args[0])
        return real_popen(*args, **kwargs)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.delitem(build._LIBS, "mscm_grouped", raising=False)
    monkeypatch.setattr(build.subprocess, "Popen", popen)
    go = threading.Barrier(2, timeout=60)
    got, errors = [], []

    def load():
        try:
            go.wait()
            got.append(build.load_library("mscm_grouped"))
        except Exception as exc:  # noqa: BLE001 — reported by the assertion below
            errors.append(exc)

    threads = [threading.Thread(target=load) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not any(th.is_alive() for th in threads) and not errors
    assert len(got) == 2 and got[0] is got[1]
    assert len(calls) == 1
    assert [p.name for p in tmp_path.iterdir()] == [build._target("mscm_grouped")[1].name]


# ---------------------------------------------------------------------------
# the label-partitioned index and multi-device dispatch on the card
# ---------------------------------------------------------------------------

def _card_batch(queries, n=45, width=32):
    from repro_torch.sparse.csr import rows_to_ell

    xi, xv = rows_to_ell(queries, np.arange(n), width)
    return torch.from_numpy(xi).cuda(), torch.from_numpy(xv).cuda()


def _bitwise(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("sync", ["level", "pipelined"])
@pytest.mark.parametrize("n_partitions", [2, 4])
@pytest.mark.parametrize("tier", ["exact", "int8", "fp8"])
def test_partitioned_grouped_bitwise_on_card(cuda_device, tier, n_partitions, sync):
    """Every partition through ``mscm_grouped`` (exact) or ``mscm_grouped_q``
    (a ``quantize_index``ed index; the router head f32 through
    ``mscm_grouped``): bitwise the unpartitioned tree on the card, with 1
    router launch and one launch a partition a partitioned level. The
    quantized index is held against the unpartitioned tree with the f32
    head and, below it, the whole tree's codes dequantized: per-(chunk,
    column) scales make the cut's codes the whole tree's, and grouped_q is
    bitwise grouped on dequantized tiles."""
    from repro_torch.index import ScatterGatherPlanner, partition_tree
    from repro_torch.quant.storage import dequantize_tree, quantize_index

    tree, queries = _serving_tree()
    xi, xv = _card_batch(queries)
    idx = partition_tree(tree, n_partitions)
    method, whole = "mscm_pallas_grouped", tree
    if tier != "exact":
        method, idx = "mscm_pallas_grouped_q", quantize_index(idx, tier=tier)
        deq = dequantize_tree(quantize_tree(tree, tier=tier))
        whole = XMRTree(layers=tree.layers[:idx.level] + deq.layers[idx.level:],
                        n_cols=tree.n_cols, branching=tree.branching, d=tree.d)
    pl = ScatterGatherPlanner(idx, beam=10, topk=10, method=method, sync=sync)
    pl.infer(xi, xv)  # builds and loads the kernels
    before = (launches("grouped"), launches("grouped_q"))
    got = pl.infer(xi, xv)
    grouped, grouped_q = launches("grouped") - before[0], launches("grouped_q") - before[1]
    part_launches = (tree.depth - idx.level) * n_partitions
    assert (grouped, grouped_q) == ((1 + part_launches, 0) if tier == "exact"
                                    else (1, part_launches))
    _bitwise(got, whole.infer(xi, xv, beam=10, topk=10, method="mscm_pallas_grouped"))


@pytest.mark.cuda
@pytest.mark.parametrize("sync", ["level", "pipelined"])
@pytest.mark.parametrize("method", ["mscm_pallas", "mscm_pallas_pregather", "vanilla",
                                    "mscm_dense"])
def test_planner_block_methods_bitwise_on_card(cuda_device, method, sync):
    """The per-block kernels (and the plain methods) through the planner:
    bitwise the unpartitioned tree on the card, in both exact modes (on the
    card a score's bits do not depend on its position in the level)."""
    from repro_torch.index import ScatterGatherPlanner, partition_tree

    tree, queries = _serving_tree()
    xi, xv = _card_batch(queries)
    before = (launches("fused"), launches("pregather"))
    got = ScatterGatherPlanner(partition_tree(tree, 3), beam=10, topk=5, method=method,
                               sync=sync).infer(xi, xv)
    _bitwise(got, tree.infer(xi, xv, beam=10, topk=5, method=method))
    fused, pregather = launches("fused") - before[0], launches("pregather") - before[1]
    if method == "mscm_pallas":
        assert fused > 0 and pregather == 0
    elif method == "mscm_pallas_pregather":
        assert pregather > 0 and fused == 0


@pytest.mark.cuda
def test_per_slot_streams_on_one_card(cuda_device):
    """Four partitions on ``cuda:0`` named five times: each partition on a
    stream of its own, the coordinator on a fifth, none the default stream.
    The results, read on the caller's stream with no synchronisation but
    the copy's, are bitwise the unpartitioned tree's over many batches in
    every exact mode (with the cache too); ``final`` dominates."""
    from repro_torch.index import ScatterGatherPlanner, partition_tree, place

    tree, queries = _serving_tree()
    idx = partition_tree(tree, 4)
    pm = place(idx, devices=["cuda:0"] * 5)
    streams = [col[0].stream for col in pm.slots] + [pm.coordinator.stream]
    assert pm.n_model == 4 and len({s.cuda_stream for s in streams}) == 5
    assert torch.cuda.default_stream().cuda_stream not in {s.cuda_stream for s in streams}
    planners = [ScatterGatherPlanner(idx, beam=10, topk=10, method="mscm_pallas_grouped",
                                     sync=sync, placement=pm, cache_entries=cache)
                for sync, cache in (("level", 0), ("pipelined", 0), ("pipelined", 64))]
    for start in range(0, 40, 4):
        xi, xv = _card_batch(queries.slice_rows(np.arange(start, 45)), n=45 - start)
        want = tree.infer(xi, xv, beam=10, topk=10, method="mscm_pallas_grouped")
        want = (want[0].cpu(), want[1].cpu())
        for pl in planners:
            s, l = pl.infer(xi, xv)
            _bitwise((s.cpu(), l.cpu()), want)
    final = ScatterGatherPlanner(idx, beam=4, topk=10, method="mscm_pallas_grouped",
                                 sync="final", placement=pm)
    s, _ = final.infer(xi, xv)
    assert torch.all(s >= tree.infer(xi, xv, beam=4, topk=10, method="mscm_pallas_grouped")[0])


@pytest.mark.cuda
def test_sharded_engines_on_a_repeated_card(cuda_device):
    """``shards=2`` on ``cuda:0`` twice and ``partitions=2, shards=2`` on it
    four times (through the micro-batcher): bitwise one slot's serving on the
    card, the bucket's halves on streams of their own."""
    from repro_torch.serving import (BatchPolicy, MicroBatcher, PartitionConfig, Query,
                                     ServeConfig, XMRServingEngine)

    tree, queries = _serving_tree()
    knobs = dict(ell_width=32, max_batch=64)
    ref_s, ref_l = XMRServingEngine(tree, ServeConfig(**knobs)).serve_batch(queries)
    rep = XMRServingEngine(tree, ServeConfig(shards=2, **knobs), devices=["cuda:0"] * 2)
    assert rep.mesh.shape == {"data": 2}
    s, l = rep.serve_batch(queries)
    np.testing.assert_array_equal(s.view(np.uint32), ref_s.view(np.uint32))
    np.testing.assert_array_equal(l, ref_l)
    eng = XMRServingEngine(tree, ServeConfig(shards=2, partition=PartitionConfig(partitions=2),
                                             **knobs), devices=["cuda:0"] * 4)
    assert eng.mesh.shape == {"data": 2, "model": 2}
    mb = MicroBatcher(eng, BatchPolicy(max_batch=16, max_wait_ms=5.0))
    futs = [mb.submit(Query(*queries.row(i), qid=i)) for i in range(45)]
    try:
        mb.start()
        res = [f.result(timeout=60) for f in futs]
    finally:
        mb.stop()
    assert all(r.ok for r in res)
    np.testing.assert_array_equal(np.stack([r.scores for r in res]).view(np.uint32),
                                  ref_s.view(np.uint32))
    np.testing.assert_array_equal(np.stack([r.ids for r in res]), ref_l)
    summ = mb.metrics.summary()
    assert len(summ["partition_occupancy"]) == 2 and len(summ["replica_occupancy"]) == 2
    assert summ["pipeline_stall_avg_ms"] >= 0.0


@pytest.mark.cuda
def test_sharded_infer_on_card(cuda_device):
    """``sharded_infer`` over a 2x2 mesh of ``cuda:0`` slots against the
    tree's own ``mscm_dense`` traversal on the card."""
    from repro_torch.core.distributed import shard_leaf_level, sharded_infer
    from repro_torch.distributed.sharding import partition_mesh

    tree, queries = _serving_tree()
    xi, xv = _card_batch(queries, n=16)
    mesh = partition_mesh(2, 2, devices=["cuda:0"] * 4)
    upper, leaf = shard_leaf_level(tree, mesh)
    s, l = sharded_infer(tree, upper, leaf, xi, xv, mesh, beam=10, topk=5)
    want = tree.infer(xi, xv, beam=10, topk=5, method="mscm_dense")
    check_ranking(s.cpu().numpy(), l.cpu().numpy(), want[0].cpu().numpy(),
                  want[1].cpu().numpy())


@pytest.mark.cuda
def test_partitioned_and_sharded_across_cards(cuda_device):
    """Every visible card a slot (skips with fewer than two): the partitions
    on cards of their own and the coordinator on the first, so each hand-off
    is a copy between cards; the replicated engine over all cards; and
    ``sharded_infer`` over a mesh of cards. Bitwise one card's serving."""
    from repro_torch.core.distributed import shard_leaf_level, sharded_infer
    from repro_torch.distributed.sharding import partition_mesh
    from repro_torch.serving import (BatchPolicy, MicroBatcher, PartitionConfig, Query,
                                     ServeConfig, XMRServingEngine)

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more CUDA devices")
    tree, queries = _serving_tree()
    knobs = dict(ell_width=32, max_batch=64)
    ref_s, ref_l = XMRServingEngine(tree, ServeConfig(**knobs)).serve_batch(queries)

    def same(s, l, what):
        np.testing.assert_array_equal(l, ref_l, err_msg=what)
        np.testing.assert_array_equal(s.view(np.uint32), ref_s.view(np.uint32), err_msg=what)

    for sync in ("level", "pipelined"):
        eng = XMRServingEngine(tree, ServeConfig(
            partition=PartitionConfig(partitions=n_cards, partition_sync=sync), **knobs))
        assert eng.mesh.shape == {"data": 1, "model": n_cards}
        assert {p.device for p in eng.planner.parts} == {torch.device("cuda", i)
                                                        for i in range(n_cards)}
        same(*eng.serve_batch(queries), f"P={n_cards} {sync} across cards")
    final = XMRServingEngine(tree, ServeConfig(
        partition=PartitionConfig(partitions=n_cards, partition_sync="final"), **knobs))
    assert (final.serve_batch(queries)[0] >= ref_s).all()
    rep = XMRServingEngine(tree, ServeConfig(shards=n_cards, **knobs))
    assert rep.mesh.shape == {"data": n_cards}
    same(*rep.serve_batch(queries), f"shards={n_cards} across cards")
    online_s, online_l = XMRServingEngine(tree, ServeConfig(**knobs)).serve_online(queries,
                                                                                 limit=8)
    s, l = rep.serve_online(queries, limit=8)
    np.testing.assert_array_equal(s.view(np.uint32), online_s.view(np.uint32))
    np.testing.assert_array_equal(l, online_l)
    if n_cards >= 4:
        eng = XMRServingEngine(tree, ServeConfig(shards=2, partition=PartitionConfig(
            partitions=2, partition_sync="pipelined"), **knobs))
        assert eng.mesh.shape == {"data": 2, "model": 2}
        mb = MicroBatcher(eng, BatchPolicy(max_batch=16, max_wait_ms=5.0))
        futs = [mb.submit(Query(*queries.row(i), qid=i)) for i in range(45)]
        try:
            mb.start()
            res = [f.result(timeout=60) for f in futs]
        finally:
            mb.stop()
        same(np.stack([r.scores for r in res]), np.stack([r.ids for r in res]),
             "P=2 shards=2 across cards, through the batcher")
        mesh = partition_mesh(2, 2)
        upper, leaf = shard_leaf_level(tree, mesh)
        xi, xv = _card_batch(queries, n=16)
        s, l = sharded_infer(tree, upper, leaf, xi, xv, mesh, beam=10, topk=5)
        want = tree.infer(xi, xv, beam=10, topk=5, method="mscm_dense")
        check_ranking(s.cpu().numpy(), l.cpu().numpy(), want[0].cpu().numpy(),
                      want[1].cpu().numpy())


# ---------------------------------------------------------------------------
# the fleet: worker processes on the card
# ---------------------------------------------------------------------------

def _fleet_served(tree, queries, method="auto", tier="exact"):
    """``serve_batch`` through a P = 2 pipelined engine whose partitions two
    worker processes serve on ``cuda:0`` (``device=`` forwarded to each as
    ``--device``), and through the same engine in process."""
    from repro_torch.serving import PartitionConfig, QuantConfig, ServeConfig, XMRServingEngine
    from repro_torch.serving.fleet import PartitionFleet

    cfg = ServeConfig(method=method, ell_width=32, max_batch=64, quant=QuantConfig(tier=tier),
                      partition=PartitionConfig(partitions=2, partition_sync="pipelined"))
    local = XMRServingEngine(tree, cfg).serve_batch(queries)
    eng = XMRServingEngine(tree, cfg)
    with PartitionFleet.launch(2, device="cuda:0") as fleet:
        fleet.attach(eng)
        assert all(h.alive() for h in fleet.handles)
        got = eng.serve_batch(queries)
        assert eng.last_degraded() is None
    return got, local


def _same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["exact", "int8"])
def test_fleet_processes_on_card_bitwise(cuda_device, tier):
    """Worker processes on the card: the exact tier bitwise the in-process
    pipelined engine and the unpartitioned one; the int8 tier (grouped_q in
    the workers) bitwise the in-process int8 pipelined engine."""
    from repro_torch.serving import ServeConfig, XMRServingEngine

    tree, queries = _serving_tree()
    got, local = _fleet_served(tree, queries, tier=tier)
    _same(got, local)
    if tier == "exact":
        _same(got, XMRServingEngine(tree, ServeConfig(ell_width=32, max_batch=64))
              .serve_batch(queries))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["mscm_pallas", "mscm_pallas_pregather"])
def test_fleet_forced_block_method_through_workers(cuda_device, method):
    """A forced per-block method through worker processes on the card: each
    worker runs the per-block kernel on its partition; bitwise the
    in-process pipelined engine and the unpartitioned tree."""
    from repro_torch.serving import ServeConfig, XMRServingEngine

    tree, queries = _serving_tree()
    got, local = _fleet_served(tree, queries, method=method)
    _same(got, local)
    _same(got, XMRServingEngine(tree, ServeConfig(method=method, ell_width=32, max_batch=64))
          .serve_batch(queries))


# ---------------------------------------------------------------------------
# the LM scaffold's serving path and checkpoints on the card
# ---------------------------------------------------------------------------

# Card against CPU (chip_smoke.py's lm phase): f32 prefill logits within 1e-4
# (other summation orders; RWKV's chunked scan magnifies last-bit
# differences); decode reads the bf16 cache, where a last-bit difference
# before rounding can round either way: 5e-3. Both scaled by 1 + max|logit|.
LM_PREFILL_TOL, LM_DECODE_TOL = 1e-4, 5e-3


def _lm_arch_ids():
    from repro_torch.configs import ARCH_IDS

    return ARCH_IDS


@pytest.mark.cuda
@pytest.mark.parametrize("arch", _lm_arch_ids())
def test_reduced_lm_on_card_matches_cpu(cuda_device, arch):
    """Prefill and four greedy decode steps on the card against the same on
    the CPU, with the same parameters (the port's seeded init, copied to the
    card) and inputs."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.specs import make_demo_batch
    from repro_torch.models import lm

    cfg = reduced_config(get_config(arch))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = make_demo_batch(cfg, np.random.default_rng(0), 2, 12, device="cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(cuda_device)

    gp, gb = to_card(params), to_card(batch)
    cl, cc = lm.prefill(cfg, params, batch, max_len=20)
    gl, gc = lm.prefill(cfg, gp, gb, max_len=20)
    assert gl.device.type == "cuda" and all(v.device.type == "cuda" for v in gc.values())
    scale = 1 + float(cl.abs().max())
    assert float((gl.cpu() - cl).abs().max()) <= LM_PREFILL_TOL * scale
    pos = 12 + (batch["patch_embeds"].shape[1] if cfg.family == "vlm" else 0)
    tok = cl[:, -1].argmax(-1)
    for i in range(4):
        cl, cc = lm.decode_step(cfg, params, cc, tok, pos + i)
        gl, gc = lm.decode_step(cfg, gp, gc, tok.to(cuda_device), pos + i)
        assert torch.isfinite(gl).all()
        assert float((gl.cpu() - cl).abs().max()) <= LM_DECODE_TOL * (1 + float(cl.abs().max()))
        tok = cl.argmax(-1)
    fl, _ = lm.forward_train(cfg, gp, gb)
    cf, _ = lm.forward_train(cfg, params, batch)
    assert float((fl.cpu() - cf).abs().max()) <= LM_PREFILL_TOL * (1 + float(cf.abs().max()))


@pytest.mark.cuda
def test_vocab_tree_head_on_card(cuda_device):
    """Beam = C gives the dense argmax on the card; the beams' token ids
    equal the CPU's."""
    from repro_torch.models.xmr_head import VocabTreeHead, greedy_token

    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 1000, generator=g) / 8
    h = torch.randn(16, 64, generator=g)
    cpu = VocabTreeHead.from_lm_head(w, 16)
    card = VocabTreeHead.from_lm_head(w.to(cuda_device), 16)
    hc = h.to(cuda_device)
    assert torch.equal(greedy_token(card, hc, beam=card.n_clusters).cpu(), (h @ w).argmax(1))
    for beam in (1, 4, 16):
        assert torch.equal(card.decode_logits(hc, beam=beam)[1].cpu(),
                           cpu.decode_logits(h, beam=beam)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("async_write", [False, True])
def test_checkpoint_round_trip_onto_card(cuda_device, tmp_path, async_write):
    """Leaves of every dtype, a quantized layer and a reduced LM's params
    saved from the card and restored onto it bitwise; restored onto the CPU
    with ``device="cpu"``; a CPU-written checkpoint restored onto the card."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.ckpt import _leaves_with_path
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm
    from repro_torch.quant.storage import QuantLayerArrays

    g = torch.Generator(cuda_device).manual_seed(1)
    q = QuantLayerArrays(
        chunk_rows=torch.randint(0, 50, (3, 4), device=cuda_device, dtype=torch.int32),
        chunk_vals=torch.randn(3, 4, 8, generator=g, device=cuda_device).to(torch.float8_e4m3fn),
        chunk_scales=torch.rand(3, 8, generator=g, device=cuda_device))
    state = {
        "misc": {"bf16": torch.randn(5, 7, generator=g, device=cuda_device).to(torch.bfloat16),
                 "i8": torch.randint(-127, 128, (9,), device=cuda_device, dtype=torch.int8),
                 "layers": [q]},
        "lm": lm.init_params(reduced_config(get_config("hymba-1.5b")), g, device=cuda_device),
    }
    ck = Checkpointer(str(tmp_path / "card"), async_write=async_write)
    ck.save(3, state)
    _, out = ck.restore(state)
    _, host = ck.restore(state, device="cpu")
    for name in state:
        want = list(_leaves_with_path(state[name]))
        got = dict(_leaves_with_path(out[name]))
        on_host = dict(_leaves_with_path(host[name]))
        for key, a in want:
            assert got[key].device == a.device and on_host[key].device.type == "cpu"
            width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
            assert torch.equal(got[key].view(width), a.view(width)), key
            assert torch.equal(on_host[key].view(width), a.cpu().view(width)), key
    cpu_state = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    ck2 = Checkpointer(str(tmp_path / "host"), async_write=False)
    ck2.save(1, {"p": cpu_state})
    _, back = ck2.restore({"p": {"w": torch.zeros(4, 4, dtype=torch.bfloat16,
                                                  device=cuda_device)}})
    assert back["p"]["w"].device.type == "cuda"
    assert torch.equal(back["p"]["w"].cpu(), cpu_state["w"])


# The LM trainer on the card against the CPU (chip_smoke.py's lm_train
# phase): one make_train_step step from the same parameters and batch. The
# loss within 1e-5; each gradient leaf within 1e-5 of its max |grad| (the
# CPU tests' bound against jax.grad), RWKV's within 1e-3 (its chunked scan
# is ill-conditioned in f32: chip_smoke.py logs each device's distance
# from an f64 run, of the same size as their gap); the card's update on the
# CPU's gradients within 1e-7 + 1e-6 |p| of the CPU's parameters.
LM_TRAIN_LOSS, LM_GRAD_REL, LM_SSM_GRAD_REL = 1e-5, 1e-5, 1e-3
LM_PARAM_ATOL, LM_PARAM_RTOL = 1e-7, 1e-6


def _train_step(cfg, params, nb, device, lr=1e-2, grads_from=None):
    """(loss, grads, new params as numpy, grads as tensors) of one step on
    ``device``; with ``grads_from``, the update takes those gradients."""
    from repro_torch.checkpoint.ckpt import _leaves_with_path
    from repro_torch.launch.train import init_opt_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import Optimizer, get_optimizer

    def flat(tree):
        return {k: v.detach().float().cpu().numpy() for k, v in _leaves_with_path(tree)}

    inner, seen = get_optimizer(cfg.optimizer), {}

    def update(grads, state, prm, lr_):
        seen["grads"], seen["tree"] = flat(grads), grads
        if grads_from is not None:
            grads = lm._map(lambda g: g.to(device), grads_from)
        return inner.update(grads, state, prm, lr_)

    step = make_train_step(cfg, Optimizer(inner.init, update, inner.name), peak_lr=lr,
                           warmup=0, total_steps=10)
    prm = lm._map(lambda a: a.to(device, copy=True), params)
    new, state, metrics = step(prm, init_opt_state(inner, prm),
                               {k: torch.from_numpy(v).to(device) for k, v in nb.items()})
    assert all(v.device.type == torch.device(device).type
               for v in (new["embed"], state["inner"]["step"], metrics["loss"]))
    return float(metrics["loss"]), seen["grads"], flat(new), seen["tree"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", _lm_arch_ids())
def test_train_step_on_card_matches_cpu(cuda_device, arch):
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import batch_at_step
    from repro_torch.models import lm

    cfg = dataclasses.replace(reduced_config(get_config(arch)), remat=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    nb = batch_at_step(cfg, seed=0, step=0, host=0, n_hosts=1, batch=2, seq=12)
    l_c, g_c, p_c, tree = _train_step(cfg, params, nb, "cpu")
    l_g, g_g, p_g, _ = _train_step(cfg, params, nb, cuda_device, grads_from=tree)
    assert abs(l_g - l_c) <= LM_TRAIN_LOSS * abs(l_c)
    rel = LM_SSM_GRAD_REL if cfg.family == "ssm" else LM_GRAD_REL
    for k, g in g_c.items():
        assert float(np.abs(g_g[k] - g).max()) <= rel * max(float(np.abs(g).max()), 1e-30), k
        assert np.all(np.abs(p_g[k] - p_c[k]) <= LM_PARAM_ATOL + LM_PARAM_RTOL * np.abs(p_c[k])), k


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-235b-a22b"])
def test_remat_gradients_on_card(cuda_device, arch):
    """Every remat policy gives the gradients of no remat on the card, within
    1e-5 of each leaf's max |grad| (a policy only changes what is computed
    again in backward; the card need not repeat a sum in the same order)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import batch_at_step
    from repro_torch.models import lm

    nb = batch_at_step(reduced_config(get_config(arch)), seed=0, step=0, host=0, n_hosts=1,
                       batch=2, seq=12)
    base = lm.init_params(reduced_config(get_config(arch)), torch.Generator().manual_seed(0),
                          device="cpu")
    grads = {}
    for policy in ("none", "full", "dots", "moe"):
        cfg = dataclasses.replace(reduced_config(get_config(arch)), remat=True,
                                  remat_policy=policy)
        _, grads[policy], _, _ = _train_step(cfg, base, nb, cuda_device)
    for policy in ("full", "dots", "moe"):
        for k, g in grads["none"].items():
            scale = max(float(np.abs(g).max()), 1e-30)
            assert float(np.abs(grads[policy][k] - g).max()) <= LM_GRAD_REL * scale, (policy, k)


@pytest.mark.cuda
def test_train_loop_on_card_by_default(cuda_device, tmp_path):
    """``train_loop`` with no device trains on the card, checkpoints, and a
    second run resumes where the first ended."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.train import train_loop

    cfg = reduced_config(get_config("yi-6b"))
    kw = dict(batch=2, seq=8, ckpt_dir=str(tmp_path / "ck"), save_every=3, compress_grads=True)
    first = train_loop(cfg, steps=6, inject_failure_at=4, **kw)
    assert first["final_params"]["embed"].device.type == "cuda"
    assert first["steps_run"] == 6 and np.all(np.isfinite(first["losses"]))
    second = train_loop(cfg, steps=9, **kw)
    assert second["steps_run"] == 3 and Checkpointer(kw["ckpt_dir"]).list_steps()[-1] == 9


# -- the launch tools and the last examples ----------------------------------

def _enterprise_small(batch=8, seed=5):
    """A small enterprise geometry (d = 300, tree [4, 4, 8]) and its step's
    global arguments, drawn from a numpy seed: int32 rows skewed toward
    the low feature ids, bf16 values (rounded from f32), queries of 16
    nonzeros."""
    from repro_torch.launch import serve_dryrun as sd

    geom = sd.Geometry(d_feat=300, branching=(4, 4, 8), level_nnz=8, ell_r=32, query_nnz=16)
    rng = np.random.default_rng(seed)
    args = [torch.from_numpy((geom.d_feat * rng.random((batch, geom.query_nnz)) ** 2)
                             .astype(np.int32)),
            torch.from_numpy(rng.random((batch, geom.query_nnz), dtype=np.float32))]
    for c, r, b in geom.level_shapes():
        args.append(torch.from_numpy(((geom.d_feat + 1) * rng.random((c, r)) ** 2)
                                     .astype(np.int32)))
        args.append(torch.from_numpy(rng.standard_normal((c, r, b), dtype=np.float32))
                    .to(torch.bfloat16))
    return geom, args


@pytest.mark.cuda
def test_enterprise_step_small_on_card_matches_cpu(cuda_device):
    """The enterprise serving step at a small geometry over a (2, 2) mesh of
    ``cuda:0`` slots (a stream each) against the same step over four CPU
    slots: scores within 1e-7 + 1e-6 |s|, labels equal outside near-ties;
    the candidate hand-offs logged as sends, the same on both."""
    from repro_torch.distributed.sharding import record_sends
    from repro_torch.launch import serve_dryrun as sd
    from repro_torch.launch.mesh import make_host_mesh

    geom, args = _enterprise_small()
    got = {}
    for dev in ("cpu", "cuda:0"):
        mesh = make_host_mesh(2, 2, devices=[dev] * 4)
        fn, specs, _ = sd.serve_step_spec(8, 3, 5, mesh, geom)
        assert [tuple(a.shape) for a in args] == [tuple(s.shape) for s in specs]
        with record_sends() as log:
            blocks = fn(*[a.to(dev) for a in args])
        s, i = sd.collect(blocks, dev)
        got[dev] = (s.cpu().numpy(), i.cpu().numpy(), [b for _, _, b in log])
    assert got["cpu"][2] == got["cuda:0"][2] == [2 * 4 * 5 * 4] * 2
    check_ranking(got["cuda:0"][0], got["cuda:0"][1], got["cpu"][0], got["cpu"][1],
                  "enterprise step, card vs CPU", rtol=1e-6, atol=1e-7)


def _profiled_copy_stats(copy):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.hlo_stats import collective_stats, trace_events

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        copy()
        torch.cuda.synchronize()
    return collective_stats(trace_events(prof))


@pytest.mark.cuda
def test_collective_stats_reads_a_device_copy(cuda_device):
    """A device-to-device copy of 4 MiB on one card, profiled: the trace's
    ``Memcpy DtoD`` counted once as ``device-copy`` with its bytes."""
    x = torch.rand(1 << 20, device=cuda_device)
    y = torch.empty_like(x)
    st = _profiled_copy_stats(lambda: y.copy_(x))
    assert st["device-copy"]["count"] == 1
    assert st["device-copy"]["operand_bytes"] == st["device-copy"]["result_bytes"] == 4 << 20
    assert st["TOTAL"]["count"] == 1


@pytest.mark.cuda
def test_collective_stats_reads_a_peer_copy(cuda_device):
    """A 4 MiB copy from card 0 to card 1, profiled: ``Memcpy PtoP`` counted
    as ``peer-copy`` with its bytes (skips with one card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    x = torch.rand(1 << 20, device="cuda:0")
    st = _profiled_copy_stats(lambda: x.to("cuda:1"))
    assert st["peer-copy"]["count"] == 1
    assert st["peer-copy"]["operand_bytes"] == 4 << 20


def _example(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_serve_search_example_on_card(cuda_device):
    """``examples/serve_search_torch.py`` on the card: the partitioned
    engine behind the micro-batcher and the in-process HTTP gateway, each
    bitwise the unpartitioned engine (the gateway's clients post one query
    at a time: against ``serve_online``)."""
    from repro_torch.data.build import build_benchmark_tree
    from repro_torch.data.xmr_data import XMRShape, benchmark_queries
    from repro_torch.serving import ServeConfig, XMRServingEngine

    ex = _example("serve_search_torch")
    shape = XMRShape("tiny", 2000, 8 ** 3, 100, 20, 8)
    rng = np.random.default_rng(0)
    tree = build_benchmark_tree(shape, 8, rng, device="cuda")
    queries = benchmark_queries(shape, 24, rng)
    args = ex.parse_args(["--partitions", "2", "--queries", "24"])
    s, l, ref_s, ref_l = ex.serve_partitioned(tree, queries, shape, args)
    np.testing.assert_array_equal(s.view(np.uint32), ref_s.view(np.uint32))
    np.testing.assert_array_equal(l, ref_l)
    gs, gl = ex.serve_gateway(tree, queries, ex.parse_args(["--gateway", "0", "--queries", "24"]))
    os_, ol = XMRServingEngine(tree, ServeConfig(beam=10, topk=10, max_batch=64)
                               ).serve_online(queries)
    np.testing.assert_array_equal(gs.view(np.uint32), os_.view(np.uint32))
    np.testing.assert_array_equal(gl, ol)


@pytest.mark.cuda
def test_lm_tree_head_example_on_card(cuda_device):
    """``examples/lm_tree_head_torch.py``'s evaluation on the card: full-beam
    exactness 1.0, and at beams 4, 16 and 64 the tokens the CPU gives on the
    same head and hidden states."""
    ex = _example("lm_tree_head_torch")
    g = torch.Generator().manual_seed(3)
    head = ex.structured_head(g, 128, 8192, 64)
    hidden = torch.randn((16, 128), generator=g)
    cpu = ex.evaluate(head, hidden, 64)
    card = ex.evaluate(head.to(cuda_device), hidden.to(cuda_device), 64)
    assert card["exact"] == cpu["exact"] == 1.0
    for beam in ex.BEAMS:
        torch.testing.assert_close(card[beam][0].cpu(), cpu[beam][0], rtol=0, atol=0)


# -- the LM as one program over a mesh (chip_smoke.py phase 18) ---------------

def _spmd_world(n: int, tmp_path, cases: str | None = None) -> str:
    """``chip_smoke.py``'s phase 18 check (reduced configs' sharded train
    step, prefill and decode against the plain port, ``SPMD_TOL``) in ``n``
    processes, one card each, on a (1, 1) or (2, n/2) NCCL mesh, for the
    ``SPMD_CASES`` indices ``cases`` (default: ``SPMD_CARD_CASES``); rank
    0's summary, a line a case."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    extra = [] if cases is None else ["--spmd-cases", cases]
    procs = [subprocess.Popen([sys.executable, str(root / "chip_smoke.py"), "--spmd-rank",
                               str(r), "--spmd-world", str(n), "--spmd-dir", str(tmp_path)]
                              + extra, cwd=root, env=env) for r in range(n)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [0] * n, codes
    summary = (tmp_path / "summary.txt").read_text()
    print(f"{n} rank(s): {summary}")
    return summary


@pytest.mark.cuda
def test_spmd_world_of_one_matches_plain(cuda_device, tmp_path):
    assert "no gradient off its parameter's placements" in _spmd_world(1, tmp_path)


#: ``chip_smoke.SPMD_CASES`` past the first (yi-6b): MLA with the expanded and
#: the absorbed decode, qwen3-moe at capacity_factor 1.0 with global and with
#: grouped dispatch, grok with 3 experts, rwkv6-7b with 4 and 3 heads, hymba
#: at 4 layers with 4 and 3 heads, seamless (2 + 2 layers) with a vocab of 256
#: and of 255, llava with 2 and 1 kv heads.
SPMD_FAMILY_CASES = {"minicpm3": 1, "minicpm3-absorb": 2, "qwen3-moe-global": 3,
                     "qwen3-moe-grouped": 4, "grok-e3": 5, "rwkv6": 6, "rwkv6-h3": 7,
                     "hymba": 8, "hymba-h3": 9, "seamless": 10, "seamless-v255": 11,
                     "llava": 12, "llava-kv1": 13}


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPMD_FAMILY_CASES)
def test_spmd_world_of_one_matches_plain_families(cuda_device, tmp_path, case):
    """Phase 18 (a) for the MLA, MoE, SSM, hybrid, enc-dec and VLM families
    on a world-1 NCCL mesh: each reduced config's sharded step, prefill and
    decode against the plain port on the card (``SPMD_TOL``)."""
    summary = _spmd_world(1, tmp_path, str(SPMD_FAMILY_CASES[case]))
    assert "no gradient off its parameter's placements" in summary


@pytest.mark.cuda
def test_spmd_two_cards_match_plain(cuda_device, tmp_path):
    """(c): reduced yi-6b, minicpm3, qwen3-moe, rwkv6-7b (4 and 3 heads),
    hymba (4 and 3 heads), seamless and llava (1 kv head) on a (2, n/2)
    NCCL mesh."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 or more cards (NCCL puts no two ranks on one card)")
    lines = _spmd_world(2 * (n // 2), tmp_path).splitlines()
    assert [ln.split(":")[0].split(",")[0] for ln in lines] == [
        "yi-6b", "minicpm3-4b", "qwen3-moe-235b-a22b", "rwkv6-7b", "rwkv6-7b", "hymba-1.5b",
        "hymba-1.5b", "seamless-m4t-large-v2", "llava-next-mistral-7b"]
    assert all("greedy tokens decided" in ln for ln in lines)
