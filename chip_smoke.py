#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   require CUDA; print the card's name and power limit; turn TF32
            off so every f32 matrix product on the card is true f32;
2. build    compile every kernel of the path from ``src/repro_torch/kernels/csrc``;
3. kernels  hold each kernel against its plain PyTorch version on the card,
            at the main path's shapes and at edge shapes, in every epilogue
            mode; time kernel, plain version and library call with CUDA events;
4. small    exact beam search on a small tree, on the card, against a numpy
            brute-force scorer;
5. path     build the ``search-1m`` model (seed 0, random weights at the real
            sparsity) on the card and serve 256 queries through
            ``XMRServingEngine.serve_batch`` with ``method="auto"``; check that
            it resolved to the grouped kernel and launched it depth x batches
            times, and that it agrees with the ``mscm_dense`` oracle on the card.

The line before last is a JSON object with one entry per kernel; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
# Scores: the tolerance the reference's tests use across methods.
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
# Kernel vs plain version: R-term f32 sums taken in different orders. With
# inputs in [0, 1) x N(0, 1) the terms' magnitudes add up to ~200 at
# R = 496, so reordering moves a sum by up to ~1e-4.
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


def check_ranking(s, l, s_ref, l_ref, what: str) -> int:
    """Scores within the stated tolerance; labels equal wherever the
    reference's score gap to both neighbours exceeds it. Returns the number
    of label positions that differ (all within near-ties)."""
    if s.shape != s_ref.shape or l.shape != l_ref.shape:
        raise AssertionError(f"{what}: shapes {s.shape} vs {s_ref.shape}")
    if not (np.isfinite(s).all() and np.isfinite(s_ref).all()):
        raise AssertionError(f"{what}: non-finite scores")
    np.testing.assert_allclose(s, s_ref, rtol=SCORE_RTOL, atol=SCORE_ATOL, err_msg=what)
    tol = SCORE_ATOL + SCORE_RTOL * np.abs(s_ref)
    gap = np.abs(np.diff(s_ref, axis=1))
    inf = np.full((s_ref.shape[0], 1), np.inf)
    decided = (np.concatenate([inf, gap], 1) > tol) & (np.concatenate([gap, inf], 1) > tol)
    differ = l != l_ref
    if (differ & decided).any():
        raise AssertionError(f"{what}: labels differ where the score gap exceeds the tolerance")
    return int(differ.sum())


def kernel_check(torch, mk, build):
    """Phase 3: the grouped kernel against its plain version, then timings
    at the main path's shapes."""
    g = torch.Generator().manual_seed(0)

    def inputs(t, qt, r, b, c, runs):
        xg = torch.rand(t, qt, r, generator=g)
        vals = torch.randn(c, r, b, generator=g)
        base = torch.randint(0, c, (t - runs,), generator=g)
        tc = torch.sort(torch.cat([base, base[:runs]])).values  # some chunks repeat
        ps = torch.rand(t, qt, generator=g) + 1e-3
        return [x.cuda() for x in (xg, vals, tc, ps)]

    shapes = [  # (T, QT, R, B, C, repeated chunks)
        (640, 8, 496, 32, 32768, 160),   # main path, leaf level
        (1, 4, 8, 6, 3, 0),              # edge: B = 6 (ragged tree test)
        (1, 4, 8, 8, 3, 0),              # edge: B = 8
        (3, 16, 100, 70, 4, 1),          # QT*B > one pass of outputs, ragged slab
    ]
    max_err = 0.0
    for t, qt, r, b, c, runs in shapes:
        xg, vals, tc, ps = inputs(t, qt, r, b, c, runs)
        for mode in ("none", "prod", "logsum"):
            p = None if mode == "none" else ps
            got = mk.mscm_grouped(xg, vals, tc, p, mode=mode)
            want = mk.mscm_grouped_plain(xg, vals, tc, p, mode=mode)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(((got - want).abs() <= KERNEL_ATOL + KERNEL_RTOL * want.abs()).all())
            log(f"  mscm_grouped T={t} QT={qt} R={r} B={b} mode={mode}: "
                f"max|kernel-plain| = {err:.3e} (tolerance {KERNEL_ATOL:g} + "
                f"{KERNEL_RTOL:g}*|plain|) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"mscm_grouped disagrees with its plain version ({mode})")
            max_err = max(max_err, err)

    # Timings at the main path's shapes, in the path's epilogue mode.
    t, qt, r, b, c, runs = shapes[0]
    xg, vals, tc, ps = inputs(t, qt, r, b, c, runs)
    out = torch.empty(t, qt, b, device="cuda")
    lib = build.load_library("mscm_grouped")
    stream = torch.cuda.current_stream().cuda_stream
    args = (xg.data_ptr(), vals.data_ptr(), tc.data_ptr(), ps.data_ptr(), out.data_ptr(),
            t, qt, r, b, c, mk.MODES["prod"], stream)

    def kernel():  # the bare launch, so host-side checks do not pace it
        err = lib.mscm_grouped_launch(*args)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    vals_g = vals[tc]
    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: mk.mscm_grouped_plain(xg, vals, tc, ps, mode="prod"))
    library_ms = time_ms(lambda: torch.bmm(xg, vals_g))
    n_chunks = int(torch.unique(tc).numel())
    nbytes = 4 * (t * qt * r + n_chunks * r * b + t * qt + t * qt * b) + 8 * t
    flops = 2 * t * qt * r * b
    bytes_ms, flops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS
    bound_ms = max(bytes_ms, flops_ms)
    log(f"  timing T={t} QT={qt} R={r} B={b} ({n_chunks} distinct chunks, "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP): kernel {ms:.5f} ms, "
        f"plain {plain_ms:.5f} ms, torch.bmm on pre-gathered tiles {library_ms:.5f} ms, "
        f"bound {bound_ms:.5f} ms (bytes {bytes_ms:.5f}, f32 ops {flops_ms:.5f})")
    return {
        "name": "mscm_grouped",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mscm_grouped.cu",
        "replaces": "src/repro/kernels/mscm_kernel.py:187",
        "max_abs_err": max_err,
        "max_err": max_err,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": library_ms,
    }


def small_check(torch):
    """Phase 4: exact search (beam = L) on a small tree against brute force."""
    from repro_torch.core.tree import XMRTree
    from repro_torch.sparse.csr import random_sparse_csc, random_sparse_csr

    rng = np.random.default_rng(1234)
    d, B = 150, 8
    ws = [random_sparse_csc(d, L, 10, rng, sibling_groups=B) for L in (8, 64, 512)]
    tree = XMRTree.from_weight_matrices(ws, B)  # on the GPU by default
    x = random_sparse_csr(12, d, 18, rng)
    xi, xv = x.to_ell()
    prev = np.ones((12, 1))
    for w in ws:
        act = 1.0 / (1.0 + np.exp(-(x.to_dense().astype(np.float64) @ w.to_dense())))
        prev = np.repeat(prev, act.shape[1] // prev.shape[1], axis=1) * act
    want_l = np.argsort(-prev, axis=1, kind="stable")[:, :5]
    want_s = np.take_along_axis(prev, want_l, axis=1)
    for method in ("mscm_pallas_grouped", "mscm_dense"):
        s, l = tree.infer(torch.from_numpy(xi), torch.from_numpy(xv), beam=512, topk=5,
                          method=method, qt=4)
        n_diff = check_ranking(s.cpu().numpy(), l.cpu().numpy(), want_s, want_l,
                               f"small tree, {method}")
        log(f"  small tree (d={d}, B={B}, 3 levels, exact search) {method}: "
            f"agrees with the brute-force scorer ({n_diff} near-tie label swaps)")


def level_counts(torch, eng, queries, bucket: int) -> None:
    """Counts, per level of the first batch, of what the grouped kernel is
    given: blocks, the static tile count, tiles holding a block, and the
    distinct chunks they read (the kernel's real byte count)."""
    from repro_torch.core.beam import beam_select
    from repro_torch.core.mscm import mscm_dense_lookup, scatter_dense
    from repro_torch.core.tree import level_combined
    from repro_torch.kernels.ops import group_blocks_device

    tree, c = eng.tree, eng.config
    xi, xv = eng.marshal_rows(queries, np.arange(bucket), bucket)
    x_dense = scatter_dense(xi, xv, tree.d)
    ids = torch.zeros((bucket, 1), dtype=torch.int64, device=xi.device)
    scores = torch.ones((bucket, 1), device=xi.device)
    for li, layer in enumerate(tree.layers):
        n_chunks, r, b = layer.chunk_vals.shape
        _, tile_src, _, _ = group_blocks_device(ids.reshape(-1), c.qt, n_chunks)
        real = int((tile_src[:, 0] >= 0).sum())
        distinct = int(torch.unique(ids).numel())
        need = 4 * (real * c.qt * r + distinct * r * b)
        block_q = torch.arange(bucket, device=ids.device).repeat_interleave(ids.shape[1])
        logits = mscm_dense_lookup(x_dense, layer.chunk_rows, layer.chunk_vals,
                                   block_q, ids.reshape(-1))
        log(f"  level {li}: {ids.numel()} blocks, {tile_src.shape[0]} tiles launched, "
            f"{real} holding blocks, {distinct} distinct chunks of {n_chunks} "
            f"({need / 1e6:.2f} MB of xg and chunk tiles needed); "
            f"{100 * float((logits != 0).float().mean()):.2f}% of logits nonzero")
        combined = level_combined(layer, tree.branching[li], tree.d, x_dense, ids, scores,
                                  method=eng.method, score_mode=c.score_mode, qt=c.qt)
        last = li == tree.depth - 1
        ids, scores = beam_select(ids, combined, tree.n_cols[li],
                                  min(c.topk if last else c.beam, tree.n_cols[li]))
        ids, order = torch.sort(ids, dim=1)
        scores = scores.gather(1, order)


def path(torch, mk, gpu: str):
    """Phase 5: the main path at the search-1m geometry."""
    from repro_torch.data.build import build_benchmark_tree
    from repro_torch.data.xmr_data import XMRShape, benchmark_queries
    from repro_torch.serving import ServeConfig, XMRServingEngine

    # The README's enterprise serving model (examples/serve_search.py).
    shape = XMRShape("search-1m", 4_000_000, 32**4, 10_000, 150, 64)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    tree = build_benchmark_tree(shape, 32, rng)
    torch.cuda.synchronize()
    log(f"  built {shape.name}: d={shape.d:,} L={shape.L:,} B={tree.branching[0]} depth {tree.depth}, "
        f"R={tree.layers[-1].chunk_vals.shape[1]}, "
        f"{tree.memory_bytes() / 1e9:.3f} GB chunk tiles, in {time.perf_counter() - t0:.1f} s (host)")
    queries = benchmark_queries(shape, 256, rng)
    cfg = dict(beam=10, topk=10, ell_width=256, max_batch=64)
    eng = XMRServingEngine(tree, ServeConfig(method="auto", **cfg))
    if eng.method != "mscm_pallas_grouped":
        raise AssertionError(f"method='auto' resolved to {eng.method!r} on the GPU")
    eng.warmup(shape.d, batch_sizes=(64,))
    torch.cuda.reset_peak_memory_stats()

    mk.GROUPED_LAUNCHES = 0
    t0 = time.perf_counter()
    s, l = eng.serve_batch(queries)
    wall = time.perf_counter() - t0
    launches = mk.GROUPED_LAUNCHES
    n_batches = -(-queries.shape[0] // cfg["max_batch"])
    if launches != tree.depth * n_batches:
        raise AssertionError(f"{launches} grouped launches, want {tree.depth * n_batches}")
    peak = torch.cuda.max_memory_allocated()
    walls = [wall]
    for _ in range(3):
        t0 = time.perf_counter()
        eng.serve_batch(queries)
        walls.append(time.perf_counter() - t0)
    n = queries.shape[0]
    med = float(np.median(walls))
    log(f"  serve_batch {n} queries (method=auto -> {eng.method}, {n_batches} batches of "
        f"{cfg['max_batch']}): {launches} grouped launches; wall s per call "
        f"{[round(w, 6) for w in walls]}; median {1e3 * med / n:.5f} ms/query amortized, "
        f"{n / med:.1f} QPS, peak device memory {peak / 1e9:.3f} GB  [{gpu}]")
    if s.shape != (n, 10) or not np.isfinite(s).all():
        raise AssertionError(f"bad scores: shape {s.shape}")

    dense = XMRServingEngine(tree, ServeConfig(method="mscm_dense", **cfg))
    s_d, l_d = dense.serve_batch(queries)
    t0 = time.perf_counter()
    dense.serve_batch(queries)
    wall_d = time.perf_counter() - t0
    n_diff = check_ranking(s, l, s_d, l_d, "search-1m grouped vs mscm_dense")
    log(f"  agrees with mscm_dense on the card: max|score diff| "
        f"{float(np.abs(s - s_d).max()):.3e}, {n_diff} near-tie label swaps of {l.size}; "
        f"mscm_dense {1e3 * wall_d / n:.5f} ms/query amortized  [{gpu}]")

    level_counts(torch, eng, queries, cfg["max_batch"])

    # The dense lookup table the path scatters every batch: [64, d+1] f32.
    from repro_torch.core.mscm import scatter_dense

    xi, xv = eng.marshal_rows(queries, np.arange(cfg["max_batch"]), cfg["max_batch"])
    table_bytes = cfg["max_batch"] * (shape.d + 1) * 4
    scatter_ms = time_ms(lambda: scatter_dense(xi, xv, shape.d), reps=10, inner=4)
    log(f"  scatter_dense of one {cfg['max_batch']}-query batch: {scatter_ms:.5f} ms for a "
        f"{table_bytes / 1e9:.3f} GB table (write bound {1e3 * table_bytes / HBM_BYTES_PER_S:.5f} ms)"
        f"  [{gpu}]")

    # Where the time goes: device time by kernel over one serve_batch.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve_batch(queries)
        wall_p = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed on their own
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    if total_us:
        log(f"  profile of one serve_batch (profiler on): wall {1e3 * wall_p:.3f} ms, "
            f"{sum(r[1] for r in rows)} device activities, device busy {total_us / 1e3:.3f} ms "
            f"= {100 * total_us / (1e6 * wall_p):.1f}% of wall  [{gpu}]")
        for dev_us, count, key in rows[:14]:
            log(f"    {dev_us / 1e3:9.4f} ms {100 * dev_us / total_us:5.1f}%  x{count:<4d} {key[:90]}")
    else:
        log("  profile: no device time recorded (device breakdown not measured)")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import mscm_kernel as mk

    t_all = time.perf_counter()
    gpu = gpu_line()
    log("phase device")
    log(gpu)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  {torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for matmul and cuDNN (true f32 oracle)")

    log("phase build")
    t0 = time.perf_counter()
    build.build_libraries(list(build.SIGNATURES))
    for name in build.SIGNATURES:
        build.load_library(name)
        report = [ln.strip() for ln in build.BUILD_LOGS.get(name, "").splitlines()
                  if "registers" in ln or "spill" in ln]
        log(f"  {name}: {'; '.join(report) or 'already built'}")
    log(f"  built in {time.perf_counter() - t0:.2f} s")

    log("phase kernels")
    entry = kernel_check(torch, mk, build)
    log("phase small")
    small_check(torch)
    log("phase path")
    entry["launches"] = path(torch, mk, gpu)
    log(f"done in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
