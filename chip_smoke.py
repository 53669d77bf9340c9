#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

Run from the root of a checkout, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3

Phases, in order; any failure raises and the script exits non-zero:

1. device   require CUDA; print the card's name and power limit; turn TF32
            off so every f32 matrix product on the card is true f32;
2. build    compile every kernel from ``src/repro_torch/kernels/csrc``, one
            ``nvcc`` per source, all started together;
3. kernels  hold each kernel (grouped, fused, pregather, and grouped_q in
            int8 and fp8) against its plain PyTorch version on the card, at
            the paths' shapes, at edge shapes and at shapes past the plans'
            old caps (grouped at QT = 32, 24 and at QT = 16, B = 1024;
            fused and pregather at B = 2048), the grouped ones with and
            without padding tiles (the last live tile's second half
            padding), grouped_q bitwise against grouped on the dequantized
            tiles, every kernel bitwise against a second launch; print the
            launch plans and ptxas lines (a spill fails, but for the
            variants named in ``BLOCK_SPILLS_ALLOWED``); time kernel, plain
            version, library call and the launch floor with CUDA events,
            behind a sleep kernel so that only device time counts; the
            grouped kernels warm (one input set) and cold (rotating six sets
            that exceed L2), at T = 640 and at the path shape (115 live
            tiles of 640), and warm at the past-cap shapes; check that the
            path's shape keeps its plan from before row groups and windows;
4. small    exact beam search on a small tree, on the card, through every
            ported method, against a numpy brute-force scorer;
5. path     build the ``search-1m`` model (seed 0, random weights at the real
            sparsity) on the card and serve 256 queries through
            ``XMRServingEngine.serve_batch`` with ``method="auto"``; check that
            it resolved to the grouped kernel and launched it depth x batches
            times, and that it agrees with the ``mscm_dense`` oracle on the card;
            profile one call and report the grouped kernel's device time a
            launch and a call;
6. quant    on that tree, check the card's int8/fp8 codes and pruned re-pack
            against the CPU's on one level; serve the 256 queries through
            ``ServeConfig(quant=QuantConfig(tier="int8"))`` (quantized on the
            card at engine build, ``method="auto"`` -> ``mscm_pallas_grouped_q``)
            four times, in turns with the exact path; check the grouped_q
            launches (depth x batches, none of the f32 kernel) and that it is
            bitwise ``mscm_pallas_grouped`` on the dequantized tree; report
            recall@10 and score MAE against the exact path, memory, ms/query;
            then the same checks once each for ``fp8`` and ``int8_pruned``;
7. online   serve 64 of those queries one at a time (``serve_online``) with
            ``method="mscm_pallas"``, which takes the pregather kernel at
            d = 4M, then through every other method, each held against
            ``mscm_dense`` and profiled; then build ``search-32k`` (d = 337,067)
            and serve 64 queries with ``method="mscm_pallas"``, which takes the
            fused kernel there; profile both online paths and report the
            per-block kernel's device time a launch.
8. server   the serving front end on that search-1m tree, in four parts,
            each counting launches from the end of its warm-up and
            calibration: (1) warm buckets 1-64 (each bucket's first run
            timed), then 256 ``Query``s through a ``MicroBatcher`` (64, 2 ms)
            from 4 client threads, every result ok and bitwise
            ``serve_batch``'s, grouped launches depth x batches and no other,
            ``ServerMetrics`` readings and one profiled run's idle share;
            (2) ``AdmissionConfig(queue_depth=64, shed_policy="reject")``
            with 512 enqueued before start: 64 ok, 448 overloaded (429),
            depth launches; (3) ``SLOConfig(target_p99_ms=2 x tier 0's batch
            cost)``: a burst of 256 served in full, some at a tier > 0, each
            result bitwise a no-SLO engine at its tier's beam, recall@10 of
            each tier; (4) the int8 tier through the batcher, bitwise
            ``serve_batch``, grouped_q launches only.
9. partition the label-partitioned index on that search-1m tree at full width,
            P = 4 (split level 1), through ``XMRServingEngine(tree,
            ServeConfig(partition=PartitionConfig(...)))``: ``serve_batch`` of
            the 256 queries in the ``level`` and ``pipelined`` modes, each
            bitwise the unpartitioned engine with 1 + 3 x 4 grouped launches a
            bucket; ``pipelined`` with ``beam_cache=256`` cold and hot
            (bitwise, hit and miss counts); ``final`` (every merged score at
            least the exact one, recall@10); the int8 tier (the router through
            grouped, each partition through grouped_q, bitwise the f32 planner
            on the dequantized parts, ``memory_bytes`` and ``shrink_ratio``);
            ``partitions=2, shards=2`` through the ``MicroBatcher`` from 4
            client threads on four device slots (the visible cards in turn,
            ``cuda:0`` four times on one card), bitwise, with its ``summary()``
            fields; then ms/query of the unpartitioned, level, pipelined and
            pipelined-on-5-slots engines in turns, and profiles (device
            activities, idle share) of one serve_batch of each of the first
            three. Each build logs its seconds and peak device memory.
10. fleet   the same P = 4 pipelined partitions served by fleet workers
            (``repro_torch.serving.fleet``): (1) four workers' own
            connection loop in threads of this process on the card, over
            localhost sockets, the int8 tier then the exact one, each bitwise
            the in-process pipelined engine, launches counted (13 grouped a
            bucket exact; 1 grouped and 12 grouped_q int8); (2) four worker
            processes on the card (``PartitionFleet.launch(4)``): launch and
            load seconds, bytes a partition, host memory; ms/query against
            the in-process pipelined and unpartitioned engines in turns; the
            256 queries as HTTP posts from 4 client threads through a
            ``MicroBatcher(64, 2 ms)`` and ``ServingGateway``, every answer
            200 and bitwise ``serve_batch``'s through JSON, client e2e
            p50/p99 and QPS, ``/healthz`` and ``/metrics``; (3) failures:
            ``reject`` (a killed worker: a typed 503 and ``/healthz`` 503,
            then a manual respawn), ``serve_partial`` under a
            ``FleetSupervisor`` (a killed worker: degraded results without
            its labels, bitwise the thread workers with that partition down;
            the supervisor respawns and re-ships it, then bitwise the full
            results), the int8 tier through the processes (bitwise), fp8
            refused by ``partition_payload``.
11. ckpt    checkpoints (``repro_torch.checkpoint.Checkpointer``) of that
            search-1m tree quantized to int8 and to fp8 (0.61 GB each) and
            of two reduced yi-6b LMs (f32 and bf16 parameters), written in
            the sync and the async mode and restored onto the card: every
            leaf bitwise, on its template's device; write and read GB/s;
            then the 256 queries through the restored int8 tree, bitwise the
            tree before the round trip (grouped_q launches counted).
12. train   the training path at eurlex-4k's width (d = 5,000, L = 3,956,
            n_test = 3,865 of ``PAPER_SHAPES``; n_train 15,460): a seeded
            ``synthetic_labeled_dataset``, PIFA + balanced-bisection
            clustering, ``train_xmr_model`` on the card (branching 8, 4
            levels, 150 Adam steps, 64 nonzeros a column), then the test split
            through ``serve_batch`` with ``method="auto"`` (the grouped
            kernel): seconds of each step, the training matmuls' share of
            67 TFLOP/s, peak device memory, P@1 / P@5 / R@5 (fails unless
            P@1 is within ``TRAIN_P1_BAND`` of the reference's on the same
            data), launches, live tiles and zero logits per level against
            search-1m's, and agreement with ``mscm_dense``.
13. lm      the LM scaffold's serving path (plain torch ops, no kernel of
            the port): ``yi-6b`` at the reference config's full width and
            depth (6.06 G parameters, 24.24 GB f32) drawn on the card from a
            seeded ``torch.Generator``; ``prefill`` of 8 prompts of 512
            tokens (``make_demo_batch``, a cache of 1,024) in naive and in
            chunked attention, their last-position logits within
            ``LM_IMPL_TOL``; 32 greedy ``decode_step``s, each step's logits
            held against ``forward_train``'s on the prompts plus the decoded
            tokens within ``LM_DECODE_TOL``, the greedy tokens equal wherever
            the top-2 gap exceeds it; the vocab-tree head on the model's
            ``lm_head`` (``full_logits`` against ``h @ lm_head``,
            ``greedy_token`` at beam C bitwise the dense argmax, agreement at
            beams 8, 16, 64); init seconds, prefill ms and its share of 67
            TFLOP/s, decode ms/step against the weight-read bound, one
            profiled step's device activities and idle share, tree-head ms
            against the dense head, peak memory; then every reduced config's
            prefill and 4 decode steps on the card against the CPU.
14. lm_train the LM's training path (plain torch ops and autograd, no kernel
            of the port): ``yi-6b`` at full width and depth (32 layers, d =
            4,096, remat ``full``) trained on the card with Adafactor in
            place of its config's AdamW (params, grads, m and v would need 4
            x 24.24 GB), 2 sequences of 1,024 tokens a step from
            ``batch_at_step``, 6 steps (warmup 2) through ``make_train_step``:
            init seconds, ms a step (median of steps 2-5, CUDA events),
            tokens/s, MFU (6·N·T over 67 TFLOP/s f32) beside the rate with
            remat's recompute (8·N·T), the optimizer update's ms, peak
            memory, the losses (a non-finite loss or gradient fails); one
            step profiled; two steps with the layer loop's per-layer
            ``a[i]`` views against two with ``torch.unbind``; then every
            reduced config's ``make_train_step`` step (remat ``full``, the
            config's optimizer) on the card against the CPU from the same
            parameters and batch (the loss and every gradient; every leaf
            the card's update makes from the CPU's gradients); then ``train_loop`` on the card (reduced yi-6b, 12 steps,
            checkpoints every 4, a failure injected at step 6, bf16 gradient
            compression) and again on the same directory to 16 steps: it
            resumes at step 12.
15. dryrun  the dry runs, on ``meta`` tensors (no card memory):
            ``repro_torch.launch.dryrun.run_cell`` for yi-6b in train_4k,
            prefill_32k and decode_32k on the (16, 16) production mesh, each
            rank 0's DTensor program on a fake process group of 256 (each
            status ok: argument bytes a device, that rank's own counted
            FLOPs, bytes and collectives by kind, the compute, memory and
            collective terms); yi-6b's step at the lm_train phase's shape
            counted, its compute and memory bounds printed beside the step
            that phase measured; the enterprise serving dry run
            (``launch/serve_dryrun.py``: 100,663,296 labels, d = 4M, tree
            [64, 32, 32, 32, 48]) on the single- and multi-pod meshes, its
            argument bytes a device held to 13,599,411,200.
16. enterprise that model at full geometry on the card: one device's shards
            (data row 0, model slot 0: the replicated upper levels and a
            sixteenth of the leaf, 13.6 GB, bf16 values) drawn on the card
            from seeds, their bytes held to the dry run's; its program
            (scatter, dense lookups, beam steps, the owned-leaf top-10) on
            64 queries timed (CUDA events) and profiled beside the dry
            run's bound, and held against the same program on the CPU on
            the same tensors (``ENTERPRISE``'s tolerance); then all 16
            model slots streamed (each leaf shard drawn, run, freed) and
            merged into the 64 queries' top-10 of 100M labels: wall time,
            peak memory, the merge bitwise a CPU merge of the same
            candidates.
17. examples ``examples/serve_search_torch.py --small --queries 64`` and
            ``examples/lm_tree_head_torch.py`` as subprocesses on the card:
            each exits 0, the tree head prints full-beam exactness 1.000.
18. spmd    the LM as one program over a mesh (DTensor, plain torch ops and
            NCCL, no kernel of the port): (a) on a world-1 NCCL mesh of
            (1, 1), reduced yi-6b's sharded ``make_train_step`` (AdamW,
            remat, an f32 cache), ``prefill`` and 4 greedy ``decode_step``s
            against the plain port on the card from the same parameters
            (``SPMD_TOL``);
            (b) rank 0's program of the (16, 16) production mesh at yi-6b's
            full width and depth, its shards drawn on the card by
            ``spmd.local_tree`` from seeds and its collectives sent to a
            fake group (no byte crosses a card, no value is checked):
            ``train_4k`` (16 x 4,096 tokens a device, AdamW, remat
            ``full``; 1 warm-up, 2 timed steps, 1 profiled), ``prefill_32k`` (2 x
            32,768; 1 call), ``decode_32k`` (8 sequences, a cache of 32,768
            over ``model``; 8 steps), each in ms (CUDA events) against that
            rank's counted compute and memory bounds from the dry run, peak
            memory against the dry run's argument bytes, and one profiled
            decode step's activities and idle share; (c) with 2 or more
            cards, (a) on a (2, n/2) NCCL mesh, one process a card (with one
            card it says it did not run, and why).

The line before last is a JSON object with one entry per kernel, whose
``launches`` count that kernel's path (grouped: path; grouped_q: the int8
tier; pregather: search-1m online; fused: search-32k online; the grouped
entry also counts the train phase's launches, and the grouped and grouped_q
entries the server phase's, as ``server_launches``, the partition phase's,
as ``partition_launches``, and the fleet phase's thread workers', as
``fleet_launches``); the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# Kernel vs plain version: R-term f32 sums taken in different orders. With
# inputs in [0, 1) x N(0, 1) the terms' magnitudes add up to ~200 at
# R = 496, so reordering moves a sum by up to ~1e-4.
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4
# bf16 inputs: the tolerance the reference's dtype sweep uses.
BF16_TOL = 2e-2
# The serving configuration of both settings (examples/serve_search.py).
SERVE = dict(beam=10, topk=10, ell_width=256, max_batch=64)
# Label partitions of the partition phase (benchmarks/bench_partitioned.py).
PARTITIONS = 4
ONLINE_QUERIES, PROFILED_QUERIES = 64, 16
# The bound of every wait on a batcher's client thread or result.
SERVER_TIMEOUT_S = 120
# The online panel: the paper's method and the baselines it is compared with.
ONLINE_PANEL = ("mscm_pallas", "mscm_pallas_pregather", "vanilla", "mscm_searchsorted",
                "mscm_pallas_grouped", "mscm_dense")
# Shapes past the old caps of the plans (QT 16, B 353 at QT = 16, B 1022 a
# block): grouped (T, QT, R, B, C, repeated chunks) and per-block (A, n, Dp,
# R, B, C, repeated chunks).
PAST_CAP_GROUPED = [
    (640, 32, 496, 32, 32768, 160),   # two row groups
    (640, 24, 496, 32, 32768, 160),   # a short last row group
    (160, 16, 496, 1024, 1024, 40),   # column windows
]
PAST_CAP_BLOCK = {
    "online A=10 R=496 B=2048": (10, 1, 5000, 496, 2048, 300, 3),
    "batch A=640 R=496 B=2048": (640, 64, 5000, 496, 2048, 300, 40),
}
# The grouped kernels' shapes: (T, QT, R, B, C, repeated chunks).
GROUPED_SHAPES = [
    (640, 8, 496, 32, 32768, 160),   # main path, leaf level
    (1, 4, 8, 6, 3, 0),              # edge: B = 6 (ragged tree test)
    (1, 4, 8, 8, 3, 0),              # edge: B = 8
    (3, 16, 100, 70, 4, 1),          # QT*B > one pass of outputs, int8/fp8 tiles off 16 bytes
    # Tiles in passes whose last pass has fewer slabs, CTAs that walk several
    # live tiles: one stage in f32 (2 passes), two stages in int8/fp8 with 3.
    (300, 16, 600, 72, 40, 2),
    (300, 16, 1300, 64, 40, 2),
] + PAST_CAP_GROUPED
# Input sets rotated for the grouped kernels' cold times: 6 x ~40 MB (f32)
# or ~18 MB (codes) of distinct tiles and query rows, beyond the 50 MB L2.
COLD_SETS = 6
# Tiles holding a block at search-1m level 3 of 640 launched (level_counts).
PATH_LIVE = 115
# Per-block variants whose ptxas spill is known and allowed: the windowed
# fused f32 variant spills 36 bytes (ptxas, sm_90a); it runs past 1,022
# columns only, off every serving path of the repo's configurations.
BLOCK_SPILLS_ALLOWED = ("fused f32, windows",)
# The grouped plans of the path's leaf shape (T = 640, QT = 8, R = 496,
# B = 32) from before row groups and windows, by element size: (pass_rows,
# passes, warp_rows, slab_rows, slabs, stages, grid, bulk_xg, bulk_tile,
# bulk_scales, smem_bytes).
OLD_PATH_PLANS = {4: (496, 1, 64, 128, 4, 2, 132, True, True, False, 168672),
                  1: (496, 1, 64, 128, 4, 2, 264, True, True, True, 73440)}
# The train phase: eurlex-4k's d, L and n_test (PAPER_SHAPES), n_train at
# 4 x n_test and 20 nonzeros a query (examples/quickstart.py's ratio and
# density); branching 8 (levels 8, 64, 512, 4096), 64 nonzeros a column,
# 150 Adam steps a level.
TRAIN_DATA = dict(n_labels=3956, d=5000, n_train=15460, n_test=3865, query_nnz=20)
TRAIN_BRANCHING, TRAIN_NNZ, TRAIN_STEPS = 8, 64, 150
TRAIN_SERVE = dict(beam=16, topk=5, ell_width=64, max_batch=64)
# The reference's P@1 on this data, clustering, training and serving, from
# ``python tests/test_torch_train.py`` (the JAX package on the CPU). It is
# under the reference's own bar of 0.25 (tests/test_train_pipeline.py) at
# this width, so the port is held to a band around it: 0.02 is 77 of the
# 3,865 test queries.
TRAIN_REFERENCE_P1, TRAIN_P1_BAND = 0.195084, 0.02
# The reference's quality envelope of each tier on its quant-4k model
# (benchmarks/bench_quant.py): (recall@k floor, score MAE bound).
QUANT_ENVELOPE = {"int8": (0.95, 2e-3), "int8_pruned": (0.80, 2e-2), "fp8": None}
# The lm phase: the reference's yi-6b config at full width and depth, 8
# prompts of 512 tokens from make_demo_batch (seed 0), a cache of 1,024, 32
# greedy decode steps; chunked prefill in key blocks of 128 and query blocks
# of 256, so the online softmax runs over 4 key blocks.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_STEPS = "yi-6b", 8, 512, 1024, 32
LM_CHUNKED = dict(attn_impl="chunked", attn_kblock=128, attn_qblock=256)
# Prefill's last-position logits, naive against chunked attention: both f32
# (TF32 off); the online softmax sums each row in 4 blocks.
LM_IMPL_TOL = 1e-3
# Decode logits against forward_train's at the same position: decode reads
# keys and values back from the bf16 cache and rounds its softmax
# probabilities to bf16 (the reference's casts), forward_train keeps both in
# f32. The reference's own 2-layer test allows 2e-2; at 32 layers the H100
# measured a gap of 2.42e-2 on logits of unit scale (PERF.md), held here
# with a margin of 2.
LM_DECODE_TOL = 0.05
# The vocab-tree head over yi-6b's lm_head: chunks of 128 tokens (C = 500).
LM_TREE_B, LM_TREE_BEAMS = 128, (8, 16, 64)
# The ten reduced configs on the card against the port on the CPU: prefill
# and 4 decode steps, batch 2, 12 prompt tokens, a cache of 20. f32 paths
# within 1e-4 (RWKV's chunked scan magnifies last-bit differences; the CPU
# and the card sum in other orders); decode reads the bf16 cache, where a
# last-bit difference before rounding can round either way (~1e-3 on these
# logits).
LM_REDUCED = dict(batch=2, seq=12, max_len=20, steps=4)
LM_REDUCED_TOL = {"prefill": 1e-4, "decode": 5e-3}
# The lm_train phase: yi-6b at full width and depth with Adafactor (AdamW's m
# and v do not fit beside params and grads on 80 GB), 2 x 1,024 tokens a
# step from batch_at_step (seed 0), 6 steps with a warmup of 2; steps 2-5 are
# timed. Then 2 steps with per-layer a[i] views and 2 with unbind, the second
# of each pair timed.
LM_TRAIN = dict(batch=2, seq=1024, steps=6, warmup=2, timed=slice(2, 6), pair=2)
# Every reduced config, one step card against CPU (remat full, the config's
# optimizer, lr 1e-2 from step 0), in two parts. The backward: each gradient
# leaf within 1e-5 of its max |grad|, the CPU tests' bound of the port against
# jax.grad; RWKV within 1e-3: its chunked scan is ill-conditioned in f32
# (each device's distance from an f64 run of the step, logged beside, is
# of the same size: 2.3e-4 on the CPU, 5.9e-4 on the card in the first
# readings), and the loss within 1e-5. The update: the
# card's optimizer applied to the CPU's gradients gives the CPU's parameters
# within 1e-7 + 1e-6 |p| (ULPs of pow, rsqrt and the means' sums; the
# update's own error is not amplified by a gradient's sign or scale).
LM_TRAIN_REDUCED = dict(batch=2, seq=12, lr=1e-2)
LM_TRAIN_TOL = dict(loss=1e-5, grad=1e-5, ssm_grad=1e-3, param_rtol=1e-6, param_atol=1e-7)
# The loop on the card: reduced yi-6b, 12 steps (a checkpoint every 4, a
# failure injected at step 6, bf16 gradient compression), then 16 steps on
# the same directory.
LM_LOOP = dict(batch=4, seq=16, steps=12, resume_steps=16, save_every=4,
               inject_failure_at=6)
# The dryrun phase: the LM cells run on meta tensors on the single-pod mesh.
DRYRUN_CELLS = ("train_4k", "prefill_32k", "decode_32k")
# The enterprise phase (src/repro/launch/serve_dryrun.py's model, paper §6):
# data row 0's 64 queries (a batch of 1,024 over 16 data rows), beam 10,
# top-10, shards drawn from seed 0. Card against CPU: the scores of one
# device's program within 1e-7 + 1e-6 |s| (the same f32 sums, ~10 nonzero
# terms of 768, taken in other orders), the labels equal wherever the CPU's
# gap to a neighbour exceeds that.
ENTERPRISE = dict(batch=1024, n=64, beam=10, topk=10, seed=0, rtol=1e-6, atol=1e-7)
ENTERPRISE_ARGUMENT_BYTES = 13_599_411_200
# The examples phase: both new examples at the reference's small settings.
EXAMPLES = (("examples/serve_search_torch.py", "--small", "--queries", "64"),
            ("examples/lm_tree_head_torch.py",))
EXAMPLES_TIMEOUT_S = 400
# The spmd phase (a): reduced yi-6b (remat on, an f32 cache), 4 x 32 tokens
# from np.random.default_rng(0), AdamW at lr 1e-2 from step 0, a cache of
# 40, 4 greedy decode steps; the sharded run against the plain port on the
# card. The cache is f32 here: a bf16 cache rounds an entry to either side
# when the two runs' f32 values differ in their last bits, which moved
# decode logits by up to 4.3e-3 x (1 + max) on a (2, 2) gloo mesh; the
# config's bf16 cache is held against the reference on the CPU
# (tests/test_torch_spmd.py) and runs at full width in (b).
SPMD_SMALL = dict(batch=4, seq=32, max_len=40, steps=4, lr=1e-2)
# The loss within rtol 1e-5; each gradient within 1e-5 of its leaf's max
# |grad|; each updated leaf (the sharded update applied to the plain step's
# gradients) within 1e-5 of its leaf's max |p|; prefill and decode logits
# within 1e-5 x (1 + max |logit|), the greedy tokens equal wherever the
# top-2 gap exceeds that.
SPMD_TOL = dict(loss=1e-5, leaf=1e-5, logits=1e-5)
# (b): rank 0 of the (16, 16) production mesh, the dry run's cells.
SPMD_RANK0 = dict(train_steps=2, decode_steps=8, seed=0)
SPMD_CARDS_TIMEOUT_S = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout
    return out.strip().splitlines()[0]


def spills(ptxas_line: str) -> bool:
    """Whether a ptxas line reports a stack frame or spill stores/loads."""
    return bool(re.search(r"\b[1-9]\d* bytes (stack frame|spill)", ptxas_line))


def time_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` back-to-back
    calls, from CUDA events. Each rep first queues a sleep kernel, so the
    host has enqueued every call before the card reaches the first: the
    events then time the card alone, not the host's launch rate. A rep whose
    sleep ran out first is dropped and the sleep doubled."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles, times = 1 << 22, []
    while len(times) < reps:
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        late = start.query()  # the card got there before the host was done
        stop.synchronize()
        if late and cycles < 1 << 32:
            cycles *= 2
            continue
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


def bound(nbytes: float, flops: float):
    """(bound ms, what bounds it): bytes over the memory rate against f32
    operations over the CUDA cores' rate."""
    from repro_torch.launch.hw import HBM_BW, PEAK_FLOPS_F32

    bytes_ms, flops_ms = 1e3 * nbytes / HBM_BW, 1e3 * flops / PEAK_FLOPS_F32
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def held(torch, got, want, what: str, rtol: float, atol: float) -> float:
    """Raise unless ``got`` is within ``atol + rtol*|want|`` of ``want``;
    log and return the largest difference."""
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = bool((diff <= atol + rtol * want.abs()).all())
    log(f"  {what}: max|kernel-plain| = {err:.3e} (tolerance {atol:g} + {rtol:g}*|plain|) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return err


def device_profile(fn):
    """Run ``fn`` once under the profiler. Returns (wall s, device
    activities, device busy us, [(busy us, count, name)] by device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed on their own
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    return wall, sum(r[1] for r in rows), sum(r[0] for r in rows), rows


def grouped_inputs(torch, g, t, qt, r, b, c, runs):
    """Inputs of the grouped kernels: xg [T, QT, R], f32 tiles [C, R, B],
    sorted tile chunks [T] of which ``runs`` repeat, parent scores [T, QT]."""
    dev = g.device
    xg = torch.rand(t, qt, r, generator=g, device=dev)
    vals = torch.randn(c, r, b, generator=g, device=dev)
    base = torch.randint(0, c, (t - runs,), generator=g, device=dev)
    tc = torch.sort(torch.cat([base, base[:runs]])).values  # some chunks repeat
    ps = torch.rand(t, qt, generator=g, device=dev) + 1e-3
    return [x.cuda() for x in (xg, vals, tc, ps)]


def padded(torch, xg, tc, ps, live):
    """The tiles from ``live`` on made padding, as the grouping leaves them:
    tile_src -1, the last live tile's chunk, zero query rows and scores; the
    last live tile's second half padding too (at QT = 32 a whole row group
    of a live tile). Returns (xg, tc, ps, tile_src), new tensors."""
    t, qt, _ = xg.shape
    xg, tc, ps = xg.clone(), tc.clone(), ps.clone()
    src = torch.arange(t * qt, device=xg.device).reshape(t, qt)
    src[live:] = -1
    if live:
        src[live - 1, max(1, qt // 2):] = -1
        tc[live:] = tc[live - 1]
    xg[live:] = 0.0
    ps[live:] = 0.0
    return xg, tc, ps, src


def grouped_sets(torch, g, n, t, qt, r, b, c, runs, live=None):
    """``n`` input sets of T tiles for one chunk table of C chunks, set i over
    chunks [i C / n, (i + 1) C / n): (xg, tc, ps, tile_src); with ``live``,
    the tiles from ``live`` on are padding. Rotating through them keeps
    the tiles a launch reads out of L2 when the sets exceed it."""
    out = []
    for i in range(n):
        lo, hi = i * c // n, (i + 1) * c // n
        base = torch.randint(lo, hi, (t - runs,), generator=g, device="cuda")
        tc = torch.sort(torch.cat([base, base[:runs]])).values
        xg = torch.rand(t, qt, r, generator=g, device="cuda")
        ps = torch.rand(t, qt, generator=g, device="cuda") + 1e-3
        out.append((xg, tc, ps, None) if live is None else padded(torch, xg, tc, ps, live))
    return out


def grouped_bytes(torch, xg, tc, src, b, es):
    """(bytes, flops) the grouped kernel needs for one input set: each live
    tile's query rows and parent scores, each distinct chunk of the live
    tiles once (its codes and, for es = 1, its scale row), the ids, the
    whole output; 2 flops a multiply-add and, for codes, one a weight."""
    t, qt, r = xg.shape
    live = t if src is None else int((src[:, 0] >= 0).sum())
    chunks = int(torch.unique(tc[:live]).numel())
    nbytes = (4 * live * qt * (r + 1) + chunks * r * b * es + (4 * chunks * b if es == 1 else 0)
              + 8 * t * (1 if src is None else 2) + 4 * t * qt * b)
    flops = 2 * live * qt * r * b + (chunks * r * b if es == 1 else 0)
    return nbytes, flops


def rotation(calls):
    """One callable that runs ``calls`` in turn, one a call."""
    state = {"i": 0}

    def run():
        calls[state["i"] % len(calls)]()
        state["i"] += 1
    return run


def grouped_timings(torch, label, kernel, sets, path_sets, plain, library):
    """Times of one grouped entry point at the path's leaf shape: warm (one
    input set, launched back to back, so much of it stays in L2) and cold
    (rotating through the sets, which exceed L2), then the same at the path
    shape, where most tiles are padding. ``kernel(xg, tc, ps, src)`` and
    ``plain`` take a set; ``library(i)`` is ``torch.bmm`` on set i's
    operands gathered before (warm and cold)."""
    def calls(fn, ss):
        return [lambda s=s: fn(*s) for s in ss]

    out = {}
    k_full, k_path = calls(kernel, sets), calls(kernel, path_sets)
    out["warm_ms"] = time_ms(k_full[0])
    out["ms"] = time_ms(rotation(k_full))
    out["path_warm_ms"] = time_ms(k_path[0])
    out["path_ms"] = time_ms(rotation(k_path))
    out["plain_ms"] = time_ms(rotation(calls(plain, sets)), reps=10, inner=6)
    lib = [lambda i=i: library(i) for i in range(len(sets))]
    out["library_warm_ms"] = time_ms(lib[0])
    out["library_ms"] = time_ms(rotation(lib))
    log(f"  timing {label}: " + ", ".join(f"{k} {v:.5f}" for k, v in out.items()))
    return out


def grouped_bound(torch, sets, b, es):
    """The mean bound over the input sets, and what sets it."""
    pairs = [grouped_bytes(torch, xg, tc, src, b, es) for xg, tc, _, src in sets]
    nbytes = sum(p[0] for p in pairs) / len(pairs)
    flops = sum(p[1] for p in pairs) / len(pairs)
    ms, by = bound(nbytes, flops)
    return ms, by, nbytes


def grouped_plans(torch, mk, build, shapes) -> None:
    """Log the grouped kernel's launch plan at ``shapes`` (label -> T, QT, R,
    B) in f32 and int8/fp8, and its ptxas lines; raise on a spill, or if the
    variant that cuts items into row groups and windows takes 128 registers
    or fewer (its plans then put one CTA an SM for nothing)."""
    for label, (t, qt, r, b) in shapes.items():
        for es, kind in ((4, "f32"), (1, "int8/fp8")):
            log(f"  plan {label} {kind}: {plan_text(mk.grouped_launch_plan(t, qt, r, b, es))}")
    kernel = None
    for line in build.BUILD_LOGS.get("mscm_grouped", "").splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("registers" in line or "spill" in line):
            kind = "fp8" if "fp8" in kernel else ("int8" if "kernelIa" in kernel else "f32")
            kind += ", row groups / windows" if "Lb1EE" in kernel else ""
            log(f"  ptxas mscm_grouped {kind}: {line.replace('ptxas info    :', '').strip()}")
            if spills(line):
                raise AssertionError(f"ptxas spills in the grouped kernel ({kind}): {line}")
            used = re.search(r"Used (\d+) registers", line)
            if used and "Lb1EE" in kernel and int(used.group(1)) <= 128:
                # grouped_launch_plan gives these variants one CTA an SM.
                raise AssertionError(f"the grouped kernel that cuts items ({kind}) takes "
                                     f"{used.group(1)} registers: two CTAs would fit an SM")


def kernel_check(torch, mk, build):
    """Phase 3a: the grouped kernel against its plain version at every
    shape and mode, with and without padding tiles, each launched twice and
    held bitwise to itself; its plans and ptxas lines; then timings at the
    batch path's leaf shape (T = 640), warm and cold, and at the path shape
    (115 live tiles of 640, search-1m level 3)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for t, qt, r, b, c, runs in GROUPED_SHAPES:
        xg, vals, tc, ps = grouped_inputs(torch, g, t, qt, r, b, c, runs)
        for dead in (False, True):
            live = (max(1, t // 5) if t > 1 else 0) if dead else t
            x, tcs, p_, src = padded(torch, xg, tc, ps, live) if dead else (xg, tc, ps, None)
            for mode in ("none", "prod", "logsum"):
                p = None if mode == "none" else p_
                what = (f"mscm_grouped T={t} QT={qt} R={r} B={b} mode={mode}"
                        f"{f' ({live} live tiles)' if dead else ''}")
                got = repeat_bitwise(torch, lambda: mk.mscm_grouped(x, vals, tcs, p, mode=mode,
                                                                    tile_src=src), what)
                want = mk.mscm_grouped_plain(x, vals, tcs, p, mode=mode, tile_src=src)
                max_err = max(max_err, held(torch, got, want, what, KERNEL_RTOL, KERNEL_ATOL))
    log("  every grouped case: two launches bitwise equal")
    t, qt, r, b, c, runs = GROUPED_SHAPES[0]
    grouped_plans(torch, mk, build, {"T=640 QT=8 R=496 B=32": (t, qt, r, b),
                                     "int8_pruned R=248": (t, qt, 248, b),
                                     "edge QT=16 R=100 B=70": (3, 16, 100, 70)})

    # Timings at the main path's shapes, in the path's epilogue mode.
    vals = torch.randn(c, r, b, generator=g, device="cuda")
    sets = grouped_sets(torch, g, COLD_SETS, t, qt, r, b, c, runs)
    path_sets = grouped_sets(torch, g, COLD_SETS, t, qt, r, b, c, runs, live=PATH_LIVE)
    gathered = [vals[tc] for _, tc, _, _ in sets]
    times = grouped_timings(
        torch, f"mscm_grouped T={t} QT={qt} R={r} B={b}",
        lambda x, tc, p, src: mk.mscm_grouped(x, vals, tc, p, mode="prod", tile_src=src),
        sets, path_sets,
        plain=lambda x, tc, p, src: mk.mscm_grouped_plain(x, vals, tc, p, mode="prod"),
        library=lambda i: torch.bmm(sets[i][0], gathered[i]))
    bound_ms, bound_by, nbytes = grouped_bound(torch, sets, b, 4)
    path_bound_ms, _, path_bytes = grouped_bound(torch, path_sets, b, 4)
    log(f"  bound T={t}: {nbytes / 1e6:.2f} MB, {bound_ms:.5f} ms ({bound_by}); path shape "
        f"({PATH_LIVE} live of {t}): {path_bytes / 1e6:.2f} MB, {path_bound_ms:.5f} ms; "
        f"{COLD_SETS} sets of {nbytes / 1e6:.1f} MB rotated for the cold times")
    return {
        "name": "mscm_grouped",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mscm_grouped.cu",
        "replaces": "src/repro/kernels/mscm_kernel.py:187",
        "max_abs_err": max_err,
        "max_err": max_err,
        **times,
        "kernel_ms": times["ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "path_bound_ms": path_bound_ms,
        "path_live_tiles": PATH_LIVE,
    }


def quant_kernel_check(torch, mk, qk, quantize_chunks):
    """Phase 3c: the quantized grouped kernel in int8 and fp8 against its
    plain version, and bitwise against the f32 grouped kernel on the
    dequantized tiles (one routine serves both), at the grouped shapes and
    with chunk ids past C, with and without padding tiles, each launched
    twice and held bitwise to itself; then the timings of kernel_check."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [shape + (False,) for shape in GROUPED_SHAPES] + [(6, 4, 24, 16, 5, 1, True)]
    err = {"int8": 0.0, "fp8": 0.0}
    timed = {}
    for dtype in err:
        for t, qt, r, b, c, runs, past in cases:
            xg, f32, tc, ps = grouped_inputs(torch, g, t, qt, r, b, c, runs)
            if past:
                tc[-2:] = c + 2  # clamped to the last chunk
            vals, scales = quantize_chunks(f32, dtype)
            deq = vals.float() * scales[:, None, :]
            for dead in (False, True):
                live = (max(1, t // 5) if t > 1 else 0) if dead else t
                x, tcs, p_, src = padded(torch, xg, tc, ps, live) if dead else (xg, tc, ps, None)
                for mode in ("none", "prod", "logsum"):
                    p = None if mode == "none" else p_
                    what = (f"mscm_grouped_q {dtype} T={t} QT={qt} R={r} B={b}"
                            f"{' chunk ids past C' if past else ''}"
                            f"{f' ({live} live tiles)' if dead else ''} mode={mode}")
                    got = repeat_bitwise(torch, lambda: qk.mscm_grouped_q(
                        x, vals, scales, tcs, p, mode=mode, tile_src=src), what)
                    want = qk.mscm_grouped_q_plain(x, vals, scales, tcs, p, mode=mode,
                                                   tile_src=src)
                    err[dtype] = max(err[dtype], held(torch, got, want, what,
                                                      KERNEL_RTOL, KERNEL_ATOL))
                    if not torch.equal(got, mk.mscm_grouped(x, deq, tcs, p, mode=mode,
                                                            tile_src=src)):
                        raise AssertionError(f"{what}: not bitwise mscm_grouped on the "
                                             "dequantized tiles")
            del deq
        log(f"  mscm_grouped_q {dtype}: bitwise mscm_grouped on the dequantized tiles "
            f"at every shape and mode, and two launches bitwise equal")

        # Timings at the main path's shape, in the path's epilogue mode.
        t, qt, r, b, c, runs = GROUPED_SHAPES[0]
        vals, scales = quantize_chunks(torch.randn(c, r, b, generator=g, device="cuda"), dtype)
        sets = grouped_sets(torch, g, COLD_SETS, t, qt, r, b, c, runs)
        path_sets = grouped_sets(torch, g, COLD_SETS, t, qt, r, b, c, runs, live=PATH_LIVE)
        deq_g = [vals[tc].float() * scales[tc][:, None, :] for _, tc, _, _ in sets]
        times = grouped_timings(
            torch, f"mscm_grouped_q {dtype} T={t} QT={qt} R={r} B={b}",
            lambda x, tc, p, src: qk.mscm_grouped_q(x, vals, scales, tc, p, mode="prod",
                                                    tile_src=src),
            sets, path_sets,
            plain=lambda x, tc, p, src: qk.mscm_grouped_q_plain(x, vals, scales, tc, p,
                                                                mode="prod"),
            library=lambda i: torch.bmm(sets[i][0], deq_g[i]))
        bound_ms, bound_by, nbytes = grouped_bound(torch, sets, b, 1)
        path_bound_ms, _, path_bytes = grouped_bound(torch, path_sets, b, 1)
        log(f"  bound {dtype} T={t}: {nbytes / 1e6:.2f} MB, {bound_ms:.5f} ms ({bound_by}); "
            f"path shape: {path_bytes / 1e6:.2f} MB, {path_bound_ms:.5f} ms")
        timed[dtype] = dict(times, bound_ms=bound_ms, bound_by=bound_by,
                            path_bound_ms=path_bound_ms)
        del vals, scales, deq_g, sets, path_sets
    return {
        "name": "mscm_grouped_q",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mscm_grouped.cu",
        "replaces": "src/repro/quant/kernels.py:66",
        "max_abs_err": max(err.values()),
        "max_err": max(err.values()),
        **timed["int8"],
        "kernel_ms": timed["int8"]["ms"],
        "path_live_tiles": PATH_LIVE,
        **{f"fp8_{k}": v for k, v in timed["fp8"].items()},
        "fp8_max_abs_err": err["fp8"],
    }


def plan_text(p) -> str:
    """One grouped launch plan, as the kernels phase logs it."""
    ops = [n for n, on in (("xg", p.bulk_xg), ("tile", p.bulk_tile), ("scales", p.bulk_scales))
           if on]
    return (f"grid {p.grid}, {p.row_groups} row group(s) of {p.group_rows}, {p.windows} "
            f"window(s) of {p.window_cols} columns, {p.stages} stage(s), {p.passes} pass(es) of "
            f"{p.pass_rows} rows, {p.warp_rows} rows a warp, {p.slabs} slab(s) of {p.slab_rows} "
            f"rows, bulk copies for {', '.join(ops) or 'nothing'}, {p.smem_bytes} B shared")


def past_cap_timings(torch, mk, qk, quantize_chunks) -> dict:
    """Phase 3d: plans and warm times of the grouped shapes past the plans'
    old caps (kernel_check and quant_kernel_check hold them against their
    plain versions), f32 and int8, with ``torch.bmm`` (on the f32 tiles and
    on the dequantized int8 tiles) and each one's bound beside them; then
    the path's old-cap shape keeps the plan it had before row groups and
    windows. Returns label -> times."""
    g = torch.Generator(device="cuda").manual_seed(16)
    times = {}
    for t, qt, r, b, c, runs in PAST_CAP_GROUPED:
        label = f"T={t} QT={qt} R={r} B={b}"
        xg, f32, tc, ps = grouped_inputs(torch, g, t, qt, r, b, c, runs)
        vals, scales = quantize_chunks(f32, "int8")
        for es, kind in ((4, "f32"), (1, "int8")):
            log(f"  plan {label} {kind}: {plan_text(mk.grouped_launch_plan(t, qt, r, b, es))}")
        gathered = f32[tc]
        deq_g = vals[tc].float() * scales[tc][:, None, :]  # dequantized, gathered
        entry = dict(
            ms=time_ms(lambda: mk.mscm_grouped(xg, f32, tc, ps, mode="prod")),
            int8_ms=time_ms(lambda: qk.mscm_grouped_q(xg, vals, scales, tc, ps, mode="prod")),
            plain_ms=time_ms(lambda: mk.mscm_grouped_plain(xg, f32, tc, ps, mode="prod"),
                             reps=10, inner=4),
            library_ms=time_ms(lambda: torch.bmm(xg, gathered)),
            int8_library_ms=time_ms(lambda: torch.bmm(xg, deq_g)))
        nbytes, flops = grouped_bytes(torch, xg, tc, None, b, 4)
        entry["bound_ms"], entry["bound_by"] = bound(nbytes, flops)
        qbytes, qflops = grouped_bytes(torch, xg, tc, None, b, 1)
        entry["int8_bound_ms"], entry["int8_bound_by"] = bound(qbytes, qflops)
        log(f"  timing {label} (prod, warm): kernel {entry['ms']:.5f} ms, int8 "
            f"{entry['int8_ms']:.5f}, plain {entry['plain_ms']:.5f}, torch.bmm on gathered "
            f"tiles {entry['library_ms']:.5f} (dequantized int8 tiles "
            f"{entry['int8_library_ms']:.5f}), bound {entry['bound_ms']:.5f} "
            f"({entry['bound_by']}, {nbytes / 1e6:.2f} MB; int8 {entry['int8_bound_ms']:.5f}, "
            f"{entry['int8_bound_by']}, {qbytes / 1e6:.2f} MB)")
        times[label] = entry
        del xg, f32, vals, scales, gathered, deq_g
    for es, want in OLD_PATH_PLANS.items():
        plan = mk.grouped_launch_plan(640, 8, 496, 32, es)
        if tuple(plan)[:11] != want or (plan.row_groups, plan.windows) != (1, 1):
            raise AssertionError(f"the path's shape lost its old plan: {plan}")
    log("  the path's shape T=640 QT=8 R=496 B=32 keeps its old plan in f32 and int8/fp8")
    return times


def block_list(torch, g, a, n, c, runs):
    """A chunk-sorted list of ``a`` blocks over ``n`` queries and ``c``
    chunks, ``runs`` of whose chunks repeat: (block_q, block_c)."""
    base = torch.randint(0, c, (a - runs,), device="cuda", generator=g)
    bc = torch.sort(torch.cat([base, base[:runs]])).values
    return torch.randint(0, n, (a,), device="cuda", generator=g), bc


def block_inputs(torch, g, a, n, dp, r, b, c, runs, *, past=0):
    """Inputs of the per-block kernels on the card: a query table [n, dp],
    chunk rows [c, r] (``past`` > 0 puts some past the table, which the
    kernels clip), tiles [c, r, b] and a block list (:func:`block_list`)."""
    x = torch.rand(n, dp, device="cuda", generator=g)
    rows = torch.randint(0, dp + past, (c, r), device="cuda", generator=g, dtype=torch.int32)
    vals = torch.randn(c, r, b, device="cuda", generator=g)
    return (x, rows, vals) + block_list(torch, g, a, n, c, runs)


def gathered_rows(x, rows, bq, bc):
    """xg for the pregather kernel: the fused kernel's gather, written out
    (chunk ids clamped, rows clipped)."""
    idx = rows[bc.clamp(0, rows.shape[0] - 1)].long().clamp(0, x.shape[1] - 1)
    return x[bq[:, None], idx]


def block_timing(torch, mk, name, x, rows, vals, bq, bc) -> dict:
    """Kernel, plain version and ``torch.bmm`` on pre-gathered inputs, at one
    shape, with the bound: each input read once (the distinct chunk tiles,
    their rows for ``fused``, the gathered query values, the block ids) and
    the output written once."""
    c, r, b = vals.shape
    a = bc.numel()
    es = vals.element_size()
    xg = gathered_rows(x, rows, bq, bc)
    vals_g = vals[bc]
    if name == "mscm_fused":
        kernel = lambda: mk.mscm_fused(x, rows, vals, bq, bc)  # noqa: E731
        plain = lambda: mk.mscm_fused_plain(x, rows, vals, bq, bc)  # noqa: E731
    else:
        kernel = lambda: mk.mscm_pregather(xg, vals, bc)  # noqa: E731
        plain = lambda: mk.mscm_pregather_plain(xg, vals, bc)  # noqa: E731
    distinct = int(torch.unique(bc).numel())
    fused = name == "mscm_fused"
    nbytes = (es * (a * r + distinct * r * b) + 4 * a * b + 8 * a * (2 if fused else 1)
              + (4 * distinct * r if fused else 0))
    bound_ms, bound_by = bound(nbytes, 2 * a * r * b)
    out = dict(ms=time_ms(kernel), plain_ms=time_ms(plain),
               library_ms=time_ms(lambda: torch.bmm(xg[:, None, :], vals_g)),
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"  timing {name} A={a} R={r} B={b} ({distinct} distinct chunks, "
        f"{nbytes / 1e6:.3f} MB, {2 * a * r * b / 1e6:.2f} MFLOP): kernel {out['ms']:.5f} ms, "
        f"plain {out['plain_ms']:.5f} ms, torch.bmm on pre-gathered rows "
        f"{out['library_ms']:.5f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return out


def repeat_bitwise(torch, fn, what: str):
    """Run ``fn`` twice; raise unless the two results are bitwise equal
    (the per-block kernels sum in a fixed order and use no atomics)."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"{what}: two launches differ")
    return first


def block_plans(torch, mk, build, shapes) -> None:
    """Log each entry point's launch plan at ``shapes`` (label -> A, R, B)
    and the per-block kernels' ptxas lines from the build; raise on a spill
    in any variant but those of :data:`BLOCK_SPILLS_ALLOWED`."""
    for label, (a, r, b) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            p = mk.block_launch_plan(a, r, b, dtype.itemsize)
            log(f"  plan {label} {str(dtype)[6:]} (fused and pregather): S={p.cluster}, "
                f"{p.windows} window(s) of {p.window_cols} columns (grid {p.grid(a)}), "
                f"{p.rows_per_slice} rows a slice in slabs of "
                f"{p.slab_rows} x {p.stages} stage(s), "
                f"{'bulk copies' if p.bulk else 'ordinary loads'}, {p.smem_bytes} B shared")
    kernel = None
    for line in build.BUILD_LOGS.get("mscm_block", "").splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("registers" in line or "spill" in line):
            fused, windowed = re.search(r"Lb([01])ELb([01])E", kernel).groups()
            kind = ("fused" if fused == "1" else "pregather") + (
                " bf16" if "bfloat16" in kernel else " f32") + (
                ", windows" if windowed == "1" else "")
            log(f"  ptxas mscm_block {kind}: {line.replace('ptxas info    :', '').strip()}")
            if spills(line) and kind not in BLOCK_SPILLS_ALLOWED:
                raise AssertionError(f"ptxas spills in the per-block kernel ({kind}): {line}")


def block_kernel_check(torch, mk, ops, build):
    """Phase 3b: the fused and pregather kernels against their plain
    versions, at the online shape (A = 10 blocks a level, and A = 1), the
    batch shape (A = 640) and edge shapes (unaligned slices that take
    ordinary loads, a tile streamed through a ring), in f32 and bf16, each
    launched twice and held bitwise to itself; then the plans and the
    timings, with the launch floor at the online shape."""
    g = torch.Generator(device="cuda").manual_seed(0)
    big = block_inputs(torch, g, 640, 64, 337_068, 496, 32, 32768, 160)
    x, rows, vals, _, _ = big
    online = (x[:1], rows, vals) + block_list(torch, g, 10, 1, vals.shape[0], 3)
    cases = {  # label -> (x, rows, vals, block_q, block_c)
        "online A=10 R=496 B=32": online,
        "online A=1 R=496 B=32": (x[:1], rows, vals) + block_list(torch, g, 1, 1,
                                                                   vals.shape[0], 0),
        "batch A=640 R=496 B=32": big,
        "edge A=1 B=6": block_inputs(torch, g, 1, 1, 50, 8, 6, 3, 0, past=3),
        "edge B=8 R=37 (unaligned)": block_inputs(torch, g, 5, 2, 70, 37, 8, 3, 1, past=3),
        "edge B=70 R=1037 (unaligned)": block_inputs(torch, g, 3, 2, 2000, 1037, 70, 4, 1,
                                                     past=3),
        "ring A=200 R=1040 B=72": block_inputs(torch, g, 200, 2, 2000, 1040, 72, 40, 10,
                                               past=3),
    }
    past = block_inputs(torch, g, 6, 3, 90, 24, 16, 5, 1)
    past[4][-2:] = 7  # chunk ids past C = 5: clamped to the last chunk
    cases["edge chunk id past C"] = past
    for label, shape in PAST_CAP_BLOCK.items():  # column windows
        cases[label] = block_inputs(torch, g, *shape)
    err = {"mscm_fused": 0.0, "mscm_pregather": 0.0, "bf16": 0.0}
    for label, (x, rows, vals, bq, bc) in cases.items():
        got = repeat_bitwise(torch, lambda: mk.mscm_fused(x, rows, vals, bq, bc),
                             f"mscm_fused {label}")
        want = mk.mscm_fused_plain(x, rows, vals, bq, bc)
        err["mscm_fused"] = max(err["mscm_fused"], held(
            torch, got, want, f"mscm_fused {label}", KERNEL_RTOL, KERNEL_ATOL))
        xg = gathered_rows(x, rows, bq, bc)
        got = repeat_bitwise(torch, lambda: mk.mscm_pregather(xg, vals, bc),
                             f"mscm_pregather {label}")
        want = mk.mscm_pregather_plain(xg, vals, bc)
        err["mscm_pregather"] = max(err["mscm_pregather"], held(
            torch, got, want, f"mscm_pregather {label}", KERNEL_RTOL, KERNEL_ATOL))
    for label in ("online A=10 R=496 B=32", "online A=1 R=496 B=32",
                  "edge B=8 R=37 (unaligned)", "edge B=70 R=1037 (unaligned)",
                  "ring A=200 R=1040 B=72", "online A=10 R=496 B=2048"):
        x, rows, vals, bq, bc = cases[label]
        x16, v16 = x.bfloat16(), vals.bfloat16()
        got = repeat_bitwise(torch, lambda: mk.mscm_fused(x16, rows, v16, bq, bc),
                             f"mscm_fused bf16 {label}")
        want = mk.mscm_fused_plain(x16, rows, v16, bq, bc)
        err["bf16"] = max(err["bf16"], held(
            torch, got, want, f"mscm_fused bf16 {label}", BF16_TOL, BF16_TOL))
        xg16 = gathered_rows(x16, rows, bq, bc)
        got = repeat_bitwise(torch, lambda: mk.mscm_pregather(xg16, v16, bc),
                             f"mscm_pregather bf16 {label}")
        err["bf16"] = max(err["bf16"], held(
            torch, got, mk.mscm_pregather_plain(xg16, v16, bc),
            f"mscm_pregather bf16 {label}", BF16_TOL, BF16_TOL))
    log("  every case of both entry points: two launches bitwise equal")
    # sort=False through ops.mscm_pallas: the block list in arrival order.
    x, rows, vals, bq, bc = cases["online A=10 R=496 B=32"]
    perm = torch.randperm(bc.numel(), device="cuda", generator=g)
    for variant in ("fused", "pregather"):
        for sort in (False, True):
            got = ops.mscm_pallas(x, rows, vals, bq[perm], bc[perm], variant=variant, sort=sort)
            want = mk.mscm_fused_plain(x, rows, vals, bq[perm], bc[perm])
            name = f"mscm_{variant}"
            err[name] = max(err[name], held(
                torch, got, want, f"ops.mscm_pallas variant={variant} sort={sort}",
                KERNEL_RTOL, KERNEL_ATOL))

    block_plans(torch, mk, build, {label: (cases[label][4].numel(),) + cases[label][2].shape[1:]
                                   for label in ("online A=10 R=496 B=32",
                                                 "batch A=640 R=496 B=32",
                                                 "edge B=70 R=1037 (unaligned)",
                                                 "ring A=200 R=1040 B=72", *PAST_CAP_BLOCK)})
    # The launch floor: one trivial kernel on the online output [A, B].
    out = torch.empty(10, 32, device="cuda")
    floor_ms = time_ms(lambda: out.zero_())
    log(f"  launch floor at the online shape: out.zero_() on [10, 32] {floor_ms:.5f} ms")
    entries = []
    for name, line in (("mscm_fused", 67), ("mscm_pregather", 111)):
        t_online = block_timing(torch, mk, name, *cases["online A=10 R=496 B=32"])
        t_one = block_timing(torch, mk, name, *cases["online A=1 R=496 B=32"])
        t_batch = block_timing(torch, mk, name, *cases["batch A=640 R=496 B=32"])
        entry = {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mscm_block.cu",
            "replaces": f"src/repro/kernels/mscm_kernel.py:{line}",
            "max_abs_err": err[name],
            "max_err": err[name],
            **t_online,
            "kernel_ms": t_online["ms"],
            "floor_ms": floor_ms,
            "a1_ms": t_one["ms"],
            **{f"batch_{k}": v for k, v in t_batch.items()},
            "past_caps": {label: block_timing(torch, mk, name, *cases[label])
                          for label in PAST_CAP_BLOCK},
        }
        if name == "mscm_fused":
            entry["bf16_max_abs_err"] = err["bf16"]
        entries.append(entry)
    return entries


def small_check(torch):
    """Phase 4: exact search (beam = L) on a small tree against brute force,
    through every ported method."""
    from repro_torch.core.tree import XMRTree
    from repro_torch.parity import check_ranking
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
    for method in ONLINE_PANEL:
        s, l = tree.infer(torch.from_numpy(xi), torch.from_numpy(xv), beam=512, topk=5,
                          method=method, qt=4)
        n_diff = check_ranking(s.cpu().numpy(), l.cpu().numpy(), want_s, want_l,
                               f"small tree, {method}")
        log(f"  small tree (d={d}, B={B}, 3 levels, exact search) {method}: "
            f"agrees with the brute-force scorer ({n_diff} near-tie label swaps)")


def level_counts(torch, eng, queries, bucket: int) -> list:
    """Counts, per level of the first batch, of what the grouped kernel is
    given: blocks, the static tile count, tiles holding a block, and the
    distinct chunks they read (the kernel's real byte count); and the share
    of the level's logits that are exactly 0. Returns one dict a level."""
    from repro_torch.core.beam import beam_select
    from repro_torch.core.mscm import mscm_dense_lookup, scatter_dense
    from repro_torch.core.tree import level_combined
    from repro_torch.kernels.ops import group_blocks_device

    tree, c = eng.tree, eng.config
    xi, xv = eng.marshal_rows(queries, np.arange(bucket), bucket)
    x_dense = scatter_dense(xi, xv, tree.d)
    ids = torch.zeros((bucket, 1), dtype=torch.int64, device=xi.device)
    scores = torch.ones((bucket, 1), device=xi.device)
    out = []
    for li, layer in enumerate(tree.layers):
        n_chunks, r, b = layer.chunk_vals.shape
        _, tile_src, _, _ = group_blocks_device(ids.reshape(-1), c.qt, n_chunks)
        real = int((tile_src[:, 0] >= 0).sum())
        distinct = int(torch.unique(ids).numel())
        need = 4 * (real * c.qt * r + distinct * r * b)
        block_q = torch.arange(bucket, device=ids.device).repeat_interleave(ids.shape[1])
        logits = mscm_dense_lookup(x_dense, layer.chunk_rows, layer.chunk_vals,
                                   block_q, ids.reshape(-1))
        zero = float((logits == 0).float().mean())
        out.append(dict(blocks=ids.numel(), tiles=tile_src.shape[0], live=real,
                        chunks=distinct, zero_share=zero))
        log(f"  level {li}: {ids.numel()} blocks, {tile_src.shape[0]} tiles launched, "
            f"{real} holding blocks, {distinct} distinct chunks of {n_chunks} "
            f"({need / 1e6:.2f} MB of xg and chunk tiles needed); "
            f"{100 * (1 - zero):.2f}% of logits nonzero")
        combined = level_combined(layer, tree.branching[li], tree.d, xi, xv, x_dense, ids,
                                  scores, method=eng.method, score_mode=c.score_mode, qt=c.qt)
        last = li == tree.depth - 1
        ids, scores = beam_select(ids, combined, tree.n_cols[li],
                                  min(c.topk if last else c.beam, tree.n_cols[li]))
        ids, order = torch.sort(ids, dim=1)
        scores = scores.gather(1, order)
    return out


def log_profile(what: str, wall: float, acts: int, busy_us: float, rows, gpu: str,
                top: int) -> None:
    if not busy_us:
        log(f"  profile of {what}: no device time recorded (device breakdown not measured)")
        return
    log(f"  profile of {what} (profiler on): wall {1e3 * wall:.3f} ms, {acts} device "
        f"activities, device busy {busy_us / 1e3:.3f} ms = {100 * busy_us / (1e6 * wall):.1f}% "
        f"of wall  [{gpu}]")
    for dev_us, count, key in rows[:top]:
        log(f"    {dev_us / 1e3:9.4f} ms {100 * dev_us / busy_us:5.1f}%  x{count:<4d} {key[:90]}")


def log_block_kernel(what: str, rows, queries: int, kernel: str = "mscm_block_kernel",
                     label: str = "the per-block kernel") -> None:
    """A kernel's share of a profile: device time a launch, and launches and
    device time a query."""
    hits = [(us, n) for us, n, key in rows if kernel in key]
    us, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
    if n:
        log(f"  {what}: {label} {us / n:.3f} us a launch on the path "
            f"({n / queries:.3f} launches, {us / queries:.3f} us a query; {n} launches, "
            f"{us / 1e3:.4f} ms in all)")


def path(torch, mk, gpu: str):
    """Phase 5: the batch path at the search-1m geometry. Returns the grouped
    kernel's launches, the tree and the queries."""
    from repro_torch.data.build import build_benchmark_tree
    from repro_torch.data.xmr_data import XMRShape, benchmark_queries
    from repro_torch.launch import hw
    from repro_torch.parity import check_ranking
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
    eng = XMRServingEngine(tree, ServeConfig(method="auto", **SERVE))
    if eng.method != "mscm_pallas_grouped":
        raise AssertionError(f"method='auto' resolved to {eng.method!r} on the GPU")
    eng.warmup(shape.d, batch_sizes=(64,))
    torch.cuda.reset_peak_memory_stats()

    mk.GROUPED_LAUNCHES = 0
    t0 = time.perf_counter()
    s, l = eng.serve_batch(queries)
    wall = time.perf_counter() - t0
    launches = mk.GROUPED_LAUNCHES
    n_batches = -(-queries.shape[0] // SERVE["max_batch"])
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
        f"{SERVE['max_batch']}): {launches} grouped launches; wall s per call "
        f"{[round(w, 6) for w in walls]}; median {1e3 * med / n:.5f} ms/query amortized, "
        f"{n / med:.1f} QPS, peak device memory {peak / 1e9:.3f} GB  [{gpu}]")
    if s.shape != (n, 10) or not np.isfinite(s).all():
        raise AssertionError(f"bad scores: shape {s.shape}")

    dense = XMRServingEngine(tree, ServeConfig(method="mscm_dense", **SERVE))
    s_d, l_d = dense.serve_batch(queries)
    t0 = time.perf_counter()
    dense.serve_batch(queries)
    wall_d = time.perf_counter() - t0
    n_diff = check_ranking(s, l, s_d, l_d, "search-1m grouped vs mscm_dense")
    log(f"  agrees with mscm_dense on the card: max|score diff| "
        f"{float(np.abs(s - s_d).max()):.3e}, {n_diff} near-tie label swaps of {l.size}; "
        f"mscm_dense {1e3 * wall_d / n:.5f} ms/query amortized  [{gpu}]")

    counts = level_counts(torch, eng, queries, SERVE["max_batch"])

    # The dense lookup table the path scatters every batch: [64, d+1] f32.
    from repro_torch.core.mscm import scatter_dense

    xi, xv = eng.marshal_rows(queries, np.arange(SERVE["max_batch"]), SERVE["max_batch"])
    table_bytes = SERVE["max_batch"] * (shape.d + 1) * 4
    scatter_ms = time_ms(lambda: scatter_dense(xi, xv, shape.d), reps=10, inner=4)
    log(f"  scatter_dense of one {SERVE['max_batch']}-query batch: {scatter_ms:.5f} ms for a "
        f"{table_bytes / 1e9:.3f} GB table (write bound {1e3 * table_bytes / hw.HBM_BW:.5f} ms)"
        f"  [{gpu}]")

    # Where the time goes: device time by kernel over one serve_batch.
    wall, acts, busy_us, rows = device_profile(lambda: eng.serve_batch(queries))
    log_profile("one serve_batch", wall, acts, busy_us, rows, gpu, 14)
    log_block_kernel(f"one serve_batch of {n}", rows, n, "mscm_grouped_kernel",
                     "the grouped kernel")
    return launches, tree, queries, counts


def quant_codes_check(torch, layer, d: int) -> None:
    """The card's int8/fp8 codes and scales, and its pruned re-pack, against
    the CPU's on one level: bitwise."""
    from repro_torch.quant.storage import prune_chunks, quantize_chunks

    cpu_vals = layer.chunk_vals.cpu()
    for dtype in ("int8", "fp8"):
        (qg, sg), (qc, sc) = quantize_chunks(layer.chunk_vals, dtype), quantize_chunks(
            cpu_vals, dtype)
        if not (torch.equal(qg.cpu().view(torch.uint8), qc.view(torch.uint8))
                and torch.equal(sg.cpu(), sc)):
            raise AssertionError(f"{dtype} codes or scales on the card differ from the CPU's")
    (rg, vg), (rc, vc) = (prune_chunks(layer.chunk_rows, layer.chunk_vals, 0.5, sentinel=d),
                          prune_chunks(layer.chunk_rows.cpu(), cpu_vals, 0.5, sentinel=d))
    if not (torch.equal(rg.cpu(), rc) and torch.equal(vg.cpu(), vc)):
        raise AssertionError("pruned re-pack on the card differs from the CPU's")
    c, r, b = layer.chunk_vals.shape
    log(f"  codes: int8 and fp8 codes and scales, and the pruned re-pack (R {r} -> "
        f"{rc.shape[1]}), of a level of {c} chunks x {r} x {b} equal the CPU's bitwise")


def quant(torch, mk, qk, gpu: str, tree, queries):
    """Phase 6: the quantized tiers on search-1m in batch. Returns the
    grouped_q kernel's launches on the int8 tier."""
    from repro_torch.quant import dequantize_tree, recall_at_k, score_mae
    from repro_torch.serving import QuantConfig, ServeConfig, XMRServingEngine

    quant_codes_check(torch, tree.layers[2], tree.d)
    n = queries.shape[0]
    n_batches = -(-n // SERVE["max_batch"])
    exact = XMRServingEngine(tree, ServeConfig(method="auto", **SERVE))
    exact.warmup(tree.d, batch_sizes=(64,))

    def build(tier):
        t0 = time.perf_counter()
        eng = XMRServingEngine(tree, ServeConfig(method="auto", quant=QuantConfig(tier=tier),
                                                 **SERVE))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if eng.method != "mscm_pallas_grouped_q":
            raise AssertionError(f"tier {tier}: method='auto' resolved to {eng.method!r}")
        eng.warmup(tree.d, batch_sizes=(64,))
        return eng, build_s

    def counted(eng, tier):
        """One serve_batch with the launch counts set to 0 just before."""
        qk.GROUPED_Q_LAUNCHES = mk.GROUPED_LAUNCHES = 0
        t0 = time.perf_counter()
        s, l = eng.serve_batch(queries)
        wall = time.perf_counter() - t0
        launches = (qk.GROUPED_Q_LAUNCHES, mk.GROUPED_LAUNCHES)
        if launches != (tree.depth * n_batches, 0):
            raise AssertionError(f"tier {tier}: (grouped_q, grouped) launches {launches}, "
                                 f"want {(tree.depth * n_batches, 0)}")
        if s.shape != (n, SERVE["topk"]) or not np.isfinite(s).all():
            raise AssertionError(f"tier {tier}: bad scores, shape {s.shape}")
        return s, l, wall, launches[0]

    def against_dequantized(eng, s, l, tier):
        deq = XMRServingEngine(dequantize_tree(eng.tree),
                               ServeConfig(method="mscm_pallas_grouped", **SERVE))
        s_d, l_d = deq.serve_batch(queries)
        if not (np.array_equal(l, l_d) and np.array_equal(s.view(np.uint32),
                                                          s_d.view(np.uint32))):
            raise AssertionError(f"tier {tier}: not bitwise mscm_pallas_grouped on the "
                                 "dequantized tree")

    def report(eng, tier, s, l, s_x, l_x, build_s):
        recall, mae = recall_at_k(l_x, l), score_mae(s_x, s)
        env = QUANT_ENVELOPE[tier]
        env_txt = (f"reference envelope on its quant-4k model: recall >= {env[0]}, MAE <= "
                   f"{env[1]}" if env else "the reference states no envelope for fp8")
        exact_b, q_b = tree.memory_bytes(), eng.tree.memory_bytes()
        log(f"  tier {tier}: recall@10 {recall:.6f}, score MAE {mae:.6e} against the exact "
            f"path ({env_txt}; reported, not gated: search-1m's weights are random); "
            f"memory_bytes {exact_b / 1e9:.4f} GB exact -> {q_b / 1e9:.4f} GB "
            f"({exact_b / q_b:.3f}x), leaf R {tree.layers[-1].chunk_vals.shape[1]} -> "
            f"{eng.tree.layers[-1].chunk_vals.shape[1]}; quantized on the card at engine "
            f"build in {build_s:.3f} s; bitwise mscm_pallas_grouped on the dequantized tree"
            f"  [{gpu}]")

    # int8: four serve_batch calls in turns with the exact path.
    eng, build_s = build("int8")
    s_x, l_x = exact.serve_batch(queries)  # the exact path's results
    walls = {"exact": [], "int8": []}
    s = None
    for which in ("exact", "int8", "int8", "exact", "exact", "int8", "int8", "exact"):
        if which == "int8" and s is None:
            torch.cuda.reset_peak_memory_stats()
            s, l, wall, launches = counted(eng, "int8")
            peak = torch.cuda.max_memory_allocated()
        else:
            t0 = time.perf_counter()
            (exact if which == "exact" else eng).serve_batch(queries)
            wall = time.perf_counter() - t0
        walls[which].append(wall)
    med = {k: float(np.median(v)) for k, v in walls.items()}
    log(f"  serve_batch {n} queries, tier int8 (method=auto -> {eng.method}, {n_batches} "
        f"batches of {SERVE['max_batch']}): {launches} grouped_q launches, 0 grouped; wall s "
        f"per call int8 {[round(w, 6) for w in walls['int8']]}, exact "
        f"{[round(w, 6) for w in walls['exact']]} (in turns); median "
        f"{1e3 * med['int8'] / n:.5f} ms/query int8 ({n / med['int8']:.1f} QPS) against "
        f"{1e3 * med['exact'] / n:.5f} exact ({n / med['exact']:.1f} QPS); peak device memory "
        f"{peak / 1e9:.3f} GB (exact and int8 trees resident)  [{gpu}]")
    against_dequantized(eng, s, l, "int8")
    report(eng, "int8", s, l, s_x, l_x, build_s)
    wall, acts, busy_us, rows = device_profile(lambda: eng.serve_batch(queries))
    log_profile("one serve_batch, tier int8", wall, acts, busy_us, rows, gpu, 12)
    log_block_kernel(f"one serve_batch of {n}, tier int8", rows, n, "mscm_grouped_kernel",
                     "the grouped_q kernel")
    del eng

    for tier in ("fp8", "int8_pruned"):
        eng, build_s = build(tier)
        s, l, _, _ = counted(eng, tier)
        against_dequantized(eng, s, l, tier)
        report(eng, tier, s, l, s_x, l_x, build_s)
        del eng
    return launches


def online(torch, mk, gpu: str, tree, queries):
    """Phase 7: the online setting, one query at a time. Returns the
    pregather kernel's launches on search-1m and the fused kernel's on
    search-32k."""
    from repro_torch.data.build import build_benchmark_tree
    from repro_torch.data.xmr_data import XMRShape, benchmark_queries
    from repro_torch.parity import check_ranking
    from repro_torch.serving import ServeConfig, XMRServingEngine

    n = ONLINE_QUERIES

    def serve(method, t, qs):
        """An engine for ``method`` on ``t``, warmed at bucket 1 (the online
        setting's only bucket), then ``n`` queries served one at a time with
        the launch counts set to 0 just before."""
        eng = XMRServingEngine(t, ServeConfig(method=method, **SERVE))
        eng.warmup(t.d)
        mk.FUSED_LAUNCHES = mk.PREGATHER_LAUNCHES = 0
        s, l = eng.serve_online(qs, limit=n)
        counts = (mk.FUSED_LAUNCHES, mk.PREGATHER_LAUNCHES)
        if s.shape != (n, SERVE["topk"]) or not np.isfinite(s).all():
            raise AssertionError(f"{method}: bad scores, shape {s.shape}")
        return eng, s, l, counts

    def expect(method, counts, want):
        if counts != want:
            raise AssertionError(f"{method}: (fused, pregather) launches {counts}, want {want}")

    # search-1m: the main path first, then the rest of the panel.
    runs = {m: serve(m, tree, queries) for m in ONLINE_PANEL}
    pregather = runs["mscm_pallas"][3][1]
    expect("mscm_pallas", runs["mscm_pallas"][3], (0, tree.depth * n))
    expect("mscm_pallas_pregather", runs["mscm_pallas_pregather"][3], (0, tree.depth * n))
    log(f"  search-1m serve_online {n} queries, method=mscm_pallas: d+1 = {tree.d + 1:,} > "
        f"VMEM_ROW_LIMIT, so pregather: {pregather} pregather launches, 0 fused  [{gpu}]")
    # A second pass in reverse order: the host-bound latencies drift with
    # the order the engines run in, and the two passes show by how much.
    for method in reversed(ONLINE_PANEL):
        runs[method][0].serve_online(queries, limit=n)
    _, s_ref, l_ref, _ = runs["mscm_dense"]
    p50 = {}
    for method, (eng, s, l, _) in runs.items():
        n_diff = check_ranking(s, l, s_ref, l_ref, f"search-1m online {method} vs mscm_dense")
        passes = np.asarray(eng.stats.per_query_ms).reshape(2, n)
        p50[method] = np.percentile(passes, 50, axis=1)
        p99 = np.percentile(passes, 99, axis=1)
        wall, acts, busy_us, rows = device_profile(
            lambda: eng.serve_online(queries, limit=PROFILED_QUERIES))
        log(f"  search-1m online {method}: p50 {p50[method][0]:.5f} / {p50[method][1]:.5f} ms, "
            f"p99 {p99[0]:.5f} / {p99[1]:.5f} ms per query over {n} (forward / reverse pass); "
            f"{acts / PROFILED_QUERIES:.1f} device activities and "
            f"{busy_us / 1e3 / PROFILED_QUERIES:.5f} ms device busy per query "
            f"({100 * busy_us / (1e6 * wall):.1f}% of the profiled wall of {PROFILED_QUERIES}); "
            f"max|score diff| vs mscm_dense {float(np.abs(s - s_ref).max()):.3e}, "
            f"{n_diff} near-tie label swaps  [{gpu}]")
        if method == "mscm_pallas":
            log_profile(f"{PROFILED_QUERIES} online queries, mscm_pallas", wall, acts, busy_us,
                        rows, gpu, 10)
            log_block_kernel("search-1m online mscm_pallas (pregather)", rows, PROFILED_QUERIES)
    ratio = p50["vanilla"] / p50["mscm_pallas"]
    log(f"  search-1m online p50 vanilla / mscm_pallas = {ratio[0]:.3f} / {ratio[1]:.3f} "
        f"(forward / reverse pass; the paper reports 7.28 / 0.88 ms = 8.3x on its "
        f"enterprise model on a CPU)  [{gpu}]")

    # search-32k: the --small model of examples/serve_search.py, whose d + 1
    # is under VMEM_ROW_LIMIT, so mscm_pallas takes the fused kernel.
    shape = XMRShape("search-32k", 337_067, 32_768, 10_000, 100, 64)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    tree32 = build_benchmark_tree(shape, 32, rng)
    torch.cuda.synchronize()
    log(f"  built {shape.name}: d={shape.d:,} L={shape.L:,} depth {tree32.depth}, "
        f"R={tree32.layers[-1].chunk_vals.shape[1]}, {tree32.memory_bytes() / 1e9:.3f} GB chunk "
        f"tiles, in {time.perf_counter() - t0:.1f} s (host)")
    q32 = benchmark_queries(shape, n, rng)
    eng, s, l, counts = serve("mscm_pallas", tree32, q32)
    fused = counts[0]
    expect("search-32k mscm_pallas", counts, (tree32.depth * n, 0))
    dense, s_d, l_d, _ = serve("mscm_dense", tree32, q32)
    n_diff = check_ranking(s, l, s_d, l_d, "search-32k online mscm_pallas vs mscm_dense")
    st, st_d = eng.latency_summary(), dense.latency_summary()
    log(f"  search-32k serve_online {n} queries, method=mscm_pallas: {fused} fused launches, "
        f"0 pregather; p50 {st['p50_ms']:.5f} ms, p99 {st['p99_ms']:.5f} ms per query "
        f"(mscm_dense p50 {st_d['p50_ms']:.5f}, p99 {st_d['p99_ms']:.5f}); agrees with "
        f"mscm_dense ({n_diff} near-tie label swaps)  [{gpu}]")
    wall, acts, busy_us, rows = device_profile(
        lambda: eng.serve_online(q32, limit=PROFILED_QUERIES))
    log_profile(f"{PROFILED_QUERIES} search-32k online queries, mscm_pallas", wall, acts,
                busy_us, rows, gpu, 6)
    log(f"  search-32k online mscm_pallas: {acts / PROFILED_QUERIES:.1f} device activities and "
        f"{busy_us / 1e3 / PROFILED_QUERIES:.5f} ms device busy per query")
    log_block_kernel("search-32k online mscm_pallas (fused)", rows, PROFILED_QUERIES)
    return pregather, fused


def zero_counts(mk, qk) -> None:
    """Set every kernel's launch count to 0."""
    mk.GROUPED_LAUNCHES = mk.FUSED_LAUNCHES = mk.PREGATHER_LAUNCHES = 0
    qk.GROUPED_Q_LAUNCHES = 0


def counts(mk, qk) -> dict:
    """Every kernel's launch count, by name."""
    return {"grouped": mk.GROUPED_LAUNCHES, "grouped_q": qk.GROUPED_Q_LAUNCHES,
            "fused": mk.FUSED_LAUNCHES, "pregather": mk.PREGATHER_LAUNCHES}


def serve_through_batcher(mb, queries, clients: int = 1, started: bool = False):
    """Submit every query as a ``Query`` (qid = its row), from ``clients``
    threads when the batcher is started, else before ``start()`` (then
    started); wait for every result and stop. Returns the results by qid
    and the wall seconds from the start (or the first submit) to the last
    result."""
    import threading

    from repro_torch.serving import Query

    n = queries.shape[0]
    futs = [None] * n

    def client(rows):
        for i in rows:
            futs[i] = mb.submit(Query(*queries.row(i), qid=i))

    try:
        if started:
            mb.start()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(range(c, n, clients),))
                       for c in range(clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=SERVER_TIMEOUT_S)
            if any(th.is_alive() for th in threads):
                raise AssertionError("a client thread did not finish submitting")
        else:
            client(range(n))
            t0 = time.perf_counter()
            mb.start()
        res = [f.result(timeout=SERVER_TIMEOUT_S) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        mb.stop()
    if [r.qid for r in res] != list(range(n)):
        raise AssertionError("results lost their qids")
    return res, wall


def held_bitwise(res, s, l, what: str, rows=None) -> None:
    """Raise unless every result is ``ok`` and bitwise row ``qid`` of
    ``(s, l)`` (or of the rows ``rows`` names)."""
    for r in res:
        i = r.qid if rows is None else rows[r.qid]
        if not r.ok:
            raise AssertionError(f"{what}: qid {r.qid} status {r.status} ({r.detail})")
        if not (np.array_equal(r.ids, l[i]) and np.array_equal(
                np.asarray(r.scores).view(np.uint32), s[i].view(np.uint32))):
            raise AssertionError(f"{what}: qid {r.qid} is not bitwise serve_batch's row {i}")


def server_readings(metrics) -> str:
    """Queue wait and compute p50/p99, QPS (goodput), triggers and bucket
    occupancy of a ``ServerMetrics``."""
    s = metrics.summary()
    wait, comp = np.asarray(metrics.queue_wait_ms), np.asarray(metrics.compute_ms)
    occ = sum(metrics.batch_sizes) / max(sum(metrics.bucket_sizes), 1)
    return (f"{s['count']} served, {s['batches']} batches (sizes {metrics.batch_sizes}), "
            f"queue wait p50 {np.percentile(wait, 50):.5f} / p99 {np.percentile(wait, 99):.5f} "
            f"ms, compute p50 {np.percentile(comp, 50):.5f} / p99 {np.percentile(comp, 99):.5f} "
            f"ms a batch, e2e p50 {s['p50_ms']:.5f} / p99 {s['p99_ms']:.5f} ms, "
            f"{s['qps']:.1f} QPS (goodput), triggers {s['triggers']}, bucket occupancy "
            f"{occ:.4f}, shed {s['shed']}")


def server(torch, mk, qk, gpu: str, tree, queries) -> tuple:
    """Phase 8: the serving front end on search-1m: 256 queries through a
    ``MicroBatcher`` from 4 client threads (exact tier), 512 at a bounded
    queue (overload), a burst under an SLO ladder, and the int8 tier. Each
    part counts launches from the end of its warm-up and calibration.
    Returns the grouped and grouped_q kernels' launches."""
    from repro_torch.quant import recall_at_k
    from repro_torch.serving import (AdmissionConfig, BatchPolicy, MicroBatcher, QuantConfig,
                                     ServeConfig, SLOConfig, XMRServingEngine)

    n, depth = queries.shape[0], tree.depth
    policy = BatchPolicy(max_batch=SERVE["max_batch"], max_wait_ms=2.0)

    def expect(part, got, grouped=0, grouped_q=0):
        want = {"grouped": grouped, "grouped_q": grouped_q, "fused": 0, "pregather": 0}
        if got != want:
            raise AssertionError(f"server {part}: launches {got}, want {want}")

    # 1. Exact tier, 4 client threads.
    eng = XMRServingEngine(tree, ServeConfig(method="auto", **SERVE))
    if eng.method != "mscm_pallas_grouped":
        raise AssertionError(f"method='auto' resolved to {eng.method!r} on the GPU")
    warm = {}
    for b in (1, 2, 4, 8, 16, 32, 64):
        t0 = time.perf_counter()
        eng.warmup(tree.d, (b,))
        warm[b] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    eng.warmup_buckets(tree.d, SERVE["max_batch"])  # what start() runs
    again = 1e3 * (time.perf_counter() - t0)
    cost0 = 1e3 * eng.measure_batch_seconds(SERVE["max_batch"])
    log(f"  exact tier: first run of each bucket (ms) "
        f"{ {b: round(ms, 3) for b, ms in warm.items()} }; warmup_buckets(1-64) again "
        f"{again:.3f} ms; a 64-query batch at tier 0 {cost0:.5f} ms (measure_batch_seconds)"
        f"  [{gpu}]")
    t0 = time.perf_counter()
    s_x, l_x = eng.serve_batch(queries)
    batch_wall = time.perf_counter() - t0
    mb = MicroBatcher(eng, policy, warmup_on_start=False)
    zero_counts(mk, qk)
    res, wall = serve_through_batcher(mb, queries, clients=4, started=True)
    got = counts(mk, qk)
    batches = len(mb.metrics.batch_sizes)
    expect("exact tier", got, grouped=depth * batches)
    held_bitwise(res, s_x, l_x, "server exact tier")
    exact_launches = got["grouped"]
    log(f"  exact tier, 4 client threads: {server_readings(mb.metrics)}; wall {1e3 * wall:.3f}"
        f" ms from start to the last result (serve_batch of the same {n}: "
        f"{1e3 * batch_wall:.3f} ms); {exact_launches} grouped launches ({depth} a batch), "
        f"none of another kernel; every result ok and bitwise serve_batch's  [{gpu}]")
    profiled = MicroBatcher(eng, policy, warmup_on_start=False)
    wall, acts, busy_us, rows = device_profile(
        lambda: serve_through_batcher(profiled, queries, clients=4, started=True))
    log_profile("256 queries through the batcher, 4 clients", wall, acts, busy_us, rows, gpu, 8)
    if busy_us:
        log(f"  batcher, profiled: device busy {busy_us / 1e3:.3f} ms of {1e3 * wall:.3f} ms wall,"
            f" idle share {1 - busy_us / (1e6 * wall):.4f}  [{gpu}]")

    # 2. Overload: 512 enqueued before start at a bound of 64, reject.
    eng_o = XMRServingEngine(tree, ServeConfig(
        method="auto", admission=AdmissionConfig(queue_depth=SERVE["max_batch"],
                                                 shed_policy="reject"), **SERVE))
    eng_o.warmup_buckets(tree.d, SERVE["max_batch"])
    twice = queries.slice_rows(np.concatenate([np.arange(n), np.arange(n)]))
    mb = MicroBatcher(eng_o, policy, warmup_on_start=False)
    zero_counts(mk, qk)
    res, _ = serve_through_batcher(mb, twice)
    got = counts(mk, qk)
    expect("overload", got, grouped=depth)
    ok = [r for r in res if r.ok]
    shed = [r for r in res if r.status == "overloaded" and r.http_status == 429]
    summ = mb.metrics.summary()
    if ([r.qid for r in ok] != list(range(SERVE["max_batch"])) or len(shed) != 2 * n - len(ok)
            or summ["shed"] != len(shed)):
        raise AssertionError(f"overload: {len(ok)} ok, {len(shed)} overloaded, summary shed "
                             f"{summ['shed']}; want 64, 448, 448")
    held_bitwise(ok, s_x, l_x, "server overload")
    log(f"  overload (queue_depth 64, reject, {2 * n} enqueued before start): {len(ok)} ok "
        f"bitwise, {len(shed)} overloaded (HTTP 429), shed {summ['shed']}, shed rate "
        f"{summ['shed_rate']:.4f}; {got['grouped']} grouped launches  [{gpu}]")

    # 3. SLO ladder: a burst of 256 at a target of about 2 batches.
    target = 2.0 * cost0
    eng_s = XMRServingEngine(tree, ServeConfig(method="auto", slo=SLOConfig(target_p99_ms=target),
                                               **SERVE))
    ladder = [t.beam for t in eng_s.tiers]
    eng_s.warmup_buckets(tree.d, SERVE["max_batch"])  # every (bucket, tier)
    probe = eng_s.measure_batch_seconds

    def probe_then_zero(*args, **kwargs):
        """start()'s calibration probe; the counts restart after each."""
        out = probe(*args, **kwargs)
        zero_counts(mk, qk)
        return out

    eng_s.measure_batch_seconds = probe_then_zero
    mb = MicroBatcher(eng_s, policy, warmup_on_start=False)
    res, _ = serve_through_batcher(mb, queries)
    got = counts(mk, qk)
    batches = len(mb.metrics.batch_sizes)
    expect("SLO ladder", got, grouped=depth * batches)
    summ, tq = mb.metrics.summary(), dict(mb.metrics.tier_queries)
    if summ["shed"] or not any(t > 0 for t in tq) or sum(tq.values()) != n:
        raise AssertionError(f"SLO ladder: shed {summ['shed']}, tier queries {tq}")
    plain = {}
    for k, beam in enumerate(ladder):
        e = XMRServingEngine(tree, ServeConfig(method="auto", **dict(SERVE, beam=beam)))
        plain[k] = e.serve_batch(queries)
    for r in res:
        if r.beam_tier not in plain:
            raise AssertionError(f"SLO ladder: qid {r.qid} at tier {r.beam_tier}")
        held_bitwise([r], *plain[r.beam_tier], f"server SLO tier {r.beam_tier}")
    recall = {ladder[k]: recall_at_k(plain[0][1], plain[k][1]) for k in plain if k}
    slo_launches = got["grouped"]
    log(f"  SLO ladder (target_p99_ms {target:.5f} = 2 x tier 0's batch): beams {ladder}, "
        f"calibrated cost_ms {[round(c, 5) for c in mb.tier_policy.cost_ms]}; burst of {n}: "
        f"queries by tier {tq}, {server_readings(mb.metrics)}; every result bitwise a no-SLO "
        f"engine at its tier's beam; {slo_launches} grouped launches; recall@10 against tier 0 "
        f"by beam {recall}  [{gpu}]")

    # 4. int8 tier.
    eng_q = XMRServingEngine(tree, ServeConfig(method="auto", quant=QuantConfig(tier="int8"),
                                               **SERVE))
    eng_q.warmup_buckets(tree.d, SERVE["max_batch"])
    s_q, l_q = eng_q.serve_batch(queries)
    mb = MicroBatcher(eng_q, policy, warmup_on_start=False)
    zero_counts(mk, qk)
    res, wall = serve_through_batcher(mb, queries)
    got = counts(mk, qk)
    expect("int8 tier", got, grouped_q=depth * len(mb.metrics.batch_sizes))
    held_bitwise(res, s_q, l_q, "server int8 tier")
    log(f"  int8 tier, {n} enqueued before start: {server_readings(mb.metrics)}; wall "
        f"{1e3 * wall:.3f} ms from start to the last result; {got['grouped_q']} grouped_q "
        f"launches, none of another kernel; every result bitwise serve_batch's  [{gpu}]")
    return exact_launches + depth + slo_launches, got["grouped_q"]


def device_slots(torch, n: int) -> list:
    """``n`` device slots over the visible cards, each card named in turn
    (``cuda:0`` n times on a one-card machine)."""
    cards = torch.cuda.device_count()
    return [f"cuda:{i % cards}" for i in range(n)]


def partition(torch, mk, qk, gpu: str, tree, queries) -> tuple:
    """Phase 9: the label-partitioned index on search-1m at full width, P =
    PARTITIONS (split level 1): ``serve_batch`` of the queries through
    ``level`` and ``pipelined`` (bitwise the unpartitioned engine), the
    pipelined mode with a hot-beam cache (bitwise, cold and hot), ``final``
    (every score at least the exact one, recall@10), the int8 tier (bitwise
    the f32 planner on the dequantized parts), ``partitions=2, shards=2``
    through the ``MicroBatcher`` on four device slots (bitwise); launches
    counted from 0 before each part; ms/query against the unpartitioned
    engine in turns, with device activities and idle share. Returns the
    grouped and grouped_q kernels' launches in the counted parts."""
    import dataclasses

    from repro_torch.index import ScatterGatherPlanner
    from repro_torch.quant import dequantize_tree, recall_at_k
    from repro_torch.serving import (BatchPolicy, MicroBatcher, PartitionConfig, QuantConfig,
                                     ServeConfig, XMRServingEngine)

    n, depth, P = queries.shape[0], tree.depth, PARTITIONS
    mb_size = SERVE["max_batch"]
    batches = -(-n // mb_size)
    exact = XMRServingEngine(tree, ServeConfig(method="auto", **SERVE))
    exact.warmup(tree.d, (mb_size,))
    s_x, l_x = exact.serve_batch(queries)
    launches = {"grouped": 0, "grouped_q": 0}

    def build(what, devices=None, quant=None, shards=1, **part):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = XMRServingEngine(tree, ServeConfig(
            method="auto", shards=shards, partition=PartitionConfig(**part),
            quant=quant or QuantConfig(), **SERVE), devices=devices)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        eng.warmup_buckets(tree.d, mb_size)
        m = eng.index.manifest
        log(f"  {what}: built in {build_s:.3f} s (cut, content hashes, placement), "
            f"{eng.placement.mesh.shape} mesh, split level {m.level}, peak device memory "
            f"{peak / 1e9:.3f} GB over the {base / 1e9:.3f} GB resident before; partition "
            f"memory_bytes {[round(p.memory_bytes / 1e9, 4) for p in m.partitions]} GB, "
            f"router {m.router_memory_bytes / 1e6:.3f} MB, shrink_ratio {m.shrink_ratio():.3f}"
            f"  [{gpu}]")
        return eng

    def served(eng, what, grouped=0, grouped_q=0, at_most=False):
        """One serve_batch of every query, launch counts from 0 just before."""
        zero_counts(mk, qk)
        t0 = time.perf_counter()
        s, l = eng.serve_batch(queries)
        wall = time.perf_counter() - t0
        got = counts(mk, qk)
        want = {"grouped": grouped, "grouped_q": grouped_q, "fused": 0, "pregather": 0}
        ok = (all(got[k] <= want[k] for k in want) and got["grouped"] >= batches
              if at_most else got == want)
        if not ok:
            raise AssertionError(f"partition {what}: launches {got}, want "
                                 f"{'at most ' if at_most else ''}{want}")
        launches["grouped"] += got["grouped"]
        launches["grouped_q"] += got["grouped_q"]
        if s.shape != (n, SERVE["topk"]) or not np.isfinite(s).all():
            raise AssertionError(f"partition {what}: bad scores, shape {s.shape}")
        return s, l, wall, got

    def bitwise(s, l, s_w, l_w, what):
        if not (np.array_equal(l, l_w) and np.array_equal(s.view(np.uint32),
                                                          s_w.view(np.uint32))):
            raise AssertionError(f"partition {what}: not bitwise the unpartitioned engine")

    per_bucket = 1 + (depth - 1) * P  # router + one launch a partition a level
    engines = {}
    # 1. level and pipelined: bitwise, 1 + 3 P grouped launches a bucket.
    for sync in ("level", "pipelined"):
        eng = build(f"P={P} {sync}", partitions=P, partition_sync=sync)
        s, l, wall, got = served(eng, sync, grouped=batches * per_bucket)
        bitwise(s, l, s_x, l_x, sync)
        engines[sync] = eng
        log(f"  P={P} {sync}: serve_batch of {n} bitwise the unpartitioned engine; "
            f"{got['grouped']} grouped launches ({got['grouped'] // batches} a bucket of "
            f"{mb_size}, unpartitioned {depth}); wall {1e3 * wall:.3f} ms  [{gpu}]")
    # 2. pipelined with the hot-beam cache, cold then hot.
    eng = build(f"P={P} pipelined, beam_cache=256", partitions=P, partition_sync="pipelined",
                beam_cache=256)
    for run in ("cold", "hot"):
        s, l, _, got = served(eng, f"cache {run}", grouped=batches * per_bucket, at_most=True)
        bitwise(s, l, s_x, l_x, f"cache {run}")
        log(f"  beam_cache=256, {run}: bitwise; {got['grouped']} grouped launches; cache "
            f"{eng.beam_cache_stats()}  [{gpu}]")
    del eng
    # 3. final: one merge; dominates the exact result.
    eng = build(f"P={P} final", partitions=P, partition_sync="final")
    s, l, _, got = served(eng, "final", grouped=batches * per_bucket)
    if not (s >= s_x).all():
        raise AssertionError("partition final: a merged score under its exact counterpart")
    log(f"  final: every merged score >= its exact counterpart ({int((s > s_x).sum())} of "
        f"{s.size} above); recall@10 against exact {recall_at_k(l_x, l):.6f}; "
        f"{got['grouped']} grouped launches  [{gpu}]")
    del eng
    # 4. int8: the router f32 through grouped, every partition through grouped_q.
    eng = build(f"P={P} int8", partitions=P, quant=QuantConfig(tier="int8"))
    s_q, l_q, _, got = served(eng, "int8", grouped=batches,
                              grouped_q=batches * (depth - 1) * P)
    deq = dataclasses.replace(eng.index, parts=[dequantize_tree(p) for p in eng.index.parts])
    pl = ScatterGatherPlanner(deq, beam=SERVE["beam"], topk=SERVE["topk"],
                              method="mscm_pallas_grouped", placement=eng.placement)
    out_s, out_l = [], []
    for i in range(0, n, mb_size):
        xi, xv = exact.marshal_rows(queries, np.arange(i, min(n, i + mb_size)), mb_size)
        sd, ld = pl.infer(xi, xv)
        out_s.append(sd[:n - i].cpu().numpy())
        out_l.append(ld[:n - i].cpu().numpy())
    bitwise(s_q, l_q, np.concatenate(out_s), np.concatenate(out_l), "int8 vs dequantized")
    m = eng.index.manifest
    log(f"  int8: {got['grouped_q']} grouped_q launches ({got['grouped_q'] // batches} a "
        f"bucket), {got['grouped']} grouped (the f32 router); bitwise the f32 planner on the "
        f"dequantized parts; recall@10 against exact {recall_at_k(l_x, l_q):.6f}; "
        f"memory_bytes per partition {[p.memory_bytes for p in m.partitions]} "
        f"({m.partitions[0].dtype}, tier {m.partitions[0].tier}), shrink_ratio "
        f"{m.shrink_ratio():.3f}  [{gpu}]")
    del eng, deq, pl
    # 5. partitions=2, shards=2 through the batcher, on four device slots.
    slots = device_slots(torch, 4)
    eng = build(f"P=2 shards=2 on {slots}", devices=slots, shards=2, partitions=2)
    mb = MicroBatcher(eng, BatchPolicy(max_batch=mb_size, max_wait_ms=2.0),
                      warmup_on_start=False)
    zero_counts(mk, qk)
    res, wall = serve_through_batcher(mb, queries, clients=4, started=True)
    got = counts(mk, qk)
    nb = len(mb.metrics.batch_sizes)
    if got != {"grouped": nb * (1 + (depth - 1) * 2 * 2), "grouped_q": 0, "fused": 0,
               "pregather": 0}:
        raise AssertionError(f"partition P=2 shards=2: launches {got} for {nb} batches")
    launches["grouped"] += got["grouped"]
    held_bitwise(res, s_x, l_x, "partition P=2 shards=2")
    summ = mb.metrics.summary()
    log(f"  P=2 shards=2, 4 client threads: every result bitwise the unpartitioned "
        f"engine's; {server_readings(mb.metrics)}; partition_occupancy "
        f"{summ['partition_occupancy']}, replica_occupancy {summ['replica_occupancy']}, "
        f"pipeline_stall avg / p99 {summ['pipeline_stall_avg_ms']:.5f} / "
        f"{summ['pipeline_stall_p99_ms']:.5f} ms; {got['grouped']} grouped launches "
        f"({got['grouped'] // nb} a batch); wall {1e3 * wall:.3f} ms  [{gpu}]")
    del eng, mb
    # 6. ms/query in turns: unpartitioned, level, pipelined, pipelined on one
    # stream a partition (P + 1 slots of this card).
    engines["pipelined, P+1 slots"] = build(
        f"P={P} pipelined on {P + 1} slots", devices=device_slots(torch, P + 1)[:1] * (P + 1),
        partitions=P, partition_sync="pipelined")
    s, l, _, _ = served(engines["pipelined, P+1 slots"], "pipelined, P+1 slots",
                        grouped=batches * per_bucket)
    bitwise(s, l, s_x, l_x, "pipelined on P+1 slots")
    runs = {"unpartitioned": exact, **engines}
    walls = {k: [] for k in runs}
    for r in range(4):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            t0 = time.perf_counter()
            runs[k].serve_batch(queries)
            walls[k].append(time.perf_counter() - t0)
    for k, w in walls.items():
        log(f"  {k}: serve_batch of {n}, wall s {[round(x, 6) for x in w]}, median "
            f"{1e3 * float(np.median(w)) / n:.5f} ms/query  [{gpu}]")
    for k in ("unpartitioned", "level", "pipelined"):
        wall, acts, busy_us, rows = device_profile(lambda: runs[k].serve_batch(queries))
        log_profile(f"one {k} serve_batch of {n}", wall, acts, busy_us, rows, gpu, 8)
        log_block_kernel(f"{k}, one serve_batch of {n}", rows, n, "mscm_grouped_kernel",
                         "the grouped kernel")
        if busy_us:
            log(f"  {k}: {acts} device activities, busy {busy_us / 1e3:.3f} ms of "
                f"{1e3 * wall:.3f} ms wall, idle share {1 - busy_us / (1e6 * wall):.4f}"
                f"  [{gpu}]")
    return launches["grouped"], launches["grouped_q"]


def http(url: str, doc=None):
    """GET ``url`` (or POST ``doc`` as JSON): (HTTP status, JSON body), for
    any status."""
    import urllib.error
    import urllib.request

    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=SERVER_TIMEOUT_S) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as err:
        return err.code, json.load(err)


class ThreadWorkers:
    """Fleet workers serving ``repro_torch.serving.fleet.worker.
    _serve_connection`` on localhost sockets in threads of this process, on
    ``device``: the worker's own loop without the process, so that this
    process's launch counts see the workers' kernels."""

    def __init__(self, n: int, device: str):
        import socket
        import threading

        from repro_torch.serving.fleet.worker import _serve_connection

        self.servers, self.threads = [], []
        for _ in range(n):
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.bind(("127.0.0.1", 0))
            srv.listen(1)
            t = threading.Thread(target=self._serve, daemon=True, args=(
                srv, {"runner": None, "device": device}, _serve_connection))
            t.start()
            self.servers.append(srv)
            self.threads.append(t)
        self.addresses = [("127.0.0.1", s.getsockname()[1]) for s in self.servers]

    @staticmethod
    def _serve(srv, state, serve_connection):
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return  # closed
            try:
                if serve_connection(conn, state):
                    return
            finally:
                conn.close()

    def close(self):
        import socket

        for s in self.servers:
            try:
                s.shutdown(socket.SHUT_RDWR)  # wakes a thread blocked in accept()
            except OSError:
                pass
            s.close()
        for t in self.threads:
            t.join(timeout=SERVER_TIMEOUT_S)
        if any(t.is_alive() for t in self.threads):
            raise AssertionError("a thread worker did not stop")


def proc_memory(pid) -> str:
    """Resident host memory of a process (GB) from /proc: now (VmRSS, else
    statm's resident pages) and its peak (VmHWM) where the kernel reports
    one."""
    import os

    fields = {}
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key in ("VmHWM", "VmRSS"):
                fields[key] = int(value.split()[0]) * 1024 / 1e9
    if "VmRSS" not in fields:
        with open(f"/proc/{pid}/statm") as f:
            fields["VmRSS"] = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9
    peak = f"{fields['VmHWM']:.3f}" if "VmHWM" in fields else "not measured"
    return f"now {fields['VmRSS']:.3f} GB, peak {peak}"


def fleet(torch, mk, qk, gpu: str, tree, queries) -> tuple:
    """Phase 10: search-1m's P = 4 partitions (split level 1, pipelined)
    served by fleet workers, in three parts. (1) Launch counts: 4 workers in
    threads of this process on the card, over sockets, the int8 tier then
    the exact one, each bitwise the in-process pipelined engine (13 grouped
    launches a bucket exact; 1 grouped and 12 grouped_q int8). (2) Worker
    processes on the card (``PartitionFleet.launch(4)``): launch and load
    seconds, bytes a partition, host memory; ms/query against the in-process
    pipelined engine in turns; the 256 queries as HTTP posts through a
    ``MicroBatcher(64, 2 ms)`` and ``ServingGateway`` from 4 client threads,
    every answer 200 and bitwise; ``/healthz`` and ``/metrics``. (3)
    Failures: ``reject`` -> a typed 503 and ``/healthz`` 503; a manual
    respawn; ``serve_partial`` under a ``FleetSupervisor``: a killed worker
    degrades results, bitwise the thread workers with that partition down,
    then the supervisor respawns it and results are bitwise the full ones
    again; then the int8 tier through the processes, bitwise, and fp8
    refused by ``partition_payload``. Returns the grouped and grouped_q
    launches of part 1."""
    import dataclasses
    import threading

    from repro_torch.quant.storage import quantize_tree
    from repro_torch.serving import (BatchPolicy, FleetConfig, MicroBatcher, PartitionConfig,
                                     QuantConfig, Query, ServeConfig, ServingGateway,
                                     XMRServingEngine)
    from repro_torch.serving.fleet import FleetSupervisor, PartitionFleet, partition_payload

    n, depth, P = queries.shape[0], tree.depth, PARTITIONS
    mb_size = SERVE["max_batch"]
    batches = -(-n // mb_size)
    per_bucket = 1 + (depth - 1) * P
    part = PartitionConfig(partitions=P, partition_sync="pipelined")

    def bitwise(s, l, s_w, l_w, what):
        if s.shape != (n, SERVE["topk"]) or not np.isfinite(s).all():
            raise AssertionError(f"fleet {what}: bad scores, shape {s.shape}")
        if not (np.array_equal(l, l_w) and np.array_equal(s.view(np.uint32),
                                                          s_w.view(np.uint32))):
            raise AssertionError(f"fleet {what}: not bitwise")

    def counted(eng, what, grouped, grouped_q=0):
        zero_counts(mk, qk)
        s, l = eng.serve_batch(queries)
        got = counts(mk, qk)
        want = {"grouped": grouped, "grouped_q": grouped_q, "fused": 0, "pregather": 0}
        if got != want:
            raise AssertionError(f"fleet {what}: launches {got}, want {want}")
        return s, l

    plain = XMRServingEngine(tree, ServeConfig(method="auto", **SERVE))
    s_x, l_x = plain.serve_batch(queries)
    t0 = time.perf_counter()
    exact = XMRServingEngine(tree, ServeConfig(method="auto", partition=part, **SERVE))
    int8 = XMRServingEngine(tree, ServeConfig(method="auto", partition=part,
                                              quant=QuantConfig(tier="int8"), **SERVE))
    torch.cuda.synchronize()
    dev = str(exact.device)  # the coordinator's card; the workers' too
    log(f"  built the exact and int8 P={P} pipelined engines in "
        f"{time.perf_counter() - t0:.3f} s  [{gpu}]")
    s_p, l_p = exact.serve_batch(queries)
    bitwise(s_p, l_p, s_x, l_x, "in-process pipelined vs unpartitioned")
    s_qi, l_qi = int8.serve_batch(queries)

    # 1. Launch counts: the workers' own loop in threads of this process.
    threads = ThreadWorkers(P, dev)
    local = PartitionFleet.connect(threads.addresses, rpc_timeout_s=SERVER_TIMEOUT_S)
    fleet_launches = {"grouped": 0, "grouped_q": 0}
    try:
        for eng, what, want in ((int8, "int8", dict(grouped=batches,
                                                     grouped_q=batches * (depth - 1) * P)),
                                (exact, "exact", dict(grouped=batches * per_bucket))):
            t0 = time.perf_counter()
            local.attach(eng)
            ship = time.perf_counter() - t0
            eng.warmup(tree.d, (mb_size,))
            s, l = counted(eng, f"thread workers {what}", **want)
            bitwise(s, l, *((s_qi, l_qi) if what == "int8" else (s_x, l_x)),
                    f"thread workers {what}")
            for k in fleet_launches:
                fleet_launches[k] += want.get(k, 0)
            log(f"  {P} thread workers on {dev}, {what}: shipped in {ship:.3f} s over "
                f"localhost; serve_batch of {n} bitwise the in-process pipelined engine; "
                f"launches {want} ({ {k: v // batches for k, v in want.items()} } a bucket of "
                f"{mb_size}), none of another kernel  [{gpu}]")
        exact.planner.set_transport(None)

        # 2. Worker processes on the card.
        t0 = time.perf_counter()
        procs = PartitionFleet.launch(P, rpc_timeout_s=SERVER_TIMEOUT_S)
        t_launch = time.perf_counter() - t0
        try:
            part_bytes = [sum(t.numel() * t.element_size() for lay in p.layers
                              for t in (lay.chunk_rows, lay.chunk_vals, lay.col_rows, lay.col_vals))
                          for p in exact.index.parts]
            rss0 = proc_memory("self")
            t0 = time.perf_counter()
            procs.attach(exact)
            t_load = time.perf_counter() - t0
            log(f"  {P} worker processes (python -m repro_torch.serving.fleet.worker, "
                f"device default, the card): launched and announced in {t_launch:.3f} s; "
                f"load of {sum(part_bytes) / 1e9:.4f} GB ({[round(b / 1e9, 4) for b in part_bytes]}"
                f" GB a partition, chunk tiles and the per-column layout) in {t_load:.3f} s, "
                f"{sum(part_bytes) / 1e9 / t_load:.3f} GB/s; coordinator host memory before "
                f"{rss0}, after {proc_memory('self')}; workers "
                f"{[proc_memory(h.proc.pid) for h in procs.handles]}  [{gpu}]")
            exact.warmup(tree.d, (mb_size,))
            s, l = exact.serve_batch(queries)
            bitwise(s, l, s_x, l_x, "worker processes")
            walls = {"unpartitioned": [], "in-process pipelined": [], "worker processes": []}
            for r in range(4):
                order = list(walls) if r % 2 == 0 else list(walls)[::-1]
                for k in order:
                    exact.planner.set_transport(procs if k == "worker processes" else None)
                    t0 = time.perf_counter()
                    (plain if k == "unpartitioned" else exact).serve_batch(queries)
                    walls[k].append(time.perf_counter() - t0)
            exact.planner.set_transport(procs)
            for k, w in walls.items():
                log(f"  {k}: serve_batch of {n}, wall s {[round(x, 6) for x in w]}, median "
                    f"{1e3 * float(np.median(w)) / n:.5f} ms/query  [{gpu}]")
            # Where a fleet bucket's wall goes, seen from the coordinator: its
            # begin and step exchanges (frames out, the workers' levels,
            # replies back), the rest being the router, marshalling, the
            # router's read-back and the merges.
            spent = {"begin": [], "step": []}
            for name in spent:
                def timed(*a, _call=getattr(procs, name), _out=spent[name], **k):
                    t = time.perf_counter()
                    out = _call(*a, **k)
                    _out.append(time.perf_counter() - t)
                    return out
                setattr(procs, name, timed)
            t0 = time.perf_counter()
            exact.serve_batch(queries)
            total = time.perf_counter() - t0
            for name in spent:
                delattr(procs, name)
            rest = total - sum(map(sum, spent.values()))
            log(f"  worker processes, one serve_batch of {n} ({batches} buckets): wall "
                f"{1e3 * total:.3f} ms; begin exchanges {[round(1e3 * x, 3) for x in spent['begin']]}"
                f" ms, step exchanges {[round(1e3 * x, 3) for x in spent['step']]} ms; the rest "
                f"(router, marshalling, read-backs, merges) {1e3 * rest:.3f} ms  [{gpu}]")

            # HTTP: 256 posts from 4 client threads.
            mb = MicroBatcher(exact, BatchPolicy(max_batch=mb_size, max_wait_ms=2.0))
            with mb, ServingGateway(mb, fleet=procs) as gw:
                code, doc = http(gw.url + "/healthz")
                if code != 200 or doc["status"] != "ok" or doc["workers"] != {
                        f"worker{i}": True for i in range(P)}:
                    raise AssertionError(f"fleet /healthz before traffic: {code} {doc}")
                docs, e2e = [None] * n, [0.0] * n

                def client(rows):
                    for i in rows:
                        t = time.perf_counter()
                        docs[i] = http(gw.url + "/v1/query",
                                       Query(*queries.row(i), qid=i).to_wire())
                        e2e[i] = 1e3 * (time.perf_counter() - t)

                t0 = time.perf_counter()
                clients = [threading.Thread(target=client, args=(range(c, n, 4),))
                           for c in range(4)]
                for c in clients:
                    c.start()
                for c in clients:
                    c.join(timeout=SERVER_TIMEOUT_S)
                wall = time.perf_counter() - t0
                if any(c.is_alive() for c in clients):
                    raise AssertionError("fleet: an HTTP client did not finish")
                for i, (code, doc) in enumerate(docs):
                    if code != 200 or doc["status"] != "ok" or doc["qid"] != i:
                        raise AssertionError(f"fleet HTTP qid {i}: {code} {doc}")
                    got_s = np.asarray(doc["scores"], np.float32)
                    if not (np.array_equal(np.asarray(doc["ids"]), l_x[i])
                            and np.array_equal(got_s.view(np.uint32), s_x[i].view(np.uint32))):
                        raise AssertionError(f"fleet HTTP qid {i}: not bitwise serve_batch's")
                code, mdoc = http(gw.url + "/metrics")
                if code != 200 or mdoc["count"] != n:
                    raise AssertionError(f"fleet /metrics: {code} count {mdoc.get('count')}")
                log(f"  HTTP through the gateway, {n} posts from 4 client threads: every answer "
                    f"200 and bitwise serve_batch's through JSON; client e2e p50 / p99 "
                    f"{np.percentile(e2e, 50):.3f} / {np.percentile(e2e, 99):.3f} ms, "
                    f"{n / wall:.1f} QPS over {1e3 * wall:.3f} ms; server "
                    f"{server_readings(mb.metrics)}; partition_occupancy "
                    f"{mdoc['partition_occupancy']}  [{gpu}]")

                # 3. Failures. reject: a dead worker fails queries typed.
                procs.degraded_policy = "reject"
                procs.handles[0].kill()
                t0 = time.perf_counter()
                code, doc = http(gw.url + "/v1/query", Query(*queries.row(0), qid=0).to_wire())
                t_503 = time.perf_counter() - t0
                if not (code == 503 and doc["status"] == "worker_unavailable"
                        and "worker0" in doc["detail"] and t_503 < 60):
                    raise AssertionError(f"fleet reject: {code} {doc} in {t_503:.3f} s")
                hcode, hdoc = http(gw.url + "/healthz")
                if hcode != 503 or hdoc["status"] != "degraded" or hdoc["workers"]["worker0"]:
                    raise AssertionError(f"fleet reject /healthz: {hcode} {hdoc}")
                t0 = time.perf_counter()
                procs.respawn_worker(0)
                t_manual = time.perf_counter() - t0
                s, l = exact.serve_batch(queries)
                bitwise(s, l, s_x, l_x, "after a manual respawn")
                log(f"  reject: worker0 killed; a post answered 503 worker_unavailable in "
                    f"{1e3 * t_503:.3f} ms ({doc['detail']!r}); /healthz {hcode} "
                    f"{hdoc['status']!r}; respawn_worker(0) (launch and re-ship) in "
                    f"{t_manual:.3f} s, then bitwise again  [{gpu}]")

                # serve_partial under the supervisor.
                procs.degraded_policy = "serve_partial"
                cfg = FleetConfig(poll_interval_s=0.05, ping_timeout_s=5.0, suspect_after=1,
                                  backoff_base_s=0.05, restart_budget=3)
                dead = 2
                with FleetSupervisor(procs, cfg) as sup:
                    t_kill = time.perf_counter()
                    procs.handles[dead].proc.kill()
                    s, l = exact.serve_batch(queries)
                    info = exact.last_degraded()
                    lo, hi = exact.index.label_ranges()[dead]
                    if info is None or info["partitions"] != [dead]:
                        raise AssertionError(f"fleet serve_partial: degraded info {info}")
                    if ((l >= lo) & (l < hi)).any():
                        raise AssertionError("fleet serve_partial: a label of the dead range")
                    local.mark_down(dead)
                    exact.planner.set_transport(local)
                    s_w, l_w = exact.serve_batch(queries)
                    exact.planner.set_transport(procs)
                    local.mark_up(dead)
                    bitwise(s, l, s_w, l_w, "degraded vs the thread workers without it")
                    code, doc = http(gw.url + "/v1/query",
                                     Query(*queries.row(1), qid=1).to_wire())
                    degraded_post = code == 200 and doc.get("degraded") is True
                    while time.perf_counter() - t_kill < SERVER_TIMEOUT_S:
                        st = sup.states()[f"worker{dead}"]
                        if st["state"] == "up" and st["restarts"] >= 1 and not procs.down_pids():
                            break
                        time.sleep(0.05)
                    t_respawn = time.perf_counter() - t_kill
                    states, metrics = sup.states(), sup.metrics()
                    if ({w["state"] for w in states.values()} != {"up"}
                            or metrics["restarts_total"] != 1):
                        raise AssertionError(f"fleet supervisor: {states} {metrics}")
                    s, l = exact.serve_batch(queries)
                    if exact.last_degraded() is not None:
                        raise AssertionError("fleet: degraded after the respawn")
                    bitwise(s, l, s_x, l_x, "after the supervisor's respawn")
                    hcode, hdoc = http(gw.url + "/healthz")
                    code, mdoc = http(gw.url + "/metrics")
                    if hcode != 200 or mdoc["fleet"]["up"] != P:
                        raise AssertionError(f"fleet after respawn: {hcode} {hdoc} {mdoc}")
                log(f"  serve_partial: worker{dead} killed (SIGKILL); serve_batch degraded "
                    f"(partitions {info['partitions']}, labels {info['label_ranges']} missing, "
                    f"none served), bitwise the thread workers with partition {dead} down; a post "
                    f"{'answered 200 degraded' if degraded_post else f'answered {code}'}; the "
                    f"supervisor respawned and re-shipped it: up {t_respawn:.3f} s after the "
                    f"kill, restarts_total {metrics['restarts_total']}; then bitwise the full "
                    f"results, /healthz {hcode}, /metrics fleet {mdoc['fleet']}  [{gpu}]")

            # int8 through the processes; fp8 refused on the wire.
            t0 = time.perf_counter()
            procs.attach(int8)
            t_q = time.perf_counter() - t0
            s, l = int8.serve_batch(queries)
            bitwise(s, l, s_qi, l_qi, "int8 worker processes")
            fp8 = dataclasses.replace(exact.index, parts=[quantize_tree(
                exact.index.parts[0], tier="fp8")] + exact.index.parts[1:])
            try:
                partition_payload(fp8, 0, beam=SERVE["beam"], topk=SERVE["topk"],
                                  method="mscm_pallas_grouped_q")
                raise AssertionError("fleet: partition_payload shipped an fp8 partition")
            except ValueError as exc:
                refused = str(exc)
            del fp8
            log(f"  int8 through the worker processes: shipped "
                f"{sum(p.memory_bytes for p in int8.index.manifest.partitions) / 1e9:.4f} GB in "
                f"{t_q:.3f} s, serve_batch bitwise the in-process int8 pipelined engine; fp8 "
                f"refused: {refused!r}  [{gpu}]")
        finally:
            procs.close()
    finally:
        local.close()
        threads.close()
    return fleet_launches["grouped"], fleet_launches["grouped_q"]


def train(torch, mk, gpu: str, random_levels: list) -> int:
    """Phase 11: the training path at eurlex-4k's width (d, L, n_test of
    ``PAPER_SHAPES``; n_train 4 x n_test, the quickstart's ratio), trained
    on the card, then its test split served in batch through
    ``method="auto"`` (the grouped kernel) and held against ``mscm_dense``
    and the reference's P@1. Returns the grouped kernel's launches."""
    from repro_torch.data import synthetic_labeled_dataset
    from repro_torch.launch import hw
    from repro_torch.metrics import precision_at_k, recall_at_k
    from repro_torch.parity import check_ranking
    from repro_torch.serving import ServeConfig, XMRServingEngine
    from repro_torch.trees.cluster import build_clustered_tree
    from repro_torch.trees.train import train_xmr_model

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    ds = synthetic_labeled_dataset(rng, name="eurlex-4k-synth", **TRAIN_DATA)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    structure = build_clustered_tree(ds.x_train, ds.y_train, ds.n_labels, TRAIN_BRANCHING, rng)
    t_cluster = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = train_xmr_model(ds.x_train, ds.y_train, ds.n_labels, TRAIN_BRANCHING, rng,
                            nnz_per_col=TRAIN_NNZ, steps=TRAIN_STEPS, structure=structure)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    tree = model.tree
    if tree.device.type != "cuda":
        raise AssertionError(f"trained tree on {tree.device}")
    n, d = ds.x_train.shape
    levels = []
    for size, (train_s, sparsify_s) in zip(structure.level_sizes, model.level_seconds):
        flops = TRAIN_STEPS * 2 * (2 * n * d * size)
        levels.append(f"L={size}: {train_s:.3f} s training ({flops / 1e12:.2f} TFLOP, "
                      f"{100 * flops / train_s / hw.PEAK_FLOPS_F32:.1f}% of 67 TFLOP/s), "
                      f"{sparsify_s:.3f} s sparsify")
    host = t_data + t_cluster + sum(s for _, s in model.level_seconds)
    log(f"  trained {ds.name}: d={d:,} L={ds.n_labels:,} n_train={n:,} n_test="
        f"{ds.x_test.shape[0]:,}, branching {TRAIN_BRANCHING}, levels {structure.level_sizes}, "
        f"{TRAIN_STEPS} steps, {TRAIN_NNZ} nonzeros a column; data {t_data:.3f} s, clustering "
        f"{t_cluster:.3f} s, train_xmr_model {t_train:.3f} s ({'; '.join(levels)}); host side "
        f"(data, clustering, sparsify) {host:.3f} s; peak device memory {peak / 1e9:.3f} GB; "
        f"{tree.memory_bytes() / 1e6:.2f} MB of chunk tiles  [{gpu}]")

    serve = TRAIN_SERVE
    queries = ds.x_test
    eng = XMRServingEngine(tree, ServeConfig(method="auto", **serve),
                           label_perm=structure.label_perm)
    if eng.method != "mscm_pallas_grouped":
        raise AssertionError(f"method='auto' resolved to {eng.method!r} on the GPU")
    eng.warmup(d, batch_sizes=(64,))
    n_test = queries.shape[0]
    n_batches = -(-n_test // serve["max_batch"])
    mk.GROUPED_LAUNCHES = 0
    t0 = time.perf_counter()
    s, l = eng.serve_batch(queries)
    wall = time.perf_counter() - t0
    launches = mk.GROUPED_LAUNCHES
    if launches != tree.depth * n_batches:
        raise AssertionError(f"{launches} grouped launches, want {tree.depth * n_batches}")
    if s.shape != (n_test, serve["topk"]) or not np.isfinite(s).all():
        raise AssertionError(f"bad scores: shape {s.shape}")
    p1, p5 = precision_at_k(l, ds.y_test, 1), precision_at_k(l, ds.y_test, 5)
    r5 = recall_at_k(l, ds.y_test, 5)
    dense = XMRServingEngine(tree, ServeConfig(method="mscm_dense", **serve),
                             label_perm=structure.label_perm)
    s_d, l_d = dense.serve_batch(queries)
    n_diff = check_ranking(s, l, s_d, l_d, "trained tree grouped vs mscm_dense")
    log(f"  serve_batch {n_test} test queries (method=auto -> {eng.method}, {n_batches} batches "
        f"of {serve['max_batch']}): {launches} grouped launches ({launches / n_batches:.0f} a "
        f"batch), {1e3 * wall / n_test:.5f} ms/query amortized (first call); P@1 {p1:.6f}, "
        f"P@5 {p5:.6f}, R@5 {r5:.6f} (the reference's P@1 {TRAIN_REFERENCE_P1} +- "
        f"{TRAIN_P1_BAND}); labels agree with "
        f"mscm_dense on the card ({n_diff} near-tie swaps of {l.size}, max|score diff| "
        f"{float(np.abs(s - s_d).max()):.3e})  [{gpu}]")
    if not abs(p1 - TRAIN_REFERENCE_P1) <= TRAIN_P1_BAND:
        raise AssertionError(f"P@1 {p1} is not within {TRAIN_P1_BAND} of the reference's "
                             f"{TRAIN_REFERENCE_P1}")
    xi, xv = (torch.from_numpy(a) for a in queries.to_ell(serve["ell_width"]))
    leaves = structure.level_sizes[-1]
    _, l_x = model.predict(xi, xv, beam=leaves, topk=serve["topk"])
    log(f"  exact search (beam = {leaves}, mscm_dense): P@1 {precision_at_k(l_x, ds.y_test, 1):.6f}"
        f" against {p1:.6f} at beam {serve['beam']}")
    counts = level_counts(torch, eng, queries, serve["max_batch"])
    trained = ", ".join(f"{100 * c['zero_share']:.2f}%" for c in counts)
    random = ", ".join(f"{100 * c['zero_share']:.2f}%" for c in random_levels)
    log(f"  logits exactly 0 per level, first batch: trained tree {trained}; random search-1m "
        f"tree {random}; live tiles per level: trained "
        f"{[c['live'] for c in counts]} of {[c['tiles'] for c in counts]}, search-1m "
        f"{[c['live'] for c in random_levels]} of {[c['tiles'] for c in random_levels]}")
    return launches


def bits_equal(torch, a, b) -> bool:
    """Whether two tensors hold the same bytes (any dtype, any device)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(torch.equal(a.contiguous().view(width), b.contiguous().view(width)))


def ckpt(torch, mk, qk, gpu: str, tree, queries, device: str = "cuda") -> None:
    """Phase 11: checkpoints of the int8 and fp8 search-1m trees and of two
    reduced LMs (f32 and bf16 parameters), written in both modes and
    restored onto the card bitwise; the 256 queries served through the
    restored int8 tree, bitwise the tree before the round trip."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.ckpt import _leaves_with_path
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm
    from repro_torch.quant.storage import QuantizedTree, quantize_tree
    from repro_torch.serving import ServeConfig, XMRServingEngine

    t0 = time.perf_counter()
    qtrees = {tier: quantize_tree(tree, tier=tier) for tier in ("int8", "fp8")}
    cfg = reduced_config(get_config(LM_ARCH))
    cfg16 = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    state = {
        "int8": qtrees["int8"].layers, "fp8": qtrees["fp8"].layers,
        "lm_f32": lm.init_params(cfg, torch.Generator(device).manual_seed(1), device=device),
        "lm_bf16": lm.init_params(cfg16, torch.Generator(device).manual_seed(2),
                                  device=device),
    }
    torch.cuda.synchronize()
    leaves = {name: list(_leaves_with_path(t)) for name, t in state.items()}
    nbytes = sum(v.numel() * v.element_size() for ls in leaves.values() for _, v in ls)
    log(f"  state: int8 {qtrees['int8'].memory_bytes() / 1e9:.4f} GB, fp8 "
        f"{qtrees['fp8'].memory_bytes() / 1e9:.4f} GB (search-1m quantized on the card in "
        f"{time.perf_counter() - t0:.3f} s), reduced {LM_ARCH} params in f32 and bf16; "
        f"{sum(len(v) for v in leaves.values())} leaves, {nbytes / 1e9:.4f} GB")
    root = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(root, ignore_errors=True)
    try:
        restored = None
        for mode in ("sync", "async"):
            ck = Checkpointer(str(root / mode), keep=1, async_write=mode == "async")
            t0 = time.perf_counter()
            ck.save(7, state, {"phase": "ckpt", "mode": mode})
            t_call = time.perf_counter() - t0
            ck.wait()
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            step, restored = ck.restore(state)
            torch.cuda.synchronize()
            t_read = time.perf_counter() - t0
            if step != 7:
                raise AssertionError(f"{mode}: restored step {step}")
            for name, ls in leaves.items():
                got = dict(_leaves_with_path(restored[name]))
                for key, want in ls:
                    g = got[key]
                    if g.device != want.device or not bits_equal(torch, g, want):
                        raise AssertionError(f"{mode}: {name}/{key} not restored bitwise on "
                                             f"{want.device}")
            files = sum(1 for _ in (root / mode).rglob("*.npy"))
            log(f"  {mode}: save {t_write:.3f} s ({nbytes / 1e9 / t_write:.3f} GB/s; the call "
                f"returned after {t_call:.3f} s), restore onto the card {t_read:.3f} s "
                f"({nbytes / 1e9 / t_read:.3f} GB/s); {files} files; every leaf bitwise, on "
                f"its template's device  [{gpu}]")
        qtree = qtrees["int8"]
        back = QuantizedTree(layers=restored["int8"], n_cols=qtree.n_cols,
                             branching=qtree.branching, d=qtree.d, tier=qtree.tier)
        n = queries.shape[0]
        results = []
        for t in (qtree, back):
            eng = XMRServingEngine(t, ServeConfig(method="mscm_pallas_grouped_q", **SERVE),
                                   device=device)
            zero_counts(mk, qk)
            results.append(eng.serve_batch(queries))
            launches = counts(mk, qk)
            want = tree.depth * -(-n // SERVE["max_batch"])
            if launches["grouped_q"] != want or launches["grouped"]:
                raise AssertionError(f"restored int8 tree: launches {launches}")
        (s0, l0), (s1, l1) = results
        if not (np.array_equal(l0, l1) and np.array_equal(s0.view(np.uint32),
                                                          s1.view(np.uint32))):
            raise AssertionError("the restored int8 tree does not serve bitwise")
        log(f"  {n} queries through the restored int8 tree: bitwise the tree before the round "
            f"trip ({launches['grouped_q']} grouped_q launches each)")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def lm_reduced(torch, gpu: str, device: str = "cuda") -> None:
    """Every reduced config: prefill and decode steps on the card against
    the port on the CPU, with the same params and inputs."""
    from repro_torch.configs import ARCH_IDS, get_config, reduced_config
    from repro_torch.launch.specs import make_demo_batch
    from repro_torch.models import lm

    r = LM_REDUCED
    for arch in ARCH_IDS:
        cfg = reduced_config(get_config(arch))
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        batch = make_demo_batch(cfg, np.random.default_rng(0), r["batch"], r["seq"],
                                device="cpu")
        on_card = (lm._map(lambda a: a.to(device), params),
                   {k: v.to(device) for k, v in batch.items()})
        t0 = time.perf_counter()
        cpu_l, cpu_c = lm.prefill(cfg, params, batch, max_len=r["max_len"])
        gpu_l, gpu_c = lm.prefill(cfg, *on_card, max_len=r["max_len"])
        errs = [float((gpu_l.cpu() - cpu_l).abs().max())]
        if errs[0] > LM_REDUCED_TOL["prefill"] * (1 + float(cpu_l.abs().max())):
            raise AssertionError(f"{arch}: prefill on the card off the CPU's by {errs[0]:.3e}")
        pos = r["seq"] + (batch["patch_embeds"].shape[1] if cfg.family == "vlm" else 0)
        tok = cpu_l[:, -1].argmax(-1)
        for i in range(r["steps"]):
            cpu_l, cpu_c = lm.decode_step(cfg, params, cpu_c, tok, pos + i)
            gpu_l, gpu_c = lm.decode_step(cfg, on_card[0], gpu_c, tok.to(device), pos + i)
            err = float((gpu_l.cpu() - cpu_l).abs().max())
            errs.append(err)
            if not (torch.isfinite(gpu_l).all() and err <= LM_REDUCED_TOL["decode"] * (
                    1 + float(cpu_l.abs().max()))):
                raise AssertionError(f"{arch}: decode step {i} on the card off the CPU's by "
                                     f"{err:.3e}")
            tok = cpu_l.argmax(-1)
        log(f"  {arch} ({cfg.family}) reduced: max|card - CPU| prefill {errs[0]:.3e}, "
            f"decode {max(errs[1:]):.3e} (tolerances {LM_REDUCED_TOL['prefill']:g} / "
            f"{LM_REDUCED_TOL['decode']:g} x (1 + max|logit|)); {time.perf_counter() - t0:.2f} s")


def lm_phase(torch, gpu: str, device: str = "cuda") -> None:
    """Phase 13: yi-6b at full width and depth on the card (init, prefill in
    naive and chunked attention, 32 greedy decode steps held against
    forward_train, the vocab-tree head on its lm_head), then every reduced
    config on the card against the CPU."""
    import dataclasses

    from repro_torch.checkpoint.ckpt import _leaves_with_path
    from repro_torch.configs import get_config
    from repro_torch.launch import hw
    from repro_torch.launch.specs import make_demo_batch
    from repro_torch.models import lm
    from repro_torch.models.common import rms_norm
    from repro_torch.models.xmr_head import VocabTreeHead, greedy_token

    cfg = get_config(LM_ARCH)
    b, s = LM_BATCH, LM_PROMPT
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(v.numel() * v.element_size() for _, v in _leaves_with_path(params))
    log(f"  {LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, V {cfg.vocab}: {cfg.n_params():,} parameters, "
        f"{n_bytes / 1e9:.3f} GB in {str(cfg.param_dtype).removeprefix('torch.')}, drawn on "
        f"{device} from torch.Generator('{device}') seed 0 in {init_s:.3f} s  [{gpu}]")
    batch = make_demo_batch(cfg, np.random.default_rng(0), b, s, device=device)
    prompt = {"tokens": batch["tokens"]}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    lm.prefill(cfg, params, prompt, max_len=LM_MAX_LEN)  # first call: cuBLAS warm-up
    (logits, cache), pre_s = timed(lambda: lm.prefill(cfg, params, prompt, max_len=LM_MAX_LEN))
    cfg_c = dataclasses.replace(cfg, **LM_CHUNKED)
    (logits_c, _), pre_c_s = timed(lambda: lm.prefill(cfg_c, params, prompt,
                                                      max_len=LM_MAX_LEN))
    impl_err = float((logits_c - logits).abs().max())
    if not (torch.isfinite(logits).all() and impl_err <= LM_IMPL_TOL):
        raise AssertionError(f"prefill naive vs chunked: max diff {impl_err:.3e}")
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    dense_per_tok = 2 * (cfg.n_params() - 2 * V * d) // L  # one layer's weights, 2 flops each
    attn = 2 * 2 * b * cfg.n_heads * s * s * cfg.head_dim  # QK^T and PV, full S x S
    flops = L * (b * s * dense_per_tok + attn) + 2 * b * d * V
    log(f"  prefill {b} x {s} tokens (max_len {LM_MAX_LEN}): naive {1e3 * pre_s:.3f} ms = "
        f"{flops / pre_s / 1e12:.2f} TFLOP/s, {100 * flops / pre_s / hw.PEAK_FLOPS_F32:.1f}% of 67 "
        f"TFLOP/s f32 (TF32 off; {flops / 1e12:.2f} TFLOP); chunked (key blocks "
        f"{LM_CHUNKED['attn_kblock']}, query blocks {LM_CHUNKED['attn_qblock']}) "
        f"{1e3 * pre_c_s:.3f} ms; last-position logits naive vs chunked max|diff| "
        f"{impl_err:.3e} (tolerance {LM_IMPL_TOL:g})  [{gpu}]")

    tok = logits[:, -1].argmax(-1)
    toks, dec_logits, step_s = [], [], []
    for i in range(LM_STEPS):
        toks.append(tok)
        (step, cache), t = timed(lambda: lm.decode_step(cfg, params, cache, tok, s + i))
        dec_logits.append(step)
        step_s.append(t)
        tok = step.argmax(-1)
    weight_bytes = (cfg.n_params() - V * d) * params["lm_head"].element_size()
    bound_ms = 1e3 * weight_bytes / hw.HBM_BW
    med = float(np.median(step_s[1:]))
    log(f"  decode {LM_STEPS} greedy steps at batch {b}: median {1e3 * med:.3f} ms/step "
        f"(first {1e3 * step_s[0]:.3f} ms), {b / med:.1f} tokens/s; weight-read bound "
        f"{weight_bytes / 1e9:.2f} GB / 3.35 TB/s = {bound_ms:.3f} ms, "
        f"{100 * bound_ms / (1e3 * med):.1f}% of it  [{gpu}]")
    wall, acts, busy_us, rows = device_profile(
        lambda: lm.decode_step(cfg, params, cache, tok, s + LM_STEPS))
    log_profile(f"one decode step at batch {b}", wall, acts, busy_us, rows, gpu, 6)
    if busy_us:
        log(f"  decode step: {acts} device activities, idle share "
            f"{1 - busy_us / (1e6 * wall):.4f} (profiler on)")

    # prefill/decode consistency, as the reference's test holds it
    full = {"tokens": torch.cat([batch["tokens"], torch.stack(toks, 1).int()], 1)}
    (f_logits, _), fwd_s = timed(lambda: lm.forward_train(cfg, params, full))
    want = f_logits[:, s: s + LM_STEPS].transpose(0, 1)        # [steps, B, V]
    got = torch.stack(dec_logits)
    err = (got - want).abs()
    gap_err = float(err.max())
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > LM_DECODE_TOL
    greedy = got.argmax(-1)
    same = greedy == want.argmax(-1)
    if gap_err > LM_DECODE_TOL or not bool(same[decided].all()):
        raise AssertionError(f"decode vs forward_train: max diff {gap_err:.3e}, greedy tokens "
                             f"differ at {int((~same & decided).sum())} decided positions")
    per_step = err.amax(dim=(1, 2)).tolist()
    log(f"  decode logits vs forward_train's at the same {LM_STEPS * b} positions: max|diff| "
        f"{gap_err:.3e}, mean {float(err.mean()):.3e}, by step first/last "
        f"{per_step[0]:.3e}/{per_step[-1]:.3e} (tolerance {LM_DECODE_TOL:g}: the bf16 cache "
        f"and bf16 probabilities); greedy tokens equal at {int(same.sum())} of {same.numel()}"
        f" positions, all {int(decided.sum())} with a top-2 gap > {LM_DECODE_TOL:g}; "
        f"forward_train of {b} x {s + LM_STEPS} in {fwd_s:.3f} s")
    del f_logits, want, got, err

    # the vocab-tree head on the model's own lm_head
    x = lm._embed(params["embed"], full["tokens"])
    x, _, _ = lm._decoder_stack(cfg, params, x)
    h = rms_norm(x, params["final_norm"])[:, s: s + LM_STEPS].transpose(0, 1).contiguous()
    del x
    (head, tree_s) = timed(lambda: VocabTreeHead.from_lm_head(params["lm_head"], LM_TREE_B))
    c = head.n_clusters
    hb = h.reshape(-1, d)
    dense = hb @ params["lm_head"]
    full_err = float((head.full_logits(hb) - dense).abs().max())
    if full_err > 1e-4 * (1 + float(dense.abs().max())):
        raise AssertionError(f"full_logits off h @ lm_head by {full_err:.3e}")
    want_tok = dense.argmax(-1).reshape(LM_STEPS, b)
    exact = torch.stack([greedy_token(head, h[i], beam=c) for i in range(LM_STEPS)])
    if not torch.equal(exact, want_tok):
        raise AssertionError(f"greedy_token at beam C = {c} differs from the dense argmax at "
                             f"{int((exact != want_tok).sum())} positions")
    agree = {bm: float((torch.stack([greedy_token(head, h[i], beam=bm)
                                     for i in range(LM_STEPS)]) == want_tok).float().mean())
             for bm in LM_TREE_BEAMS}
    h8 = h[-1]
    dense_ms = time_ms(lambda: (h8 @ params["lm_head"]).argmax(-1))
    tree_ms = {bm: time_ms(lambda bm=bm: greedy_token(head, h8, beam=bm))
               for bm in LM_TREE_BEAMS}
    log(f"  vocab-tree head: B = {LM_TREE_B}, C = {c} chunks, "
        f"{head.chunks.numel() * head.chunks.element_size() / 1e9:.3f} GB, built in "
        f"{tree_s:.3f} s; full_logits vs h @ lm_head max|diff| {full_err:.3e}; greedy_token at "
        f"beam C bitwise the dense argmax at all {want_tok.numel()} decoded positions; "
        f"agreement with the dense argmax at beams "
        + ", ".join(f"{bm}: {agree[bm]:.4f}" for bm in LM_TREE_BEAMS)
        + f" (random weights: chunks are not clustered); ms for {b} rows: dense head + argmax "
        f"{dense_ms:.5f}, tree " + ", ".join(f"beam {bm} {tree_ms[bm]:.5f}"
                                              for bm in LM_TREE_BEAMS) + f"  [{gpu}]")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory of the yi-6b run {peak / 1e9:.3f} GB  [{gpu}]")
    del params, cache, head, h, hb, dense
    torch.cuda.empty_cache()
    lm_reduced(torch, gpu, device)


def _flat_f32(tree) -> dict:
    from repro_torch.checkpoint.ckpt import _leaves_with_path

    return {k: v.detach().float().cpu().numpy() for k, v in _leaves_with_path(tree)}


def _f64_grads(torch, cfg, params, nb) -> dict:
    """The gradients of one step of ``cfg`` in float64 on the CPU (the
    parameters and float inputs cast up), as f32 numpy."""
    import dataclasses

    from repro_torch.launch.train import init_opt_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import Optimizer, get_optimizer

    seen, inner = {}, get_optimizer(cfg.optimizer)

    def capture(grads, state, prm, lr):
        seen["grads"] = _flat_f32(grads)
        return prm, state

    cfg64 = dataclasses.replace(cfg, param_dtype=torch.float64)
    prm = lm._map(lambda a: a.double(), params)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    make_train_step(cfg64, Optimizer(inner.init, capture, inner.name))(
        prm, init_opt_state(inner, prm), batch)
    return seen["grads"]


def lm_train_reduced(torch, gpu: str, device: str = "cuda") -> None:
    """Every reduced config: one ``make_train_step`` step on the card
    against the CPU, from the same parameters and batch: the loss and the
    gradients, then the update, the card's on the CPU's gradients."""
    import dataclasses

    from repro_torch.configs import ARCH_IDS, get_config, reduced_config
    from repro_torch.data import batch_at_step
    from repro_torch.launch.train import init_opt_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import Optimizer, get_optimizer

    r, tol = LM_TRAIN_REDUCED, LM_TRAIN_TOL
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(reduced_config(get_config(arch)), remat=True,
                                  remat_policy="full")
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        nb = batch_at_step(cfg, seed=0, step=0, host=0, n_hosts=1, batch=r["batch"],
                           seq=r["seq"])
        out, cpu_grads = {}, {}
        t0 = time.perf_counter()
        exact = _f64_grads(torch, cfg, params, nb)
        for dev in ("cpu", device):
            inner = get_optimizer(cfg.optimizer)
            seen = {}

            def update(grads, state, prm, lr, inner=inner, seen=seen, dev=dev):
                seen["grads"] = _flat_f32(grads)
                if cpu_grads:  # the card's update on the CPU's gradients
                    grads = lm._map(lambda g: g.to(dev), cpu_grads["tree"])
                else:
                    cpu_grads["tree"] = grads
                return inner.update(grads, state, prm, lr)

            step = make_train_step(cfg, Optimizer(inner.init, update, inner.name),
                                   peak_lr=r["lr"], warmup=0, total_steps=10)
            prm = lm._map(lambda a: a.to(dev, copy=True), params)
            new, _, metrics = step(prm, init_opt_state(inner, prm),
                                   {k: torch.from_numpy(v).to(dev) for k, v in nb.items()})
            out[dev] = (float(metrics["loss"]), seen["grads"], _flat_f32(new))
        (l_c, g_c, p_c), (l_g, g_g, p_g) = out["cpu"], out[device]
        rel = tol["ssm_grad"] if cfg.family == "ssm" else tol["grad"]
        if not (np.isfinite(l_g) and abs(l_g - l_c) <= tol["loss"] * abs(l_c)):
            raise AssertionError(f"{arch}: train-step loss on the card {l_g} against {l_c}")
        g_err = p_err = 0.0
        from_f64 = [max(float(np.abs(g[k] - e).max()) / max(float(np.abs(e).max()), 1e-30)
                        for k, e in exact.items()) for g in (g_c, g_g)]
        for k, g in g_c.items():
            e = float(np.abs(g_g[k] - g).max()) / max(float(np.abs(g).max()), 1e-30)
            if not e <= rel:
                raise AssertionError(f"{arch} {k}: gradient on the card off the CPU's by "
                                     f"{e:.3e} of its max")
            g_err = max(g_err, e)
            off = np.abs(p_g[k] - p_c[k])
            if not np.all(off <= tol["param_atol"] + tol["param_rtol"] * np.abs(p_c[k])):
                raise AssertionError(f"{arch} {k}: updated leaf on the card off the CPU's by "
                                     f"{float(off.max()):.3e}")
            p_err = max(p_err, float(off.max()))
        log(f"  {arch} ({cfg.family}, {cfg.optimizer}) reduced train step, card against CPU: "
            f"loss {l_g:.6f} / {l_c:.6f}; max gradient diff {g_err:.3e} of the leaf's max "
            f"(tolerance {rel:g}; from an f64 run on the CPU: CPU {from_f64[0]:.3e}, card "
            f"{from_f64[1]:.3e}); updated leaves from the same gradients within "
            f"{p_err:.3e} (tolerance {tol['param_atol']:g} + {tol['param_rtol']:g} |p|); "
            f"{time.perf_counter() - t0:.2f} s")


def lm_train_loop(torch, gpu: str, device=None) -> None:
    """``train_loop`` on the card (no device named): checkpoints, an
    injected failure, and a second run that resumes where the first ended."""
    import os
    import shutil
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.train import train_loop

    r = LM_LOOP
    cfg = reduced_config(get_config(LM_ARCH))
    root = tempfile.mkdtemp(prefix="lm_train_")
    try:
        d = os.path.join(root, "ckpt")
        kw = dict(batch=r["batch"], seq=r["seq"], ckpt_dir=d, save_every=r["save_every"],
                  compress_grads=True, device=device)
        t0 = time.perf_counter()
        first = train_loop(cfg, steps=r["steps"], inject_failure_at=r["inject_failure_at"], **kw)
        t1 = time.perf_counter()
        steps_after_first = Checkpointer(d).list_steps()
        second = train_loop(cfg, steps=r["resume_steps"], **kw)
        t2 = time.perf_counter()
        ck = Checkpointer(d)
        step, state = ck.restore({"opt": {"inner": {"step": torch.zeros((), dtype=torch.int32)}}},
                                 device="cpu")
        losses = first["losses"] + second["losses"]
        want_dev = "cuda" if device is None else torch.device(device).type
        if not (first["steps_run"] == r["steps"]
                and second["steps_run"] == r["resume_steps"] - r["steps"]
                and np.all(np.isfinite(losses))
                and steps_after_first == [4, 8, 12] and step == r["resume_steps"]
                and second["final_params"]["embed"].device.type == want_dev):
            raise AssertionError(f"train_loop: ran {first['steps_run']} + "
                                 f"{second['steps_run']} steps, checkpoints "
                                 f"{steps_after_first} then {ck.list_steps()}")
        # the retry restored the step-4 checkpoint and went on at step 6
        opt_steps = int(state["opt"]["inner"]["step"])
        if opt_steps != r["resume_steps"] - (r["inject_failure_at"] - 4):
            raise AssertionError(f"optimizer step {opt_steps} after the rollback")
        log(f"  train_loop on {second['final_params']['embed'].device} (no device named), "
            f"reduced {LM_ARCH}, {r['batch']} x {r['seq']} tokens, bf16 gradient compression: "
            f"{first['steps_run']} steps in {t1 - t0:.2f} s with a failure injected at step "
            f"{r['inject_failure_at']} (retried from the step-4 checkpoint), checkpoints "
            f"{steps_after_first}; a second run on the directory resumed at step "
            f"{r['steps']} and ran {second['steps_run']} more in {t2 - t1:.2f} s (checkpoint "
            f"{step}, optimizer step {opt_steps}); loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"watchdog {first['watchdog']} then {second['watchdog']}  [{gpu}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def lm_train_phase(torch, gpu: str, device: str = "cuda") -> float:
    """Phase 14: yi-6b trained on the card at full width and depth, every
    reduced config's train step on the card against the CPU, and the
    training loop's checkpoint, failure and resume path on the card.
    Returns the median ms of a yi-6b step."""
    import dataclasses

    from repro_torch.checkpoint.ckpt import _leaves_with_path
    from repro_torch.configs import get_config
    from repro_torch.data import batch_at_step
    from repro_torch.launch import hw
    from repro_torch.launch.train import init_opt_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import Optimizer, get_optimizer

    base = get_config(LM_ARCH)
    cfg = dataclasses.replace(base, optimizer="adafactor")
    r = LM_TRAIN
    b, s = r["batch"], r["seq"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    inner = get_optimizer(cfg.optimizer)
    opt_state = init_opt_state(inner, params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for _, p in _leaves_with_path(params))
    state_bytes = sum(v.numel() * v.element_size() for _, v in _leaves_with_path(opt_state))
    log(f"  {LM_ARCH} training: {cfg.n_layers} layers, d {cfg.d_model}, {n_params:,} parameters"
        f" ({4 * n_params / 1e9:.2f} GB f32), remat {cfg.remat_policy!r}; optimizer "
        f"{cfg.optimizer} in place of the config's {base.optimizer} (AdamW's m and v would "
        f"add 2 x {4 * n_params / 1e9:.2f} GB to params and grads: more than 80 GB), its "
        f"state {state_bytes / 1e6:.1f} MB; drawn on {device} in {init_s:.3f} s  [{gpu}]")

    updates, finite, peaks = [], [], []

    def update(grads, state, prm, lr):
        # a NaN or inf anywhere in a leaf makes its sum non-finite
        finite.append(torch.stack([g.sum() for _, g in _leaves_with_path(grads)])
                      .isfinite().all())
        backward_peak = torch.cuda.max_memory_allocated()  # the step's, up to here
        torch.cuda.reset_peak_memory_stats()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner.update(grads, state, prm, lr)
        stop.record()
        updates.append((start, stop))
        peaks.append((backward_peak, torch.cuda.max_memory_allocated()))
        return out

    step_fn = make_train_step(cfg, Optimizer(inner.init, update, inner.name),
                              warmup=r["warmup"], total_steps=r["steps"])
    losses, step_ms = [], []

    def run(i: int) -> float:
        """Step ``i`` on batch ``i``; returns its ms (CUDA events)."""
        nonlocal params, opt_state
        nb = batch_at_step(cfg, seed=0, step=i, host=0, n_hosts=1, batch=b, seq=s)
        batch = {k: torch.from_numpy(v).to(device) for k, v in nb.items()}
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats()
        start.record()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        stop.record()
        loss = float(metrics["loss"])
        if not (np.isfinite(loss) and bool(finite[-1])):
            raise AssertionError(f"step {i}: loss {loss}, gradients finite {bool(finite[-1])}")
        losses.append(loss)
        return start.elapsed_time(stop)

    for i in range(r["steps"]):
        step_ms.append(run(i))
    peak = max(max(pk) for pk in peaks)
    back_peak, upd_peak = (max(pk[j] for pk in peaks) for j in (0, 1))
    upd_ms = [a.elapsed_time(z) for a, z in updates]
    med = float(np.median(step_ms[r["timed"]]))
    upd = float(np.median(upd_ms[r["timed"]]))
    tokens = b * s
    mfu = 6 * n_params * tokens / (med / 1e3) / hw.PEAK_FLOPS_F32
    hw_rate = 8 * n_params * tokens / (med / 1e3) / hw.PEAK_FLOPS_F32
    log(f"  {r['steps']} steps of {b} x {s} tokens (batch_at_step, seed 0; warmup "
        f"{r['warmup']}): ms a step {', '.join(f'{t:.1f}' for t in step_ms)}; median of steps "
        f"2-5 {med:.1f} ms, {tokens / (med / 1e3):.1f} tokens/s; MFU (6·N·T) "
        f"{100 * mfu:.1f}% of 67 TFLOP/s f32, with remat's recompute (8·N·T) {100 * hw_rate:.1f}%"
        f"; optimizer update {upd:.2f} ms (median of steps 2-5; each "
        f"{', '.join(f'{t:.2f}' for t in upd_ms)}); peak device memory {peak / 1e9:.3f} GB "
        f"(forward and backward {back_peak / 1e9:.3f} GB, the update {upd_peak / 1e9:.3f} GB); "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}  [{gpu}]")

    # the layer loop's views: a[i] per layer (the serving path's before
    # unbind) against one unbind per leaf, steps in turns
    by_unbind = lm._layers

    def by_index(stacked, n):
        return [lm._map(lambda a, i=i: a[i], stacked) for i in range(n)]

    pairs = {}
    for name, views in (("a[i]", by_index), ("unbind", by_unbind)):
        lm._layers = views
        try:
            t = [run(r["steps"] + len(pairs) * r["pair"] + j) for j in range(r["pair"])]
        finally:
            lm._layers = by_unbind
        pairs[name] = (t[-1], max(peaks[-1]))
    log(f"  layer views, a step (the second of {r['pair']}) and its peak memory: a[i] "
        f"{pairs['a[i]'][0]:.1f} ms, {pairs['a[i]'][1] / 1e9:.3f} GB; unbind "
        f"{pairs['unbind'][0]:.1f} ms, {pairs['unbind'][1] / 1e9:.3f} GB  [{gpu}]")
    step_no = r["steps"] + len(pairs) * r["pair"]
    wall, acts, busy_us, rows = device_profile(lambda: run(step_no))
    log_profile(f"one yi-6b train step ({b} x {s} tokens)", wall, acts, busy_us, rows, gpu, 10)
    if busy_us:
        log(f"  train step: {acts} device activities, idle share "
            f"{1 - busy_us / (1e6 * wall):.4f} (profiler on)")
    del params, opt_state, step_fn
    torch.cuda.empty_cache()
    lm_train_reduced(torch, gpu, device)
    lm_train_loop(torch, gpu, None if device == "cuda" else device)
    return med


def dryrun_phase(torch, gpu: str, step_ms: float) -> dict:
    """Phase 15: the dry runs on ``meta`` tensors (no card memory): yi-6b's
    cells on the single-pod mesh (rank 0's DTensor program), yi-6b's step at
    the lm_train phase's shape counted and its bound held against the
    measured step, and the enterprise serving step on both production
    meshes. Returns the single-pod enterprise record and yi-6b's cells."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, hw
    from repro_torch.launch import serve_dryrun as sd
    from repro_torch.launch.mesh import make_production_mesh

    lm_cells = {}
    for shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(LM_ARCH, shape, "single")
        if rec.get("status") != "ok" or not rec.get("spmd"):
            raise AssertionError(f"dry run {LM_ARCH} {shape}: {rec.get('status')}")
        lm_cells[shape] = rec
        rf, coll = rec["roofline"], rec["collectives"]
        kinds = ", ".join(f"{k} {v['count']} x {v['operand_bytes']:.4e} B"
                          for k, v in coll.items() if k != "TOTAL")
        log(f"  {LM_ARCH} {shape}, rank 0's program of the (16, 16) mesh on meta (fake group "
            f"of {rec['chips']}): status ok in {rec['meta_run_s']} s; "
            f"{rec['memory']['argument_size_in_bytes']:,} argument bytes a device; counted a "
            f"device {rec['counted_flops_per_device']:.4e} FLOP, "
            f"{rec['counted_bytes_per_device']:.4e} bytes, collectives {kinds} (operand "
            f"{rec['collective_bytes_per_device']:.4e} B); model/counted FLOPs "
            f"{rec['model_vs_counted_flops']:.4f}; bound a step compute "
            f"{1e3 * rf['compute_s']:.3f} ms, memory {1e3 * rf['memory_s']:.3f} ms, collective "
            f"{1e3 * rf['collective_s']:.3f} ms ({rf['dominant']}; H100 SXM data sheet rates, "
            f"NVLink 4 for the collectives)")
    cfg = dataclasses.replace(get_config(LM_ARCH), optimizer="adafactor")
    shape = ShapeSpec("lm_train", LM_TRAIN["seq"], LM_TRAIN["batch"], "train")
    fn, args, _ = dryrun._step_and_specs(cfg, shape, make_production_mesh())
    t0 = time.perf_counter()
    counter = dryrun.count_step(fn, args)
    rf = hw.roofline_terms(flops=counter.flops, bytes_hbm=counter.bytes, bytes_collective=0.0,
                           chips=1)
    log(f"  {LM_ARCH} train step at the lm_train phase's shape ({LM_TRAIN['batch']} x "
        f"{LM_TRAIN['seq']} tokens, remat {cfg.remat_policy!r}, Adafactor), counted on meta in "
        f"{time.perf_counter() - t0:.1f} s: {counter.flops:.4e} FLOP "
        f"({counter.flops / (6 * cfg.n_active_params() * LM_TRAIN['batch'] * LM_TRAIN['seq']):.4f}"
        f" x 6·N·T), {counter.bytes:.4e} bytes; bound compute {1e3 * rf['compute_s']:.1f} ms "
        f"(67 TFLOP/s f32), memory {1e3 * rf['memory_s']:.1f} ms (3.35 TB/s); the lm_train "
        f"phase's measured step {step_ms:.1f} ms = {step_ms / (1e3 * rf['bound_s']):.3f} x the "
        f"{rf['dominant']} bound  [{gpu}]")
    for name, n, flops, nbytes in counter.top(5):
        log(f"    {name:24s} x{n:<6d} {flops:.4e} FLOP {nbytes:.4e} bytes")
    recs = {}
    for kind in ("single", "multi"):
        rec = sd.dry_run(ENTERPRISE["batch"], ENTERPRISE["beam"], ENTERPRISE["topk"],
                         multi_pod=kind == "multi")
        recs[kind] = rec
        mem, rf = rec["memory"], rec["roofline"]
        log(f"  enterprise serve ({rec['model']}), {kind}-pod mesh of {rec['chips']} meta slots,"
            f" batch {rec['batch']}: {mem['argument_bytes_per_device']:,} argument bytes a "
            f"device; counted {rec['counted_flops_per_device']:.4e} FLOP and "
            f"{rec['counted_bytes_per_device']:.4e} bytes a device; bound a step "
            f"{1e3 * rf['bound_s']:.4f} ms ({rf['dominant']}), {rec['per_query_bound_us']:.4f} "
            f"us a query; candidates sent between slots {rec['collectives']['TOTAL']['count']}"
            f" x, {rec['collectives']['TOTAL']['operand_bytes']:,.0f} bytes; run on meta in "
            f"{rec['meta_run_s']} s")
        if mem["argument_bytes_per_device"] != ENTERPRISE_ARGUMENT_BYTES:
            raise AssertionError(f"enterprise {kind}: {mem['argument_bytes_per_device']:,} "
                                 f"argument bytes a device, not {ENTERPRISE_ARGUMENT_BYTES:,}")
    return recs["single"], lm_cells


def enterprise_phase(torch, gpu: str, dry: dict, device: str = "cuda") -> None:
    """Phase 16: one device's shards of the 100M-label model drawn on the
    card (data row 0, model slot 0), its program timed, profiled and held
    against the CPU; then all 16 model slots streamed through the card and
    merged into the top-10 of 64 queries, the slot that owns most of the
    answer held against the CPU too."""
    from repro_torch.core.mscm import scatter_dense
    from repro_torch.launch import serve_dryrun as sd
    from repro_torch.launch.hw import HBM_BW
    from repro_torch.parity import check_ranking

    e, geom = ENTERPRISE, sd.ENTERPRISE
    n_model = 16
    step_kw = dict(geom=geom, beam=e["beam"], topk=e["topk"])
    tol = dict(rtol=e["rtol"], atol=e["atol"])

    def host(ts):
        return tuple(t.cpu() for t in ts)

    def held_cpu(got, want, what: str) -> str:
        """check_ranking of the card's (scores, ids) against the CPU's."""
        swaps = check_ranking(got[0].cpu().numpy(), got[1].cpu().numpy(), want[0].numpy(),
                              want[1].numpy(), what, **tol)
        err = float((got[0].cpu() - want[0]).abs().max())
        real = want[0][want[0] > -1e29]  # the rest: rows with no block of the slot
        return (f"max|diff| {err:.3e}, {swaps} near-tie swaps, {real.numel()} of "
                f"{want[0].numel()} scores real ({float(real.min()) if real.numel() else 0:.6f}"
                f"..{float(real.max()) if real.numel() else 0:.6f})")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    upper = sd.make_upper(geom, device=device, seed=e["seed"])
    leaf = sd.make_leaf_shard(0, n_model, geom, device=device, seed=e["seed"])
    xi, xv = sd.make_queries(e["n"], 0, geom, device=device, seed=e["seed"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    args = (xi, xv, *upper, *leaf)
    nbytes = sum(t.numel() * t.element_size() for t in args)
    log(f"  device (data 0, model 0) of {dry['model']}: {nbytes:,} bytes drawn on the card "
        f"in {gen_s:.2f} s (the dry run: {dry['memory']['argument_bytes_per_device']:,}); "
        f"leaf shard {leaf[1].shape[0]:,} chunks of {geom.ell_r} x {geom.branching[-1]} bf16")
    if nbytes != dry["memory"]["argument_bytes_per_device"]:
        raise AssertionError("the device's shards differ from the dry run's bytes")

    def step():
        return sd.device_step(*args, m=0, **step_kw)

    ms = time_ms(step, reps=10, inner=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / 10
    wall, acts, busy_us, rows = device_profile(step)
    log_profile("one enterprise device call (64 queries)", wall, acts, busy_us, rows, gpu, 8)
    idle = 1 - busy_us / (1e6 * wall) if busy_us else None
    bound_ms = 1e3 * dry["counted_bytes_per_device"] / HBM_BW
    log(f"  enterprise device call: {ms:.4f} ms on the card ({1e3 * ms / e['n']:.3f} us a "
        f"query; CUDA events behind a sleep), {wall_ms:.4f} ms wall a call (10 in a row, "
        f"host clock); the dry run's bound {bound_ms:.4f} ms a call ({ms / bound_ms:.2f} x), "
        f"{dry['per_query_bound_us']:.4f} us a query of the 1,024; {acts} device activities, "
        f"idle share {'not measured' if idle is None else f'{idle:.4f}'} (profiler on)  [{gpu}]")

    out = step()
    xd = scatter_dense(xi, xv, geom.d_feat)
    beam = sd.upper_beam(xd, *upper, geom=geom, beam=e["beam"])
    del xd
    t0 = time.perf_counter()
    cpu_upper, cpu_leaf, (cxi, cxv) = host(upper), host(leaf), host((xi, xv))
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_out = sd.device_step(cxi, cxv, *cpu_upper, *cpu_leaf, m=0, **step_kw)
    cpu_s = time.perf_counter() - t0
    cxd = scatter_dense(cxi, cxv, geom.d_feat)
    cpu_beam = sd.upper_beam(cxd, *cpu_upper, geom=geom, beam=e["beam"])
    del cxd, cpu_leaf
    log(f"  card vs CPU (the same {nbytes / 1e9:.2f} GB copied to the host in {copy_s:.1f} s; "
        f"the CPU's call {cpu_s:.2f} s; tolerance {e['atol']:g} + {e['rtol']:g}|s|): the "
        f"device's top-10 {held_cpu(out, cpu_out, 'enterprise device call, card vs CPU')}; "
        f"the beam into the leaf level (parents and scores) "
        f"{held_cpu(beam[::-1], cpu_beam[::-1], 'enterprise upper beam, card vs CPU')}")

    del leaf, args
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cands = []
    for m in range(n_model):
        leaf = sd.make_leaf_shard(m, n_model, geom, device=device, seed=e["seed"])
        cands.append(sd.device_step(xi, xv, *upper, *leaf, m=m, **step_kw))
        del leaf
    s, i = sd.merge_candidates([c[0] for c in cands], [c[1] for c in cands], e["topk"])
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not (torch.equal(cands[0][0], out[0]) and torch.equal(cands[0][1], out[1])):
        raise AssertionError("model slot 0 redrawn from its seed gave other candidates")
    cs, ci = sd.merge_candidates([c[0].cpu() for c in cands], [c[1].cpu() for c in cands],
                                 e["topk"])
    if not (torch.equal(cs, s.cpu()) and torch.equal(ci, i.cpu())):
        raise AssertionError("the card's merge differs from the CPU's on the same candidates")
    labels = i.cpu().numpy()
    n_labels = geom.level_sizes()[-1]
    ok = (np.isfinite(s.cpu().numpy()).all() and (labels >= 0).all()
          and (labels < n_labels).all()
          and all(len(set(r)) == len(r) for r in labels.tolist())
          and bool((s[:, :-1] >= s[:, 1:]).all()) and bool((s > 0).all()))
    if not ok:
        raise AssertionError("the merged top-10 is not a ranking of distinct leaf labels")
    owners = np.bincount(labels.ravel() // (n_labels // n_model), minlength=n_model)
    log(f"  all {n_model} model slots streamed (each leaf shard drawn from its seed, its "
        f"program run, the shard freed): {e['n']} queries' top-{e['topk']} of "
        f"{n_labels:,} labels in {stream_s:.3f} s wall, peak {peak / 1e9:.3f} GB; the merge "
        f"bitwise the CPU's merge of the same candidates; slot 0 bitwise its first draw; "
        f"top-10 labels a model slot {owners.tolist()}  [{gpu}]")
    top = int(owners.argmax())
    cpu_leaf = host(sd.make_leaf_shard(top, n_model, geom, device=device, seed=e["seed"]))
    cpu_top = sd.device_step(cxi, cxv, *cpu_upper, *cpu_leaf, m=top, **step_kw)
    log(f"  model slot {top} (the most top-10 labels), card vs CPU: "
        f"{held_cpu(cands[top], cpu_top, f'enterprise slot {top}, card vs CPU')}")


def examples_phase(gpu: str) -> None:
    """Phase 17: both new examples as subprocesses on the card."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (os.pathsep + env["PYTHONPATH"]
                                             if env.get("PYTHONPATH") else "")
    for cmd in EXAMPLES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *cmd], cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=EXAMPLES_TIMEOUT_S)
        lines = proc.stdout.strip().splitlines()
        log(f"  {' '.join(cmd)}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
        for ln in lines[-12:]:
            log(f"    | {ln}")
        if proc.returncode != 0:
            log(proc.stderr[-3000:])
            raise AssertionError(f"{cmd[0]} exited {proc.returncode}")
        if cmd[0].endswith("lm_tree_head_torch.py") and \
                "full-beam exactness: 1.000" not in proc.stdout:
            raise AssertionError("lm_tree_head_torch.py: full-beam exactness is not 1.000")
        if cmd[0].endswith("serve_search_torch.py") and "microbatch-" not in proc.stdout:
            raise AssertionError("serve_search_torch.py did not reach its online setting")


def _leaf_err(torch, got, want) -> float:
    """max |got - want| over max |want| (both tensors)."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def spmd_vs_plain(torch, mesh, device) -> str:
    """Reduced yi-6b on ``mesh`` (DTensor) against the plain port on
    ``device``, from the same parameters: prefill and greedy decode (the
    sharded run fed the plain run's tokens), then one ``make_train_step``
    step (AdamW): the loss, every gradient (none reaching the optimizer
    with placements other than its parameter's), and every leaf the sharded
    update makes from the plain step's gradients. Raises past ``SPMD_TOL``;
    returns a summary."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import batch_specs, shard_opt_state, shard_params
    from repro_torch.launch.train import init_opt_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import Optimizer, get_optimizer
    from torch.utils._pytree import tree_flatten

    r, tol = SPMD_SMALL, SPMD_TOL
    cfg = dataclasses.replace(reduced_config(get_config(LM_ARCH)), remat=True,
                              activ_dtype=torch.float32)
    rules = spmd.RuleMesh(mesh)
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (r["batch"], r["seq"]))
                                 .astype(np.int32)).to(device) for k in ("tokens", "targets")}
    p_sh = shard_params(params, rules)

    def copy(tree):
        return lm._map(lambda a: a.clone(), tree)

    def place(tree, shardings):
        return spmd.distribute_tree(tree, shardings, mesh)

    dbatch = place(batch, batch_specs(cfg, batch, rules))
    plain, sharded = copy(params), place(copy(params), p_sh)
    logits, cache = lm.prefill(cfg, plain, batch, r["max_len"])
    dlogits, dcache = lm.prefill(cfg, sharded, dbatch, r["max_len"])
    scale = 1 + float(logits[:, -1].abs().max())
    pre_err = float((dlogits.full_tensor()[:, -1] - logits[:, -1]).abs().max()) / scale
    if not pre_err <= tol["logits"]:
        raise AssertionError(f"sharded prefill logits off the plain ones by {pre_err:.3e}")
    tok, dec_err, decided = logits[:, -1].argmax(-1).int(), 0.0, 0
    for i in range(r["steps"]):
        lg, cache = lm.decode_step(cfg, plain, cache, tok, r["seq"] + i)
        dtok = spmd.distribute_tensor(tok, mesh, spmd.batch_placements(tok.shape, mesh),
                                      src_data_rank=None)
        dlg, dcache = lm.decode_step(cfg, sharded, dcache, dtok, r["seq"] + i)
        dlg = dlg.full_tensor()
        scale = 1 + float(lg.abs().max())
        err = float((dlg - lg).abs().max()) / scale
        top2 = lg.topk(2, -1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol["logits"] * scale
        if not (err <= tol["logits"] and torch.equal(dlg.argmax(-1)[sure], lg.argmax(-1)[sure])):
            raise AssertionError(f"sharded decode step {i}: logits off by {err:.3e}")
        dec_err, decided = max(dec_err, err), decided + int(sure.sum())
        tok = lg.argmax(-1).int()

    inner, seen = get_optimizer("adamw"), {}

    def update(grads, state, prm, lr):
        if "plain" not in seen:
            seen["plain"] = grads
            return inner.update(grads, state, prm, lr)
        flat_g, _ = tree_flatten(grads)
        flat_p, _ = tree_flatten(prm)
        seen["mismatch"] = sum(tuple(g.placements) != tuple(p.placements)
                               for g, p in zip(flat_g, flat_p))
        seen["sharded"] = spmd.full_tree(grads)
        return inner.update(place(seen["plain"], p_sh), state, prm, lr)

    step = make_train_step(cfg, Optimizer(inner.init, update, "adamw"), peak_lr=r["lr"],
                           warmup=0)
    p1, _, m = step(copy(params), init_opt_state(inner, params), batch)
    dstate = place(init_opt_state(inner, params), shard_opt_state(
        init_opt_state(inner, params), params, rules))
    dp1, _, dm = step(place(copy(params), p_sh), dstate, dbatch)
    loss, dloss = float(m["loss"]), float(dm["loss"])
    if not abs(dloss - loss) <= tol["loss"] * abs(loss) or seen["mismatch"]:
        raise AssertionError(f"sharded loss {dloss} against {loss}; {seen['mismatch']} "
                             "gradients off their parameter's placements")
    g_err = max(_leaf_err(torch, g, w) for g, w in zip(tree_flatten(seen["sharded"])[0],
                                                      tree_flatten(seen["plain"])[0]))
    p_err = max(_leaf_err(torch, g, w) for g, w in zip(tree_flatten(spmd.full_tree(dp1))[0],
                                                      tree_flatten(p1)[0]))
    if not (g_err <= tol["leaf"] and p_err <= tol["leaf"]):
        raise AssertionError(f"sharded gradients off by {g_err:.3e}, updated leaves by "
                             f"{p_err:.3e} of their leaf's max")
    return (f"loss {dloss:.6f} / {loss:.6f}; gradients within {g_err:.3e} and updated leaves "
            f"within {p_err:.3e} of each leaf's max; no gradient off its parameter's "
            f"placements; prefill logits within {pre_err:.3e} x (1 + max); {r['steps']} decode "
            f"steps' logits within {dec_err:.3e} x (1 + max), {decided} greedy tokens decided "
            f"and equal")


def spmd_rank0(torch, gpu: str, dry: dict) -> None:
    """Phase 18 (b): rank 0's program of the (16, 16) production mesh at
    yi-6b's full width, its collectives sent to a fake group: train_4k,
    prefill_32k and decode_32k timed against that rank's counted bounds."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import (batch_specs, shard_opt_state,
                                                  shard_params)
    from repro_torch.launch.mesh import make_production_spmd_mesh
    from repro_torch.launch.specs import input_specs
    from repro_torch.launch.train import init_opt_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import get_optimizer
    from torch.utils._pytree import tree_leaves

    cfg, r = get_config(LM_ARCH), SPMD_RANK0

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(fn) -> float:
        start, stop = events()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    def report(shape: str, ms: list, what: str) -> None:
        rec = dry[shape]
        rf = rec["roofline"]
        med = float(np.median(ms))
        peak = torch.cuda.max_memory_allocated()
        arg = rec["memory"]["argument_size_in_bytes"]
        log(f"  {LM_ARCH} {shape}, rank 0 of (16, 16): {what} {', '.join(f'{t:.1f}' for t in ms)}"
            f" ms (median {med:.1f}); that rank's counted bound compute "
            f"{1e3 * rf['compute_s']:.1f} ms ({med / (1e3 * rf['compute_s']):.3f} x), memory "
            f"{1e3 * rf['memory_s']:.1f} ms ({med / (1e3 * rf['memory_s']):.3f} x); peak device "
            f"memory {peak / 1e9:.3f} GB against the dry run's {arg / 1e9:.3f} GB of arguments "
            f"a device  [{gpu}]")

    def meta(specs):
        return {k: torch.empty(s, dtype=dt, device="meta") for k, (s, dt) in specs.items()}

    with make_production_spmd_mesh() as mesh:
        rules = spmd.RuleMesh(mesh)
        log(f"  rank 0 of a fake process group of {mesh.size()}: every collective returns at "
            "once, so no byte crosses a card and the values (gathered blocks unwritten) are "
            "not checked here")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        shapes = lm.param_shapes(cfg)
        params = spmd.local_tree(shapes, shard_params(shapes, rules), mesh, seed=r["seed"],
                                 device="cuda")
        inner = get_optimizer(cfg.optimizer)
        opt_shapes = init_opt_state(inner, shapes)
        state = spmd.zeros_tree(opt_shapes, shard_opt_state(opt_shapes, shapes, rules), mesh,
                                device="cuda")
        bshapes = meta(input_specs(cfg, SHAPES["train_4k"]))
        batch = spmd.local_tree(bshapes, batch_specs(cfg, bshapes, rules), mesh,
                                seed=r["seed"] + 1, device="cuda", high=cfg.vocab)
        torch.cuda.synchronize()
        held_bytes = sum(t.to_local().numel() * t.element_size()
                         for t in tree_leaves((params, state, batch)))
        log(f"  rank 0's shards drawn on the card in {time.perf_counter() - t0:.2f} s: "
            f"{held_bytes:,} bytes (the dry run: "
            f"{dry['train_4k']['memory']['argument_size_in_bytes']:,})")
        step = make_train_step(cfg, inner)
        ms = []
        for i in range(1 + r["train_steps"]):
            t = timed(lambda: step(params, state, batch))
            if i:
                ms.append(t)
        report("train_4k", ms, f"AdamW, remat {cfg.remat_policy!r}, a step (after 1 warm-up)")
        wall, acts, busy_us, rows = device_profile(lambda: step(params, state, batch))
        log_profile("one train_4k step of rank 0", wall, acts, busy_us, rows, gpu, 8)
        if busy_us:
            log(f"  train_4k step: {acts} device activities, idle share "
                f"{1 - busy_us / (1e6 * wall):.4f} (profiler on)")
        del state, batch, step
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bshapes = meta(input_specs(cfg, SHAPES["prefill_32k"]))
        batch = spmd.local_tree(bshapes, batch_specs(cfg, bshapes, rules), mesh,
                                seed=r["seed"] + 2, device="cuda", high=cfg.vocab)
        seq = SHAPES["prefill_32k"].seq_len
        ms = [timed(lambda: lm.prefill(cfg, params, batch, max_len=seq))]
        report("prefill_32k", ms, "one call")
        del batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        shape = SHAPES["decode_32k"]
        cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, device="cuda", mesh=mesh)
        tshape = {"t": torch.empty((shape.global_batch,), dtype=torch.int32, device="meta")}
        tokens = spmd.local_tree(tshape, batch_specs(cfg, tshape, rules), mesh,
                                 seed=r["seed"] + 3, device="cuda", high=cfg.vocab)["t"]

        def decode():
            lm.decode_step(cfg, params, cache, tokens, shape.seq_len - 1)

        decode()
        ms = [timed(decode) for _ in range(r["decode_steps"])]
        report("decode_32k", ms, "a step (after 1 warm-up)")
        wall, acts, busy_us, rows = device_profile(decode)
        log_profile("one decode_32k step of rank 0", wall, acts, busy_us, rows, gpu, 8)
        if busy_us:
            log(f"  decode_32k step: {acts} device activities, idle share "
                f"{1 - busy_us / (1e6 * wall):.4f} (profiler on)")
        del cache, tokens, params


def spmd_rank_main(rank: int, world: int, directory: str) -> int:
    """One rank of phase 18 (c), on its own card: ``spmd_vs_plain`` on a
    (2, world/2) NCCL mesh ((1, 1) for a world of one); rank 0 writes the
    summary to ``directory``. ``tests/test_torch_cuda.py`` runs it too."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed import spmd

    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (1, 1) if world == 1 else (2, world // 2)
    with spmd.spmd_mesh(shape, ("data", "model"), backend="nccl", rank=rank,
                        init_dir=directory) as mesh:
        summary = spmd_vs_plain(torch, mesh, f"cuda:{rank}")
    if rank == 0:
        Path(directory, "summary.txt").write_text(summary)
    return 0


def spmd_cards(torch, gpu: str) -> None:
    """Phase 18 (c): with 2 or more cards, (a) on a (2, n/2) NCCL mesh."""
    import os
    import tempfile

    n = torch.cuda.device_count()
    if n < 2:
        log(f"  (c) not run: {n} card visible, and NCCL puts no two ranks of a mesh on one "
            "card; the (2, n/2) run needs a machine with 2 or more")
        return
    world = 2 * (n // 2)
    env = dict(os.environ)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--spmd-rank",
                                   str(rk), "--spmd-world", str(world), "--spmd-dir", d],
                                  cwd=ROOT, env=env) for rk in range(world)]
        try:
            codes = [p.wait(timeout=SPMD_CARDS_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise AssertionError(f"(c) ranks exited {codes}")
        log(f"  (c) reduced {LM_ARCH} on a (2, {world // 2}) NCCL mesh of {world} cards against "
            f"the plain port: {Path(d, 'summary.txt').read_text()}; "
            f"{time.perf_counter() - t0:.1f} s  [{gpu}]")


def spmd_phase(torch, gpu: str, dry: dict) -> None:
    """Phase 18: the LM as one program over a mesh (DTensor)."""
    import tempfile

    from repro_torch.distributed import spmd

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d, \
            spmd.spmd_mesh((1, 1), ("data", "model"), backend="nccl", init_dir=d) as mesh:
        summary = spmd_vs_plain(torch, mesh, "cuda")
    log(f"  (a) reduced {LM_ARCH} on a world-1 NCCL mesh of (1, 1) against the plain port on "
        f"the card: {summary}; {time.perf_counter() - t0:.1f} s  [{gpu}]")
    torch.cuda.empty_cache()
    spmd_rank0(torch, gpu, dry)
    torch.cuda.empty_cache()
    spmd_cards(torch, gpu)


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernels phase: print the kernel line (without "
                         "path launches) and no ok line; for comparing kernel versions")
    ap.add_argument("--spmd-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--spmd-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--spmd-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.spmd_rank is not None:
        return spmd_rank_main(args.spmd_rank, args.spmd_world, args.spmd_dir)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import mscm_kernel as mk
    from repro_torch.quant import kernels as qk
    from repro_torch.quant.storage import quantize_chunks

    t_all = time.perf_counter()
    gpu = gpu_line()
    log(f"phase device (at {time.perf_counter() - t_all:.1f} s)")
    log(gpu)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  {torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for matmul and cuDNN (true f32 oracle)")

    log(f"phase build (at {time.perf_counter() - t_all:.1f} s)")
    t0 = time.perf_counter()
    build.build_libraries(list(build.SIGNATURES))
    for name in build.SIGNATURES:
        build.load_library(name)
        report = [ln.strip() for ln in build.BUILD_LOGS.get(name, "").splitlines()
                  if "registers" in ln or "spill" in ln]
        log(f"  {name}: {'; '.join(report) or 'already built'}")
    log(f"  built in {time.perf_counter() - t0:.2f} s")

    log(f"phase kernels (at {time.perf_counter() - t_all:.1f} s)")
    grouped = kernel_check(torch, mk, build)
    fused, pregather = block_kernel_check(torch, mk, ops, build)
    grouped_q = quant_kernel_check(torch, mk, qk, quantize_chunks)
    grouped["past_caps"] = past_cap_timings(torch, mk, qk, quantize_chunks)
    if args.kernels_only:
        print(json.dumps({"kernels": [grouped, fused, pregather, grouped_q]}))
        return 0
    # The kernels phase leaves GBs of inputs in PyTorch's caching allocator;
    # the paths below start from an empty cache, as a server process would.
    torch.cuda.empty_cache()
    log(f"phase small (at {time.perf_counter() - t_all:.1f} s)")
    small_check(torch)
    log(f"phase path (at {time.perf_counter() - t_all:.1f} s)")
    grouped["launches"], tree, queries, random_levels = path(torch, mk, gpu)
    log(f"phase quant (at {time.perf_counter() - t_all:.1f} s)")
    grouped_q["launches"] = quant(torch, mk, qk, gpu, tree, queries)
    log(f"phase online (at {time.perf_counter() - t_all:.1f} s)")
    pregather["launches"], fused["launches"] = online(torch, mk, gpu, tree, queries)
    log(f"phase server (at {time.perf_counter() - t_all:.1f} s)")
    grouped["server_launches"], grouped_q["server_launches"] = server(
        torch, mk, qk, gpu, tree, queries)
    log(f"phase partition (at {time.perf_counter() - t_all:.1f} s)")
    grouped["partition_launches"], grouped_q["partition_launches"] = partition(
        torch, mk, qk, gpu, tree, queries)
    log(f"phase fleet (at {time.perf_counter() - t_all:.1f} s)")
    grouped["fleet_launches"], grouped_q["fleet_launches"] = fleet(
        torch, mk, qk, gpu, tree, queries)
    log(f"phase ckpt (at {time.perf_counter() - t_all:.1f} s)")
    ckpt(torch, mk, qk, gpu, tree, queries)
    del tree, queries
    torch.cuda.empty_cache()
    log(f"phase train (at {time.perf_counter() - t_all:.1f} s)")
    grouped["train_launches"] = train(torch, mk, gpu, random_levels)
    log(f"phase lm (at {time.perf_counter() - t_all:.1f} s)")
    lm_phase(torch, gpu)
    log(f"phase lm_train (at {time.perf_counter() - t_all:.1f} s)")
    step_ms = lm_train_phase(torch, gpu)
    torch.cuda.empty_cache()
    log(f"phase dryrun (at {time.perf_counter() - t_all:.1f} s)")
    dry, dry_lm = dryrun_phase(torch, gpu, step_ms)
    log(f"phase enterprise (at {time.perf_counter() - t_all:.1f} s)")
    enterprise_phase(torch, gpu, dry)
    torch.cuda.empty_cache()
    log(f"phase examples (at {time.perf_counter() - t_all:.1f} s)")
    examples_phase(gpu)
    log(f"phase spmd (at {time.perf_counter() - t_all:.1f} s)")
    spmd_phase(torch, gpu, dry_lm)
    log(f"done in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [grouped, fused, pregather, grouped_q]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
