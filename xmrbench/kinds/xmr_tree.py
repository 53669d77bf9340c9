"""The XMR tree kind: ``repro_torch``'s serving engine over a tree drawn
from the seed.

The configuration (``configs/<name>.json``) holds the tree's sizes, the
engine's settings and the check's limits; the traffic mix the parameters
of the one pool generator and loop. Set-up makes the tree and the query
pool on the device from the seed (:mod:`gen`), builds ``repro_torch``'s
``XMRServingEngine`` over the tree, and warms the buckets the mix uses.
Where the configuration is one chip's share of a label-partitioned tree,
the engine serves through the port's scatter-gather planner: the levels
above the leaves as the router head, the held leaf chunks as the one
partition on this chip (:func:`build_engine`). A call is, as the mix says,
one ``serve_batch`` call of ``call_queries`` queries (``batch``) or one
``serve_online`` call of one query (``online``). Once the windows have
closed the engine is dropped and :mod:`reference` works out a sample of
the window's answers again, drawn from the seed.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from xmrbench import control, gen, reference, work
from xmrbench.kinds import log, sync


class Traffic:
    """The pool as the program's CSR calls, in pool order, wrapping."""

    def __init__(self, pool: gen.Pool, d: int):
        from repro_torch.sparse.csr import CSR

        self.pool, self.d, self._csr = pool, d, CSR
        self.cursor = 0
        self.q = pool.ids.shape[1]

    def next(self, count: int):
        """``(pool rows, CSR)`` of the next ``count`` queries."""
        start, n = self.cursor, len(self.pool)
        self.cursor += count
        if start % n + count <= n:
            s = start % n
            ids, vals = self.pool.ids[s:s + count], self.pool.vals[s:s + count]
        else:
            r = self.pool.rows(start, count)
            ids, vals = self.pool.ids[r], self.pool.vals[r]
        indptr = np.arange(count + 1, dtype=np.int64) * self.q
        csr = self._csr(indptr, ids.reshape(-1), vals.reshape(-1), (count, self.d))
        return self.pool.rows(start, count), csr


def _bucket_sizes(n: int, max_batch: int) -> List[int]:
    sizes = {max_batch} if n >= max_batch else set()
    if n % max_batch:
        sizes.add(1 << (n % max_batch - 1).bit_length())
    return sorted(min(s, max_batch) for s in sizes)


def _collect(out, k: int, n_labels: int):
    """The window's answers as ``(rows [N], scores [N, k], labels [N, k],
    malformed [N])``: a call whose answer has the wrong shape, a score that
    is not finite or a label out of range marks its queries malformed."""
    rows, ss, ls, bad = [], [], [], []
    for r, s, l in out:
        s, l = np.asarray(s), np.asarray(l)
        n = len(r)
        ok = s.shape == (n, k) and l.shape == (n, k)
        if ok:
            b = ~(np.isfinite(s).all(1) & ((l >= 0) & (l < n_labels)).all(1))
        else:
            s, l, b = np.full((n, k), np.nan), np.full((n, k), -1), np.ones(n, bool)
        rows.append(r)
        ss.append(s.astype(np.float64))
        ls.append(l.astype(np.int64))
        bad.append(b)
    return np.concatenate(rows), np.concatenate(ss), np.concatenate(ls), np.concatenate(bad)


#: A score at or below this is the program's mark of a slot that no held
#: candidate fills (the port's ``NEG_INF``, -1e30, is one).
NONE_BELOW = -1e29


def build_engine(levels, geom: gen.Geometry, serve: dict, device):
    """``repro_torch``'s engine over the generator's tensors. For one chip's
    share (``geom.leaf_chunks``) the port has no constructor: its
    ``ServeConfig(partition=...)`` cuts a whole tree, which no chip holds.
    So the share is assembled as ``partition_tree`` would leave it on this
    chip (the levels above the leaves as the router head, the held leaf
    chunks and their spare chunk as the one partition) and served by the
    port's ``ScatterGatherPlanner``, which the engine's partitioned path
    runs every bucket through."""
    from repro_torch.core.tree import TreeLayerArrays, XMRTree
    from repro_torch.serving.engine import ServeConfig, XMRServingEngine

    layers = [TreeLayerArrays(l.chunk_rows, l.chunk_vals, l.col_rows, l.col_vals)
              for l in levels]
    if geom.leaf_chunks is None:
        tree = XMRTree(layers=layers, n_cols=geom.n_cols, branching=geom.branching, d=geom.d)
        return XMRServingEngine(tree, ServeConfig(**serve), device=device)
    from repro_torch.index.partition import PartitionedIndex, PartitionInfo, PartitionManifest
    from repro_torch.index.planner import ScatterGatherPlanner

    split = len(layers) - 1
    head = XMRTree(layers=layers[:split], n_cols=geom.n_cols[:split],
                   branching=geom.branching[:split], d=geom.d)
    c0, c1 = geom.leaf_chunks
    b = geom.branching[-1]
    part = XMRTree(layers=layers[split:], n_cols=(min(c1 * b, geom.n_labels) - c0 * b,),
                   branching=geom.branching[split:], d=geom.d)
    info = PartitionInfo(pid=0, chunk_start=c0, chunk_end=c1, label_start=c0 * b,
                         label_end=c0 * b + part.n_labels, memory_bytes=part.memory_bytes(),
                         content_hash="")
    manifest = PartitionManifest(
        level=split, n_partitions=1, n_labels=geom.n_labels, d=geom.d,
        branching=geom.branching, router_memory_bytes=head.memory_bytes(),
        total_memory_bytes=head.memory_bytes() + part.memory_bytes(), partitions=[info])
    index = PartitionedIndex(head=head, parts=[part], manifest=manifest, n_cols=geom.n_cols,
                             branching=geom.branching)
    engine = XMRServingEngine(head, ServeConfig(**serve), device=device)
    c = engine.config
    engine.index = index
    engine.planner = ScatterGatherPlanner(
        index, beam=c.beam, topk=c.topk, method=engine.method, score_mode=c.score_mode,
        qt=c.qt, sync=c.partition.partition_sync)
    return engine


def _judged_rows(geom: gen.Geometry, pool: gen.Pool, rows, n_judge: int, seed: int):
    """Positions in ``rows`` to judge, drawn from the seed. On one chip's
    share, half among the queries whose target this chip holds (most
    others find no held leaf, and their answers are empty), half among the
    rest."""
    g = torch.Generator().manual_seed(gen.sub_seed(seed, "judge"))
    if geom.leaf_chunks is None:
        return torch.randperm(len(rows), generator=g)[:n_judge].sort().values.numpy()
    c0, c1 = geom.leaf_chunks
    b = geom.branching[-1]
    t = pool.targets[rows]
    mine = (t >= c0 * b) & (t < c1 * b)
    pick = []
    for group, count in ((np.flatnonzero(mine), n_judge // 2),
                         (np.flatnonzero(~mine), n_judge - n_judge // 2)):
        pick.append(group[torch.randperm(len(group), generator=g)[:count].numpy()])
    return np.sort(np.concatenate(pick))


def judge(levels, geom: gen.Geometry, serve: dict, pool: gen.Pool, rows, scores, labels,
          bad, *, n_judge: int, seed: int, device, limits: Dict[str, float]):
    """Compare a sample of the window's answers, drawn from the seed, with
    the reference. Returns (checks ``{name: (value, limit)}``, failed
    queries among the judged and malformed)."""
    pick = _judged_rows(geom, pool, rows, n_judge, seed)
    dev = torch.device(device)
    qi = torch.from_numpy(pool.ids[rows[pick]]).to(dev)
    qv = torch.from_numpy(pool.vals[rows[pick]]).to(dev)
    s = torch.from_numpy(scores[pick]).to(dev)
    lab = torch.from_numpy(labels[pick]).to(dev)
    ok = ~torch.from_numpy(bad[pick]).to(dev)
    ref_s, _ = reference.search(levels, geom.n_cols, geom.branching, qi, qv,
                                beam=serve["beam"], topk=serve["topk"])
    path = reference.path_scores(levels, geom.branching, qi, qv,
                                 lab.clamp(0, geom.n_labels - 1))
    inf = torch.tensor(math.inf, dtype=torch.float64, device=dev)
    # An empty slot (no held candidate) has to be empty on both sides.
    empty, ref_empty = s <= NONE_BELOW, ref_s == -math.inf

    def gap(a, b, judged):
        g = torch.where(judged, (a - b).abs() / b.abs(), 0.0)
        g = torch.where(empty != ref_empty, inf, g).amax(1)
        return torch.where(ok & ~torch.isnan(g), g, inf)

    score_gap = gap(s, ref_s, ~empty & ~ref_empty)
    label_gap = gap(s, path, ~empty)
    per_query = (score_gap > limits["score_gap"]) | (label_gap > limits["label_gap"])
    checks = {
        "score_gap": (float(score_gap.max()), limits["score_gap"]),
        "label_gap": (float(label_gap.max()), limits["label_gap"]),
    }
    return checks, int(per_query.sum())


#: Buckets at the window's start whose visited chunks a run logs.
VISIT_BUCKETS = 4


def log_visits(levels, geom: gen.Geometry, serve: dict, pool: gen.Pool, rows, device) -> None:
    """Log the distinct chunks that the reference's beams visit in the
    window's first buckets (``VISIT_BUCKETS`` groups of ``max_batch``
    queries, in the order sent), a level, beside :mod:`work`'s count for
    the same visits a query; on one chip's share, also the held leaf
    chunks visited a query beside :mod:`work`'s ``p * H / C``."""
    mb = serve["max_batch"]
    n = min(len(rows), VISIT_BUCKETS * mb)
    if n < mb:
        return
    dev = torch.device(device)
    visits = [[] for _ in levels]
    reference.search(levels, geom.n_cols, geom.branching,
                     torch.from_numpy(pool.ids[rows[:n]]).to(dev),
                     torch.from_numpy(pool.vals[rows[:n]]).to(dev),
                     beam=serve["beam"], topk=serve["topk"], visits=visits)
    parts = []
    for li, v in enumerate(visits):
        v = torch.cat(v).cpu().numpy()
        h0, h1 = geom.held(li)
        groups = [v[i:i + mb] for i in range(0, n - mb + 1, mb)]
        seen = np.mean([len(np.unique(g[g >= 0])) for g in groups])
        q = np.mean([(g >= 0).sum() / len(g) for g in groups])
        parts.append(f"level {li} {seen:.1f} / {work.distinct_chunks(mb, q, h1 - h0):.1f}")
    log(f"distinct chunks a bucket of {mb}, the window's first {n // mb}, reference / "
         "work.py: " + "; ".join(parts))
    if geom.leaf_chunks is not None:
        c, _, _ = geom.shapes()[-1]
        h0, h1 = geom.leaf_chunks
        p = work.chunks_per_query(geom.n_cols, serve["beam"])[-1]
        log(f"held leaf chunks a query there, reference / work.py: {q:.4f} / "
             f"{p * (h1 - h0) / c:.4f}")


def validate(config: dict, mix: dict) -> None:
    geom = gen.Geometry.of(config)
    serve = config["serve"]
    if serve.get("score_mode", "prod") != "prod":
        raise ValueError("the reference scores in 'prod' mode only")
    if serve.get("ell_width", 256) < geom.query_nnz:
        raise ValueError("ell_width below query_nnz: the engine would cut every query")
    mode, call_q = mix["mode"], int(mix["call_queries"])
    if mode not in ("batch", "online") or (mode == "online" and call_q != 1):
        raise ValueError(f"unknown mix mode {mode!r} with {call_q} queries a call")


class Run:
    """One cell's engine, tree and pool. ``hook(engine, levels, geom,
    serve)`` may put something else in the engine's place."""

    def __init__(self, config: dict, mix: dict, seed: int, seconds: float, traced: bool, *,
                 device, hook=None, marks=None):
        marks = [] if marks is None else marks
        self.config, self.seed, self.dev = config, seed, torch.device(device)
        self.geom = geom = gen.Geometry.of(config)
        self.serve = serve = dict(config["serve"])
        self.mode, self.per_call = mix["mode"], int(mix["call_queries"])
        self.judge_queries = int(mix["judge_queries"])
        self.levels = gen.make_tree(geom, seed, self.dev)
        self.sums = gen.checksum(self.levels)
        sync(self.dev)
        marks.append(("tree", time.perf_counter()))
        self.warm_calls = int(mix["warm_calls"])
        self.trace_calls = int(mix["trace_calls"]) if traced else 0
        self.breakdown_calls = int(mix["breakdown_calls"]) if traced else 0
        n_pool = (int(math.ceil(float(mix["pool_rate"]) * seconds))
                  + (self.warm_calls + self.trace_calls + self.breakdown_calls) * self.per_call
                  + self.judge_queries)
        self.pool = gen.make_pool(geom, self.levels, mix, n_pool, seed, self.dev)
        sync(self.dev)
        marks.append(("pool", time.perf_counter()))
        log(f"pool {len(self.pool)} queries")
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        engine = build_engine(self.levels, geom, serve, self.dev)
        if hook is not None:
            engine = hook(engine, self.levels, geom, serve)
        self.engine = engine
        marks.append(("engine", time.perf_counter()))
        engine.warmup(geom.d, batch_sizes=_bucket_sizes(self.per_call, serve["max_batch"]))
        marks.append(("warmup", time.perf_counter()))
        self.traffic = Traffic(self.pool, geom.d)
        self._serve = engine.serve_batch if self.mode == "batch" else engine.serve_online
        shapes = geom.shapes()
        held = [h1 - h0 for h0, h1 in map(geom.held, range(len(shapes)))]
        self.per_call_work = work.call_work(
            shapes, geom.n_cols, self.per_call, max_batch=serve["max_batch"],
            beam=serve["beam"], topk=serve["topk"], query_nnz=geom.query_nnz, held=held)
        self.out = []

    def next_input(self, i: int):
        return self.traffic.next(self.per_call)

    def call(self, x):
        return self._serve(x[1])

    def begin_window(self, i: int) -> None:
        pass

    def keep(self, i: int, x, out) -> None:
        s, l = out
        self.out.append((x[0], s, l))

    def work(self, i0: int, i1: int) -> work.Work:
        return self.per_call_work * (i1 - i0)

    def release(self) -> None:
        if self.traffic.cursor > len(self.pool):
            log(f"the pool wrapped: {self.traffic.cursor} queries sent from a pool of "
                 f"{len(self.pool)}")
        self.engine = self._serve = None

    def check(self):
        geom, serve = self.geom, self.serve
        k = min(serve["topk"], geom.n_labels)
        rows, scores, labels, bad = _collect(self.out, k, geom.n_labels)
        self.out = []
        checks, failed_judged = judge(self.levels, geom, serve, self.pool, rows, scores, labels,
                                      bad, n_judge=self.judge_queries, seed=self.seed,
                                      device=self.dev, limits=self.config["check"])
        log_visits(self.levels, geom, serve, self.pool, rows, self.dev)
        checks["malformed"] = (int(bad.sum()), 0)
        checks["weights_changed"] = (
            sum(a != b for a, b in zip(self.sums, gen.checksum(self.levels))), 0)
        return checks, int(bad.sum()) + failed_judged


setup = Run


control_hook = control.control_hook


def fault_hooks(mix: dict):
    kinds = control.FAULTS if mix["mode"] == "batch" else ("alter_answer", "stale")
    return {k: control.fault_hook(k) for k in kinds}
