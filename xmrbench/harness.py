"""One run of one cell: set-up, the measured window, the traced window, the
check, and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<name>.json``: the tree's sizes, the engine's
settings, the check's limits) and a traffic mix (``traffic/<name>.json``:
the parameters the one loop below reads). Each metric is read by
``metrics/<name>.py`` from the run's :class:`Record`.

Set-up makes the tree and the query pool on the device from the seed
(:mod:`gen`), builds ``repro_torch``'s ``XMRServingEngine`` over the tree,
and warms the buckets the mix uses. Where the configuration is one chip's
share of a label-partitioned tree, the engine serves through the port's
scatter-gather planner: the levels above the leaves as the router head,
the held leaf chunks as the one partition on this chip (:func:`build_engine`). The window drives the engine as the
mix says, closed loop, one client: ``batch`` sends back-to-back
``serve_batch`` calls of ``call_queries`` queries; ``online`` sends
back-to-back ``serve_online`` calls of one query, each timed from the
client. With tracing on, ``trace_calls`` further calls run under
``torch.profiler`` after the window, tracing the device alone, then
``breakdown_calls`` tracing the host too. Once the windows have closed and the
memory peak is read, the engine is dropped and :mod:`reference` works out
a sample of the window's answers again, drawn from the seed.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from xmrbench import gen, reference, trace, work
from xmrbench.work import Work

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules the process may not hold: JAX and the JAX package
#: (``repro``, whose name ``repro_torch`` begins with), and the repository's
#: JAX benchmark and examples.
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks", "examples")


def banned_modules() -> List[str]:
    """Banned top-level names among the loaded modules, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    its mix and the metrics it reports."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = _by_name(bench["workloads"], name, "workload")
    cfg = json.loads((root / _by_name(bench["configs"], wl["config"], "config")["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, int(wl["chips"]), cfg, mix, e2e, per_layer)


def load_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"xmrbench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers read it."""

    mode: str
    on_chip: bool = False
    served: int = 0
    window_s: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    peak_bytes: int = 0
    work: Work = Work()
    trace: Optional[trace.DeviceTrace] = None
    traced_queries: int = 0
    traced_work: Work = Work()
    breakdown: Optional[dict] = None


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


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _bucket_sizes(n: int, max_batch: int) -> List[int]:
    sizes = {max_batch} if n >= max_batch else set()
    if n % max_batch:
        sizes.add(1 << (n % max_batch - 1).bit_length())
    return sorted(min(s, max_batch) for s in sizes)


def _run_calls(engine, traffic: Traffic, mode: str, call_queries: int, *,
               seconds: Optional[float] = None, calls: Optional[int] = None):
    """Back-to-back calls until ``seconds`` have passed (the call that
    crosses the deadline completes) or ``calls`` are done. Returns (answers
    ``[(pool rows, scores, labels)]``, per-call client seconds, elapsed)."""
    out, lat = [], []
    t0 = time.perf_counter()
    while True:
        if calls is not None and len(out) >= calls:
            break
        rows, csr = traffic.next(call_queries)
        ts = time.perf_counter()
        if mode == "batch":
            s, l = engine.serve_batch(csr)
        else:
            s, l = engine.serve_online(csr)
        te = time.perf_counter()
        lat.append(te - ts)
        out.append((rows, s, l))
        if seconds is not None and te - t0 >= seconds:
            break
    return out, lat, time.perf_counter() - t0


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
    _log(f"distinct chunks a bucket of {mb}, the window's first {n // mb}, reference / "
         "work.py: " + "; ".join(parts))
    if geom.leaf_chunks is not None:
        c, _, _ = geom.shapes()[-1]
        h0, h1 = geom.leaf_chunks
        p = work.chunks_per_query(geom.n_cols, serve["beam"])[-1]
        _log(f"held leaf chunks a query there, reference / work.py: {q:.4f} / "
             f"{p * (h1 - h0) / c:.4f}")


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *, device,
             t_start: float, engine_hook: Optional[Callable] = None
             ) -> Tuple[dict, Dict[str, Tuple[float, float]]]:
    """One run. Returns (the result line's object, the checks ``{name:
    (value, limit)}``). ``engine_hook(engine, levels, geom, serve)`` may
    put something else in the engine's place (the control, a fault)."""
    cfg, mix = cell.config, cell.mix
    geom = gen.Geometry.of(cfg)
    serve = dict(cfg["serve"])
    if serve.get("score_mode", "prod") != "prod":
        raise ValueError("the reference scores in 'prod' mode only")
    if serve.get("ell_width", 256) < geom.query_nnz:
        raise ValueError("ell_width below query_nnz: the engine would cut every query")
    dev = torch.device(device)
    mode, call_q = mix["mode"], int(mix["call_queries"])
    if mode not in ("batch", "online") or (mode == "online" and call_q != 1):
        raise ValueError(f"unknown mix mode {mode!r} with {call_q} queries a call")

    marks = [("start", t_start)]
    levels = gen.make_tree(geom, seed, dev)
    sums = gen.checksum(levels)
    _sync(dev)
    marks.append(("tree", time.perf_counter()))
    warm_calls = int(mix["warm_calls"])
    trace_calls = int(mix["trace_calls"]) if traced else 0
    breakdown_calls = int(mix["breakdown_calls"]) if traced else 0
    n_pool = (int(math.ceil(float(mix["pool_rate"]) * seconds))
              + (warm_calls + trace_calls + breakdown_calls) * call_q
              + int(mix["judge_queries"]))
    pool = gen.make_pool(geom, levels, mix, n_pool, seed, dev)
    _sync(dev)
    marks.append(("pool", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    engine = build_engine(levels, geom, serve, dev)
    if engine_hook is not None:
        engine = engine_hook(engine, levels, geom, serve)
    marks.append(("engine", time.perf_counter()))
    engine.warmup(geom.d, batch_sizes=_bucket_sizes(call_q, serve["max_batch"]))
    marks.append(("warmup", time.perf_counter()))
    traffic = Traffic(pool, geom.d)
    _run_calls(engine, traffic, mode, call_q, calls=warm_calls)
    _sync(dev)
    marks.append(("warm calls", time.perf_counter()))
    if banned_modules():
        raise RuntimeError(f"banned modules loaded before the window: {banned_modules()}")

    rec = Record(mode=mode, on_chip=dev.type == "cuda")
    rec.setup_s = time.perf_counter() - t_start
    _log("set-up s: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:]))
        + f"; pool {len(pool)} queries")
    out, lat, rec.window_s = _run_calls(engine, traffic, mode, call_q, seconds=seconds)
    rec.served = len(out) * call_q
    rec.latencies_s = lat
    q = np.percentile(lat, [0, 25, 50, 75, 100]) * 1e3
    _log(f"window: {len(out)} calls in {rec.window_s:.3f} s; call ms min/q1/median/q3/max "
        + " / ".join(f"{v:.3f}" for v in q))
    if dev.type == "cuda":
        rec.peak_bytes = int(torch.cuda.max_memory_allocated())
    shapes = geom.shapes()
    held = [h1 - h0 for h0, h1 in map(geom.held, range(len(shapes)))]
    per_call = work.call_work(shapes, geom.n_cols, call_q, max_batch=serve["max_batch"],
                              beam=serve["beam"], topk=serve["topk"],
                              query_nnz=geom.query_nnz, held=held)
    rec.work = per_call * len(out)
    if traffic.cursor > len(pool):
        _log(f"the pool wrapped: {traffic.cursor} queries sent from a pool of {len(pool)}")

    if traced:
        rec.trace, rec.breakdown = _traced_windows(engine, traffic, mode, call_q, trace_calls,
                                                   breakdown_calls, dev)
        rec.traced_queries = trace_calls * call_q
        rec.traced_work = per_call * trace_calls

    del engine
    if banned_modules():
        raise RuntimeError(f"banned modules loaded: {banned_modules()}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    k = min(serve["topk"], geom.n_labels)
    rows, scores, labels, bad = _collect(out, k, geom.n_labels)
    del out
    checks, failed_judged = judge(levels, geom, serve, pool, rows, scores, labels, bad,
                                  n_judge=int(mix["judge_queries"]), seed=seed,
                                  device=dev, limits=cfg["check"])
    log_visits(levels, geom, serve, pool, rows, dev)
    checks["malformed"] = (int(bad.sum()), 0)
    checks["weights_changed"] = (sum(a != b for a, b in zip(sums, gen.checksum(levels))), 0)
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = load_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": rec.served,
        "failed": int(bad.sum()) + failed_judged,
        "metrics": metrics,
        "device": _device(dev, cell.chips, rec),
    }
    if rec.breakdown is not None:
        result["breakdown"] = rec.breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    return result, checks


def _traced_windows(engine, traffic, mode, call_q, trace_calls, breakdown_calls, dev):
    """Two traced windows after the measured one: ``trace_calls`` calls
    traced on the device alone, whose numbers the per-layer metrics read,
    then ``breakdown_calls`` calls traced on the host too, which name the
    idle gaps (host tracing slows the host several-fold)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = dev.type == "cuda"
    out = []
    for calls, acts in ((trace_calls, [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]),
                        (breakdown_calls, [ProfilerActivity.CPU]
                         + ([ProfilerActivity.CUDA] if on_card else []))):
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                _run_calls(engine, traffic, mode, call_q, calls=calls)
                _sync(dev)
        t1 = time.perf_counter()
        out.append(trace.read(prof))
        _log(f"traced {calls} calls ({[a.name for a in acts]}) in {t1 - t0:.3f} s, "
            f"read in {time.perf_counter() - t1:.3f} s")
        del prof
    return out[0], out[1].breakdown()


def _device(dev: torch.device, chips: int, rec: Record) -> dict:
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
               "memory_peak_bytes": rec.peak_bytes}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if rec.trace is not None:
        out["busy_s"] = rec.trace.busy_s
        out["window_s"] = rec.trace.window_s
    return out
