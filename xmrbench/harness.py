"""One run of one cell: set-up, the measured window, the traced windows,
the check, and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<name>.json``: the program's sizes and settings,
the check's limits) and a traffic mix (``traffic/<name>.json``: the
parameters of the kind's one generator and loop). The configuration's
``kind`` (``xmr_tree`` where it names none) is the module
``kinds/<kind>.py`` that sets the program and its inputs up from the seed,
makes one call of the window, counts a call's work and checks the window's
answers against its own plain reference (see :mod:`xmrbench.kinds`). Each
metric is read by ``metrics/<name>.py`` from the run's :class:`Record`.

The loop here is the same for every kind. Set-up (the kind's, then
``warm_calls`` calls) is timed from the process's start. The window makes
back-to-back calls, closed loop, one client, each timed from the client,
until ``--seconds`` have passed. With tracing on, ``trace_calls`` further
calls run under ``torch.profiler`` after the window, tracing the device
alone, then ``breakdown_calls`` tracing the host too. Once the windows have
closed and the memory peak is read, the program's state is dropped and the
kind checks its sample of the window's answers.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from xmrbench import gen, trace  # noqa: F401  (gen: the xmr_tree kind's generator)
from xmrbench.kinds import log, sync
from xmrbench.kinds.xmr_tree import Traffic, build_engine  # noqa: F401
from xmrbench.work import Work

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules the process may not hold: JAX and the JAX package
#: (``repro``, whose name ``repro_torch`` begins with), and the repository's
#: JAX benchmark and examples.
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks", "examples")
#: The kind of a configuration that names none.
DEFAULT_KIND = "xmr_tree"


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
    kinds: Path = HERE / "kinds"


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
    traced_calls: int = 0
    traced_queries: int = 0
    traced_work: Work = Work()
    breakdown: Optional[dict] = None


def load_kind(name: str, kinds: Path = HERE / "kinds"):
    """The kind module ``kinds/<name>.py``, found by its name as configs,
    mixes and metrics are."""
    path = Path(kinds) / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise KeyError(f"no kind named {name!r}: {path} is missing")
    if Path(kinds) == HERE / "kinds":
        return importlib.import_module(f"xmrbench.kinds.{name}")
    spec = importlib.util.spec_from_file_location(f"xmrbench_kind_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_calls(run, i: int, *, seconds: Optional[float] = None, calls: Optional[int] = None,
               keep: bool = False):
    """Back-to-back calls of ``run``, numbered from ``i``, until ``seconds``
    have passed (the call that crosses the deadline completes) or ``calls``
    are done; with ``keep``, each answer is handed to ``run.keep``. Returns
    (calls made, per-call client seconds, elapsed)."""
    lat = []
    n = 0
    t0 = time.perf_counter()
    while True:
        if calls is not None and n >= calls:
            break
        x = run.next_input(i + n)
        ts = time.perf_counter()
        out = run.call(x)
        te = time.perf_counter()
        lat.append(te - ts)
        if keep:
            run.keep(i + n, x, out)
        n += 1
        if seconds is not None and te - t0 >= seconds:
            break
    return n, lat, time.perf_counter() - t0


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *, device,
             t_start: float, engine_hook: Optional[Callable] = None
             ) -> Tuple[dict, Dict[str, Tuple[float, float]]]:
    """One run. Returns (the result line's object, the checks ``{name:
    (value, limit)}``). ``engine_hook`` may put something else in the
    program's place (the control, a fault); its form is the kind's."""
    kind = load_kind(cell.config.get("kind", DEFAULT_KIND), cell.kinds)
    kind.validate(cell.config, cell.mix)
    dev = torch.device(device)
    marks = [("start", t_start)]
    run = kind.setup(cell.config, cell.mix, seed, seconds, traced, device=dev,
                     hook=engine_hook, marks=marks)
    i, _, _ = _run_calls(run, 0, calls=run.warm_calls)
    sync(dev)
    marks.append(("warm calls", time.perf_counter()))
    if banned_modules():
        raise RuntimeError(f"banned modules loaded before the window: {banned_modules()}")

    rec = Record(mode=run.mode, on_chip=dev.type == "cuda")
    rec.setup_s = time.perf_counter() - t_start
    log("set-up s: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])))
    run.begin_window(i)
    n, lat, rec.window_s = _run_calls(run, i, seconds=seconds, keep=True)
    rec.served, rec.latencies_s = n * run.per_call, lat
    q = np.percentile(lat, [0, 25, 50, 75, 100]) * 1e3
    log(f"window: {n} calls in {rec.window_s:.3f} s; call ms min/q1/median/q3/max "
        + " / ".join(f"{v:.3f}" for v in q))
    if dev.type == "cuda":
        rec.peak_bytes = int(torch.cuda.max_memory_allocated())
    rec.work = run.work(i, i + n)
    i += n

    if traced:
        rec.trace, rec.breakdown = _traced_windows(run, i, dev)
        rec.traced_calls = run.trace_calls
        rec.traced_queries = run.trace_calls * run.per_call
        rec.traced_work = run.work(i, i + run.trace_calls)

    run.release()
    if banned_modules():
        raise RuntimeError(f"banned modules loaded: {banned_modules()}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks, failed = run.check()
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = load_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": rec.served,
        "failed": int(failed),
        "metrics": metrics,
        "device": _device(dev, cell.chips, rec),
    }
    if rec.breakdown is not None:
        result["breakdown"] = rec.breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    return result, checks


def _traced_windows(run, i: int, dev):
    """Two traced windows after the measured one: ``run.trace_calls`` calls
    traced on the device alone, whose numbers the per-layer metrics read,
    then ``run.breakdown_calls`` calls traced on the host too, which name
    the idle gaps (host tracing slows the host several-fold)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = dev.type == "cuda"
    out = []
    for calls, acts in ((run.trace_calls, [ProfilerActivity.CUDA] if on_card
                         else [ProfilerActivity.CPU]),
                        (run.breakdown_calls, [ProfilerActivity.CPU]
                         + ([ProfilerActivity.CUDA] if on_card else []))):
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                n, _, _ = _run_calls(run, i, calls=calls)
                sync(dev)
        i += n
        t1 = time.perf_counter()
        out.append(trace.read(prof))
        log(f"traced {calls} calls ({[a.name for a in acts]}) in {t1 - t0:.3f} s, "
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
