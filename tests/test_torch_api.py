"""PyTorch port, v1 serving API: wire documents, status tables and the
config shim against the reference's.

The counterparts of ``tests/test_api.py``:

1. for the same arrays, ``json.dumps(x.to_wire())`` is the same string in
   both packages, and each package's ``from_wire`` reads the other's
   documents to the same bits (int32 ids, f32 scores);
2. the status and HTTP tables, the typed errors, version refusal;
3. the nested config groups, flat kwargs that warn and never mutate a
   shared group, an unknown kwarg raising, a default config warning
   nothing;
4. every module of ``repro_torch.serving`` (the fleet's and the gateway
   included), ``repro_torch.index`` and the LM's packages (the trainer's
   ``optim``, ``data.lm_data``, ``distributed.fault``, ``launch.train`` and
   ``launch.hw`` included), the launch tools (``mesh``, ``hlo_stats``,
   ``dryrun``, ``serve_dryrun``) and the port's last two examples import
   with ``jax`` and ``repro`` blocked, and
   ``__all__`` is the reference's; without a card, the trainer and
   ``resolve_device`` raise when no device is named.
"""

import dataclasses
import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

import repro.serving as J
import repro.serving.api as japi
import repro_torch.serving as T
import repro_torch.serving.api as tapi

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = [ROOT / "examples" / f"{name}_torch.py" for name in ("serve_search", "lm_tree_head")]


def _exotic_f32():
    """float32 values whose bits must survive the JSON round trip."""
    return np.asarray([0.1, 1 / 3, np.float32(1e-30), np.float32(3.4e38),
                       np.nextafter(np.float32(1.0), np.float32(2.0)), -0.0, 7.7e-7],
                      np.float32)


def _queries(pkg):
    val = _exotic_f32()
    return [
        pkg.Query(idx=np.arange(7, dtype=np.int32) * 1000, val=val, qid=42,
                  deadline_ms=12.5, priority=3),
        pkg.Query(idx=np.asarray([5, 9], np.int64), val=val[:2]),
        pkg.Query(idx=np.zeros(0, np.int32), val=np.zeros(0, np.float32), qid=-1,
                  deadline_ms=0.0),
    ]


def _results(pkg):
    ids, scores = np.asarray([5, 1, 9], np.int32), _exotic_f32()[:3]
    return [
        pkg.QueryResult(qid=7, ids=ids, scores=scores, timing={"e2e_ms": 1.25}),
        pkg.QueryResult(qid=8, ids=ids.astype(np.int64), scores=scores, beam_tier=2,
                        timing={"e2e_ms": 0.5, "queue_ms": 1e-3}),
        pkg.QueryResult(qid=9, ids=ids, scores=scores, degraded=True,
                        missing_labels=[(0, 64), (128, 192)]),
        pkg.QueryResult.from_error(3, pkg.Overloaded(16, "reject"), {"e2e_ms": 0.1}),
        pkg.QueryResult.from_error(4, pkg.DeadlineExceeded(5.0, 1.0)),
        pkg.QueryResult.from_error(5, pkg.WorkerUnavailable("worker0", "begin", "timed out")),
        pkg.QueryResult.from_error(6, RuntimeError("boom")),
    ]


# ---------------------------------------------------------------------------
# 1. byte-identical wire documents, both directions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["Query", "QueryResult"])
def test_wire_documents_byte_identical(kind):
    make = _queries if kind == "Query" else _results
    for j, t in zip(make(J), make(T)):
        assert json.dumps(t.to_wire()) == json.dumps(j.to_wire())


@pytest.mark.parametrize("src,dst", [(J, T), (T, J)])
def test_from_wire_reads_the_other_package(src, dst):
    for q in _queries(src):
        back = dst.Query.from_wire(json.loads(json.dumps(q.to_wire())))
        assert back.idx.dtype == np.int32 and back.val.dtype == np.float32
        np.testing.assert_array_equal(back.idx, q.idx)
        np.testing.assert_array_equal(back.val.view(np.uint32), q.val.view(np.uint32))
        assert (back.qid, back.deadline_ms, back.priority) == (q.qid, q.deadline_ms, q.priority)
        assert json.dumps(back.to_wire()) == json.dumps(q.to_wire())
    for r in _results(src):
        back = dst.QueryResult.from_wire(json.loads(json.dumps(r.to_wire())))
        assert (back.qid, back.status, back.ok, back.http_status) == (
            r.qid, r.status, r.ok, r.http_status)
        assert (back.beam_tier, back.degraded, back.missing_labels, back.detail) == (
            r.beam_tier, r.degraded, r.missing_labels, r.detail)
        assert back.error is None  # exceptions never cross the wire
        if r.ok:
            assert back.ids.dtype == np.int32 and back.scores.dtype == np.float32
            np.testing.assert_array_equal(back.ids, r.ids)
            np.testing.assert_array_equal(back.scores.view(np.uint32),
                                          np.asarray(r.scores).view(np.uint32))
        else:
            assert back.ids is None and back.scores is None
        assert json.dumps(back.to_wire()) == json.dumps(r.to_wire())


# ---------------------------------------------------------------------------
# 2. status tables, typed errors, version refusal
# ---------------------------------------------------------------------------

def test_status_and_http_tables_match_reference():
    assert T.WIRE_VERSION == J.WIRE_VERSION == 1
    assert T.HTTP_STATUS == J.HTTP_STATUS
    names = [n for n in dir(japi) if n.startswith("STATUS_")]
    assert names and names == [n for n in dir(tapi) if n.startswith("STATUS_")]
    assert all(getattr(tapi, n) == getattr(japi, n) for n in names)


@pytest.mark.parametrize("make,status,code", [
    (lambda m: m.Overloaded(8, "reject"), "overloaded", 429),
    (lambda m: m.DeadlineExceeded(5.0, 1.0), "deadline_exceeded", 504),
    (lambda m: m.WorkerUnavailable("worker0", "begin", "timed out"), "worker_unavailable", 503),
    (lambda m: RuntimeError("boom"), "internal_error", 500),
])
def test_status_mapping_matches_reference(make, status, code):
    exc, jexc = make(T), make(J)
    assert T.status_for_exception(exc) == J.status_for_exception(jexc) == status
    assert str(exc) == str(jexc)
    r = T.QueryResult.from_error(0, exc)
    assert (r.status, r.http_status, r.error) == (status, code, exc) and not r.ok
    if status != "internal_error":
        assert isinstance(exc, T.ServingError) and isinstance(exc, RuntimeError)


def test_wire_version_rejected():
    doc = T.Query(idx=np.asarray([1], np.int32), val=np.asarray([1.0], np.float32)).to_wire()
    doc["v"] = 2
    with pytest.raises(T.WireError, match="wire version"):
        T.Query.from_wire(doc)
    with pytest.raises(T.WireError):
        T.QueryResult.from_wire({"v": None, "status": "ok"})
    with pytest.raises(T.WireError, match="malformed"):
        T.Query.from_wire({"v": 1})
    with pytest.raises(T.WireError, match="equal-length"):
        T.Query(idx=np.arange(3), val=np.ones(2, np.float32))
    assert issubclass(T.WireError, ValueError)


def test_result_aliases_and_stream_result():
    r = T.QueryResult(qid=7, ids=np.asarray([5, 1], np.int32), scores=np.ones(2, np.float32))
    assert r.index == 7 and r.labels is r.ids and T.StreamResult is T.QueryResult


# ---------------------------------------------------------------------------
# 3. the config groups and the flat-kwarg shim
# ---------------------------------------------------------------------------

def test_nested_config_groups():
    cfg = T.ServeConfig(
        max_batch=64,
        admission=T.AdmissionConfig(queue_depth=32, shed_policy="shed-oldest", deadline_ms=50.0),
        slo=T.SLOConfig(target_p99_ms=20.0, min_beam=2),
    )
    assert cfg.admission.queue_depth == 32 and cfg.slo.min_beam == 2
    assert (cfg.queue_depth, cfg.shed_policy, cfg.deadline_ms, cfg.target_p99_ms) == (
        32, "shed-oldest", 50.0, 20.0)


def test_flat_kwargs_resolve_and_warn_as_reference():
    kw = dict(beam=5, queue_depth="auto", deadline_ms=10.0, target_p99_ms=8.0, min_beam=2,
              tier="int8")
    with pytest.warns(DeprecationWarning, match="deprecated"):
        cfg = T.ServeConfig(**kw)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        ref = J.ServeConfig(**kw)
    for group in ("admission", "quant", "slo"):
        assert dataclasses.asdict(getattr(cfg, group)) == dataclasses.asdict(getattr(ref, group))
    assert cfg.beam == 5 and cfg.admission.queue_depth == "auto" and cfg.slo.min_beam == 2


@pytest.mark.parametrize("group,flat", [
    ("admission", dict(queue_depth=4)), ("slo", dict(target_p99_ms=5.0)),
    ("quant", dict(prune_keep=0.25)),
])
def test_flat_kwargs_do_not_mutate_shared_group(group, flat):
    cls = {"admission": T.AdmissionConfig, "slo": T.SLOConfig, "quant": T.QuantConfig}[group]
    shared = cls()
    with pytest.warns(DeprecationWarning):
        cfg = T.ServeConfig(**{group: shared}, **flat)
    (name, value), = flat.items()
    assert getattr(getattr(cfg, group), name) == value
    assert shared == cls()  # the caller's instance untouched


def test_unknown_kwarg_raises():
    with pytest.raises(TypeError, match="unexpected keyword"):
        T.ServeConfig(nonsense=1)
    with pytest.raises(TypeError, match="AdmissionConfig"):
        T.ServeConfig(admission=object())


def test_default_config_warns_nothing():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg = T.ServeConfig()
    assert cfg.queue_depth is None and cfg.target_p99_ms is None
    assert dataclasses.is_dataclass(cfg)


# ---------------------------------------------------------------------------
# 4. the port imports nothing of JAX or of the reference
# ---------------------------------------------------------------------------

def test_serving_and_index_import_without_jax_or_repro():
    """Every module of the serving, index, distributed, core, checkpoint,
    configs, models, launch, optim and data packages, and the port's
    examples ``serve_search_torch.py`` and ``lm_tree_head_torch.py``,
    import with jax and repro blocked."""
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for d in ("serving", "serving/fleet", "index", "distributed", "core", "checkpoint",
                  "configs", "models", "launch", "optim", "data")
        for p in (ROOT / "src/repro_torch" / d).glob("*.py"))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None  # any import of them raises ImportError\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import repro_torch.serving as s\n"
        "assert 'MicroBatcher' in s.__all__\n"
        "import importlib.util\n"
        f"for path in {[str(p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(len(s.__all__))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.returncode == 0, out.stderr
    for m in ("repro_torch.serving.batcher", "repro_torch.index.planner",
              "repro_torch.index.placement", "repro_torch.distributed.sharding",
              "repro_torch.core.distributed", "repro_torch.serving.gateway",
              "repro_torch.serving.fleet", "repro_torch.serving.fleet.rpc",
              "repro_torch.serving.fleet.worker", "repro_torch.serving.fleet.launcher",
              "repro_torch.serving.fleet.supervisor", "repro_torch.checkpoint.ckpt",
              "repro_torch.configs.base", "repro_torch.configs.yi_6b",
              "repro_torch.models.lm", "repro_torch.models.xmr_head",
              "repro_torch.models.attention", "repro_torch.models.moe",
              "repro_torch.models.ssm", "repro_torch.launch.specs",
              "repro_torch.optim", "repro_torch.optim.optimizers", "repro_torch.data.lm_data",
              "repro_torch.distributed.fault", "repro_torch.launch.train",
              "repro_torch.launch.hw", "repro_torch.launch.mesh",
              "repro_torch.launch.hlo_stats", "repro_torch.launch.dryrun",
              "repro_torch.launch.serve_dryrun"):
        assert m in modules
    assert T.__all__ == J.__all__


def test_trainer_needs_a_card_unless_a_device_is_named(monkeypatch):
    """With no card, naming no device raises; it never trains on the CPU
    and never allocates a sharded cache there."""
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.tree import resolve_device
    from repro_torch.distributed import spmd
    from repro_torch.launch.train import train_loop
    from repro_torch.models import lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(reduced_config(get_config("yi-6b")), steps=1, batch=2, seq=8)
    with spmd.spmd_mesh((2, 2), ("data", "model"), backend="fake") as mesh:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm.init_cache(reduced_config(get_config("yi-6b")), 4, 8, mesh=mesh)
    assert resolve_device("cpu") == torch.device("cpu")
