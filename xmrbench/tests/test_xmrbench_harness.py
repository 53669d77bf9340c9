"""The harness's pieces at a tiny configuration on the CPU, through the
engine's plain path: cells by name, the traffic loop, the check and its
control and faults, the last line's form, the import guard and the exit
without a card."""

import json
import os
import subprocess
import sys
import time
import types

import pytest

from xmrbench import control, harness

from conftest import ROOT

CELLS = ("ent16-batch", "ent16-online", "amazon3m-online")


def _run(cell, seed=2**31 + 5, seconds=0.3, traced=False, hook=None):
    return harness.run_cell(cell, seed, seconds, traced, device="cpu",
                            t_start=time.perf_counter(), engine_hook=hook)


@pytest.mark.parametrize("name", CELLS)
def test_cells_load_by_name(name):
    cell = harness.load_cell(name)
    mode = cell.mix["mode"]
    assert name.endswith(mode)
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == ({"batch_qps"} if mode == "batch" else {"online_p50_ms", "online_p95_ms"}) \
        | {"peak_mem_gb", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        f"{mode}_mfu", f"kernel_roofline.{mode}", f"idle_share.{mode}",
        f"activities_per_query.{mode}"}
    geom = harness.gen.Geometry.of(cell.config)
    assert geom.n_labels == cell.config["n_labels"]


def test_every_metric_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


@pytest.mark.parametrize("mode", ["batch", "online"])
def test_run_is_correct_and_well_formed(tiny_cell, mode):
    result, checks = _run(tiny_cell(mode))
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"score_gap", "label_gap", "malformed", "weights_changed"}
    assert checks["score_gap"][0] < 1e-5 and checks["label_gap"][0] < 1e-5
    # Device metrics are not read off a CPU run: set-up time is all there is.
    assert set(result["metrics"]) == {"setup_s"}
    assert result["metrics"]["setup_s"]["unit"] == "s"
    json.loads(json.dumps(result))


@pytest.mark.parametrize("mode", ["batch", "online"])
def test_traced_run(tiny_cell, mode):
    result, _ = _run(tiny_cell(mode), traced=True)
    assert result["correct"] is True
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "busy_s" in result["device"] and result["device"]["window_s"] > 0


@pytest.mark.parametrize("mode", ["batch", "online"])
def test_control_is_not_correct(tiny_cell, mode):
    result, checks = _run(tiny_cell(mode), hook=control.control_hook())
    assert result["correct"] is False
    assert checks["score_gap"][0] > checks["score_gap"][1]


@pytest.mark.parametrize("mode,fault", [("batch", f) for f in control.FAULTS]
                         + [("online", f) for f in ("alter_answer", "stale")])
def test_faults_are_not_correct(tiny_cell, mode, fault):
    result, _ = _run(tiny_cell(mode), hook=control.fault_hook(fault))
    assert result["correct"] is False
    assert result["failed"] > 0


@pytest.mark.parametrize("mode", ["batch", "online"])
def test_share_through_the_planner(tiny_cell, tiny_share, mode):
    """One chip's share runs through the port's scatter-gather planner and
    passes; the control and each fault fail."""
    cell = tiny_cell(mode, tiny_share)
    result, checks = _run(cell)
    assert result["correct"] is True and result["failed"] == 0, checks
    assert checks["score_gap"][0] < 1e-5 and checks["label_gap"][0] < 1e-5
    engine = harness.build_engine(
        harness.gen.make_tree(harness.gen.Geometry.of(tiny_share), 1, "cpu"),
        harness.gen.Geometry.of(tiny_share), tiny_share["serve"], "cpu")
    assert engine.planner is not None and engine.index.parts[0].n_labels == 32
    bad, _ = _run(cell, hook=control.control_hook())
    assert bad["correct"] is False
    kinds = control.FAULTS if mode == "batch" else ("alter_answer", "stale")
    for kind in kinds:
        res, _ = _run(cell, hook=control.fault_hook(kind))
        assert res["correct"] is False, kind


def test_written_weights_are_caught(tiny_cell):
    def hook(engine, levels, geom, serve):
        levels[-1].chunk_vals[0, 0, 0] += 1.0
        return engine
    result, checks = _run(tiny_cell("batch"), hook=hook)
    assert checks["weights_changed"][0] == 1 and result["correct"] is False


def test_import_guard(monkeypatch):
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_extra", types.ModuleType("repro_torch_extra"))
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.banned_modules() == ["jax", "repro"]


def test_the_program_loads_no_banned_module():
    code = ("import sys; sys.path[:0] = [%r, %r]; from xmrbench import harness; "
            "import repro_torch.serving.engine, repro_torch.kernels.ops; "
            "print(harness.banned_modules())" % (str(ROOT / "src"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "xmrbench/run.py", "--workload", "ent16-online",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "CUDA" in out.stderr


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r, %r]; import xmrbench.reference, xmrbench.gen, "
            "xmrbench.work; print(sorted(m for m in sys.modules if m.startswith('repro')))"
            % (str(ROOT / "src"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_control_and_program_on_the_card(cuda, tiny_cell, tiny_config):
    """On the card, the grouped kernel's answers pass and the control's fail."""
    cfg = dict(tiny_config, d=200_000, branching=[3, 32, 32], n_cols=[3, 96, 3050],
               n_labels=3050, chunk_rows=[192, 496, 496], col_nnz=64, query_nnz=100)
    cfg["serve"] = dict(cfg["serve"], ell_width=128)
    cell = tiny_cell("batch", cfg)
    ok, _ = harness.run_cell(cell, 123, 0.5, True, device=cuda, t_start=time.perf_counter())
    bad, _ = harness.run_cell(cell, 123, 0.5, False, device=cuda, t_start=time.perf_counter(),
                              engine_hook=control.control_hook())
    assert ok["correct"] is True, ok
    assert bad["correct"] is False, bad
    assert ok["metrics"]["kernel_roofline.batch"]["value"] > 0
