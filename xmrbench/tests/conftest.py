"""Shared fixtures of the benchmark's tests: a tiny configuration and mixes
that run on the CPU through the engine's plain path."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_CONFIG = {
    "name": "tiny",
    "d": 3000,
    "branching": [3, 4, 5],
    "n_cols": [3, 11, 52],
    "n_labels": 52,
    "chunk_rows": [24, 40, 40],
    "col_nnz": 8,
    "query_nnz": 30,
    "dtype": "float32",
    "serve": {"beam": 4, "topk": 5, "method": "auto", "max_batch": 8, "ell_width": 64},
    "check": {"score_gap": 1e-4, "label_gap": 1e-4},
}

#: One chip's share of the tiny tree: the last level's chunks [4, 11) of 11
#: (the ragged tail chunk among them), the levels above whole.
TINY_SHARE = dict(TINY_CONFIG, name="tiny-share", leaf_chunks=[4, 11])

TINY_MIXES = {
    "batch": {"mode": "batch", "call_queries": 20, "path_share": 0.5,
              "targets": {"dist": "uniform"}, "pool_rate": 20000, "warm_calls": 1,
              "trace_calls": 1, "breakdown_calls": 1, "judge_queries": 48},
    "online": {"mode": "online", "call_queries": 1, "path_share": 0.5,
               "targets": {"dist": "uniform"}, "pool_rate": 20000, "warm_calls": 2,
               "trace_calls": 4, "breakdown_calls": 2, "judge_queries": 48},
}


@pytest.fixture
def tiny_config():
    return copy.deepcopy(TINY_CONFIG)


@pytest.fixture
def tiny_share():
    return copy.deepcopy(TINY_SHARE)


@pytest.fixture
def tiny_cell():
    """``tiny_cell(mode)``: a Cell of the tiny configuration under the mode's
    mix, reporting the real benchmark's metrics of that mode."""
    from xmrbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    model = {"batch": "ent16-batch", "online": "ent16-online"}

    def make(mode, config=None):
        ref = harness.load_cell(model[mode], ROOT, bench)
        return harness.Cell(f"tiny-{mode}", 1, copy.deepcopy(config or TINY_CONFIG),
                            copy.deepcopy(TINY_MIXES[mode]), ref.end_to_end, ref.per_layer)

    return make


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
