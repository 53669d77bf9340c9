"""PyTorch port, the last two examples: ``examples/serve_search_torch.py``
and ``examples/lm_tree_head_torch.py`` on the CPU at a small size.

* the serving example's functions on a 512-label tree (d = 2,000, B = 8):
  ``serve_partitioned`` bitwise the unpartitioned engine, the in-process
  HTTP gateway bitwise ``serve_online`` (its clients post one query at a
  time), the batch panel's methods and the online setting's micro-batcher
  agreeing by ``repro_torch.parity``'s rule (scores within 1e-5 |s| +
  1e-6, labels equal outside near-ties: on the CPU a batch's shape can move
  a score's last bit);
* the tree-head example's evaluation: full-beam exactness 1.0, and its
  greedy tokens at beams 4, 16 and 64 equal to the reference's
  ``greedy_token`` on the same numpy head and hidden states.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.xmr_head import VocabTreeHead as JHead, greedy_token as j_greedy_token
from repro_torch.data.build import build_benchmark_tree
from repro_torch.data.xmr_data import XMRShape, benchmark_queries
from repro_torch.parity import check_ranking
from repro_torch.serving import ServeConfig, XMRServingEngine

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def serve_ex():
    return _example("serve_search_torch")


@pytest.fixture(scope="module")
def tiny():
    shape = XMRShape("tiny", 2000, 8 ** 3, 100, 20, 8)
    rng = np.random.default_rng(0)
    tree = build_benchmark_tree(shape, 8, rng, device="cpu")
    return shape, tree, benchmark_queries(shape, 24, rng)


def test_serve_partitioned_bitwise_the_engine(serve_ex, tiny):
    shape, tree, queries = tiny
    args = serve_ex.parse_args(["--partitions", "2", "--queries", "24", "--device", "cpu"])
    s, l, ref_s, ref_l = serve_ex.serve_partitioned(tree, queries, shape, args)
    np.testing.assert_array_equal(s.view(np.uint32), ref_s.view(np.uint32))
    np.testing.assert_array_equal(l, ref_l)


def test_gateway_in_process_bitwise_serve_online(serve_ex, tiny):
    _, tree, queries = tiny
    args = serve_ex.parse_args(["--gateway", "0", "--queries", "24", "--device", "cpu"])
    s, l = serve_ex.serve_gateway(tree, queries, args)
    want_s, want_l = XMRServingEngine(tree, ServeConfig(beam=10, topk=10, max_batch=64),
                                      device="cpu").serve_online(queries)
    np.testing.assert_array_equal(s.view(np.uint32), want_s.view(np.uint32))
    np.testing.assert_array_equal(l, want_l)


def test_batch_panel_and_online_agree(serve_ex, tiny):
    shape, tree, queries = tiny
    args = serve_ex.parse_args(["--queries", "24", "--device", "cpu"])
    panel = serve_ex.batch_panel(tree, queries, shape, args)
    assert sorted(panel) == ["mscm_dense", "mscm_searchsorted", "vanilla"]
    ref = panel["mscm_dense"]
    for method, (s, l) in panel.items():
        check_ranking(s, l, *ref, method)
    res = serve_ex.online(tree, queries, shape, args, np.random.default_rng(1))
    assert len(res) == 24
    check_ranking(np.stack([r[0] for r in res]), np.stack([r[1] for r in res]), *ref, "online")


def test_serve_search_flags(serve_ex):
    args = serve_ex.parse_args([])
    assert (args.device, args.queries, args.partitions, args.gateway, args.tier) == (
        None, 256, 1, None, "exact")
    with pytest.raises(SystemExit):
        serve_ex.parse_args(["--tier", "fp8", "--gateway", "0", "--partitions", "2"])


def test_lm_tree_head_matches_reference():
    """Full-beam exactness, and the greedy tokens at beams 4, 16 and 64 on
    the same numpy head (d = 128, V = 8,192, B = 64) in both packages."""
    ex = _example("lm_tree_head_torch")
    rng = np.random.default_rng(0)
    d, vocab, b = 128, 8192, 64
    c = vocab // b
    centers = rng.standard_normal((c, d)).astype(np.float32) / np.sqrt(d)
    noise = rng.standard_normal((c, b, d)).astype(np.float32) / np.sqrt(d)
    head = (centers[:, None, :] + 0.4 * noise).reshape(vocab, d).T.astype(np.float32)
    hidden = rng.standard_normal((16, d)).astype(np.float32)
    out = ex.evaluate(torch.from_numpy(head), torch.from_numpy(hidden), b)
    assert out["exact"] == 1.0
    jtree = JHead.from_lm_head(jnp.asarray(head), b)
    for beam in ex.BEAMS:
        want = np.asarray(j_greedy_token(jtree, jnp.asarray(hidden), beam=beam))
        np.testing.assert_array_equal(out[beam][0].numpy(), want)
    g = torch.Generator().manual_seed(0)
    w = ex.structured_head(g, 16, 100, 8)
    assert w.shape == (16, 100) and w.device.type == "cpu"
