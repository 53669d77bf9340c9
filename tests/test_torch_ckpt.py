"""PyTorch port, checkpoints: ``repro_torch.checkpoint`` against
``repro.checkpoint`` on the same seeded leaves.

The format is shared, so the comparisons are exact: each package writes the
same file names, the same bytes in every ``.npy`` and the same
``manifest.json`` text, for f32, int32, int8, bf16 and fp8 leaves, dict /
tuple / list / ``None`` nesting and the quantized ``QuantLayerArrays``
dataclass; each restores the other's f32 and integer files bitwise; the
port also restores the reference's bf16 and fp8 files (void ``<V2`` /
``<V1`` arrays of the raw bytes), which the reference's own ``restore``
cannot read. Restored values are compared bitwise (no tolerance: nothing is
computed).
"""

import os
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.quant.storage import QuantLayerArrays as JQuantLayerArrays
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.quant.storage import QuantizedTree, QuantLayerArrays, quantize_tree


def bits(t) -> np.ndarray:
    """A leaf's raw bytes as an unsigned integer array (any dtype)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        return t.contiguous().view(width).numpy().view(f"u{t.element_size()}")
    a = np.asarray(t)
    return a.view(f"u{a.itemsize}")


def files_of(root: Path) -> dict:
    """Every file under ``root``: relative path -> bytes."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def leaves(rng):
    """Seeded leaves of every dtype, as (numpy or raw bits, dtype name)."""
    nan8 = np.array([0x7F, 0xFF], np.uint8)
    u8 = rng.integers(0, 256, size=(3, 5)).astype(np.uint8)
    u8[np.isin(u8, nan8)] = 0x38            # no fp8 NaN patterns
    i16 = rng.integers(-2**15, 2**15, size=(4, 6)).astype(np.int16)
    i16[(i16 & 0x7F80) == 0x7F80] = 0x3F80  # no bf16 NaN / inf patterns
    return {
        "f32": rng.standard_normal((4, 3)).astype(np.float32),
        "i32": rng.integers(-1000, 1000, size=(7,)).astype(np.int32),
        "i8": rng.integers(-127, 128, size=(2, 3, 4)).astype(np.int8),
        "bf16": i16,
        "fp8": u8,
    }


def jax_leaf(name, a):
    if name == "bf16":
        return jax.lax.bitcast_convert_type(jnp.asarray(a), jnp.bfloat16)
    if name == "fp8":
        return jax.lax.bitcast_convert_type(jnp.asarray(a), jnp.float8_e4m3fn)
    return jnp.asarray(a)


def port_leaf(name, a):
    t = torch.from_numpy(a.copy())
    if name == "bf16":
        return t.view(torch.bfloat16)
    if name == "fp8":
        return t.view(torch.float8_e4m3fn)
    return t


def states(rng):
    """The same nested state in both packages: dicts (unsorted keys),
    tuples, lists, None, every dtype and two quantized layers (int8, fp8)."""
    lv = leaves(rng)
    rows = rng.integers(0, 50, size=(3, 4)).astype(np.int32)
    scales = rng.random((3, 8)).astype(np.float32)
    codes8 = rng.integers(-127, 128, size=(3, 4, 8)).astype(np.int8)

    def build(leaf, qcls, fp8_codes):
        return {
            "params": {"zeta": leaf("f32", lv["f32"]), "alpha": {"w": leaf("bf16", lv["bf16"]),
                                                                 "n": None},
                       "blocks": (leaf("i32", lv["i32"]), [leaf("i8", lv["i8"]),
                                                           leaf("fp8", lv["fp8"])])},
            "layers": [
                qcls(chunk_rows=leaf("i32", rows), chunk_vals=leaf("i8", codes8),
                     chunk_scales=leaf("f32", scales)),
                qcls(chunk_rows=leaf("i32", rows), chunk_vals=fp8_codes,
                     chunk_scales=leaf("f32", scales)),
            ],
        }

    u8 = leaves(np.random.default_rng(5))["fp8"][:3, :4]
    codes_fp8 = np.resize(u8, (3, 4, 8)).astype(np.uint8)
    ref = build(jax_leaf, JQuantLayerArrays, jax_leaf("fp8", codes_fp8))
    port = build(port_leaf, QuantLayerArrays, port_leaf("fp8", codes_fp8))
    return ref, port


def assert_same_bits(ref_state, port_state):
    """Every leaf of each named tree: the same key (the reference's path
    string) and the same bytes."""
    from repro.checkpoint.ckpt import _flatten

    for name in ref_state:
        r = _flatten(ref_state[name])
        p = dict(ckpt_mod._leaves_with_path(port_state[name]))
        assert list(r) == list(p)
        for key in r:
            np.testing.assert_array_equal(bits(r[key]), bits(p[key]), err_msg=key)


# ---------------------------------------------------------------------------
# 1. the reference's checkpoint tests, in the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_write=False)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    ck.save(10, state)
    ck.save(20, state)
    ck.save(30, state)
    assert ck.list_steps() == [20, 30]  # keep=2 retention
    step, restored = ck.restore(state)
    assert step == 30
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 7


def test_checkpoint_async_and_atomic(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=True)
    state = {"params": {"w": torch.ones(4)}}
    ck.save(1, state)
    ck.wait()
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    step, restored = ck.restore(state)
    assert step == 1
    assert torch.equal(restored["params"]["w"], torch.ones(4))


def test_checkpoint_elastic_restore_to_other_structure(tmp_path):
    """Mesh-independent format: restore is pure logical arrays."""
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(5, {"params": {"w": torch.arange(8.0)}})
    _, restored = ck.restore({"params": {"w": torch.zeros(8, dtype=torch.float32)}})
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.arange(8.0, dtype=np.float32))


@pytest.mark.parametrize("tier", ["int8", "fp8"])
def test_checkpoint_roundtrip_quantized_layers(tmp_path, tier):
    """QuantLayerArrays survive the npy checkpoint path with their codes
    intact (the reference's ``test_quant.py`` test, and fp8 beside it)."""
    from repro_torch.core.tree import XMRTree
    from repro_torch.sparse.csr import random_sparse_csc

    rng = np.random.default_rng(29)
    ws = [random_sparse_csc(200, n, 10, rng, sibling_groups=8) for n in (8, 64, 512)]
    tree = XMRTree.from_weight_matrices(ws, 8, device="cpu")
    qtree = quantize_tree(tree, tier=tier)
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(0, {"layers": qtree.layers})
    step, out = ck.restore({"layers": qtree.layers})
    assert step == 0
    restored = QuantizedTree(layers=out["layers"], n_cols=qtree.n_cols,
                             branching=qtree.branching, d=qtree.d, tier=qtree.tier)
    for a, b in zip(qtree.layers, restored.layers):
        assert b.chunk_vals.dtype == a.chunk_vals.dtype
        for f in ("chunk_rows", "chunk_vals", "chunk_scales"):
            np.testing.assert_array_equal(bits(getattr(a, f)), bits(getattr(b, f)))


# ---------------------------------------------------------------------------
# 2. one format: the same files, each package reading the other's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("async_write", [False, True])
def test_same_files_bytes_and_manifest(tmp_path, async_write):
    ref, port = states(np.random.default_rng(0))
    meta = {"arch": "yi-6b", "note": [1, 2]}
    jck = JCheckpointer(str(tmp_path / "ref"), async_write=async_write)
    jck.save(3, ref, meta)
    ck = Checkpointer(str(tmp_path / "port"), async_write=async_write)
    ck.save(3, port, meta)
    jck.wait()
    ck.wait()
    jf = files_of(tmp_path / "ref")
    tf = files_of(tmp_path / "port")
    assert sorted(jf) == sorted(tf)
    assert "step_00000003/layers/0__.chunk_rows.npy" in tf
    assert "step_00000003/params/blocks__1__1.npy" in tf
    for name in jf:
        assert jf[name] == tf[name], name
    manifest = tf["step_00000003/manifest.json"].decode()
    assert manifest == jf["step_00000003/manifest.json"].decode()
    header = tf["step_00000003/params/alpha__w.npy"][:80]
    assert b"'descr': '<V2'" in header


@pytest.mark.parametrize("dtype", ["f32", "i32", "i8"])
def test_reference_writes_port_restores(tmp_path, dtype):
    a = leaves(np.random.default_rng(1))[dtype]
    JCheckpointer(str(tmp_path), async_write=False).save(
        2, {"params": {"x": jax_leaf(dtype, a), "y": (jax_leaf(dtype, a[..., :1]),)}})
    template = {"params": {"x": torch.zeros_like(port_leaf(dtype, a)),
                           "y": (torch.zeros_like(port_leaf(dtype, a[..., :1])),)}}
    step, out = Checkpointer(str(tmp_path)).restore(template)
    assert step == 2
    np.testing.assert_array_equal(bits(out["params"]["x"]), bits(a))
    np.testing.assert_array_equal(bits(out["params"]["y"][0]), bits(a[..., :1]))
    assert out["params"]["x"].dtype == port_leaf(dtype, a).dtype


@pytest.mark.parametrize("dtype", ["f32", "i32", "i8"])
def test_port_writes_reference_restores(tmp_path, dtype):
    a = leaves(np.random.default_rng(2))[dtype]
    Checkpointer(str(tmp_path), async_write=False).save(
        4, {"params": {"x": port_leaf(dtype, a), "y": [port_leaf(dtype, a[:1])]}})
    template = {"params": {"x": jnp.zeros_like(jax_leaf(dtype, a)),
                           "y": [jnp.zeros_like(jax_leaf(dtype, a[:1]))]}}
    step, out = JCheckpointer(str(tmp_path)).restore(template)
    assert step == 4
    np.testing.assert_array_equal(bits(np.asarray(out["params"]["x"])), bits(a))
    np.testing.assert_array_equal(bits(np.asarray(out["params"]["y"][0])), bits(a[:1]))


def test_port_restores_reference_bf16_fp8_and_quantized(tmp_path):
    ref, port = states(np.random.default_rng(3))
    JCheckpointer(str(tmp_path), async_write=False).save(9, ref)
    template = {"params": port["params"], "layers": port["layers"]}
    zeroed = ckpt_mod._rebuild(template, iter(
        torch.zeros_like(t) for _, t in ckpt_mod._leaves_with_path(template)))
    step, out = Checkpointer(str(tmp_path)).restore(zeroed)
    assert step == 9
    assert out["params"]["alpha"]["w"].dtype == torch.bfloat16
    assert out["params"]["blocks"][1][1].dtype == torch.float8_e4m3fn
    assert out["params"]["alpha"]["n"] is None
    assert isinstance(out["layers"][1], QuantLayerArrays)
    assert list(out["params"]) == list(port["params"])  # the template's key order
    assert_same_bits(ref, out)


def test_port_roundtrip_every_dtype_async(tmp_path):
    _, port = states(np.random.default_rng(4))
    ck = Checkpointer(str(tmp_path), keep=1, async_write=True)
    ck.save(1, port)
    ck.save(2, port)
    ck.wait()
    assert ck.list_steps() == [2] and ck.latest_step() == 2
    step, out = ck.restore(port, device="cpu")
    assert step == 2
    for (k1, a), (k2, b) in zip(ckpt_mod._leaves_with_path(port),
                                ckpt_mod._leaves_with_path(out)):
        assert k1 == k2 and a.dtype == b.dtype
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=k1)


def test_async_save_snapshots_before_returning(tmp_path):
    """The caller may overwrite its tensor once ``save`` returns."""
    ck = Checkpointer(str(tmp_path), async_write=True)
    w = torch.arange(1000.0)
    ck.save(1, {"p": {"w": w}})
    w.zero_()
    _, out = ck.restore({"p": {"w": w}})
    assert torch.equal(out["p"]["w"], torch.arange(1000.0))


def test_async_write_error_raised_by_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path), async_write=True)
    started = threading.Event()

    def broken(path, arr):
        started.set()
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "_save_npy", broken)
    ck.save(1, {"p": {"w": torch.ones(2)}})
    assert started.wait(10)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # raised once
    assert ck.list_steps() == []


def test_restore_refuses_void_file_into_other_width(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, {"p": {"w": torch.ones(3, dtype=torch.bfloat16)}})
    with pytest.raises(TypeError, match="2-byte float"):
        ck.restore({"p": {"w": torch.ones(3, dtype=torch.float32)}})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"p": {}})


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_reference_lm_checkpoint_restores_to_converted_params(tmp_path, param_dtype):
    """A reduced LM's parameters saved by the reference restore in the port
    to the tensors ``convert.lm_params_from_numpy`` gives (same keys,
    shapes, dtypes and bytes), bf16 parameters included."""
    import dataclasses

    from repro.configs import get_config, reduced_config
    from repro.models import lm as J
    from repro_torch.convert import lm_params_from_numpy

    cfg = dataclasses.replace(reduced_config(get_config("minicpm3-4b")),
                              param_dtype=getattr(jnp, param_dtype))
    jp = J.init_params(cfg, jax.random.PRNGKey(0))
    JCheckpointer(str(tmp_path), async_write=False).save(1, {"params": jp})
    want = lm_params_from_numpy(jax.device_get(jp), device="cpu")
    template = ckpt_mod._rebuild(want, iter(
        torch.zeros_like(t) for _, t in ckpt_mod._leaves_with_path(want)))
    _, out = Checkpointer(str(tmp_path)).restore({"params": template})
    got = dict(ckpt_mod._leaves_with_path(out["params"]))
    for key, w in ckpt_mod._leaves_with_path(want):
        assert got[key].dtype == w.dtype == getattr(torch, param_dtype)
        np.testing.assert_array_equal(bits(got[key]), bits(w), err_msg=key)
