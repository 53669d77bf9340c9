"""PyTorch port, the LM scaffold's configs, input specs and shared
primitives against the reference's: ``repro_torch.configs``,
``repro_torch.launch.specs`` and ``repro_torch.models.common``.

Configs and parameter counts are compared exactly (every field equal, the
dtype fields by name); specs by shapes and dtype names; the primitives
(``rms_norm``, RoPE, cross-entropy, the promoted products) within ``F32``
(rtol and atol 1e-5), on the same seeded inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import specs as JSpecs
from repro.models import common as JCommon
from repro_torch import configs as TC
from repro_torch.launch import specs as TSpecs
from repro_torch.models import common as TCommon

F32 = dict(rtol=1e-5, atol=1e-5)
DTYPE_FIELDS = ("param_dtype", "activ_dtype")


def fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    for f in DTYPE_FIELDS:
        out[f] = str(jnp.dtype(out[f]) if not isinstance(out[f], torch.dtype)
                     else out[f]).removeprefix("torch.")
    return out


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_config_and_reduced_config_equal_the_references(arch):
    j, t = JC.get_config(arch), TC.get_config(arch)
    assert fields(t) == fields(j)
    assert fields(TC.reduced_config(t)) == fields(JC.reduced_config(j))
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert (t.supports_long_context, t.has_decoder) == (j.supports_long_context, j.has_decoder)
    for name, shape in JC.SHAPES.items():
        assert TC.runnable(t.family, TC.SHAPES[name]) == JC.runnable(j.family, shape)


def test_registry_and_shapes():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    assert list(TC.all_configs()) == list(JC.all_configs())
    assert {k: dataclasses.astuple(v) for k, v in TC.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JC.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("gpt-2")
    yi = TC.get_config("yi-6b")
    assert yi.n_params() == 6_060_769_280  # 24.24 GB in the default f32


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
@pytest.mark.parametrize("shape", list(JC.SHAPES))
def test_input_specs_match_the_references(arch, shape):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    j = JSpecs.input_specs(jcfg, JC.SHAPES[shape])
    t = TSpecs.input_specs(tcfg, TC.SHAPES[shape])
    assert list(t) == list(j)
    if JC.SHAPES[shape].kind == "decode":
        assert sorted(t["cache"]) == sorted(j["cache"])  # (jax sorts a dict's keys)
        pairs = [(t["cache"][k], j["cache"][k]) for k in j["cache"]]
        pairs += [(t[k], j[k]) for k in ("tokens", "pos")]
    else:
        pairs = [(t[k], j[k]) for k in j]
    for (shp, dt), sds in pairs:
        assert tuple(shp) == sds.shape
        assert str(dt).removeprefix("torch.") == str(sds.dtype)


def test_rms_norm_rope_and_loss_match_the_references():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        TCommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(JCommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))), **F32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = TCommon.rms_norm(xb, torch.from_numpy(scale))
    want = JCommon.rms_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2**-7, atol=1e-6)
    pos = np.arange(5, 12)
    for theta in (1e4, 5e6):
        tc, ts = TCommon.rope_angles(torch.from_numpy(pos), 16, theta)
        jc, js = JCommon.rope_angles(jnp.asarray(pos), 16, theta)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **F32)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32)
        np.testing.assert_allclose(
            TCommon.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
            np.asarray(JCommon.apply_rope(jnp.asarray(x), jc, js)), **F32)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    tgt = rng.integers(0, 11, size=(3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = TCommon.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(tgt),
                                         None if m is None else torch.from_numpy(m))
        want = JCommon.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(tgt),
                                          None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), **F32)


def test_promoted_products():
    """f32 x bf16 promotes to f32, as JAX does (torch.matmul refuses the
    pair); bf16 x bf16 sums in f32 and rounds once."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 40)).astype(np.float32)
    b = rng.standard_normal((40, 5)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b).to(torch.bfloat16)
    got = TCommon.dot(ta, tb)
    want = jnp.asarray(a) @ jnp.asarray(b).astype(jnp.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    got = TCommon.einsum("ik,kj->ij", ta.to(torch.bfloat16), tb)
    assert got.dtype == torch.bfloat16
    exact = (ta.to(torch.bfloat16).double() @ tb.double()).to(torch.bfloat16)
    assert torch.equal(got, exact)
    with pytest.raises(RuntimeError):
        ta @ tb  # what the helpers are for


def test_dense_init_and_meta():
    g = torch.Generator().manual_seed(0)
    w = TCommon.dense_init(g, (256, 512), 256, device="cpu")
    assert w.dtype == torch.float32 and abs(float(w.std()) - 1 / 16) < 2e-3
    m = TCommon.dense_init(g, (10, 3), 10, torch.bfloat16, device="meta")
    assert m.device.type == "meta" and m.dtype == torch.bfloat16
    s = g.get_state()
    TCommon.dense_init(g, (10, 3), 10, device="meta")
    assert torch.equal(g.get_state(), s)  # nothing drawn on meta


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """With no device named and no card, entry points raise rather than
    run on the CPU."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.reduced_config(TC.get_config("yi-6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSpecs.make_demo_batch(cfg, np.random.default_rng(0), 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCommon.dense_init(torch.Generator(), (2, 2), 2)
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, {"p": {"w": np.ones(2, np.float32)}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.restore({"p": {"w": np.zeros(2, np.float32)}})  # a leaf with no device
    _, out = ck.restore({"p": {"w": np.zeros(2, np.float32)}}, device="cpu")
    assert out["p"]["w"].tolist() == [1.0, 1.0]
