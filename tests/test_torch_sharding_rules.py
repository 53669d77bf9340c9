"""PyTorch port, the LM's sharding rules: ``repro_torch.distributed.sharding``
against ``repro.distributed.sharding``, spec for spec.

For all ten full-size configs, on a (16, 16) ("data", "model") mesh and a
(2, 16, 16) ("pod", "data", "model") one: ``shard_params`` over the
parameters, ``shard_opt_state`` over AdamW's and Adafactor's state,
``batch_specs`` over a ``train_4k`` batch (256 x 4,096) and ``cache_specs``
over a ``decode_32k`` cache (128 x 32,768).
The port's trees are ``meta`` tensors (``param_shapes``, ``init_cache``; no
memory), the reference's ``ShapeDtypeStruct``s on an ``AbstractMesh``; the
port's meshes are stand-ins with ``axis_names`` and ``shape``. Specs must be
equal, leaf by leaf. Then the three rule cases of
``tests/test_sharding_rules.py``, on the port.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.distributed import sharding as J
from repro.launch.specs import input_specs as j_input_specs
from repro.models import lm as JL
from repro.optim import optimizers as JO
from repro_torch import configs as TC
from repro_torch.checkpoint.ckpt import _leaves_with_path
from repro_torch.distributed import sharding as T
from repro_torch.launch.specs import input_specs as t_input_specs
from repro_torch.models import lm as TL
from repro_torch.optim import optimizers as TO

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    def __init__(self, sizes, names):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), FakeMesh(sizes, names)


def specs_equal(got, want, what):
    """``got`` (the port's NamedSharding tree) and ``want`` (the
    reference's) hold the same spec at every leaf path."""
    g = {k: v for k, v in _walk(got)}
    w = {jax.tree_util.keystr(p, simple=True, separator="/"): s
         for p, s in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(g) == sorted(w), what
    for k in w:
        assert isinstance(g[k].spec, T.PartitionSpec), (what, k)
        assert tuple(g[k].spec) == tuple(w[k].spec), (what, k, g[k].spec, w[k].spec)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield "/".join(path), tree


@pytest.fixture(scope="module")
def shapes():
    """Per arch, once: (reference params, port params) as shapes."""
    done = {}

    def get(arch):
        if arch not in done:
            done[arch] = (JL.param_shapes(get_config(arch)),
                          TL.param_shapes(TC.get_config(arch)))
        return done[arch]

    return get


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_match_reference(arch, mesh, shapes):
    jmesh, tmesh = meshes(mesh)
    jp, tp = shapes(arch)
    specs_equal(T.shard_params(tp, tmesh), J.shard_params(jp, jmesh), "params")
    for j_opt, t_opt in ((JO.adamw(), TO.adamw()), (JO.adafactor(), TO.adafactor())):
        js = jax.eval_shape(j_opt.init, jp)
        ts = t_opt.init(tp)
        assert all(v.device.type == "meta" for _, v in _leaves_with_path(ts))
        specs_equal(T.shard_opt_state(ts, tp, tmesh), J.shard_opt_state(js, jp, jmesh),
                    j_opt.name)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch, mesh):
    jmesh, tmesh = meshes(mesh)
    jcfg, tcfg = get_config(arch), TC.get_config(arch)
    jb = j_input_specs(jcfg, SHAPES["train_4k"])
    tb = {k: torch.empty(s, dtype=dt, device="meta")
          for k, (s, dt) in t_input_specs(tcfg, TC.SHAPES["train_4k"]).items()}
    specs_equal(T.batch_specs(tcfg, tb, tmesh), J.batch_specs(jcfg, jb, jmesh), "batch")
    b, s = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
    src = s if jcfg.family == "encdec" else 0
    jc = jax.eval_shape(lambda: JL.init_cache(jcfg, b, s, src_len=src))
    tc = TL.init_cache(tcfg, b, s, src_len=src, device="meta")
    specs_equal(T.cache_specs(tcfg, tc, tmesh), J.cache_specs(jcfg, jc, jmesh), "cache")


def test_batch_spec_of_a_scalar_and_an_odd_batch():
    jmesh, tmesh = meshes("16x16")
    want = J.batch_specs(None, {"s": jax.ShapeDtypeStruct((), jnp.float32),
                                "odd": jax.ShapeDtypeStruct((3, 5), jnp.int32)}, jmesh)
    got = T.batch_specs(None, {"s": torch.empty((), device="meta"),
                               "odd": torch.empty((3, 5), device="meta")}, tmesh)
    specs_equal(got, want, "batch")


# -- the rule cases of tests/test_sharding_rules.py, on the port -------------

def test_param_spec_rules():
    mesh = FakeMesh((1, 1), ("data", "model"))
    P = T.PartitionSpec
    # 1-D -> replicated
    assert T.param_spec("layers/ln1", (64,), mesh) == P()
    # attention out-proj: in-feature dim on model
    spec = T.param_spec("layers/attn/wo", (4, 128, 64), mesh)
    assert spec[1] == "model"
    # embed: vocab on model
    spec = T.param_spec("embed", (1000, 64), mesh)
    assert spec[0] == "model"


def test_expert_divisibility_fallback():
    m = FakeMesh((16, 16), ("data", "model"))
    # qwen: E=128 divides 16 -> experts on model
    spec = T._assign((94, 128, 4096, 1536), [(1, "model"), (2, "data")], m)
    assert spec[1] == "model" and spec[2] == "data"
    # grok: E=8 does NOT divide 16 -> skipped, next prefs apply
    spec = T._assign((64, 8, 6144, 32768), [(1, "model"), (2, "data"), (3, None)], m)
    assert spec[1] is None and spec[2] == "data"


def test_assign_never_reuses_axis():
    spec = T._assign((16, 16), [(0, "model"), (1, "model")], FakeMesh((4, 4), ("data", "model")))
    assert spec[0] == "model" and spec[1] is None


def test_rules_take_a_device_mesh():
    """The port's own ``DeviceMesh`` (device slots) carries the rules too."""
    mesh = T.partition_mesh(2, 2, devices=["cpu"] * 4)
    assert T.data_axes(mesh) == ("data",) and T.axis_size(mesh, ("data", "model")) == 4
    sh = T.shard_params({"layers": {"attn": {"wq": torch.empty((4, 8, 16), device="meta")}}},
                        mesh)
    assert sh["layers"]["attn"]["wq"].mesh is mesh
    assert sh["layers"]["attn"]["wq"].spec == T.PartitionSpec(None, "data", "model")
