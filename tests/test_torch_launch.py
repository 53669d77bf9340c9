"""PyTorch port, the launch tools: ``repro_torch.launch.{mesh, hlo_stats,
dryrun, serve_dryrun}`` against ``repro.launch``'s.

The reference's ``dryrun`` and ``serve_dryrun`` set ``XLA_FLAGS`` to
hundreds of host devices when they are imported, which would change JAX's
device count for every later test in this process: they are imported only
in subprocesses, as ``tests/test_sharded_serving.py`` runs its forced host
devices. One subprocess (with the reference's 512 devices) reports its
production meshes, ``_model_flops`` for every arch x shape,
``_apply_overrides``, ``cell_path`` and the enterprise step's per-device
argument bytes; another runs the enterprise step at a small geometry on a
(2, 2) mesh of four forced host devices.

Tolerances: the counts, shapes and bytes are exact. The enterprise step's
scores within 1e-7 + 1e-6 |s| of the reference's (f32 sums of a few terms
in other orders), its labels bitwise.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.distributed import sharding as J
from repro.launch import hlo_stats as jstats
from repro.launch import mesh as jmesh
from repro.launch.specs import input_specs as j_input_specs
from repro.launch.train import init_opt_state as j_init_opt_state
from repro.models import lm as JL
from repro.optim.optimizers import get_optimizer as j_get_optimizer
from repro_torch import configs as TC
from repro_torch.distributed.sharding import Slot, record_sends, send
from repro_torch.launch import dryrun, hlo_stats, hw, mesh
from repro_torch.launch import serve_dryrun as sd
from repro_torch.launch.specs import input_specs
from repro_torch.models import lm as TL

REPO = Path(__file__).resolve().parents[1]
CELL_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
OVERRIDES = ({}, {"n_layers": "3", "remat": "false", "attn_impl": "chunked"},
             {"capacity_factor": "2.0", "attn_kblock": "512"})
SCORE_RTOL, SCORE_ATOL = 1e-6, 1e-7

# The small enterprise geometry of the step test (d = 300, tree [4, 4, 8]).
SMALL = dict(d_feat=300, branching=(4, 4, 8), level_nnz=8, ell_r=32, query_nnz=16)


def _run(script: str, env_extra: dict, timeout: int = 240) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **env_extra)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def reference_dryrun():
    """What the reference's dry-run modules give, from a subprocess."""
    out = _run(f"""
        import dataclasses, json, os
        import numpy as np
        from repro.configs import ARCH_IDS, SHAPES, get_config
        from repro.launch import dryrun, serve_dryrun as sd
        from repro.launch.mesh import make_production_mesh

        rec = {{"meshes": {{}}, "model_flops": {{}}, "overrides": [], "paths": []}}
        for multi in (False, True):
            m = make_production_mesh(multi_pod=multi)
            rec["meshes"][str(multi)] = [list(m.axis_names), list(m.devices.shape)]
        for arch in ARCH_IDS:
            for name, shape in SHAPES.items():
                rec["model_flops"][arch + "/" + name] = dryrun._model_flops(get_config(arch), shape)
        for ov in {list(OVERRIDES)!r}:
            cfg = dryrun._apply_overrides(get_config("yi-6b"), ov)
            rec["overrides"].append({{f.name: str(getattr(cfg, f.name))
                                     for f in dataclasses.fields(cfg)}})
        for args in (("yi-6b", "train_4k", "single"), ("grok-1-314b", "decode_32k", "multi", "t1")):
            rec["paths"].append(os.path.basename(dryrun.cell_path(*args)))
        fn, specs, shardings = sd.serve_step_spec(1024, 10, 10, make_production_mesh())
        rec["enterprise_bytes"] = sum(int(np.prod(sh.shard_shape(s.shape))) * s.dtype.itemsize
                                      for s, sh in zip(specs, shardings))
        rec["level_sizes"] = sd.level_sizes()
        rec["geometry"] = [sd.D_FEAT, sd.BRANCHING, sd.LEVEL_NNZ, sd.ELL_R, sd.QUERY_NNZ]
        print(json.dumps(rec))
    """, {})
    return json.loads(out.strip().splitlines()[-1])


# -- mesh --------------------------------------------------------------------

@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_matches_reference(multi, reference_dryrun):
    m = mesh.make_production_mesh(multi_pod=multi)
    names, shape = reference_dryrun["meshes"][str(multi)]
    assert list(m.axis_names) == names and list(m.devices.shape) == shape
    assert m.shape == dict(zip(names, shape))
    assert all(d == torch.device("meta") for d in m.devices.ravel())


def test_host_mesh_and_its_error():
    m = mesh.make_host_mesh(2, 2, devices=["cpu"] * 4)
    assert m.axis_names == ("data", "model") and m.devices.shape == (2, 2)
    k = len(jax.devices())
    with pytest.raises(ValueError) as got:
        mesh.make_host_mesh(2, k + 1, devices=["cpu"] * k)
    with pytest.raises(ValueError) as want:
        jmesh.make_host_mesh(2, k + 1)
    assert str(got.value) == str(want.value) == f"need {2 * k + 2} devices, have {k}"


# -- collective and traffic statistics ---------------------------------------

def _kernel(name, n_in, n_out, dtype="Float"):
    """An NCCL kernel's trace event, with the metadata torch records."""
    return {"ph": "X", "cat": "kernel", "name": f"ncclDevKernel_{name}(x)",
            "args": {"Collective name": name, "In msg nelems": n_in, "Out msg nelems": n_out,
                     "dtype": dtype, "Group size": 16}}


# The ops and bytes of tests/test_sharding_rules.py's HLO_SAMPLE: an
# all-gather of f32[4,1024] to [64,1024] (twice: plain and -start), an
# all-reduce of [64,1024], a reduce-scatter to [4,1024], a
# collective-permute of [4,1024].
TRACE_SAMPLE = [
    _kernel("_allgather_base", 4096, 65536),
    _kernel("allreduce", 65536, 65536),
    _kernel("reduce_scatter_tensor", 65536, 4096),
    _kernel("send", 4096, 4096),
    _kernel("all_gather_into_tensor", 4096, 65536),
    # the host's annotations of the same collectives: not counted again
    {"ph": "X", "cat": "cpu_op", "name": "record_param_comms",
     "args": {"Collective name": "allreduce", "In msg nelems": 65536,
              "Out msg nelems": 65536, "dtype": "Float"}},
    {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_Recv(x)",
     "args": {"Collective name": "recv", "In msg nelems": 4096, "Out msg nelems": 4096,
              "dtype": "Float"}},
    {"ph": "X", "cat": "kernel", "name": "sgemm", "args": {}},
]

HLO_SAMPLE = """
HloModule test
ENTRY %main {
  %p0 = f32[4,1024]{1,0} parameter(0)
  %ag = f32[64,1024]{1,0} all-gather(%p0), replica_groups={}
  %ar.1 = f32[64,1024]{1,0} all-reduce(%ag), to_apply=%add
  %rs = f32[4,1024]{1,0} reduce-scatter(%ar.1), dimensions={0}
  %cp = f32[4,1024]{1,0} collective-permute(%rs), source_target_pairs={{0,1}}
  %ags = f32[64,1024]{1,0} all-gather-start(%p0)
  %agd = f32[64,1024]{1,0} all-gather-done(%ags)
  ROOT %out = f32[4,1024]{1,0} add(%rs, %cp)
}
"""


def test_collective_stats_matches_reference_on_the_same_ops():
    got = hlo_stats.collective_stats({"traceEvents": TRACE_SAMPLE})
    assert got == jstats.collective_stats(HLO_SAMPLE)
    assert got["TOTAL"]["count"] == 5


def test_collective_stats_falls_back_to_host_events_and_reads_copies():
    host = [dict(e, cat="cpu_op", name="record_param_comms") for e in TRACE_SAMPLE[:5]]
    copies = [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy PtoP (Device -> Device)",
               "args": {"bytes": 1 << 20}},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
               "args": {"bytes": 4096}},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
               "args": {"bytes": 999}}]
    got = hlo_stats.collective_stats(host + copies)
    want = jstats.collective_stats(HLO_SAMPLE)
    for op in jstats.COLLECTIVES[:3]:
        assert got[op] == want[op]
    assert got["peer-copy"] == {"count": 1, "operand_bytes": 1 << 20, "result_bytes": 1 << 20}
    assert got["device-copy"]["operand_bytes"] == 4096 and "HtoD" not in json.dumps(got)
    assert got["TOTAL"]["count"] == 7
    half = [dict(e, args=dict(e["args"], dtype="BFloat16")) for e in TRACE_SAMPLE[1:2]]
    assert hlo_stats.collective_stats(half)["all-reduce"]["operand_bytes"] == 65536 * 2


def test_send_counts_bytes_between_distinct_slots_only():
    a, b = Slot.new("meta"), Slot.new("meta")
    x = torch.empty((64, 10), dtype=torch.float32, device="meta")
    i = torch.empty((64, 10), dtype=torch.int32, device="meta")
    with record_sends() as log:
        got = send((x, i), a, b)
        assert send((x,), a, a)[0] is x
    assert got[0] is x and got[1] is i  # counted, not copied
    assert [(s, d, n) for s, d, n in log] == [(a, b, 64 * 10 * 8)]
    st = hlo_stats.send_stats(log)
    assert st["send"] == {"count": 1, "operand_bytes": 5120.0, "result_bytes": 5120.0}
    with record_sends() as log:
        cpu = Slot.new("cpu")
        send((torch.zeros(3),), cpu, Slot.new("cpu"))
    assert [n for _, _, n in log] == [12]


# -- counting ops ------------------------------------------------------------

def test_op_counter_counts_a_reduced_forward_by_hand():
    """Matmul FLOPs of a reduced yi-6b's forward (2 layers, d = 64, naive
    attention over the full S x S) against a count by hand: 2·T per
    weight element of each projection and the head, 4·B·S²·H·dh per layer
    for attention's two products."""
    cfg = TC.reduced_config(TC.get_config("yi-6b"))
    b, s = 2, 16
    params = TL.param_shapes(cfg)
    batch = {k: torch.empty(v[0], dtype=v[1], device="meta")
             for k, v in input_specs(cfg, TC.ShapeSpec("t", s, b, "train")).items()}
    counter = dryrun.count_step(lambda p, x: TL.forward_train(cfg, p, x), (params, batch))
    d, h, hkv, dh, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                            cfg.vocab)
    per_layer = d * h * dh + 2 * d * hkv * dh + h * dh * d + 3 * d * ff
    t = b * s
    want = 2 * t * (cfg.n_layers * per_layer + d * v) + cfg.n_layers * 4 * b * s * s * h * dh
    assert counter.flops == want
    assert counter.by_op["aten.mm"][1] + counter.by_op["aten.bmm"][1] == want
    assert counter.bytes > 0


def test_op_counter_bytes_rules():
    """Views and allocations move nothing; an op reads its inputs and
    writes its outputs once; a gather reads only what it returns; an
    in-place scatter touches only what it indexes."""
    src = torch.zeros((1000, 8))
    idx = torch.arange(10)
    with hlo_stats.OpCounter() as c:
        src.view(8000)[:5]
        torch.empty((100,))
    assert c.bytes == 0 and c.flops == 0
    with hlo_stats.OpCounter() as c:
        src + 1.0
    assert c.bytes == 2 * src.numel() * 4
    with hlo_stats.OpCounter() as c:
        src[idx]
    assert c.bytes == 2 * 10 * 8 * 4 + 10 * 8
    vals = torch.ones((10, 8))
    with hlo_stats.OpCounter() as c:
        src.index_put_((idx,), vals, accumulate=True)
    assert c.bytes == 10 * 8 + 10 * 8 * 4 + 2 * 10 * 8 * 4
    with hlo_stats.OpCounter() as c:
        torch.ones((4, 5)) @ torch.ones((5, 6))
    assert c.flops == 2 * 4 * 5 * 6


# -- the LM dry run ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch, reference_dryrun):
    for name, shape in TC.SHAPES.items():
        got = dryrun._model_flops(TC.get_config(arch), shape)
        assert got == reference_dryrun["model_flops"][f"{arch}/{name}"], (arch, name)


def test_overrides_and_cell_paths_match_reference(reference_dryrun):
    for ov, want in zip(OVERRIDES, reference_dryrun["overrides"]):
        cfg = dryrun._apply_overrides(TC.get_config("yi-6b"), ov)
        got = {k: str(v) for k, v in vars(cfg).items()}
        for k in ("param_dtype", "activ_dtype"):  # torch.float32 against float32
            assert got.pop(k).split(".")[-1] == want.pop(k).split("'")[-2].split(".")[-1]
        assert got == want
    got = [os.path.basename(dryrun.cell_path(*a)) for a in
           (("yi-6b", "train_4k", "single"), ("grok-1-314b", "decode_32k", "multi", "t1"))]
    assert got == reference_dryrun["paths"]
    assert dryrun.cell_path("yi-6b", "train_4k", "single").endswith(
        os.path.join("experiments", "dryrun_torch", "yi-6b__train_4k__single.json"))


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    return JL.param_shapes(get_config(arch))


def _reference_bytes(args, shardings):
    leaves = jax.tree_util.tree_leaves(args)
    shs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(x, J.NamedSharding))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(sh.shard_shape(a.shape))) * a.dtype.itemsize
               for a, sh in zip(leaves, shs))


def _reference_argument_bytes(arch, shape_name, amesh):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    specs = j_input_specs(cfg, shape)
    params = _reference_params(arch)
    if shape.kind == "train":
        opt = jax.eval_shape(functools.partial(j_init_opt_state, j_get_optimizer(cfg.optimizer)),
                             params)
        return _reference_bytes((params, opt, specs),
                                (J.shard_params(params, amesh), J.shard_params(opt, amesh),
                                 J.batch_specs(cfg, specs, amesh)))
    if shape.kind == "prefill":
        return _reference_bytes((params, specs), (J.shard_params(params, amesh),
                                                  J.batch_specs(cfg, specs, amesh)))
    return _reference_bytes(
        (params, specs["cache"], specs["tokens"]),
        (J.shard_params(params, amesh), J.cache_specs(cfg, specs["cache"], amesh),
         J.batch_specs(cfg, {"t": specs["tokens"]}, amesh)["t"]))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_match_reference_shard_shape(arch, multi):
    """Per-device argument bytes of each cell's step (params, optimizer
    state and batch; params and batch; params, cache and tokens) on the
    production mesh, against the reference's ``NamedSharding.shard_shape``
    over an ``AbstractMesh``."""
    tmesh = mesh.make_production_mesh(multi_pod=multi)
    amesh = AbstractMesh(tuple(tmesh.devices.shape), tmesh.axis_names)
    for shape_name in CELL_SHAPES:
        cfg = TC.get_config(arch)
        _, args, shardings = dryrun._step_and_specs(cfg, TC.SHAPES[shape_name], tmesh)
        got = mesh.argument_bytes(args, shardings)
        assert got == _reference_argument_bytes(arch, shape_name, amesh), (arch, shape_name)


@pytest.mark.parametrize("shape", CELL_SHAPES)
def test_run_cell_record(shape):
    """``run_cell`` on a 2-layer yi-6b (``--override n_layers=2``): status
    ok, rank 0's own counts of its DTensor program with the collective term
    (under the reference's op names), the notes where the port has no
    counterpart."""
    rec = dryrun.run_cell("yi-6b", shape, "single", {"n_layers": "2"})
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["spmd"] is True
    assert rec["collective_bytes_per_device"] > 0
    assert rec["collective_bytes"] == rec["collective_bytes_per_device"] * 256
    assert set(rec["collectives"]) <= set(hlo_stats.COLLECTIVES) | {"TOTAL"}
    assert rec["collectives"]["TOTAL"]["operand_bytes"] == rec["collective_bytes_per_device"]
    assert rec["roofline"]["collective_s"] == pytest.approx(
        rec["collective_bytes"] / (256 * hw.NVLINK_BW))
    assert rec["counted_flops"] == rec["counted_flops_per_device"] * 256
    assert "InfiniBand" in rec["collective_note"]
    assert "no counterpart" in rec["probe"] and "probe_l1" not in rec
    assert rec["counted_flops"] > 0 and rec["counted_bytes"] > 0
    assert rec["memory"]["argument_gb_per_device"] > 0
    assert rec["roofline"]["bound_s"] == max(rec["roofline"]["compute_s"],
                                             rec["roofline"]["memory_s"],
                                             rec["roofline"]["collective_s"])
    skipped = dryrun.run_cell("yi-6b", "long_500k", "single")
    assert skipped["status"] == "skipped(full-attention)"


def test_run_cell_of_encdec_is_rank0s_program():
    """An enc-dec cell (seamless-m4t-large-v2, 2 + 2 layers, ``decode_32k``)
    counts rank 0's program with its collectives, as every family does, and
    its record says that the cross cache's source sequence is split over
    ``model``, each rank scoring its own block (the encoder does not run in
    decode: its note is a train / prefill cell's)."""
    rec = dryrun.run_cell("seamless-m4t-large-v2", "decode_32k", "single",
                          {"n_layers": "2", "n_enc_layers": "2"})
    assert rec["status"] == "ok" and rec["spmd"] is True and rec["chips"] == 256
    assert rec["collectives"]["TOTAL"]["count"] > 0
    assert rec["collective_bytes"] == rec["collective_bytes_per_device"] * 256 > 0
    assert rec["roofline"]["collective_s"] > 0
    assert 0 < rec["counted_flops_per_device"] < rec["counted_flops"]
    assert "encoder" not in rec
    assert rec["cross_cache"].startswith("cross_k / cross_v of 32768 source positions")
    assert "split over the 16-way model axis (2048 a rank)" in rec["cross_cache"]


def test_run_cell_of_vlm_is_rank0s_program():
    """A VLM cell (llava-next-mistral-7b, 2 layers, ``train_4k``) counts
    rank 0's program with its collectives, and its record gives the patch
    tokens ahead of the text (2,048 of 4,096: ``launch.specs``) and says that
    only the text is scored."""
    rec = dryrun.run_cell("llava-next-mistral-7b", "train_4k", "single", {"n_layers": "2"})
    assert rec["status"] == "ok" and rec["spmd"] is True and rec["chips"] == 256
    assert rec["collectives"]["TOTAL"]["count"] > 0
    assert rec["collective_bytes"] == rec["collective_bytes_per_device"] * 256 > 0
    assert 0 < rec["counted_flops_per_device"] < rec["counted_flops"]
    assert rec["patch_tokens"] == ("2048 patch tokens ahead of 2048 text tokens in each "
                                   "sequence; only the text positions are scored")
    assert "encoder" not in rec and "cross_cache" not in rec


# -- the enterprise serving dry run ------------------------------------------

def test_level_sizes_and_per_device_bytes(reference_dryrun):
    assert sd.level_sizes() == reference_dryrun["level_sizes"] == [
        64, 2048, 65536, 2097152, 100663296]
    assert [sd.D_FEAT, sd.BRANCHING, sd.LEVEL_NNZ, sd.ELL_R, sd.QUERY_NNZ] == \
        reference_dryrun["geometry"]
    for multi in (False, True):
        _, specs, shardings = sd.serve_step_spec(1024, 10, 10,
                                                 mesh.make_production_mesh(multi_pod=multi))
        assert mesh.argument_bytes(specs, shardings) == 13_599_411_200
    assert reference_dryrun["enterprise_bytes"] == 13_599_411_200


def test_dry_run_record_at_a_small_geometry():
    geom = sd.Geometry(**dict(SMALL, branching=(4, 4, 16)))
    rec = sd.dry_run(256, 3, 5, geom=geom)
    assert rec["chips"] == 256 and rec["memory"]["temp_gb_per_device"] is None
    # 16 data rows x 15 model slots hand their 16 x 5 candidates (f32 + int32)
    assert rec["collectives"]["send"] == {"count": 240, "operand_bytes": 240 * 16 * 5 * 8.0,
                                          "result_bytes": 240 * 16 * 5 * 8.0}
    assert rec["roofline"]["dominant"] == "memory" and rec["per_query_bound_us"] > 0


def _small_arguments(batch, seed=11):
    """The step's global arguments at the small geometry, from numpy:
    skewed int32 feature ids, f32 query values, int32 rows, bf16 values as
    their bits (uint16)."""
    geom = sd.Geometry(**SMALL)
    rng = np.random.default_rng(seed)
    out = [(geom.d_feat * rng.random((batch, geom.query_nnz)) ** 2).astype(np.int32),
           rng.random((batch, geom.query_nnz), dtype=np.float32)]
    for c, r, b in geom.level_shapes():
        out.append(((geom.d_feat + 1) * rng.random((c, r)) ** 2).astype(np.int32))
        f32 = rng.standard_normal((c, r, b), dtype=np.float32)
        out.append(torch.from_numpy(f32).to(torch.bfloat16).view(torch.int16).numpy()
                   .view(np.uint16))
    return geom, out


def test_enterprise_step_matches_reference_on_a_small_geometry(tmp_path):
    """The reference's ``serve`` run for real on a (2, 2) mesh of forced
    host devices with its geometry globals set small, against the port's
    step on four CPU slots, from the same arrays (bf16 carried as bits)."""
    batch, beam, topk = 8, 3, 5
    geom, arrays = _small_arguments(batch)
    np.savez(tmp_path / "in.npz", *arrays)
    _run(f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.launch import serve_dryrun as sd
        sd.D_FEAT, sd.BRANCHING, sd.LEVEL_NNZ, sd.ELL_R, sd.QUERY_NNZ = (
            {geom.d_feat}, {list(geom.branching)}, {geom.level_nnz}, {geom.ell_r},
            {geom.query_nnz})
        mesh = jax.make_mesh((2, 2), ("data", "model"))
        fn, specs, shardings = sd.serve_step_spec({batch}, {beam}, {topk}, mesh)
        data = np.load("{tmp_path / 'in.npz'}")
        arrays = [data[f"arr_{{i}}"] for i in range(len(specs))]
        arrays = [jax.lax.bitcast_convert_type(jnp.asarray(a), jnp.bfloat16)
                  if s.dtype == jnp.bfloat16 else jnp.asarray(a)
                  for a, s in zip(arrays, specs)]
        args = [jax.device_put(a, sh) for a, sh in zip(arrays, shardings)]
        with jax.sharding.set_mesh(mesh):
            s, l = jax.jit(fn, in_shardings=shardings)(*args)
        np.savez("{tmp_path / 'out.npz'}", s=np.asarray(s), l=np.asarray(l))
    """, {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    want = np.load(tmp_path / "out.npz")
    args = [torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if a.dtype == np.uint16
            else torch.from_numpy(a) for a in arrays]
    m = mesh.make_host_mesh(2, 2, devices=["cpu"] * 4)
    fn, specs, _ = sd.serve_step_spec(batch, beam, topk, m, geom)
    assert [(tuple(a.shape), a.dtype) for a in args] == [(tuple(s.shape), s.dtype) for s in specs]
    with record_sends() as log:
        blocks = fn(*args)
    s, l = sd.collect(blocks, "cpu")
    np.testing.assert_array_equal(l.numpy(), want["l"])
    np.testing.assert_allclose(s.numpy(), want["s"], rtol=SCORE_RTOL, atol=SCORE_ATOL)
    assert (want["s"] > 0).all()  # every query's top-k is a real leaf
    # each data block's model slot 1 hands its 4 x 5 candidates to slot 0
    assert [n for _, _, n in log] == [4 * topk * 8] * 2
