"""PyTorch port, the enc-dec (seamless-m4t-large-v2) and VLM
(llava-next-mistral-7b) LMs as one program over a device mesh
(``repro_torch.distributed.spmd``, DTensor) against the reference's sharded
programs, as ``tests/test_torch_spmd_ssm.py`` holds RWKV6 and hymba (its
helpers are reused).

The reference runs in subprocesses with 4 forced host devices on an
Auto-axis ``jax.sharding.Mesh`` of (data 2, model 2), the port in four
``gloo`` processes started by ``file://``; the two run side by side after a
first subprocess has drawn the reference's parameters
(``init_params(PRNGKey(0))``, carried across by
``convert.lm_params_from_numpy``). Four reduced configs (``CASES``), each
with its config's AdamW: seamless at 2 + 2 layers with 4 heads and 2 kv
heads (vocab 256: the head split by vocab), the same with a vocab of 255
(it does not divide ``model``, as 256,206 does not divide 16: the logits on
sequence blocks), llava with 4 heads, 2 kv heads and 8 patch tokens, and
llava with 1 kv head (kv heads below ``model``, as 8 are below 16). Inputs:
``make_demo_batch(cfg, np.random.default_rng(0), 4, 32)`` in each package
(seamless: 32 source frames and 32 tokens; llava: 8 patch embeddings and 24
tokens), then the decode steps' tokens from the same generator. The sharded
``make_train_step`` (``peak_lr`` 1e-2 from step 0), ``prefill`` (a cache of
40) and 4 ``decode_step``s at positions 32-35 (llava: after its 8 patch and
24 text positions).

Tolerances (``tests/test_torch_spmd.py``'s):
- the loss: rtol 1e-5;
- each gradient within 1e-5 of its leaf's max |grad|;
- one AdamW step: each leaf's move within 1e-5 of the leaf's largest move
  where the sign is decided, at most ``lr x (1 + wd |p|)`` where the
  reference's |grad| is under 1e-3 of the leaf's max;
- prefill's last-position logits within 1e-5 x (1 + max |logit|);
- each decode step's logits within 5e-3 x (1 + max |logit|) (decode reads
  the bf16 cache), the argmax equal wherever the reference's top-2 gap
  exceeds 1e-5 x (1 + max |logit|);
- the cross cache after prefill within one bf16 step of the reference's
  (2^-7 of the larger magnitude);
- the demo batches bitwise equal;
- no gradient reaches the optimizer with placements other than its
  parameter's, and the cache (``cross_k`` / ``cross_v`` included) leaves
  prefill and each decode step in ``cache_specs``' placements.

On fake process groups in this process: ``placements`` against
``NamedSharding.shard_shape`` for every seamless and llava leaf (params,
AdamW state, ``train_4k`` batch, ``decode_32k`` cache) on both production
meshes; rank 0's FLOPs x 4 against one device's count of the reduced train
cells (an encoder or ``enc_out`` backward replicated over ``model`` would
show); a decode step's collectives independent of the cross cache's length
(the cache is never gathered).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tests.test_torch_spmd import (DECODE_REL, GRAD_REL, LOGIT_REL, LOSS_RTOL,  # noqa: E402
                                   SIGN_UNDECIDED, WEIGHT_DECAY, _flatten, _leaf_keys,
                                   _unflatten, _wait)
from tests.test_torch_spmd_families import WORLD_TIMEOUT_S, _env  # noqa: E402

BATCH, SEQ, MAX_LEN, DECODE_STEPS = 4, 32, 40, 4
LR = 1e-2
BF16_STEP = 2.0 ** -7
CASES = {
    "seamless": ("seamless-m4t-large-v2", {}),
    "seamless_v255": ("seamless-m4t-large-v2", {"vocab": 255}),
    "llava": ("llava-next-mistral-7b", {}),
    "llava_kv1": ("llava-next-mistral-7b", {"n_kv_heads": 1}),
}
ENCDEC = ("seamless", "seamless_v255")
CROSS = ("cross_k", "cross_v")


def _config(get_config, reduced_config, case):
    arch, overrides = CASES[case]
    return dataclasses.replace(reduced_config(get_config(arch)), **overrides)


def _inputs(cfg, make_demo_batch, **kw):
    """The demo batch (a dict of the package's arrays) and the decode
    steps' tokens."""
    rng = np.random.default_rng(0)
    batch = make_demo_batch(cfg, rng, BATCH, SEQ, **kw)
    steps = rng.integers(0, cfg.vocab, (DECODE_STEPS, BATCH)).astype(np.int32)
    return batch, steps


def _prompt(batch):
    """The prefill inputs of a demo batch: everything but the targets."""
    return {k: v for k, v in batch.items() if k != "targets"}


# ---------------------------------------------------------------------------
# the reference, in subprocesses with 4 host devices
# ---------------------------------------------------------------------------

def params_main(out_path: str) -> None:
    """Each case's ``init_params(PRNGKey(0))``."""
    import jax

    from repro.configs import get_config, reduced_config
    from repro.models import lm

    out = {}
    for case in CASES:
        cfg = _config(get_config, reduced_config, case)
        out.update(_flatten(jax.device_get(lm.init_params(cfg, jax.random.PRNGKey(0))),
                            f"{case}/p0/"))
    np.savez(out_path, **out)


def reference_main(params_path: str, out_path: str, cases: str) -> None:
    """The reference's sharded programs for the comma-separated ``cases``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced_config
    from repro.distributed.sharding import batch_specs, cache_specs, shard_params
    from repro.launch.specs import make_demo_batch
    from repro.launch.train import init_opt_state, make_train_step
    from repro.models import lm
    from repro.optim.optimizers import get_optimizer

    ref_p = dict(np.load(params_path))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out = {}
    for case in cases.split(","):
        cfg = _config(get_config, reduced_config, case)
        params = jax.tree.map(jnp.asarray, _unflatten(ref_p, f"{case}/p0/"))
        batch, steps = _inputs(cfg, make_demo_batch)
        out.update({f"{case}/batch/{k}": np.asarray(v.astype(jnp.float32))
                    for k, v in batch.items()})
        out.update(_flatten(jax.device_get(params), f"{case}/p0/"))
        opt = get_optimizer(cfg.optimizer)
        state = init_opt_state(opt, params)
        p_sh, b_sh = shard_params(params, mesh), batch_specs(cfg, batch, mesh)
        with jax.sharding.set_mesh(mesh):
            grad_fn = jax.jit(jax.grad(lambda p, b: lm.loss_fn(cfg, p, b)[0]),
                              in_shardings=(p_sh, b_sh))
            out.update(_flatten(jax.device_get(grad_fn(params, batch)), f"{case}/g/"))
            step = jax.jit(make_train_step(cfg, opt, peak_lr=LR, warmup=0),
                           in_shardings=(p_sh, shard_params(state, mesh), b_sh))
            p1, _, metrics = step(params, state, batch)
            out[f"{case}/loss"] = np.asarray(metrics["loss"])
            out.update(_flatten(jax.device_get(p1), f"{case}/p1/"))
            pb = _prompt(batch)
            logits, cache = jax.jit(lambda p, b: lm.prefill(cfg, p, b, max_len=MAX_LEN),
                                    in_shardings=(p_sh, batch_specs(cfg, pb, mesh)))(params, pb)
            out[f"{case}/prefill"] = np.asarray(logits[:, -1])
            for key in CROSS:
                if key in cache:
                    out[f"{case}/cache/{key}"] = np.asarray(jax.device_get(cache[key]),
                                                            np.float32)
            c_sh = cache_specs(cfg, cache, mesh)
            t_sh = batch_specs(cfg, {"t": jnp.asarray(steps[0])}, mesh)["t"]
            step_fn = jax.jit(lambda p, c, t, pos: lm.decode_step(cfg, p, c, t, pos),
                              in_shardings=(p_sh, c_sh, t_sh, None))
            lgs = []
            for i in range(DECODE_STEPS):
                lg, cache = step_fn(params, jax.device_put(cache, c_sh),
                                    jnp.asarray(steps[i]), jnp.int32(SEQ + i))
                lgs.append(np.asarray(lg))
            out[f"{case}/dec_logits"] = np.stack(lgs)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port, in four gloo processes
# ---------------------------------------------------------------------------

def port_main(rank: int, world_dir: str, params_path: str, out_path: str) -> None:
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import (batch_specs, cache_specs, shard_opt_state,
                                                  shard_params)
    from repro_torch.launch.specs import make_demo_batch
    from repro_torch.launch.train import init_opt_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import Optimizer, get_optimizer

    torch.set_num_threads(1)
    ref_p = dict(np.load(params_path))
    out = {}

    def recording(inner, seen):
        """``inner`` with each update's gradients (full tensors) and
        placement mismatches recorded in ``seen``."""
        def update(grads, state, params, lr):
            flat_g, flat_p = _flatten(grads), _flatten(params)
            seen["mismatch"] = [k for k in flat_g
                                if tuple(flat_g[k].placements) != tuple(flat_p[k].placements)]
            seen["grads"] = {k: spmd.replicated(v) for k, v in flat_g.items()}
            return inner.update(grads, state, params, lr)
        return Optimizer(inner.init, update, inner.name)

    with spmd.spmd_mesh((2, 2), ("data", "model"), backend="gloo", rank=rank,
                        init_dir=world_dir) as mesh:
        rules = spmd.RuleMesh(mesh)

        def place(tree, shardings):
            return spmd.distribute_tree(tree, shardings, mesh)

        def off_specs(cfg, cache):
            """The cache leaves whose placements are not ``cache_specs``'."""
            specs = cache_specs(cfg, cache, rules)
            return [k for k, t in cache.items()
                    if tuple(t.placements) != spmd.placements(specs[k].spec, mesh)]

        for case in CASES:
            cfg = _config(get_config, reduced_config, case)
            p0 = lm_params_from_numpy(_unflatten(ref_p, f"{case}/p0/"), device="cpu")
            batch, steps = _inputs(cfg, make_demo_batch, device="cpu")
            out.update({f"{case}/batch/{k}": v.float().numpy() for k, v in batch.items()})
            params = place(p0, shard_params(p0, rules))
            pb = _prompt(batch)
            logits, cache = lm.prefill(cfg, params, place(pb, batch_specs(cfg, pb, rules)),
                                       max_len=MAX_LEN)
            out[f"{case}/prefill"] = logits.full_tensor()[:, -1].numpy()
            off = off_specs(cfg, cache)
            for key in CROSS:
                if key in cache:
                    out[f"{case}/cache/{key}"] = cache[key].full_tensor().float().numpy()
            lgs = []
            for i in range(DECODE_STEPS):
                tok = torch.from_numpy(steps[i])
                tok = spmd.distribute_tensor(tok, mesh, spmd.batch_placements(tok.shape, mesh),
                                             src_data_rank=None)
                lg, cache = lm.decode_step(cfg, params, cache, tok, SEQ + i)
                lgs.append(lg.full_tensor().numpy())
                off += off_specs(cfg, cache)
            out[f"{case}/dec_logits"] = np.stack(lgs)
            out[f"{case}/cache_off_specs"] = np.array(json.dumps(off))

            seen: dict = {}
            inner = get_optimizer(cfg.optimizer)
            state = init_opt_state(inner, p0)
            state = place(state, shard_opt_state(state, p0, rules))
            step = make_train_step(cfg, recording(inner, seen), peak_lr=LR, warmup=0)
            p1, _, metrics = step(params, state, place(batch, batch_specs(cfg, batch, rules)))
            out[f"{case}/loss"] = metrics["loss"].numpy()
            out[f"{case}/mismatch"] = np.array(json.dumps(seen["mismatch"]))
            out.update({f"{case}/g/{k}": v.numpy() for k, v in seen["grads"].items()})
            out.update({f"{case}/p1/{k}": v.numpy()
                        for k, v in _flatten(spmd.full_tree(p1)).items()})
    if rank == 0:
        np.savez(out_path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's sharded programs (enc-dec and VLM cases in two
    processes) and the port's gloo world, run side by side from the
    reference's parameters; (reference npz, port npz)."""
    d = tmp_path_factory.mktemp("spmd_encdec_vlm")
    params_path, port_path = str(d / "p0.npz"), str(d / "port.npz")
    env = _env()
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    first = subprocess.Popen([sys.executable, __file__, "--params", params_path], env=ref_env,
                             stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    _wait([("the reference's parameters", first)], "drawing the reference's parameters",
          WORLD_TIMEOUT_S)
    world = d / "world"
    world.mkdir()
    groups = {"encdec": list(ENCDEC), "vlm": [c for c in CASES if c not in ENCDEC]}
    procs = [(f"reference ({name})", subprocess.Popen(
        [sys.executable, __file__, "--reference", str(d / f"ref_{name}.npz"), "--params",
         params_path, "--cases", ",".join(cases)], env=ref_env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)) for name, cases in groups.items()]
    procs += [(f"rank {r}", subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world", str(world), "--params",
         params_path, "--out", port_path], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)) for r in range(4)]
    _wait(procs, "the reference's sharded runs and the port's gloo world", WORLD_TIMEOUT_S)
    ref: dict = {}
    for name in groups:
        ref.update(dict(np.load(d / f"ref_{name}.npz")))
    return ref, dict(np.load(port_path))


@pytest.mark.parametrize("case", CASES)
def test_demo_batches_match_reference(runs, case):
    """``make_demo_batch`` draws the same batch in both packages: tokens,
    targets and the bf16 source frames or patch embeddings, bitwise."""
    ref, port = runs
    keys = _leaf_keys(ref, case, "batch")
    assert keys == _leaf_keys(port, case, "batch")
    assert ("src_embeds" if case in ENCDEC else "patch_embeds") in keys
    for k in keys:
        np.testing.assert_array_equal(port[f"{case}/batch/{k}"], ref[f"{case}/batch/{k}"])


@pytest.mark.parametrize("case", CASES)
def test_sharded_loss_and_gradients_match_reference(runs, case):
    ref, port = runs
    np.testing.assert_allclose(port[f"{case}/loss"], ref[f"{case}/loss"], rtol=LOSS_RTOL)
    keys = _leaf_keys(ref, case, "g")
    assert keys == _leaf_keys(port, case, "g")
    for k in keys:
        g, want = port[f"{case}/g/{k}"], ref[f"{case}/g/{k}"]
        tol = GRAD_REL * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(g - want).max()) <= tol, (case, k)
    assert json.loads(str(port[f"{case}/mismatch"])) == []


@pytest.mark.parametrize("case", CASES)
def test_sharded_adamw_step_matches_reference(runs, case):
    ref, port = runs
    for k in _leaf_keys(ref, case, "p1"):
        p0 = ref[f"{case}/p0/{k}"]
        move, want = port[f"{case}/p1/{k}"] - p0, ref[f"{case}/p1/{k}"] - p0
        g = np.abs(ref[f"{case}/g/{k}"])
        undecided = g < SIGN_UNDECIDED * g.max()
        tol = GRAD_REL * float(np.abs(want).max()) + np.spacing(np.abs(p0)).max()
        assert float(np.abs(move - want)[~undecided].max(initial=0.0)) <= tol, (case, k)
        bound = LR * (1 + WEIGHT_DECAY * np.abs(p0)) * (1 + 1e-5)
        assert (np.abs(move)[undecided] <= bound[undecided]).all(), (case, k)


@pytest.mark.parametrize("case", CASES)
def test_sharded_prefill_and_decode_match_reference(runs, case):
    """Prefill's last logits and 4 decode steps' logits; the cache in
    ``cache_specs``' placements after prefill and after every step."""
    ref, port = runs
    got, want = port[f"{case}/prefill"], ref[f"{case}/prefill"]
    assert float(np.abs(got - want).max()) <= LOGIT_REL * (1 + float(np.abs(want).max()))
    for i in range(DECODE_STEPS):
        lg, wl = port[f"{case}/dec_logits"][i], ref[f"{case}/dec_logits"][i]
        scale = 1 + float(np.abs(wl).max())
        assert float(np.abs(lg - wl).max()) <= DECODE_REL * scale, (i, np.abs(lg - wl).max())
        top2 = np.sort(wl, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > LOGIT_REL * scale
        np.testing.assert_array_equal(lg.argmax(-1)[sure], wl.argmax(-1)[sure])
    assert json.loads(str(port[f"{case}/cache_off_specs"])) == []


@pytest.mark.parametrize("case", ENCDEC)
def test_sharded_cross_cache_matches_reference(runs, case):
    """The cross cache after prefill, ``[L, B, S_src, Hkv, dh]`` in bf16,
    gathered from its blocks (the source sequence over ``model``): within
    one bf16 step of the reference's."""
    ref, port = runs
    for key in CROSS:
        got, want = port[f"{case}/cache/{key}"], ref[f"{case}/cache/{key}"]
        assert got.shape == want.shape == (2, BATCH, SEQ, 2, 16), key
        assert (np.abs(got - want) <= BF16_STEP * np.maximum(np.abs(got), np.abs(want))).all()
        assert np.abs(want).max() > 0


# ---------------------------------------------------------------------------
# in this process, on fake process groups
# ---------------------------------------------------------------------------

def _rank0_count(cfg, shape):
    """(rank 0's count on a fake (2, 2) mesh, its world size)."""
    from repro_torch.distributed import spmd
    from repro_torch.launch import dryrun

    with spmd.spmd_mesh((2, 2), ("data", "model"), backend="fake") as mesh:
        counter, arg_bytes, _ = dryrun.count_rank0(cfg, shape, mesh)
        chips = mesh.size()
    assert arg_bytes > 0 and counter.collectives["TOTAL"]["count"] > 0
    return counter, chips


@pytest.mark.parametrize("case", ["seamless", "llava"])
def test_rank0_count_covers_the_single_device_count(case):
    """The encoder, the cross attention and the decoder by heads, the
    ``enc_out`` gradient reduced once: rank 0's FLOPs x 4 of the reduced
    train cell (4 x 32 tokens, remat off) within 1.00-1.05 of one device's
    count of the whole step (measured: 1.000 / 1.000; before the encoder's
    and the cross attention's row-parallel outputs were reduced at the
    residual adds, seamless counted 1.179: a backward replicated over
    ``model``)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg = _config(get_config, reduced_config, case)
    shape = ShapeSpec("train_small", SEQ, BATCH, "train")
    counter, chips = _rank0_count(cfg, shape)
    fn, args, _ = dryrun._step_and_specs(cfg, shape, make_production_mesh())
    one = dryrun.count_step(fn, args).flops
    assert 1.0 <= chips * counter.flops / one <= 1.05, (chips * counter.flops, one)


def test_decode_never_gathers_the_cross_cache():
    """Rank 0's collectives in one reduced seamless decode step on a fake
    (2, 2) mesh are the same with a cross cache (and self cache) of 32 and
    of 128 positions: each rank scores its own block of the source sequence
    and only the softmax's max and sum and the context cross ranks."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.shapes import ShapeSpec

    cfg = _config(get_config, reduced_config, "seamless")
    short, _ = _rank0_count(cfg, ShapeSpec("decode_small", SEQ, BATCH, "decode"))
    long, _ = _rank0_count(cfg, ShapeSpec("decode_small", 4 * SEQ, BATCH, "decode"))
    assert short.collectives == long.collectives
    assert long.bytes > short.bytes


def _trees(arch):
    """``arch``'s params, AdamW state, the ``train_4k`` batch and the
    ``decode_32k`` cache as ``meta`` tensors."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.specs import input_specs
    from repro_torch.launch.train import init_opt_state
    from repro_torch.models import lm
    from repro_torch.optim import get_optimizer

    cfg = get_config(arch)
    params = lm.param_shapes(cfg)
    opt = init_opt_state(get_optimizer(cfg.optimizer), params)
    batch = {k: torch.empty(shape, dtype=dt, device="meta")
             for k, (shape, dt) in input_specs(cfg, SHAPES["train_4k"]).items()}
    cache = {k: torch.empty(shape, dtype=dt, device="meta")
             for k, (shape, dt) in input_specs(cfg, SHAPES["decode_32k"])["cache"].items()}
    return cfg, params, opt, batch, cache


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llava-next-mistral-7b"])
def test_placements_give_the_rules_shard_shape(arch, multi):
    """Rank 0's block under ``placements`` of every leaf (params with
    ``enc_layers`` / ``cross_layers``, AdamW state, the ``train_4k`` batch
    with ``src_embeds`` / ``patch_embeds``, the ``decode_32k`` cache with
    ``cross_k`` / ``cross_v``) on the production mesh is
    ``NamedSharding.shard_shape``, bitwise; the cross cache's source
    sequence is over ``model``."""
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import (batch_specs, cache_specs, shard_opt_state,
                                                  shard_params)
    from repro_torch.launch.mesh import make_production_spmd_mesh

    cfg, params, opt, batch, cache = _trees(arch)
    with make_production_spmd_mesh(multi_pod=multi) as mesh:
        rules = spmd.RuleMesh(mesh)
        trees = [(params, shard_params(params, rules)),
                 (opt, shard_opt_state(opt, params, rules)),
                 (batch, batch_specs(cfg, batch, rules)),
                 (cache, cache_specs(cfg, cache, rules))]
        keys = set()
        for tree, shardings in trees:
            flat_t, flat_s = _flatten(tree), _flatten(shardings)
            for key, t in flat_t.items():
                sh = flat_s[key]
                got, _ = spmd.local_shape(t.shape, mesh, spmd.placements(sh.spec, mesh))
                assert tuple(got) == sh.shard_shape(t.shape), (key, sh.spec)
                keys.add(key)
        if cfg.family == "encdec":
            assert {"enc_layers/attn/wq", "cross_layers/wk", "src_embeds", "cross_k",
                    "cross_v"} <= keys
            specs = cache_specs(cfg, cache, rules)
            assert tuple(specs["cross_k"].spec)[2] == "model"
        else:
            assert "patch_embeds" in keys


def test_layout_notes_name_the_encoder_cross_cache_and_patch_tokens():
    """The full configs' notes on the (16, 16) mesh: seamless's 16 heads
    split by heads (1 a rank) in train and prefill, its cross cache of
    32,768 source positions split 16 ways (2,048 a rank) in prefill and
    decode; llava's 2,880 patch tokens ahead of 29,888 text tokens at
    ``prefill_32k`` (``launch.specs``), none in decode."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun

    seamless, llava = get_config("seamless-m4t-large-v2"), get_config("llava-next-mistral-7b")
    train = dryrun._layout_notes(seamless, SHAPES["train_4k"], 16)
    assert set(train) == {"encoder"} and "its 1 of 16" in train["encoder"]
    prefill = dryrun._layout_notes(seamless, SHAPES["prefill_32k"], 16)
    assert "(2048 a rank)" in prefill["cross_cache"] and "encoder" in prefill
    assert set(dryrun._layout_notes(seamless, SHAPES["decode_32k"], 16)) == {"cross_cache"}
    notes = dryrun._layout_notes(llava, SHAPES["prefill_32k"], 16)
    assert notes == {"patch_tokens": "2880 patch tokens ahead of 29888 text tokens in each "
                                     "sequence; only the text positions are scored"}
    assert dryrun._layout_notes(llava, SHAPES["decode_32k"], 16) == {}


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--params")
    ap.add_argument("--reference")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world")
    ap.add_argument("--out")
    ap.add_argument("--cases")
    a = ap.parse_args()
    if a.reference:
        reference_main(a.params, a.reference, a.cases)
    elif a.rank is not None:
        port_main(a.rank, a.world, a.params, a.out)
    else:
        params_main(a.params)
