"""PyTorch port, the SSM (RWKV6) and hybrid (hymba) LMs as one program over a
device mesh (``repro_torch.distributed.spmd``, DTensor) against the
reference's sharded programs, as ``tests/test_torch_spmd_families.py`` holds
MLA and MoE (its helpers are reused).

The reference runs in subprocesses with 4 forced host devices on an
Auto-axis ``jax.sharding.Mesh`` of (data 2, model 2), the port in four
``gloo`` processes started by ``file://``; the two run side by side after a
first subprocess has drawn the reference's parameters
(``init_params(PRNGKey(0))``, carried across by
``convert.lm_params_from_numpy``). Four reduced configs (``CASES``), each
with its config's AdamW: rwkv6-7b as it is (4 heads on the 2-way model
axis: the scan split by head) and with ``ssm_heads=3`` (the scan replicated
over ``model``); hymba-1.5b at 4 layers (layer 1 windowed, window 8, the
others global; attention and SSD by heads) and with ``ssm_heads=3,
n_heads=3, n_kv_heads=1`` under ``attn_act_shard="auto"`` (attention split
by the query sequence, the SSD scan replicated). 4 sequences of 32 tokens
from ``np.random.default_rng(0)``; the sharded ``make_train_step``
(``peak_lr`` 1e-2 from step 0), ``prefill`` (a cache of 40) and 4
``decode_step``s on fixed tokens from the same generator (past hymba's
window), then the decode states (``tm_s``, ``tm_x``, ``cm_x``; ``ssd_s``).
The same prefill and decode at batch 1, ``long_500k``'s layout: nothing
split over ``data``, the cache's sequence (hymba) and the RWKV state's heads
over ``model``.

Tolerances (``tests/test_torch_spmd.py``'s, and looser ones for the
gradients through the scans):
- the loss: rtol 1e-5;
- each gradient within 1e-5 of its leaf's max |grad|; RWKV's within 1e-3:
  its chunked scan rescales ``k`` by ``exp(-cum)``, so a summation order
  moves its gradients far more than its values. Measured on this (2, 2)
  mesh for reduced rwkv6-7b: nudging the plain port's parameters by 1e-7 of
  themselves moves its own gradients by up to 3.2e-4 of a leaf's max, and
  the sharded program is off the plain port by up to 5.7e-4 (``tm/wg``)
  and off the reference by up to 9.9e-5 (``rwkv_h3``, ``tm/ww1``). hymba's
  (4 layers) within 5e-5: the same nudge moves the plain port's gradients
  by up to 1.26e-5 (``ffn/w3``), and the sharded program is off the
  reference by up to 2.38e-5 (``hymba_h3``, ``embed``);
- one AdamW step: each leaf's move within 1e-5 of the leaf's largest move
  where the sign is decided (RWKV and hymba: their gradients' bound;
  measured up to 1.63e-5, ``rwkv_h3``), and at most ``lr x (1 + wd |p|)``
  where the reference's |grad| is under 1e-3 of the leaf's max;
- prefill's last-position logits within 1e-5 x (1 + max |logit|);
- each decode step's logits within 5e-3 x (1 + max |logit|) (decode reads
  the bf16 cache), the argmax equal wherever the reference's top-2 gap
  exceeds 1e-5 x (1 + max |logit|); the decode states within 5e-3 x (1 +
  max |state|) (they follow the same bf16 reads);
- no gradient reaches the optimizer with placements other than its
  parameter's, and the cache leaves prefill and each decode step in
  ``cache_specs``' placements.

Also in the port's world: each call of attention's local ``_attend`` on
rank 0, whose scores are ``[B_l, H, S / 2, S]`` for the 3-head hymba
(sequence-parallel) and ``[B_l, H / 2, S, S]`` for the 4-head one.

On fake process groups in this process: ``placements`` against
``NamedSharding.shard_shape`` for every rwkv6 and hymba leaf (params, AdamW
state, ``train_4k`` batch, ``decode_32k`` and ``long_500k`` caches) on both
production meshes; rank 0's FLOPs x 4 against one device's count of the
reduced train cells; both archs' full-width ``long_500k`` dry-run records.
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
SSM_GRAD_REL, HYBRID_GRAD_REL = 1e-3, 5e-5
CASES = {
    "rwkv": ("rwkv6-7b", {}),
    "rwkv_h3": ("rwkv6-7b", {"ssm_heads": 3}),
    "hymba": ("hymba-1.5b", {"n_layers": 4}),
    "hymba_h3": ("hymba-1.5b", {"n_layers": 4, "ssm_heads": 3, "n_heads": 3, "n_kv_heads": 1,
                                "attn_act_shard": "auto"}),
}
STATES = {"rwkv6-7b": ("tm_s", "tm_x", "cm_x"), "hymba-1.5b": ("ssd_s",)}
LAYOUTS = ("b4", "b1")


def _inputs(vocab):
    """Tokens, targets and the decode steps' tokens."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    targets = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    steps = rng.integers(0, vocab, (DECODE_STEPS, BATCH)).astype(np.int32)
    return tokens, targets, steps


def _config(get_config, reduced_config, case):
    arch, overrides = CASES[case]
    return dataclasses.replace(reduced_config(get_config(arch)), **overrides)


def _layout(layout, tokens, steps):
    """The prompts and decode tokens of a layout: the 4 sequences, or the
    first alone (batch 1)."""
    n = BATCH if layout == "b4" else 1
    return tokens[:n], steps[:, :n]


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
    from repro.launch.train import init_opt_state, make_train_step
    from repro.models import lm
    from repro.optim.optimizers import get_optimizer

    ref_p = dict(np.load(params_path))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out = {}
    for case in cases.split(","):
        cfg = _config(get_config, reduced_config, case)
        params = jax.tree.map(jnp.asarray, _unflatten(ref_p, f"{case}/p0/"))
        tokens, targets, steps = _inputs(cfg.vocab)
        batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
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
            for layout in LAYOUTS:
                toks, dec = _layout(layout, tokens, steps)
                pb = {"tokens": jnp.asarray(toks)}
                pb_sh = batch_specs(cfg, pb, mesh)
                logits, cache = jax.jit(lambda p, b: lm.prefill(cfg, p, b, max_len=MAX_LEN),
                                        in_shardings=(p_sh, pb_sh))(params, pb)
                out[f"{case}/{layout}/prefill"] = np.asarray(logits[:, -1])
                c_sh = cache_specs(cfg, cache, mesh)
                t_sh = batch_specs(cfg, {"t": pb["tokens"][:, 0]}, mesh)["t"]
                step_fn = jax.jit(lambda p, c, t, pos: lm.decode_step(cfg, p, c, t, pos),
                                  in_shardings=(p_sh, c_sh, t_sh, None))
                lgs = []
                for i in range(DECODE_STEPS):
                    lg, cache = step_fn(params, jax.device_put(cache, c_sh),
                                        jnp.asarray(dec[i]), jnp.int32(SEQ + i))
                    lgs.append(np.asarray(lg))
                out[f"{case}/{layout}/dec_logits"] = np.stack(lgs)
                for key in STATES[CASES[case][0]]:
                    out[f"{case}/{layout}/state/{key}"] = np.asarray(
                        jax.device_get(cache[key]), np.float32)
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
    from repro_torch.launch.train import init_opt_state, make_train_step
    from repro_torch.models import attention as attn_mod
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

    attend = attn_mod._attend
    scores: list = []

    def recording_attend(q, k, *args, **kwargs):
        scores.append((q.shape[0], q.shape[2], q.shape[1], k.shape[1]))
        return attend(q, k, *args, **kwargs)

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
            tokens, targets, steps = _inputs(cfg.vocab)
            params = place(p0, shard_params(p0, rules))
            off: list = []
            for layout in LAYOUTS:
                toks, dec = _layout(layout, tokens, steps)
                pb = {"tokens": torch.from_numpy(toks)}
                scores.clear()
                attn_mod._attend = recording_attend
                try:
                    logits, cache = lm.prefill(cfg, params, place(pb, batch_specs(cfg, pb, rules)),
                                               max_len=MAX_LEN)
                finally:
                    attn_mod._attend = attend
                out[f"{case}/{layout}/scores"] = np.array(scores)
                out[f"{case}/{layout}/prefill"] = logits.full_tensor()[:, -1].numpy()
                off += off_specs(cfg, cache)
                lgs = []
                for i in range(DECODE_STEPS):
                    tok = torch.from_numpy(dec[i])
                    tok = spmd.distribute_tensor(tok, mesh, spmd.batch_placements(tok.shape, mesh),
                                                 src_data_rank=None)
                    lg, cache = lm.decode_step(cfg, params, cache, tok, SEQ + i)
                    lgs.append(lg.full_tensor().numpy())
                    off += off_specs(cfg, cache)
                out[f"{case}/{layout}/dec_logits"] = np.stack(lgs)
                for key in STATES[CASES[case][0]]:
                    out[f"{case}/{layout}/state/{key}"] = cache[key].full_tensor().float().numpy()
            out[f"{case}/cache_off_specs"] = np.array(json.dumps(off))

            seen: dict = {}
            inner = get_optimizer(cfg.optimizer)
            state = init_opt_state(inner, p0)
            state = place(state, shard_opt_state(state, p0, rules))
            batch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
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
    """The reference's sharded programs (RWKV and hymba cases in two
    processes) and the port's gloo world, run side by side from the
    reference's parameters; (reference npz, port npz)."""
    d = tmp_path_factory.mktemp("spmd_ssm")
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
    groups = {"rwkv": ["rwkv", "rwkv_h3"], "hymba": ["hymba", "hymba_h3"]}
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


def _grad_rel(case):
    return SSM_GRAD_REL if CASES[case][0] == "rwkv6-7b" else HYBRID_GRAD_REL


@pytest.mark.parametrize("case", CASES)
def test_sharded_loss_and_gradients_match_reference(runs, case):
    ref, port = runs
    np.testing.assert_allclose(port[f"{case}/loss"], ref[f"{case}/loss"], rtol=LOSS_RTOL)
    keys = _leaf_keys(ref, case, "g")
    assert keys == _leaf_keys(port, case, "g")
    for k in keys:
        g, want = port[f"{case}/g/{k}"], ref[f"{case}/g/{k}"]
        tol = _grad_rel(case) * max(float(np.abs(want).max()), 1e-30)
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
        tol = _grad_rel(case) * float(np.abs(want).max()) + np.spacing(np.abs(p0)).max()
        assert float(np.abs(move - want)[~undecided].max(initial=0.0)) <= tol, (case, k)
        bound = LR * (1 + WEIGHT_DECAY * np.abs(p0)) * (1 + 1e-5)
        assert (np.abs(move)[undecided] <= bound[undecided]).all(), (case, k)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_prefill_decode_and_states_match_reference(runs, case, layout):
    """Prefill's last logits, 4 decode steps' logits and the decode states
    after them, at batch 4 and at batch 1 (``long_500k``'s layout); the
    cache in ``cache_specs``' placements throughout."""
    ref, port = runs
    pre = f"{case}/{layout}"
    got, want = port[f"{pre}/prefill"], ref[f"{pre}/prefill"]
    assert float(np.abs(got - want).max()) <= LOGIT_REL * (1 + float(np.abs(want).max()))
    for i in range(DECODE_STEPS):
        lg, wl = port[f"{pre}/dec_logits"][i], ref[f"{pre}/dec_logits"][i]
        scale = 1 + float(np.abs(wl).max())
        assert float(np.abs(lg - wl).max()) <= DECODE_REL * scale, (i, np.abs(lg - wl).max())
        top2 = np.sort(wl, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > LOGIT_REL * scale
        np.testing.assert_array_equal(lg.argmax(-1)[sure], wl.argmax(-1)[sure])
    for key in STATES[CASES[case][0]]:
        got, want = port[f"{pre}/state/{key}"], ref[f"{pre}/state/{key}"]
        assert got.shape == want.shape, key
        assert float(np.abs(got - want).max()) <= DECODE_REL * (1 + float(np.abs(want).max())), (
            key, float(np.abs(got - want).max()))
    assert json.loads(str(port[f"{case}/cache_off_specs"])) == []


def test_hymba_attention_splits_by_sequence_where_heads_do_not_divide(runs):
    """Rank 0's attention scores in prefill, a layer each: 3 query heads do
    not divide the model axis, so each rank holds its 16 of the 32 query
    rows against every key (``[2, 3, 16, 32]`` at batch 4, ``[1, 3, 16,
    32]`` at batch 1); 4 heads split by heads (``[2, 2, 32, 32]``)."""
    _, port = runs
    for case, want in (("hymba_h3", (2, 3, SEQ // 2, SEQ)), ("hymba", (2, 2, SEQ, SEQ))):
        got = port[f"{case}/b4/scores"]
        assert got.shape == (4, 4) and (got == want).all(), (case, got)
    assert (port["hymba_h3/b1/scores"] == (1, 3, SEQ // 2, SEQ)).all()
    assert port["rwkv/b4/scores"].size == 0


# ---------------------------------------------------------------------------
# in this process, on fake process groups
# ---------------------------------------------------------------------------

def _train_counts(case, stand_in: bool = False):
    """(rank 0's FLOPs x 4 on a fake (2, 2) mesh, one device's FLOPs) of
    the case's reduced train cell (4 x 32 tokens, remat off); with
    ``stand_in``, one device's FLOPs with the chunked scans replaced by
    elementwise stand-ins of the same shapes (no FLOPs)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import spmd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import ssm

    cfg = _config(get_config, reduced_config, case)
    shape = ShapeSpec("train_small", SEQ, BATCH, "train")
    with spmd.spmd_mesh((2, 2), ("data", "model"), backend="fake") as mesh:
        counter, arg_bytes, _ = dryrun.count_rank0(cfg, shape, mesh)
        chips = mesh.size()
    assert arg_bytes > 0 and counter.collectives["TOTAL"]["count"] > 0
    fn, args, _ = dryrun._step_and_specs(cfg, shape, make_production_mesh())
    if not stand_in:
        return chips * counter.flops, dryrun.count_step(fn, args).flops
    scans = ssm.wkv6_chunked, ssm.ssd_chunked
    # every input reaches the output, so every product upstream keeps its
    # backward
    ssm.wkv6_chunked = lambda r, k, v, logw, u, state: (r * k * v * logw.exp() * u, state)
    ssm.ssd_chunked = lambda xv, B, C, dt, ld, D, state: (
        xv * (dt * ld.exp())[..., None] * D + (B.sum(-1) + C.sum(-1))[..., None, None], state)
    try:
        return chips * counter.flops, dryrun.count_step(fn, args).flops
    finally:
        ssm.wkv6_chunked, ssm.ssd_chunked = scans


@pytest.mark.parametrize("case", ["rwkv", "hymba"])
def test_rank0_count_covers_the_single_device_count(case):
    """The scans split by head (and hymba's attention by head): rank 0's
    FLOPs x 4 within 0.99-1.05 of one device's count of the whole step
    (measured: 1.000 / 1.004)."""
    got, one = _train_counts(case)
    assert 0.99 <= got / one <= 1.05, (got, one)


@pytest.mark.parametrize("case", ["rwkv_h3", "hymba_h3"])
def test_rank0_count_of_a_replicated_scan_is_its_design(case):
    """Heads that do not divide the 2-way model axis: each model rank scans
    every head of its own batch rows, so the scan's FLOPs (forward and
    backward) count once more for the second model rank, while every
    product around it stays split. The scan's share of one device's count
    is the drop when the chunked scan is replaced by an elementwise
    stand-in that every input reaches; 4 x rank 0's FLOPs are within
    0.99-1.05 of one device's count plus that share once (measured: 1.000 /
    1.004; against one device's count alone 1.045 / 1.048, the scans' share
    0.045 / 0.044)."""
    got, one = _train_counts(case)
    _, without = _train_counts(case, stand_in=True)
    scan = one - without
    assert scan > 0.01 * one
    assert 0.99 <= got / (one + scan) <= 1.05, (got, one, scan)


def _trees(arch):
    """``arch``'s params, AdamW state, the ``train_4k`` batch and the
    ``decode_32k`` and ``long_500k`` caches as ``meta`` tensors."""
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
    caches = [{k: torch.empty(shape, dtype=dt, device="meta")
               for k, (shape, dt) in input_specs(cfg, SHAPES[s])["cache"].items()}
              for s in ("decode_32k", "long_500k")]
    return cfg, params, opt, batch, caches


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_placements_give_the_rules_shard_shape(arch, multi):
    """Rank 0's block under ``placements`` of every leaf (params, AdamW
    state, ``train_4k`` batch, ``decode_32k`` and ``long_500k`` caches) on
    the production mesh is ``NamedSharding.shard_shape``, bitwise; at batch
    1 the RWKV state keeps its heads over ``model`` and hymba's cache its
    sequence."""
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import (batch_specs, cache_specs, shard_opt_state,
                                                  shard_params)
    from repro_torch.launch.mesh import make_production_spmd_mesh

    cfg, params, opt, batch, caches = _trees(arch)
    with make_production_spmd_mesh(multi_pod=multi) as mesh:
        rules = spmd.RuleMesh(mesh)
        trees = [(params, shard_params(params, rules)),
                 (opt, shard_opt_state(opt, params, rules)),
                 (batch, batch_specs(cfg, batch, rules))]
        trees += [(c, cache_specs(cfg, c, rules)) for c in caches]
        n = 0
        for tree, shardings in trees:
            flat_t, flat_s = _flatten(tree), _flatten(shardings)
            for key, t in flat_t.items():
                sh = flat_s[key]
                got, _ = spmd.local_shape(t.shape, mesh, spmd.placements(sh.spec, mesh))
                assert tuple(got) == sh.shard_shape(t.shape), (key, sh.spec)
                n += 1
        assert n > 20
        long_cache = cache_specs(cfg, caches[1], rules)
        key = "tm_s" if arch == "rwkv6-7b" else "k"
        assert tuple(long_cache[key].spec)[1:3] == (None, "model")


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_full_width_long_500k_is_rank0s_program(arch):
    """Each arch's ``long_500k`` cell at full width and depth, rank 0 of
    the (16, 16) mesh on ``meta``: status ok, rank 0's own program with its
    collectives, the scan's layout named (RWKV's 64 heads by head, hymba's
    25 SSD heads replicated over the model axis)."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell(arch, "long_500k", "single")
    assert rec["status"] == "ok" and rec["spmd"] is True and rec["chips"] == 256
    assert rec["collectives"]["TOTAL"]["count"] > 0
    assert 0 < rec["counted_flops_per_device"] < rec["counted_flops"]
    assert rec["ssm_scan"] == ("by_heads" if arch == "rwkv6-7b" else "replicated_over_model")


def test_layout_notes_name_the_sequence_parallel_attention():
    """A hymba train or prefill cell's record names its sequence-parallel
    attention (25 heads on 16); decode and RWKV cells name none."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun

    hymba, rwkv = get_config("hymba-1.5b"), get_config("rwkv6-7b")
    notes = dryrun._layout_notes(hymba, SHAPES["prefill_32k"], 16)
    assert "sequence-parallel" in notes["attention"] and "2048 query rows" in notes["attention"]
    assert "attention" not in dryrun._layout_notes(hymba, SHAPES["decode_32k"], 16)
    assert dryrun._layout_notes(rwkv, SHAPES["train_4k"], 16)["ssm_scan"] == "by_heads"


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
