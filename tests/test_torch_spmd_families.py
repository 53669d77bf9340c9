"""PyTorch port, the MLA and MoE decoders as one program over a device mesh
(``repro_torch.distributed.spmd``, DTensor) against the reference's sharded
programs, as ``tests/test_torch_spmd.py`` holds the dense GQA decoders (its
helpers are imported from there).

The reference runs in a subprocess with 4 forced host devices on an
Auto-axis ``jax.sharding.Mesh`` of (data 2, model 2), the port in four
``gloo`` processes started by ``file://``; the two run side by side after a
first subprocess has drawn the reference's parameters
(``init_params(PRNGKey(0))``, carried across by
``convert.lm_params_from_numpy``). Eight reduced configs (``CASES``), each
with its config's optimizer: minicpm3-4b (MLA, AdamW) as it is, with 3 heads
and the absorbed decode, and with 3 heads under ``attn_act_shard="auto"`` (3
heads do not divide the model axis: sequence-parallel attention);
qwen3-moe-235b-a22b (Adafactor) with global and with grouped dispatch (the
latter with ``moe_shard_constraints``), each at the reduced config's
``capacity_factor`` of 4.0 (no pair drops) and at 1.0 (pairs drop); and
grok-1-314b with 3 experts (they do not divide the model axis: the expert
weights are sharded over ``d`` and ``ff``). 4 sequences of 32 tokens from
``np.random.default_rng(0)``; the sharded ``make_train_step`` (``peak_lr``
1e-2 from step 0), ``prefill`` (a cache of 40) and 4 ``decode_step``s on
fixed tokens from the same generator.

Tolerances (``tests/test_torch_spmd.py``'s):
- the loss: rtol 1e-5;
- each gradient within 1e-5 of its leaf's max |grad|;
- one AdamW step: each leaf's move within 1e-5 of the leaf's largest move
  where the sign is decided, and at most ``lr x (1 + wd |p|)`` where the
  reference's |grad| is under 1e-3 of the leaf's max; one Adafactor step:
  each leaf within 1e-5 of its largest |p| (``tests/test_torch_spmd.py``'s
  Adafactor rule: the update divides the gradient by a factored RMS, which
  is small in rows of small gradients, so the gradients' 1e-5 is not 1e-5
  of the largest move there);
- prefill's last-position logits within 1e-5 x (1 + max |logit|);
- each decode step's logits within 5e-3 x (1 + max |logit|) (decode reads
  the bf16 cache), the argmax equal wherever the reference's top-2 gap
  exceeds 1e-5 x (1 + max |logit|);
- MoE: each layer's kept (token, expert) pairs in prefill equal to the
  reference's for every token whose router top-k gap (the k-th against the
  (k+1)-th probability) exceeds 1e-5;
- no gradient reaches the optimizer with placements other than its
  parameter's.

Also in the port's world, against the plain port in the same process: the
MoE layer under remat policy ``moe`` (its buffers ``moe_xin`` / ``moe_out``
kept as DTensors), and minicpm3 with a vocab that does not divide the model
axis (logits and loss on sequence blocks): loss rtol 1e-5, every gradient
within 1e-5 of its leaf's max, prefill logits within 1e-5 x (1 + max).

On fake process groups in this process: rank 0's FLOPs x 4 against the
single-device count of the reduced train cells (0.99-1.05 for MLA and the
grouped MoE; for the global MoE against what its design gives: the expert
FLOPs once more for each further data rank); ``placements`` against
``NamedSharding.shard_shape`` for every minicpm3, qwen3-moe and grok leaf on
both production meshes; full-width minicpm3 ``decode_32k`` counted on
``meta``; an MoE cell's record naming its dispatch.
"""

from __future__ import annotations

import dataclasses
import json
import os
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

BATCH, SEQ, MAX_LEN, DECODE_STEPS = 4, 32, 40, 4
LR = 1e-2
GAP = 1e-5
# A guard against a hung world, not a time budget: alone the file takes
# ~90 s, but beside the rest of the suite on a loaded machine its reference
# runs took over 120 s.
WORLD_TIMEOUT_S = 600
CASES = {
    "mla": ("minicpm3-4b", {}),
    "mla_h3_absorb": ("minicpm3-4b", {"n_heads": 3, "mla_absorb": True}),
    "mla_h3_auto": ("minicpm3-4b", {"n_heads": 3, "attn_act_shard": "auto"}),
    "qwen_global": ("qwen3-moe-235b-a22b", {}),
    "qwen_grouped": ("qwen3-moe-235b-a22b", {"moe_dispatch": "grouped",
                                             "moe_shard_constraints": True}),
    "qwen_global_cf1": ("qwen3-moe-235b-a22b", {"capacity_factor": 1.0}),
    "qwen_grouped_cf1": ("qwen3-moe-235b-a22b", {"moe_dispatch": "grouped",
                                                 "moe_shard_constraints": True,
                                                 "capacity_factor": 1.0}),
    "grok_e3": ("grok-1-314b", {"n_experts": 3, "moe_shard_constraints": True}),
}
MOE = tuple(c for c, (arch, _) in CASES.items() if arch != "minicpm3-4b")


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


def _recording_moe(moe_mod, seen):
    """``moe_mod.moe_ffn`` with each call's (experts, keep, top-k gap)
    recorded in ``seen`` through ``jax.debug.callback`` (the layers of a
    scan call it in order)."""
    import jax
    import jax.numpy as jnp

    inner = moe_mod.moe_ffn

    def moe_ffn(p, x, cfg):
        b, s, d = x.shape
        e, k = cfg.n_experts, cfg.experts_per_token
        _, idx, probs = moe_mod._route(p, x.reshape(-1, d), cfg)
        top = jax.lax.top_k(probs, k + 1)[0]
        if cfg.moe_dispatch == "grouped":
            cap = max(1, int(np.ceil(s * k * cfg.capacity_factor / e)))
            flat = idx.reshape(b, s * k)
        else:
            cap = moe_mod.moe_capacity(b * s, cfg)
            flat = idx.reshape(1, -1)
        onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
        pos = jnp.cumsum(onehot, axis=1) - onehot
        slot = jnp.take_along_axis(pos, flat[..., None], axis=2)[..., 0]
        jax.debug.callback(lambda i, kp, g: seen.append((np.asarray(i), np.asarray(kp),
                                                         np.asarray(g))),
                           idx, (slot < cap).reshape(-1, k), top[:, k - 1] - top[:, k])
        return inner(p, x, cfg)

    return moe_ffn


def reference_main(params_path: str, out_path: str, cases: str) -> None:
    """The reference's sharded programs for the comma-separated ``cases``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced_config
    from repro.distributed.sharding import batch_specs, cache_specs, shard_params
    from repro.launch.hlo_stats import collective_stats
    from repro.launch.train import init_opt_state, make_train_step
    from repro.models import lm
    from repro.models import moe as moe_mod
    from repro.optim.optimizers import get_optimizer

    ref_p = dict(np.load(params_path))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out, stats = {}, {}
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
            compiled = step.lower(params, state, batch).compile()
            stats[case] = collective_stats(compiled.as_text())
            p1, _, metrics = compiled(params, state, batch)
            out[f"{case}/loss"] = np.asarray(metrics["loss"])
            out.update(_flatten(jax.device_get(p1), f"{case}/p1/"))
            seen: list = []
            plain_moe = moe_mod.moe_ffn
            if cfg.n_experts:
                moe_mod.moe_ffn = _recording_moe(moe_mod, seen)
            try:
                logits, cache = jax.jit(lambda p, b: lm.prefill(cfg, p, b, max_len=MAX_LEN),
                                        in_shardings=(p_sh, b_sh))(params, batch)
                jax.block_until_ready(logits)
                jax.effects_barrier()
            finally:
                moe_mod.moe_ffn = plain_moe
            if cfg.n_experts:
                assert len(seen) == cfg.n_layers, len(seen)
                out[f"{case}/kept_idx"] = np.stack([s[0] for s in seen])
                out[f"{case}/kept"] = np.stack([s[1] for s in seen])
                out[f"{case}/gap"] = np.stack([s[2] for s in seen])
            out[f"{case}/prefill"] = np.asarray(logits[:, -1])
            c_sh = cache_specs(cfg, cache, mesh)
            dec = jax.jit(lambda p, c, t, pos: lm.decode_step(cfg, p, c, t, pos),
                          in_shardings=(p_sh, c_sh, batch_specs(cfg, {"t": batch["tokens"][:, 0]},
                                                                mesh)["t"], None))
            lgs = []
            for i in range(DECODE_STEPS):
                lg, cache = dec(params, jax.device_put(cache, c_sh), jnp.asarray(steps[i]),
                                jnp.int32(SEQ + i))
                lgs.append(np.asarray(lg))
            out[f"{case}/dec_logits"] = np.stack(lgs)
    out["collectives"] = np.array(json.dumps(stats))
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port, in four gloo processes
# ---------------------------------------------------------------------------

def port_main(rank: int, world_dir: str, params_path: str, out_path: str) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import batch_specs, shard_opt_state, shard_params
    from repro_torch.launch.hlo_stats import OpCounter
    from repro_torch.launch.train import init_opt_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import Optimizer, get_optimizer

    torch.set_num_threads(1)
    ref_p = dict(np.load(params_path))
    out, stats = {}, {}

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

    slots = moe_mod._dispatch_slots
    kept: list = []

    def recording_slots(flat_e, *args, **kwargs):
        slot, keep = slots(flat_e, *args, **kwargs)
        kept.append((flat_e.reshape(-1), keep.reshape(-1)))
        return slot, keep

    with spmd.spmd_mesh((2, 2), ("data", "model"), backend="gloo", rank=rank,
                        init_dir=world_dir) as mesh:
        rules = spmd.RuleMesh(mesh)

        def place(cfg, params, batch):
            return (spmd.distribute_tree(params, shard_params(params, rules), mesh),
                    spmd.distribute_tree(batch, batch_specs(cfg, batch, rules), mesh))

        for case in CASES:
            cfg = _config(get_config, reduced_config, case)
            p0 = lm_params_from_numpy(_unflatten(ref_p, f"{case}/p0/"), device="cpu")
            tokens, targets, steps = _inputs(cfg.vocab)
            batch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
            params, dbatch = place(cfg, p0, batch)
            kept.clear()
            moe_mod._dispatch_slots = recording_slots
            try:
                logits, cache = lm.prefill(cfg, params, dbatch, max_len=MAX_LEN)
            finally:
                moe_mod._dispatch_slots = slots
            if cfg.n_experts:
                # each rank's pairs; the data ranks hold the tokens in order
                every = [None] * dist.get_world_size()
                dist.all_gather_object(every, kept)
                coords = mesh.mesh.tolist()
                layers = [[every[coords[d][0]][i] for d in range(mesh.size(0))]
                          for i in range(cfg.n_layers)]
                k = cfg.experts_per_token
                out[f"{case}/kept_idx"] = np.stack(
                    [torch.cat([e for e, _ in parts]).reshape(-1, k).numpy() for parts in layers])
                out[f"{case}/kept"] = np.stack(
                    [torch.cat([kp for _, kp in parts]).reshape(-1, k).numpy()
                     for parts in layers])
            out[f"{case}/prefill"] = logits.full_tensor()[:, -1].numpy()
            lgs = []
            for i in range(DECODE_STEPS):
                tok = torch.from_numpy(steps[i])
                tok = spmd.distribute_tensor(tok, mesh, spmd.batch_placements(tok.shape, mesh),
                                             src_data_rank=None)
                lg, cache = lm.decode_step(cfg, params, cache, tok, SEQ + i)
                lgs.append(lg.full_tensor().numpy())
            out[f"{case}/dec_logits"] = np.stack(lgs)

            seen: dict = {}
            inner = get_optimizer(cfg.optimizer)
            state = init_opt_state(inner, p0)
            state = spmd.distribute_tree(state, shard_opt_state(state, p0, rules), mesh)
            step = make_train_step(cfg, recording(inner, seen), peak_lr=LR, warmup=0)
            with OpCounter() as counter:
                p1, _, metrics = step(params, state, dbatch)
            stats[case] = counter.collectives
            out[f"{case}/loss"] = metrics["loss"].numpy()
            out[f"{case}/mismatch"] = np.array(json.dumps(seen["mismatch"]))
            out.update({f"{case}/g/{k}": v.numpy() for k, v in seen["grads"].items()})
            out.update({f"{case}/p1/{k}": v.numpy()
                        for k, v in _flatten(spmd.full_tree(p1)).items()})

        # against the plain port in this process: the MoE layer under remat
        # policy "moe"; a vocab that does not divide the model axis (the
        # logits and the loss on sequence blocks, as minicpm3's 73,448 on 16)
        extra = {"remat": dataclasses.replace(_config(get_config, reduced_config,
                                                      "qwen_global_cf1"),
                                              remat=True, remat_policy="moe"),
                 "vocab": dataclasses.replace(_config(get_config, reduced_config, "mla"),
                                              vocab=255)}
        for what, cfg in extra.items():
            p0 = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            tokens, targets, _ = _inputs(cfg.vocab)
            batch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
            plain_p = _unflatten({k: v.clone() for k, v in _flatten(p0).items()}, "")
            for name, (prm, b) in (("plain", (plain_p, batch)),
                                   ("sharded", place(cfg, p0, batch))):
                logits, _ = lm.prefill(cfg, prm, b, max_len=MAX_LEN)
                out[f"{what}/{name}/prefill"] = spmd.replicated(logits)[:, -1].numpy()
                grads: list = []
                inner = get_optimizer(cfg.optimizer)

                def capture(g, s, p, lr, inner=inner, grads=grads):
                    grads.append({k: spmd.replicated(v) for k, v in _flatten(g).items()})
                    return inner.update(g, s, p, lr)

                state = init_opt_state(inner, p0)
                if name == "sharded":
                    state = spmd.distribute_tree(state, shard_opt_state(state, p0, rules),
                                                 mesh)
                step = make_train_step(cfg, Optimizer(inner.init, capture, inner.name),
                                       peak_lr=LR, warmup=0)
                _, _, metrics = step(prm, state, b)
                out[f"{what}/{name}/loss"] = metrics["loss"].numpy()
                out.update({f"{what}/{name}/g/{k}": v.numpy() for k, v in grads[0].items()})
    if rank == 0:
        out["collectives"] = np.array(json.dumps(stats))
        np.savez(out_path, **out)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's sharded programs (MLA and MoE cases in two processes)
    and the port's gloo world, run side by side from the reference's
    parameters; (reference npz, port npz)."""
    d = tmp_path_factory.mktemp("spmd_families")
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
    groups = {"mla": [c for c in CASES if c not in MOE], "moe": list(MOE)}
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
    stats: dict = {}
    for name in groups:
        part = dict(np.load(d / f"ref_{name}.npz"))
        stats.update(json.loads(str(part.pop("collectives"))))
        ref.update(part)
    ref["collectives"] = np.array(json.dumps(stats))
    return ref, dict(np.load(port_path))


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
def test_sharded_optimizer_step_matches_reference(runs, case):
    ref, port = runs
    adamw = CASES[case][0] == "minicpm3-4b"
    for k in _leaf_keys(ref, case, "p1"):
        p0 = ref[f"{case}/p0/{k}"]
        move, want = port[f"{case}/p1/{k}"] - p0, ref[f"{case}/p1/{k}"] - p0
        tol = GRAD_REL * float(np.abs(want).max()) + np.spacing(np.abs(p0)).max()
        if not adamw:
            got, ref_p1 = port[f"{case}/p1/{k}"], ref[f"{case}/p1/{k}"]
            assert float(np.abs(got - ref_p1).max()) <= GRAD_REL * float(np.abs(ref_p1).max()), (
                case, k)
            continue
        g = np.abs(ref[f"{case}/g/{k}"])
        undecided = g < SIGN_UNDECIDED * g.max()
        assert float(np.abs(move - want)[~undecided].max(initial=0.0)) <= tol, (case, k)
        bound = LR * (1 + WEIGHT_DECAY * np.abs(p0)) * (1 + 1e-5)
        assert (np.abs(move)[undecided] <= bound[undecided]).all(), (case, k)


@pytest.mark.parametrize("case", CASES)
def test_sharded_prefill_and_decode_match_reference(runs, case):
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


@pytest.mark.parametrize("case", MOE)
def test_sharded_moe_keeps_the_reference_pairs(runs, case):
    """Each layer's kept (token, expert) pairs in prefill, for every token
    whose router top-k gap exceeds 1e-5; at ``capacity_factor`` 1.0 some
    pairs drop, and they are the reference's."""
    ref, port = runs
    idx, kept, gap = ref[f"{case}/kept_idx"], ref[f"{case}/kept"], ref[f"{case}/gap"]
    p_idx, p_kept = port[f"{case}/kept_idx"], port[f"{case}/kept"]
    assert idx.shape == p_idx.shape and kept.shape == p_kept.shape
    for layer in range(idx.shape[0]):
        sure = gap[layer] > GAP
        assert sure.mean() > 0.9, (case, layer)
        want = [set(i[k]) for i, k in zip(idx[layer][sure], kept[layer][sure])]
        got = [set(i[k]) for i, k in zip(p_idx[layer][sure], p_kept[layer][sure])]
        assert got == want, (case, layer)
    if CASES[case][1].get("capacity_factor") == 1.0:
        assert not kept.all(), f"{case}: no pair dropped"
    else:
        assert kept.all(), f"{case}: a pair dropped at capacity_factor 4"


@pytest.mark.parametrize("what", ["remat", "vocab"])
def test_sharded_variants_match_plain(runs, what):
    """Against the plain port's step in the same process, on the (2, 2)
    mesh: ``remat``, reduced qwen3-moe (global dispatch, ``capacity_factor``
    1.0) under remat policy ``moe``, whose buffers ``moe_xin`` /
    ``moe_out`` are kept as DTensors; ``vocab``, reduced minicpm3 with a
    vocab of 255, which does not divide the model axis (the logits and the
    loss on sequence blocks). Loss (rtol 1e-5), every gradient (1e-5 of its
    leaf's max) and prefill's last-position logits (1e-5 x (1 + max))."""
    _, port = runs
    np.testing.assert_allclose(port[f"{what}/sharded/loss"], port[f"{what}/plain/loss"],
                               rtol=LOSS_RTOL)
    got, want = port[f"{what}/sharded/prefill"], port[f"{what}/plain/prefill"]
    assert float(np.abs(got - want).max()) <= LOGIT_REL * (1 + float(np.abs(want).max()))
    prefix = f"{what}/plain/g/"
    keys = sorted(k[len(prefix):] for k in port if k.startswith(prefix))
    assert ("layers/ffn/w1" if what == "remat" else "lm_head") in keys
    for k in keys:
        g, want = port[f"{what}/sharded/g/{k}"], port[f"{what}/plain/g/{k}"]
        assert float(np.abs(g - want).max()) <= GRAD_REL * float(np.abs(want).max()), k


def test_collectives_beside_reference(runs, capsys):
    ref, port = runs
    rs, ps = json.loads(str(ref["collectives"])), json.loads(str(port["collectives"]))
    with capsys.disabled():
        for case in CASES:
            for name, st in (("reference (XLA, per device)", rs[case]),
                             ("port (DTensor, rank 0)", ps[case])):
                kinds = ", ".join(f"{k} {int(v['count'])} x {int(v['operand_bytes']):,} B"
                                  for k, v in sorted(st.items()) if k != "TOTAL")
                print(f"\n{case} train step, {name}: {kinds}; total "
                      f"{int(st['TOTAL']['count'])} x {int(st['TOTAL']['operand_bytes']):,} B")
    for case in CASES:
        assert ps[case]["TOTAL"]["count"] > 0 and rs[case]["TOTAL"]["count"] > 0


# ---------------------------------------------------------------------------
# in this process, on fake process groups
# ---------------------------------------------------------------------------

def _train_counts(case, **overrides):
    """(rank 0's FLOPs x 4 on a fake (2, 2) mesh, one device's FLOPs) of
    the case's reduced train cell (4 x 32 tokens, remat off)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import spmd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg = dataclasses.replace(_config(get_config, reduced_config, case), **overrides)
    shape = ShapeSpec("train_small", SEQ, BATCH, "train")
    with spmd.spmd_mesh((2, 2), ("data", "model"), backend="fake") as mesh:
        counter, arg_bytes, _ = dryrun.count_rank0(cfg, shape, mesh)
        chips = mesh.size()
    fn, args, _ = dryrun._step_and_specs(cfg, shape, make_production_mesh())
    assert arg_bytes > 0 and counter.collectives["TOTAL"]["count"] > 0
    return chips * counter.flops, dryrun.count_step(fn, args).flops


@pytest.mark.parametrize("case", ["mla", "mla_h3_auto", "qwen_grouped", "grok_e3_grouped"])
def test_rank0_count_covers_the_single_device_count(case):
    """MLA (head- and sequence-parallel) and grouped MoE (experts over
    ``model``; grok's 3 experts by their ``ff`` slices): rank 0's FLOPs x 4
    within 0.99-1.05 of one device's count of the whole step (measured:
    1.000 / 1.000 / 1.000 / 1.003)."""
    if case == "grok_e3_grouped":
        got, one = _train_counts("grok_e3", moe_dispatch="grouped")
    else:
        got, one = _train_counts(case)
    assert 0.99 <= got / one <= 1.05, (got, one)


@pytest.mark.parametrize("case", ["qwen_global", "qwen_global_cf1", "grok_e3"])
def test_rank0_count_of_global_dispatch_is_its_design(case):
    """Global dispatch: each rank runs its experts over the whole capacity,
    so the expert FLOPs count once more for each further data rank. Their
    share of one device's count is what doubling the capacity adds (the
    reduced config's capacity is above its floor of 8); 4 x rank 0's FLOPs
    are within 0.99-1.05 of one device's count plus that share once
    (measured ratios to one device's count 1.66 / 1.33 / 1.67)."""
    from repro_torch.configs import get_config, reduced_config

    cf = _config(get_config, reduced_config, case).capacity_factor
    got, one = _train_counts(case)
    _, twice = _train_counts(case, capacity_factor=2 * cf)
    experts = twice - one
    assert experts > 0.1 * one
    assert 0.99 <= got / (one + experts) <= 1.05, (got, one, experts)


def _trees(arch):
    """``arch``'s params, its optimizer's state, the ``train_4k`` batch and
    the ``decode_32k`` cache as ``meta`` tensors."""
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
@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen3-moe-235b-a22b", "grok-1-314b"])
def test_placements_give_the_rules_shard_shape(arch, multi):
    """Rank 0's block under ``placements`` of every leaf (params, the
    config's optimizer state, ``train_4k`` batch, ``decode_32k`` cache) on
    the production mesh is ``NamedSharding.shard_shape``, bitwise."""
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
        n = 0
        for tree, shardings in trees:
            flat_t, flat_s = _flatten(tree), _flatten(shardings)
            for key, t in flat_t.items():
                sh = flat_s[key]
                got, _ = spmd.local_shape(t.shape, mesh, spmd.placements(sh.spec, mesh))
                assert tuple(got) == sh.shard_shape(t.shape), (key, sh.spec)
                n += 1
        assert n > 20


def test_moe_record_names_its_dispatch():
    """A reduced qwen3-moe cell's dry-run record on the (16, 16) mesh (2
    layers): rank 0's own program, its dispatch and the expert FLOPs its
    design gives (global: the 16 data ranks' worth; grouped: 1)."""
    from repro_torch.launch import dryrun

    for dispatch, ratio in (("global", 16), ("grouped", 1)):
        rec = dryrun.run_cell("qwen3-moe-235b-a22b", "decode_32k", "single",
                              {"n_layers": "2", "moe_dispatch": dispatch})
        assert rec["status"] == "ok" and rec["spmd"] is True
        assert rec["moe_dispatch"] == dispatch and dispatch in rec["dispatch_note"]
        assert rec["expert_flops_vs_single_device"] == ratio


def test_full_width_mla_decode_counts_on_meta():
    """minicpm3-4b's ``decode_32k`` cell at full width and depth, rank 0 of
    the (16, 16) mesh on ``meta``: 40 heads do not divide the model axis's
    16; the record is rank 0's own program with its collectives."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("minicpm3-4b", "decode_32k", "single")
    assert rec["status"] == "ok" and rec["spmd"] is True and rec["chips"] == 256
    assert rec["collectives"]["TOTAL"]["count"] > 0
    assert rec["roofline"]["collective_s"] > 0
    assert 0 < rec["counted_flops_per_device"] < rec["counted_flops"]


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
