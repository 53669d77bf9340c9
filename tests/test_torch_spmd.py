"""PyTorch port, the LM as one program over a device mesh
(``repro_torch.distributed.spmd``, DTensor) against the reference's sharded
programs (``jax.jit`` with the rules' ``in_shardings``).

Both run on a ``("data", "model")`` mesh of (2, 2) on the CPU: the reference
in a subprocess with 4 forced host devices and an Auto-axis
``jax.sharding.Mesh`` (``jax.make_mesh`` makes Explicit axes, on which the
reference's ``_shard_act`` raises under jax 0.9.0), the port in four
``gloo`` processes started by ``file://`` in a temporary directory. Reduced
yi-6b, yi-9b and phi3-medium-14b (dense GQA) from the reference's
``init_params(PRNGKey(0))``, carried across by
``convert.lm_params_from_numpy``; 4 sequences of 32 tokens from
``np.random.default_rng(0)``. The reference's sharded ``make_train_step``
(AdamW, ``peak_lr`` 1e-2 from step 0), ``prefill`` and ``decode_step`` all
compile on the Auto-axis mesh, so the port is held against them.

Tolerances:
- the loss: rtol 1e-5;
- each gradient within 1e-5 of its leaf's max |grad| (the bound of
  ``tests/test_torch_lm_grads.py``);
- every parameter after one AdamW step: each leaf's move within 1e-5 of the
  leaf's largest move, but where the reference's |grad| is under 1e-3 of the
  leaf's max (AdamW's first update is about the gradient's sign, which is
  undecided there), where the move is at most ``lr x (1 + wd |p|)``: the
  rule of ``tests/test_torch_lm_train.py``;
- prefill's last-position logits within 1e-5 x (1 + max |logit|);
- the 4 greedy decode tokens equal wherever the reference's top-2 gap
  exceeds that, each step's logits within 5e-3 x (1 + max |logit|) (decode
  reads the bf16 cache: ``tests/test_torch_models.py``'s bound);
- no gradient reaches the optimizer with placements other than its
  parameter's;
- Adafactor (reduced yi-6b with the config's optimizer swapped): the sharded
  port step against the plain port step in the same process, every leaf
  within 1e-5 of its leaf's max |p| and the loss within rtol 1e-5.

The reference's ``collective_stats`` of its compiled train step and the
port's count of rank 0's collectives are printed side by side, not held
equal: XLA's partitioner and DTensor's propagation choose other programs
(on a ``"cpu"`` mesh DTensor also sends an all-to-all as all-gather +
chunk).

The other tests run on a fake process group in this process: ``placements``
against ``NamedSharding.shard_shape`` for every yi-6b leaf on both
production meshes, the counter on one product against hand counts, and the
reduced train cell's per-device count against the single-device count.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("yi-6b", "yi-9b", "phi3-medium-14b")
BATCH, SEQ, MAX_LEN, DECODE_STEPS = 4, 32, 40, 4
LR = 1e-2
WORLD_TIMEOUT_S = 120
LOSS_RTOL, GRAD_REL, SIGN_UNDECIDED, WEIGHT_DECAY = 1e-5, 1e-5, 1e-3, 0.01
LOGIT_REL, DECODE_REL = 1e-5, 5e-3


def _flatten(tree, prefix=""):
    """Leaves of nested dicts as ``{prefix + "a/b": leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(flat, prefix):
    """The nested dicts of the ``prefix``ed keys of ``flat``."""
    tree: dict = {}
    for key in flat:
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return tree


def _inputs(vocab):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    targets = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    return tokens, targets


# ---------------------------------------------------------------------------
# the reference, in a subprocess with 4 host devices
# ---------------------------------------------------------------------------

def reference_main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced_config
    from repro.distributed.sharding import batch_specs, cache_specs, shard_params
    from repro.launch.hlo_stats import collective_stats
    from repro.launch.train import init_opt_state, make_train_step
    from repro.models import lm
    from repro.optim.optimizers import get_optimizer

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out, stats = {}, {}
    for arch in ARCHS:
        cfg = reduced_config(get_config(arch))
        params = lm.init_params(cfg, jax.random.PRNGKey(0))
        tokens, targets = _inputs(cfg.vocab)
        batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
        opt = get_optimizer(cfg.optimizer)
        state = init_opt_state(opt, params)
        host = jax.device_get(params)
        out.update(_flatten(host, f"{arch}/p0/"))
        p_sh, b_sh = shard_params(params, mesh), batch_specs(cfg, batch, mesh)
        with jax.sharding.set_mesh(mesh):
            grad_fn = jax.jit(jax.grad(lambda p, b: lm.loss_fn(cfg, p, b)[0]),
                              in_shardings=(p_sh, b_sh))
            out.update(_flatten(jax.device_get(grad_fn(params, batch)), f"{arch}/g/"))
            step = jax.jit(make_train_step(cfg, opt, peak_lr=LR, warmup=0),
                           in_shardings=(p_sh, shard_params(state, mesh), b_sh))
            compiled = step.lower(params, state, batch).compile()
            stats[arch] = collective_stats(compiled.as_text())
            p1, _, metrics = compiled(params, state, batch)
            out[f"{arch}/loss"] = np.asarray(metrics["loss"])
            out.update(_flatten(jax.device_get(p1), f"{arch}/p1/"))
            logits, cache = jax.jit(lambda p, b: lm.prefill(cfg, p, b, max_len=MAX_LEN),
                                    in_shardings=(p_sh, b_sh))(params, batch)
            out[f"{arch}/prefill"] = np.asarray(logits[:, -1])
            c_sh = cache_specs(cfg, cache, mesh)
            dec = jax.jit(lambda p, c, t, pos: lm.decode_step(cfg, p, c, t, pos),
                          in_shardings=(p_sh, c_sh, batch_specs(cfg, {"t": batch["tokens"][:, 0]},
                                                                mesh)["t"], None))
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
            toks, lgs = [], []
            for i in range(DECODE_STEPS):
                lg, cache = dec(params, jax.device_put(cache, c_sh), tok, jnp.int32(SEQ + i))
                toks.append(np.asarray(tok))
                lgs.append(np.asarray(lg))
                tok = jnp.argmax(lg, -1).astype(jnp.int32)
            out[f"{arch}/dec_tok"] = np.stack(toks)
            out[f"{arch}/dec_logits"] = np.stack(lgs)
    out["collectives"] = np.array(json.dumps(stats))
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port, in four gloo processes
# ---------------------------------------------------------------------------

def port_main(rank: int, world_dir: str, ref_path: str, out_path: str) -> None:
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import (batch_specs, shard_opt_state,
                                                  shard_params)
    from repro_torch.launch.hlo_stats import OpCounter
    from repro_torch.launch.train import init_opt_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import Optimizer, get_optimizer

    torch.set_num_threads(1)
    ref = dict(np.load(ref_path))
    out, stats = {}, {}

    def recording(inner, seen):
        """``inner`` with each update's gradients (gathered) and placement
        mismatches recorded in ``seen``."""
        def update(grads, state, params, lr):
            flat_g, flat_p = _flatten(grads), _flatten(params)
            seen["mismatch"] = [k for k in flat_g
                                if tuple(flat_g[k].placements) != tuple(flat_p[k].placements)]
            seen["grads"] = {k: v.full_tensor() for k, v in flat_g.items()}
            return inner.update(grads, state, params, lr)
        return Optimizer(inner.init, update, inner.name)

    def capturing(inner, seen):
        """``inner`` with each update's gradients (full tensors) appended to
        ``seen``."""
        def update(grads, state, params, lr):
            seen.append({k: spmd.replicated(v) for k, v in _flatten(grads).items()})
            return inner.update(grads, state, params, lr)
        return Optimizer(inner.init, update, inner.name)

    with spmd.spmd_mesh((2, 2), ("data", "model"), backend="gloo", rank=rank,
                        init_dir=world_dir) as mesh:
        rules = spmd.RuleMesh(mesh)

        def place(cfg, params, batch):
            return (spmd.distribute_tree(params, shard_params(params, rules), mesh),
                    spmd.distribute_tree(batch, batch_specs(cfg, batch, rules), mesh))

        for arch in ARCHS:
            cfg = reduced_config(get_config(arch))
            p0 = lm_params_from_numpy(_unflatten(ref, f"{arch}/p0/"), device="cpu")
            tokens, targets = _inputs(cfg.vocab)
            batch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
            params, dbatch = place(cfg, p0, batch)
            logits, cache = lm.prefill(cfg, params, dbatch, max_len=MAX_LEN)
            out[f"{arch}/prefill"] = logits.full_tensor()[:, -1].numpy()
            lgs = []
            for i in range(DECODE_STEPS):
                tok = torch.from_numpy(ref[f"{arch}/dec_tok"][i])
                tok = spmd.distribute_tensor(tok, mesh, spmd.batch_placements(tok.shape, mesh),
                                             src_data_rank=None)
                lg, cache = lm.decode_step(cfg, params, cache, tok, SEQ + i)
                lgs.append(lg.full_tensor().numpy())
            out[f"{arch}/dec_logits"] = np.stack(lgs)

            seen: dict = {}
            inner = get_optimizer(cfg.optimizer)
            state = init_opt_state(inner, p0)
            state = spmd.distribute_tree(state, shard_opt_state(state, p0, rules), mesh)
            step = make_train_step(cfg, recording(inner, seen), peak_lr=LR, warmup=0)
            with OpCounter() as counter:
                p1, _, metrics = step(params, state, dbatch)
            stats[arch] = counter.collectives
            out[f"{arch}/loss"] = metrics["loss"].numpy()
            out[f"{arch}/mismatch"] = np.array(json.dumps(seen["mismatch"]))
            out.update({f"{arch}/g/{k}": v.numpy() for k, v in seen["grads"].items()})
            out.update({f"{arch}/p1/{k}": v.numpy()
                        for k, v in _flatten(spmd.full_tree(p1)).items()})

        # Adafactor: the sharded step against the plain one, in this process
        cfg = dataclasses.replace(reduced_config(get_config("yi-6b")), optimizer="adafactor")
        p0 = lm_params_from_numpy(_unflatten(ref, "yi-6b/p0/"), device="cpu")
        tokens, targets = _inputs(cfg.vocab)
        batch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
        inner = get_optimizer("adafactor")
        plain_p = _unflatten({k: v.clone() for k, v in _flatten(p0).items()}, "")
        step = make_train_step(cfg, inner, peak_lr=LR, warmup=0)
        plain_p, _, plain_m = step(plain_p, init_opt_state(inner, plain_p), batch)
        params, dbatch = place(cfg, p0, batch)
        state = init_opt_state(inner, p0)
        state = spmd.distribute_tree(state, shard_opt_state(state, p0, rules), mesh)
        p1, _, metrics = step(params, state, dbatch)
        out["adafactor/loss"] = np.stack([metrics["loss"].numpy(), plain_m["loss"].numpy()])
        out.update({f"adafactor/sharded/{k}": v.numpy()
                    for k, v in _flatten(spmd.full_tree(p1)).items()})
        out.update({f"adafactor/plain/{k}": v.numpy() for k, v in _flatten(plain_p).items()})

        # one kv head, fewer than the model axis's 2 ranks: each rank repeats
        # the kv head for its own block of query heads; against the plain port
        cfg = dataclasses.replace(reduced_config(get_config("yi-6b")), n_kv_heads=1)
        p0 = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        tokens, targets = _inputs(cfg.vocab)
        batch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
        plain_p = _unflatten({k: v.clone() for k, v in _flatten(p0).items()}, "")
        for name, (params, b) in (("plain", (plain_p, batch)),
                                  ("sharded", place(cfg, p0, batch))):
            logits, _ = lm.prefill(cfg, params, b, max_len=MAX_LEN)
            out[f"kv1/{name}/prefill"] = spmd.replicated(logits)[:, -1].numpy()
            seen = []
            inner = get_optimizer(cfg.optimizer)
            state = init_opt_state(inner, p0)
            if name == "sharded":
                state = spmd.distribute_tree(state, shard_opt_state(state, p0, rules), mesh)
            step = make_train_step(cfg, capturing(inner, seen), peak_lr=LR, warmup=0)
            _, _, metrics = step(params, state, b)
            out[f"kv1/{name}/loss"] = metrics["loss"].numpy()
            out.update({f"kv1/{name}/g/{k}": v.numpy() for k, v in seen[0].items()})
    if rank == 0:
        out["collectives"] = np.array(json.dumps(stats))
        np.savez(out_path, **out)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (os.pathsep + env["PYTHONPATH"]
                                             if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _wait(procs, what, timeout: float = WORLD_TIMEOUT_S):
    """Join every process within ``timeout`` seconds; kill the rest and fail."""
    deadline = time.monotonic() + timeout
    failed = []
    try:
        for name, p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                failed.append(f"{name}: timed out after {timeout} s")
                continue
            if p.returncode:
                failed.append(f"{name}: exit {p.returncode}\n{p.stderr.read()[-4000:]}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            if p.stderr:
                p.stderr.close()
    assert not failed, f"{what}: " + "\n".join(failed)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's sharded programs and the port's gloo world, run side
    by side; (reference npz, port npz)."""
    d = tmp_path_factory.mktemp("spmd")
    ref_path, port_path = str(d / "ref.npz"), str(d / "port.npz")
    env = _env()
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, __file__, "--reference", ref_path], env=ref_env,
                           stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    _wait([("reference", ref)], "the reference's sharded run")
    world = d / "world"
    world.mkdir()
    procs = [(f"rank {r}", subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world", str(world), "--ref", ref_path,
         "--out", port_path], env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)) for r in range(4)]
    _wait(procs, "the port's gloo world")
    return dict(np.load(ref_path)), dict(np.load(port_path))


def _leaf_keys(data, arch, kind):
    prefix = f"{arch}/{kind}/"
    return sorted(k[len(prefix):] for k in data if k.startswith(prefix))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_gradients_match_reference(runs, arch):
    ref, port = runs
    np.testing.assert_allclose(port[f"{arch}/loss"], ref[f"{arch}/loss"], rtol=LOSS_RTOL)
    keys = _leaf_keys(ref, arch, "g")
    assert keys == _leaf_keys(port, arch, "g")
    for k in keys:
        g, want = port[f"{arch}/g/{k}"], ref[f"{arch}/g/{k}"]
        tol = GRAD_REL * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(g - want).max()) <= tol, (arch, k)
    assert json.loads(str(port[f"{arch}/mismatch"])) == []


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_adamw_step_matches_reference(runs, arch):
    ref, port = runs
    keys = _leaf_keys(ref, arch, "p1")
    for k in keys:
        p0 = ref[f"{arch}/p0/{k}"]
        move, want = port[f"{arch}/p1/{k}"] - p0, ref[f"{arch}/p1/{k}"] - p0
        g = np.abs(ref[f"{arch}/g/{k}"])
        undecided = g < SIGN_UNDECIDED * g.max()
        tol = GRAD_REL * float(np.abs(want).max()) + np.spacing(np.abs(p0)).max()
        assert float(np.abs(move - want)[~undecided].max(initial=0.0)) <= tol, (arch, k)
        bound = LR * (1 + WEIGHT_DECAY * np.abs(p0)) * (1 + 1e-5)
        assert (np.abs(move)[undecided] <= bound[undecided]).all(), (arch, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_reference(runs, arch):
    ref, port = runs
    got, want = port[f"{arch}/prefill"], ref[f"{arch}/prefill"]
    assert float(np.abs(got - want).max()) <= LOGIT_REL * (1 + float(np.abs(want).max()))
    tol = LOGIT_REL * (1 + float(np.abs(ref[f"{arch}/dec_logits"]).max()))
    for i in range(DECODE_STEPS):
        lg, wl = port[f"{arch}/dec_logits"][i], ref[f"{arch}/dec_logits"][i]
        assert float(np.abs(lg - wl).max()) <= DECODE_REL * (1 + float(np.abs(wl).max())), i
        top2 = np.sort(wl, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > tol
        np.testing.assert_array_equal(lg.argmax(-1)[sure], wl.argmax(-1)[sure])


def test_sharded_adafactor_matches_plain_step(runs):
    _, port = runs
    loss = port["adafactor/loss"]
    np.testing.assert_allclose(loss[0], loss[1], rtol=LOSS_RTOL)
    keys = sorted(k[len("adafactor/plain/"):] for k in port if k.startswith("adafactor/plain/"))
    assert keys
    for k in keys:
        got, want = port[f"adafactor/sharded/{k}"], port[f"adafactor/plain/{k}"]
        assert float(np.abs(got - want).max()) <= GRAD_REL * float(np.abs(want).max()), k


def test_sharded_kv_heads_below_the_model_axis_match_plain(runs):
    """Reduced yi-6b with one kv head on the (2, 2) mesh: the kv heads do
    not divide the model axis, so each rank repeats the kv head for its own
    two query heads. Loss (rtol 1e-5), every gradient (1e-5 of its leaf's
    max) and prefill's last-position logits (1e-5 x (1 + max |logit|))
    against the plain port's step in the same process."""
    _, port = runs
    np.testing.assert_allclose(port["kv1/sharded/loss"], port["kv1/plain/loss"],
                               rtol=LOSS_RTOL)
    got, want = port["kv1/sharded/prefill"], port["kv1/plain/prefill"]
    assert float(np.abs(got - want).max()) <= LOGIT_REL * (1 + float(np.abs(want).max()))
    keys = sorted(k[len("kv1/plain/g/"):] for k in port if k.startswith("kv1/plain/g/"))
    assert "layers/attn/wk" in keys
    for k in keys:
        g, want = port[f"kv1/sharded/g/{k}"], port[f"kv1/plain/g/{k}"]
        assert float(np.abs(g - want).max()) <= GRAD_REL * float(np.abs(want).max()), k


def test_collectives_beside_reference(runs, capsys):
    ref, port = runs
    rs, ps = json.loads(str(ref["collectives"])), json.loads(str(port["collectives"]))
    with capsys.disabled():
        for arch in ARCHS:
            for name, st in (("reference (XLA, per device)", rs[arch]),
                             ("port (DTensor, rank 0)", ps[arch])):
                kinds = ", ".join(f"{k} {int(v['count'])} x {int(v['operand_bytes']):,} B"
                                  for k, v in sorted(st.items()) if k != "TOTAL")
                print(f"\n{arch} train step, {name}: {kinds}; total "
                      f"{int(st['TOTAL']['count'])} x {int(st['TOTAL']['operand_bytes']):,} B")
    for arch in ARCHS:
        assert ps[arch]["TOTAL"]["count"] > 0 and rs[arch]["TOTAL"]["count"] > 0


# ---------------------------------------------------------------------------
# in this process, on fake process groups
# ---------------------------------------------------------------------------

def _yi6b_trees():
    """yi-6b's params, AdamW state, ``train_4k`` batch and ``decode_32k``
    cache as ``meta`` tensors."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.specs import input_specs
    from repro_torch.launch.train import init_opt_state
    from repro_torch.models import lm
    from repro_torch.optim import get_optimizer

    cfg = get_config("yi-6b")
    params = lm.param_shapes(cfg)
    opt = init_opt_state(get_optimizer("adamw"), params)
    batch = {k: torch.empty(shape, dtype=dt, device="meta")
             for k, (shape, dt) in input_specs(cfg, SHAPES["train_4k"]).items()}
    cache = {k: torch.empty(shape, dtype=dt, device="meta")
             for k, (shape, dt) in input_specs(cfg, SHAPES["decode_32k"])["cache"].items()}
    return cfg, params, opt, batch, cache


@pytest.mark.parametrize("multi", [False, True])
def test_placements_give_the_rules_shard_shape(multi):
    """Rank 0's block under ``placements`` of every yi-6b leaf (params,
    AdamW state, ``train_4k`` batch, ``decode_32k`` cache) on the production
    mesh is ``NamedSharding.shard_shape``, bitwise."""
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import (batch_specs, cache_specs, shard_opt_state,
                                                  shard_params)
    from repro_torch.launch.mesh import make_production_spmd_mesh

    cfg, params, opt, batch, cache = _yi6b_trees()
    with make_production_spmd_mesh(multi_pod=multi) as mesh:
        assert mesh.size() == (512 if multi else 256)
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
        # a dim over ("pod", "data") is sharded by both, in the mesh's order
        if multi:
            assert spmd.placements((("pod", "data"), "model"), mesh) == (
                spmd.Shard(0), spmd.Shard(0), spmd.Shard(1))


def test_counter_counts_one_rank_of_a_placed_product():
    """The counter on ``dot`` of a rule-placed ``[B, S, d] x [d, ff]``
    product on a fake (2, 2) mesh: rank 0's FLOPs (its half of the batch
    against its half of ``ff``) and the weight's FSDP all-gather, by hand."""
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import param_spec
    from repro_torch.launch.hlo_stats import OpCounter
    from repro_torch.models.common import dot

    b, s, d, ff = 4, 8, 16, 32
    with spmd.spmd_mesh((2, 2), ("data", "model"), backend="fake") as mesh:
        rules = spmd.RuleMesh(mesh)
        spec = param_spec("layers/ffn/w1", (d, ff), rules, stacked=False)
        w = spmd.zeros_tree({"w": torch.empty(d, ff, device="meta")},
                            {"w": spmd.NamedSharding(rules, spec)}, mesh, device="meta")["w"]
        x = spmd.DTensor.from_local(torch.empty(b // 2, s, d, device="meta"), mesh,
                                    spmd.batch_placements((b, s, d), mesh), run_check=False)
        with OpCounter() as counter:
            y = dot(x, w)
    assert tuple(y.shape) == (b, s, ff)
    assert counter.flops == 2 * (b // 2) * s * d * (ff // 2)
    assert counter.collectives == {
        "all-gather": {"count": 1, "operand_bytes": 4.0 * (d // 2) * (ff // 2),
                       "result_bytes": 4.0 * d * (ff // 2)},
        "TOTAL": {"count": 1, "operand_bytes": 4.0 * (d // 2) * (ff // 2),
                  "result_bytes": 4.0 * d * (ff // 2)}}


def test_checkpoint_name_keeps_placements(tmp_path):
    """``repro_torch::checkpoint_name`` (the names a remat policy sees) on a
    DTensor: an identity that keeps the input's placements, forward and
    backward; on a fake (2, 2) mesh with ``meta`` blocks (placements and
    shapes) and on a ``gloo`` world of one (values too, bitwise)."""
    from repro_torch.distributed import spmd
    from repro_torch.models.common import checkpoint_name

    worlds = [(dict(mesh=(2, 2), backend="fake"), "meta"),
              (dict(mesh=(1, 1), backend="gloo", init_dir=str(tmp_path)), "cpu")]
    for world, device in worlds:
        with spmd.spmd_mesh(axis_names=("data", "model"), **world) as mesh:
            for places in [(spmd.Shard(0), spmd.Shard(1)), (spmd.Replicate(), spmd.Shard(0)),
                           (spmd.Shard(1), spmd.Replicate())]:
                x = spmd.DTensor.from_local(torch.randn(2, 3, device=device), mesh, places,
                                            run_check=False).requires_grad_()
                y = checkpoint_name(x, "moe_xin")
                assert tuple(y.placements) == places and y is not x
                assert y.to_local().shape == x.to_local().shape
                if device != "meta":
                    torch.testing.assert_close(y.to_local(), x.to_local(), rtol=0, atol=0)
                (grad,) = torch.autograd.grad(y.to_local().sum(), x)
                assert tuple(grad.placements) == places


def test_rank0_count_covers_the_single_device_count():
    """Reduced yi-6b's train cell (AdamW, remat off, 4 x 32 tokens): rank
    0's FLOPs on a (2, 2) mesh times 4 are at least 0.99 x the count of the
    whole step on one device (replicated work counts on every rank) and at
    most 1.05 x (measured: 1.000 x); a product whose compute DTensor
    replicated over ``model`` would exceed that."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import spmd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg = reduced_config(get_config("yi-6b"))
    shape = ShapeSpec("train_small", SEQ, BATCH, "train")
    with spmd.spmd_mesh((2, 2), ("data", "model"), backend="fake") as mesh:
        counter, arg_bytes, _ = dryrun.count_rank0(cfg, shape, mesh)
        chips = mesh.size()
    fn, args, _ = dryrun._step_and_specs(cfg, shape, make_production_mesh())
    one = dryrun.count_step(fn, args)
    assert chips == 4 and arg_bytes > 0
    ratio = chips * counter.flops / one.flops
    assert 0.99 <= ratio <= 1.05, (chips * counter.flops, one.flops)
    assert counter.collectives["TOTAL"]["count"] > 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--reference")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world")
    ap.add_argument("--ref")
    ap.add_argument("--out")
    a = ap.parse_args()
    if a.reference:
        reference_main(a.reference)
    else:
        port_main(a.rank, a.world, a.ref, a.out)
