"""PyTorch port, the LM's backward pass: gradients of the port's ``loss_fn``
under torch autograd against ``jax.grad`` of the reference's, the remat
policies of ``repro_torch.models.lm._remat``, and the layer loop's
``torch.unbind`` against per-layer ``a[i]`` views.

Both packages get the same weights (the reference's seeded init, carried
across by ``convert.lm_params_from_numpy``) and the same batch
(``batch_at_step``, numpy in both).

Tolerances:
- gradients: each leaf within ``GRAD_REL`` (1e-5) of that leaf's max |grad|;
  ``SSM_GRAD_REL`` (5e-5) for RWKV, whose chunked scan magnifies last-bit
  differences of a partial sum (the forward's tolerance there is 10x the
  others' for the same reason, ``tests/test_torch_models.py``). Measured on
  the CPU: up to 4.1e-6 (hymba's ``ssd/dt_bias``) and 1.5e-5 (RWKV).
- remat policies: bitwise on the CPU. A policy only chooses which forward
  results are kept and which are computed again in backward, and the CPU
  computes them again to the bit.
- ``unbind`` against ``a[i]``: bitwise (the same views of the same data).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, reduced_config
from repro.data.lm_data import batch_at_step
from repro.models import lm as J
from repro_torch import configs as TC
from repro_torch.checkpoint.ckpt import _leaves_with_path
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm as T

GRAD_REL, SSM_GRAD_REL = 1e-5, 5e-5
BATCH, SEQ, MAX_LEN = 2, 12, 20
POLICIES = ("none", "full", "dots", "moe")


def setup(arch, **kw):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch)), **kw)
    jp = J.init_params(cfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.device_get(jp), device="cpu")
    nb = batch_at_step(cfg, seed=0, step=0, host=0, n_hosts=1, batch=BATCH, seq=SEQ)
    return cfg, tcfg, jp, tp, nb


def port_grads(tcfg, tp, tb):
    """(loss, {path: grad}) of the port's loss_fn under autograd."""
    paths = [k for k, _ in _leaves_with_path(tp)]
    live = {k: v.detach().requires_grad_() for k, v in _leaves_with_path(tp)}

    def rebuild(tree, path=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (k,)) for k, v in tree.items()}
        return live["/".join(path)]

    loss, _ = T.loss_fn(tcfg, rebuild(tp), tb)
    grads = torch.autograd.grad(loss, [live[k] for k in paths], allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(paths, grads))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_gradients_match_jax_grad(arch):
    cfg, tcfg, jp, tp, nb = setup(arch)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p, b: J.loss_fn(cfg, p, b),
                                             has_aux=True))(jp, jb)
    tl, tg = port_grads(tcfg, tp, {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    want = dict(_leaves_with_path(jax.device_get(jg)))
    assert sorted(tg) == sorted(want)
    rel = SSM_GRAD_REL if cfg.family == "ssm" else GRAD_REL
    for k, w in want.items():
        g = tg[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, f"{arch} {k}: max|diff| {err:.3e} > {rel:g} x {scale:.3e}"


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-235b-a22b"])
def test_remat_policies_give_equal_gradients(arch, monkeypatch):
    """Every policy gives the gradients of no remat, bitwise; under each
    policy but ``none`` the backward runs every layer's forward again."""
    grads, runs = {}, {}
    attn_block = T._attn_block_full
    for policy in POLICIES:
        _, tcfg, _, tp, nb = setup(arch, remat=True, remat_policy=policy)
        count = [0]

        def counted(*args, count=count):
            count[0] += 1
            return attn_block(*args)

        monkeypatch.setattr(T, "_attn_block_full", counted)
        _, grads[policy] = port_grads(tcfg, tp, {k: torch.from_numpy(v) for k, v in nb.items()})
        runs[policy] = count[0]
    for policy in POLICIES[1:]:
        for k, g in grads["none"].items():
            assert torch.equal(grads[policy][k], g), (policy, k)
    n = tcfg.n_layers
    assert runs == {"none": n, "full": 2 * n, "dots": 2 * n, "moe": 2 * n}


@pytest.mark.parametrize("arch,policy,kept", [
    ("yi-6b", "dots", "aten.mm"),
    ("qwen3-moe-235b-a22b", "moe", "repro_torch.checkpoint_name"),
])
def test_selective_policy_keeps_its_ops(arch, policy, kept, monkeypatch):
    """The policy sees the ops it keeps: matrix products without batch dims
    (``dots``), the two named MoE buffers of every layer (``moe``)."""
    seen = []
    inner = T._POLICIES[policy]

    def spy(ctx, op, *args, **kwargs):
        decision = inner(ctx, op, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            seen.append((str(op.overloadpacket), args[1] if policy == "moe" else None))
        return decision

    monkeypatch.setitem(T._POLICIES, policy, spy)
    _, tcfg, _, tp, nb = setup(arch, remat=True, remat_policy=policy)
    port_grads(tcfg, tp, {k: torch.from_numpy(v) for k, v in nb.items()})
    assert seen and all(op == kept for op, _ in seen)
    if policy == "moe":
        # asked once a layer, in the forward: the recompute takes the kept
        # buffers
        names = [n for _, n in seen]
        assert names == ["moe_xin", "moe_out"] * tcfg.n_layers


def _views_by_index(stacked, n):
    """The layer loop's views before ``torch.unbind``: ``a[i]`` per leaf."""
    return [T._map(lambda a, i=i: a[i], stacked) for i in range(n)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_bitwise_with_unbind_and_remat_on(arch, monkeypatch):
    """Prefill and a decode step are bitwise what they were with ``a[i]``
    views and remat off: with no input that requires grad, remat does
    nothing (the second run is not under ``torch.no_grad``)."""
    from repro_torch.launch.specs import make_demo_batch

    _, tcfg, _, tp, _ = setup(arch)
    tb = make_demo_batch(tcfg, np.random.default_rng(0), BATCH, SEQ, device="cpu")
    pos = SEQ + (tb["patch_embeds"].shape[1] if tcfg.family == "vlm" else 0)
    monkeypatch.setattr(T, "checkpoint", lambda *a, **k: pytest.fail("remat while serving"))
    runs = []
    for views, cfg in ((_views_by_index, tcfg),
                       (T._layers, dataclasses.replace(tcfg, remat=True))):
        monkeypatch.setattr(T, "_layers", views)
        with torch.set_grad_enabled(cfg.remat):
            logits, cache = T.prefill(cfg, tp, tb, max_len=MAX_LEN)
            cache = {k: v.clone() for k, v in cache.items()}
            step, cache = T.decode_step(cfg, tp, cache, logits[:, -1].argmax(-1), pos)
        assert logits.grad_fn is None and step.grad_fn is None
        runs.append((logits, step, cache))
    (l0, s0, c0), (l1, s1, c1) = runs
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert sorted(c0) == sorted(c1)
    for k in c0:
        assert c0[k].dtype == c1[k].dtype and torch.equal(c0[k], c1[k]), k
