"""PyTorch port, the LM trainer's optimizers: ``repro_torch.optim`` against
``repro.optim`` on the same seeded numpy inputs.

Compared: the warmup-cosine schedule over steps 0-40; one and three AdamW and
Adafactor updates on the same gradients (parameters and every state leaf);
the step count (bitwise, int32); Adafactor's factored state shapes;
``clip_by_global_norm``; ``ef_compress`` / ``ef_init`` (bitwise: both round
f32 to bf16 to nearest even). Then the optimizer cases of
``tests/test_runtime.py``, run on the port.

Tolerances: ``OPT`` (rtol 1e-6, atol 1e-7) for f32 results. XLA and torch
evaluate ``pow``, ``cos``, ``rsqrt`` and the sums of the global norm and of
Adafactor's means with other code and in other orders, so results may differ
by a few ULP (~1.2e-7 relative each), which the updates carry. A bf16
parameter is held to one bf16 step (2^-7 relative): its f32 value before the
rounding may differ in the last bit and round to either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as J
from repro_torch.optim import optimizers as T

OPT = dict(rtol=1e-6, atol=1e-7)
BF16 = dict(rtol=2**-7, atol=1e-6)
# Shapes that take each path: a stacked leaf worked layer by layer ([L, a, b]
# and a 4-D expert stack), a 2-D factored leaf, a stacked norm scale [L, d]
# (2-D: factored, one piece), a leaf too thin to factor, a vector, a scalar.
SHAPES = {"layers": {"w": (3, 8, 16), "experts": (2, 3, 4, 6), "ln": (3, 16)},
          "embed": (32, 8), "thin": (16, 1), "bias": (16,), "scale": ()}


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    return fn(shapes)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def pair(tree_np):
    """(JAX tree, torch tree) of the same numpy leaves."""
    return (_tree_np(tree_np, jnp.asarray), _tree_np(tree_np, lambda a: torch.from_numpy(a.copy())))


def _tree_np(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_np(v, fn) for k, v in tree.items()}
    return fn(tree)


def draws(seed, n, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [_tree(shapes, lambda s: np.asarray(scale * rng.standard_normal(s), np.float32))
            for _ in range(n)]


def trees_close(got, want, tol=OPT, what=""):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), what
    for k in w:
        assert tuple(g[k].shape) == tuple(np.shape(w[k])), (what, k)
        np.testing.assert_allclose(np32(g[k]), np32(w[k]), err_msg=f"{what} {k}", **tol)


def run_updates(name, n_steps, lr=0.01, shapes=SHAPES):
    p0, *gs = draws(0, 1, shapes=shapes) + draws(1, n_steps, scale=0.1, shapes=shapes)
    jo, to = getattr(J, name)(), getattr(T, name)()
    jp, tp = pair(p0)
    js, ts = jo.init(jp), to.init(tp)
    jlr, tlr = jnp.float32(lr), torch.tensor(lr, dtype=torch.float32)
    for g in gs:
        jg, tg = pair(g)
        jp, js = jo.update(jg, js, jp, jlr)
        tp, ts = to.update(tg, ts, tp, tlr)
    return jp, js, tp, ts


def test_warmup_cosine_matches_reference():
    for s in range(41):
        want = J.warmup_cosine(jnp.int32(s), peak=3e-4, warmup=10, total=40)
        got = T.warmup_cosine(torch.tensor(s, dtype=torch.int32), peak=3e-4, warmup=10,
                              total=40)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(np32(got), np32(want), err_msg=f"step {s}", **OPT)
    assert float(T.warmup_cosine(torch.tensor(0, dtype=torch.int32), peak=1.0, warmup=5,
                                 total=9)) == 0.0


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_updates_match_reference(name, n_steps):
    jp, js, tp, ts = run_updates(name, n_steps)
    trees_close(tp, jp, what="params")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"]) == n_steps
    state = {k: v for k, v in ts.items() if k != "step"}
    trees_close(state, {k: v for k, v in js.items() if k != "step"}, what="state")


def test_adafactor_factored_state_shapes_match_reference():
    shapes = _tree(SHAPES, lambda s: np.zeros(s, np.float32))
    jp, tp = pair(shapes)
    want = dict(_leaves(J.adafactor().init(jp)))
    got = dict(_leaves(T.adafactor().init(tp)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == {jnp.float32: torch.float32,
                                jnp.int32: torch.int32}[want[k].dtype.type], k


def test_update_writes_in_place_and_leaves_grads():
    p0, g = draws(0, 1)[0], draws(1, 1, scale=0.1)[0]
    for opt in (T.adamw(), T.adafactor()):
        tp = _tree_np(p0, lambda a: torch.from_numpy(a.copy()))
        tg = _tree_np(g, lambda a: torch.from_numpy(a.copy()))
        state = opt.init(tp)
        new_p, new_s = opt.update(tg, state, tp, torch.tensor(0.01))
        assert new_p["layers"]["w"] is tp["layers"]["w"]
        assert not torch.equal(tp["layers"]["w"], torch.from_numpy(p0["layers"]["w"]))
        trees_close(tg, g, tol=dict(rtol=0, atol=0), what="grads untouched")


def test_adamw_bf16_parameter_within_one_bf16_step():
    shapes = {"w": (8, 16)}
    p0 = draws(0, 1, shapes=shapes)[0]
    g = draws(1, 1, scale=0.1, shapes=shapes)[0]
    jp = {"w": jnp.asarray(p0["w"]).astype(jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p0["w"]).to(torch.bfloat16)}
    jo, to = J.adamw(), T.adamw()
    jp, _ = jo.update({"w": jnp.asarray(g["w"])}, jo.init(jp), jp, jnp.float32(0.01))
    tp, _ = to.update({"w": torch.from_numpy(g["w"])}, to.init(tp), tp, torch.tensor(0.01))
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(np32(tp["w"]), np32(jp["w"]), **BF16)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = draws(2, 1)[0]
    jg, tg = pair(g)
    trees_close(T.clip_by_global_norm(tg, max_norm), J.clip_by_global_norm(jg, max_norm))


def test_ef_compress_and_init_bitwise():
    grads = draws(3, 3, scale=0.3)
    p0 = draws(0, 1)[0]
    jr = J.ef_init(pair(p0)[0])
    tr = T.ef_init(pair(p0)[1])
    trees_close(tr, jr, tol=dict(rtol=0, atol=0), what="ef_init")
    for g in grads:
        jg, tg = pair(g)
        jc, jr = J.ef_compress(jg, jr)
        tc, tr = T.ef_compress(tg, tr)
        for (k, c), (_, w) in zip(_leaves(tc), _leaves(jc)):
            assert c.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(c.view(torch.int16).numpy(),
                                          np.asarray(w).view(np.int16), err_msg=k)
        for (k, r), (_, w) in zip(_leaves(tr), _leaves(jr)):
            np.testing.assert_array_equal(r.numpy().view(np.uint32),
                                          np.asarray(w).view(np.uint32), err_msg=k)


def test_get_optimizer():
    assert T.get_optimizer("adamw").name == "adamw"
    assert T.get_optimizer("adafactor").name == "adafactor"
    with pytest.raises(ValueError):
        T.get_optimizer("sgd")


# -- the optimizer cases of tests/test_runtime.py, on the port ---------------

def _quad_problem():
    params = {"w": torch.tensor([3.0, -2.0, 1.5]), "b": torch.tensor(4.0)}

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    return params, loss


@pytest.mark.parametrize("opt_fn", [T.adamw, T.adafactor])
def test_optimizers_descend(opt_fn):
    opt = opt_fn()
    params, loss = _quad_problem()
    state = opt.init(params)
    l0 = float(loss(params))
    for _ in range(60):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(live, torch.autograd.grad(loss(live), list(live.values()))))
        params, state = opt.update(grads, state, params, torch.tensor(0.1))
    assert float(loss(params)) < 0.2 * l0


def test_adafactor_state_is_factored():
    opt = T.adafactor()
    params = {"m": torch.zeros((64, 32)), "v1d": torch.zeros((7,))}
    state = opt.init(params)
    assert state["v"]["m"]["vr"].shape == (64,)
    assert state["v"]["m"]["vc"].shape == (32,)
    assert state["v"]["v1d"]["v"].shape == (7,)  # small tensors unfactored


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 100.0)}
    c = T.clip_by_global_norm(g, 1.0)
    assert np.isclose(float(torch.linalg.norm(c["a"])), 1.0, rtol=1e-5)


def test_warmup_cosine_schedule():
    lrs = [float(T.warmup_cosine(torch.tensor(s, dtype=torch.int32), peak=1.0, warmup=10,
                                 total=100))
           for s in range(0, 101, 10)]
    assert lrs[0] == 0.0 and np.isclose(lrs[1], 1.0)
    assert all(lrs[i] >= lrs[i + 1] - 1e-6 for i in range(1, len(lrs) - 1))
    assert lrs[-1] >= 0.1 - 1e-6  # floor


def test_ef_compression_preserves_signal():
    """Error feedback: compressed stream + residual reconstructs the sum."""
    rng = np.random.default_rng(0)
    grads = [{"g": torch.from_numpy(rng.standard_normal(128).astype(np.float32))}
             for _ in range(20)]
    res = T.ef_init(grads[0])
    total_true = np.zeros(128)
    total_comp = np.zeros(128)
    for g in grads:
        comp, res = T.ef_compress(g, res)
        total_true += g["g"].numpy()
        total_comp += comp["g"].double().numpy()
    np.testing.assert_allclose(total_comp + res["g"].numpy(), total_true, rtol=1e-3, atol=1e-3)


def test_jax_is_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
