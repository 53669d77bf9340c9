"""PyTorch port, Mixture-of-Experts: ``repro_torch.models.moe`` against
``repro.models.moe`` on the same seeded weights and tokens.

Routing (top-k experts, ties to the lowest expert id as ``lax.top_k``
breaks them), queue slots and the capacity drops are integers and compared
exactly: at ``capacity_factor=1.0`` the port drops the same (token, k) pairs
as the reference, in the global and the grouped dispatch. Outputs and the
aux loss within ``F32`` (rtol and atol 1e-5); the dense all-experts oracle
at the reference's own tolerance (rtol 1e-4, atol 1e-5).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import moe as JM
from repro_torch import configs as TC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import moe as TM

F32 = dict(rtol=1e-5, atol=1e-5)


def setup(arch="qwen3-moe-235b-a22b", **kw):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch)), **kw)
    jp = JM.moe_init(jax.random.PRNGKey(1), cfg)
    return cfg, tcfg, jp, lm_params_from_numpy(jax.device_get(jp), device="cpu")


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def ref_keep(cfg, jp, x, grouped: bool):
    """The reference's keep mask, recomputed from its own routing."""
    w, idx, _ = JM._route(jp, jnp.asarray(x).reshape(-1, x.shape[-1]), cfg)
    e, k = cfg.n_experts, cfg.experts_per_token
    b, s = x.shape[:2]
    idx = np.asarray(idx)
    if grouped:
        cap = max(1, math.ceil(s * k * cfg.capacity_factor / e))
        flat = idx.reshape(b, s * k)
    else:
        cap = JM.moe_capacity(b * s, cfg)
        flat = idx.reshape(1, -1)
    keep = np.zeros(flat.shape, bool)
    for r in range(flat.shape[0]):
        seen = np.zeros(e, int)
        for j, ex in enumerate(flat[r]):
            keep[r, j] = seen[ex] < cap
            seen[ex] += 1
    return idx, keep.reshape(-1)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b"])
@pytest.mark.parametrize("dispatch", ["global", "grouped"])
@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_moe_ffn_matches_reference_with_drops(arch, dispatch, cf):
    cfg, tcfg, jp, tp = setup(arch, capacity_factor=cf, moe_dispatch=dispatch)
    x = tokens(cfg, 4, 24, 3)
    jy, jaux = JM.moe_ffn(jp, jnp.asarray(x), cfg)
    ty, taux = TM.moe_ffn(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)
    # the same experts, and the same pairs dropped
    idx, keep = ref_keep(cfg, jp, x, grouped=dispatch == "grouped")
    _, tidx, _ = TM._route(tp, torch.from_numpy(x).reshape(-1, cfg.d_model), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    e = cfg.n_experts
    flat = tidx.reshape(4, -1) if dispatch == "grouped" else tidx.reshape(1, -1)
    tkeep = (TM._queue_slots(flat, e, dim=1) < (
        max(1, math.ceil(24 * cfg.experts_per_token * cf / e)) if dispatch == "grouped"
        else JM.moe_capacity(96, cfg))).reshape(-1)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    if cf == 1.0 and dispatch == "global":
        assert not keep.all(), "capacity 1.0 should drop some pairs at this shape"


def test_moe_capacity_matches_dense_ref():
    """Sort/scatter MoE == dense all-experts oracle when nothing drops (the
    reference's test, in the port), and the oracle == the reference's."""
    cfg, tcfg, jp, tp = setup(capacity_factor=8.0)
    x = tokens(cfg, 2, 8, 2)
    y, aux = TM.moe_ffn(tp, torch.from_numpy(x), tcfg)
    y_ref = TM.moe_dense_ref(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-4, atol=1e-5)
    assert float(aux) > 0
    np.testing.assert_allclose(y_ref.numpy(), np.asarray(JM.moe_dense_ref(jp, jnp.asarray(x), cfg)),
                               **F32)


def test_route_breaks_ties_by_lowest_expert():
    """Equal router probabilities: ``lax.top_k`` takes the lowest ids."""
    cfg, tcfg, jp, tp = setup()
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    x = tokens(cfg, 1, 5, 4).reshape(5, -1)
    w, idx, _ = TM._route(tp, torch.from_numpy(x), tcfg)
    jw, jidx, _ = JM._route(jp, jnp.asarray(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx.numpy() == np.arange(cfg.experts_per_token)).all()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **F32)
    # a tie between the second and third expert after a clear first
    router = torch.zeros_like(tp["router"])
    router[:, 3] = 1.0
    w, idx, _ = TM._route(dict(tp, router=router), torch.ones(2, cfg.d_model), tcfg)
    assert idx.tolist() == [[3, 0], [3, 0]]
