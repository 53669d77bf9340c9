"""PyTorch port, sequence mixers: ``repro_torch.models.ssm`` against
``repro.models.ssm`` on the same seeded inputs.

The WKV6 and SSD scans, chunked against recurrent within the port and each
against the reference's same form, over the sequence lengths and chunk sizes
of the reference's hypothesis tests (``test_ssm.py``, as a fixed grid: a
length shorter than a chunk, ragged, exact multiples, longer); the full
RWKV time-mix / channel-mix and SSD blocks in both modes; state carried
across segments.

Tolerances: ``IMPL`` (2e-4, the reference's own) chunked against recurrent;
``F32`` (rtol and atol 1e-5) port against reference in the same form;
``CHUNKED`` (atol 1e-4) for the chunked WKV against the reference's chunked
WKV, which rescales k by exp(-cumulative log-decay) within a chunk and so
magnifies last-bit differences. Denormals: the decays' cumulative products
can reach denormal floats, which torch keeps and XLA's CPU backend flushes;
the absolute tolerances cover the < 1.2e-38 that this moves a value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro.models.common import ArchConfig as JArchConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ssm as TS
from repro_torch.models.common import ArchConfig

IMPL = dict(rtol=2e-4, atol=2e-4)
F32 = dict(rtol=1e-5, atol=1e-5)
CHUNKED = dict(rtol=1e-5, atol=1e-4)

CFG = dict(name="t", family="ssm", n_layers=1, d_model=48, n_heads=0, n_kv_heads=0,
           head_dim=0, d_ff=96, vocab=100, attn_type="none", ssm_heads=3,
           ssm_head_dim=16, ssm_state=8)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np32(got), np32(want), err_msg=what, **tol)


def both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def wkv_inputs(t, seed):
    rng = np.random.default_rng(seed)
    b, h, dh = 2, 3, 16
    r, k, v = (0.5 * rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(3))
    logw = -np.exp(0.3 * rng.standard_normal((b, t, h, dh))).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, dh))).astype(np.float32)
    s0 = (0.2 * rng.standard_normal((b, h, dh, dh))).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("t,chunk", [(1, 16), (7, 4), (16, 16), (23, 16), (32, 32),
                                     (50, 16), (37, 32), (12, 4)])
def test_wkv6_chunked_equals_recurrent_and_reference(t, chunk):
    j, p = both(*wkv_inputs(t, t * 31 + chunk))
    o1, s1 = TS.wkv6_recurrent(*p)
    o2, s2 = TS.wkv6_chunked(*p, chunk=chunk)
    close(o2, o1, IMPL, "chunked vs recurrent")
    close(s2, s1, IMPL, "state")
    jo1, js1 = jax.jit(JS.wkv6_recurrent)(*j)
    close(o1, jo1, F32, "recurrent vs reference")
    close(s1, js1, F32, "recurrent state vs reference")
    jo2, js2 = jax.jit(JS.wkv6_chunked, static_argnames='chunk')(*j, chunk=chunk)
    close(o2, jo2, CHUNKED, "chunked vs reference")
    close(s2, js2, CHUNKED, "chunked state vs reference")


def ssd_inputs(t, seed):
    rng = np.random.default_rng(seed)
    b, h, dh, n = 2, 3, 16, 8
    xv = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    B = (0.5 * rng.standard_normal((b, t, n))).astype(np.float32)
    C = (0.5 * rng.standard_normal((b, t, n))).astype(np.float32)
    z = rng.standard_normal((b, t, h))
    dt = np.logaddexp(z, 0).astype(np.float32)
    logdecay = (-0.5 * dt).astype(np.float32)
    D = np.ones((h, dh), np.float32)
    s0 = (0.2 * rng.standard_normal((b, h, n, dh))).astype(np.float32)
    return xv, B, C, dt, logdecay, D, s0


@pytest.mark.parametrize("t,chunk", [(1, 8), (9, 8), (32, 32), (50, 32), (17, 8),
                                     (40, 8)])
def test_ssd_chunked_equals_recurrent_and_reference(t, chunk):
    j, p = both(*ssd_inputs(t, t * 17 + chunk))
    o1, s1 = TS.ssd_recurrent(*p)
    o2, s2 = TS.ssd_chunked(*p, chunk=chunk)
    close(o2, o1, IMPL, "chunked vs recurrent")
    close(s2, s1, IMPL, "state")
    jo1, js1 = jax.jit(JS.ssd_recurrent)(*j)
    close(o1, jo1, F32, "recurrent vs reference")
    close(s1, js1, F32, "recurrent state vs reference")
    jo2, js2 = jax.jit(JS.ssd_chunked, static_argnames='chunk')(*j, chunk=chunk)
    close(o2, jo2, F32, "chunked vs reference")
    close(s2, js2, F32, "chunked state vs reference")


@pytest.fixture(scope="module")
def blocks():
    jcfg = JArchConfig(**CFG)
    key = jax.random.PRNGKey(4)
    jp = {"tm": JS.rwkv_time_mix_init(key, jcfg),
          "cm": JS.rwkv_channel_mix_init(jax.random.PRNGKey(5), jcfg),
          "ssd": JS.ssd_init(jax.random.PRNGKey(6), jcfg)}
    return jcfg, ArchConfig(**CFG), jp, lm_params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("mode", ["chunked", "recurrent"])
def test_rwkv_blocks_match_reference(blocks, mode):
    jcfg, tcfg, jp, tp = blocks
    rng = np.random.default_rng(8)
    x = (0.5 * rng.standard_normal((2, 21, 48))).astype(np.float32)
    xp = (0.5 * rng.standard_normal((2, 48))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((2, 3, 16, 16))).astype(np.float32)
    (jx, jxp, js0), (tx, txp, ts0) = both(x, xp, s0)
    jy, jlast, js = jax.jit(JS.rwkv_time_mix, static_argnums=4, static_argnames='mode')(
        jp["tm"], jx, jxp, js0, jcfg, mode=mode)
    ty, tlast, ts = TS.rwkv_time_mix(tp["tm"], tx, txp, ts0, tcfg, mode=mode)
    tol = CHUNKED if mode == "chunked" else F32
    close(ty, jy, tol, "time-mix")
    close(ts, js, tol, "time-mix state")
    close(tlast, jlast, F32, "token shift")
    jy2, jl2 = JS.rwkv_channel_mix(jp["cm"], jx, jxp)
    ty2, tl2 = TS.rwkv_channel_mix(tp["cm"], tx, txp)
    close(ty2, jy2, F32, "channel-mix")
    close(tl2, jl2, F32)


@pytest.mark.parametrize("mode", ["chunked", "recurrent"])
def test_ssd_mix_matches_reference(blocks, mode):
    jcfg, tcfg, jp, tp = blocks
    rng = np.random.default_rng(9)
    x = (0.5 * rng.standard_normal((2, 19, 48))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((2, 3, 8, 16))).astype(np.float32)
    (jx, js0), (tx, ts0) = both(x, s0)
    jy, js = jax.jit(JS.ssd_mix, static_argnums=3, static_argnames='mode')(
        jp["ssd"], jx, js0, jcfg, mode=mode)
    ty, ts = TS.ssd_mix(tp["ssd"], tx, ts0, tcfg, mode=mode)
    close(ty, jy, F32)
    close(ts, js, F32)


def test_state_carry_across_segments(blocks):
    """Processing [0:T] == processing [0:T/2] then [T/2:T] with carried
    state (the reference's test, in the port, at its tolerance)."""
    _, tcfg, _, tp = blocks
    g = torch.Generator().manual_seed(3)
    x = 0.5 * torch.randn(2, 24, 48, generator=g)
    xp = torch.zeros(2, 48)
    st0 = torch.zeros(2, 3, 16, 16)
    y_full, _, s_full = TS.rwkv_time_mix(tp["tm"], x, xp, st0, tcfg, mode="chunked")
    y1, xp1, s1 = TS.rwkv_time_mix(tp["tm"], x[:, :12], xp, st0, tcfg, mode="chunked")
    y2, _, s2 = TS.rwkv_time_mix(tp["tm"], x[:, 12:], xp1, s1, tcfg, mode="chunked")
    close(torch.cat([y1, y2], 1), y_full, IMPL)
    close(s2, s_full, IMPL)


def test_softplus_is_the_references():
    z = np.concatenate([np.linspace(-30, 30, 601), [0.0, 1e-8, 88.0]]).astype(np.float32)
    close(TS._softplus(torch.from_numpy(z)), jax.nn.softplus(jnp.asarray(z)), F32)
