"""PyTorch port, attention: ``repro_torch.models.attention`` against
``repro.models.attention`` on the same seeded inputs.

The chunked (online-softmax) attention against the naive one, both against
the reference's, over the grid of the reference's
``test_attention_impls.py::test_chunked_equals_naive`` (query lengths, windows
0 / 3 / 8, key blocks 4 / 8 / 16, query blocks 8 / 32, GQA groups 1 / 2 / 4)
as a fixed sample instead of hypothesis draws; GQA and MLA decode (MLA with
``absorb`` on and off) against the reference, on an f32 and a bf16 cache,
including writes past the cache's end. Tolerances: ``F32`` (rtol and atol
1e-5) port against reference on f32 inputs; ``IMPL`` (2e-4, the reference's
own) chunked against naive; ``BF16`` (2^-7 relative, one bf16 step) where
the output is bf16 or reads a bf16 cache written by both (a last-bit
difference before rounding can round either way).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.launch.specs import make_demo_batch as j_demo_batch
from repro.models import attention as JA
from repro.models import lm as J
from repro_torch import configs as TC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.specs import make_demo_batch
from repro_torch.models import attention as TA
from repro_torch.models import lm as T

F32 = dict(rtol=1e-5, atol=1e-5)
IMPL = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2**-7, atol=1e-5)

# the reference's hypothesis grid, sampled: every window x kblock x qblock x
# gqa once, at query lengths cycling through short, ragged and long; every
# ninth case also against the reference's own chunked attention (a scan that
# XLA compiles anew for each shape)
GRID = [(sq, w, kb, qb, g, i % 9 == 0) for i, (w, kb, qb, g) in enumerate(
    itertools.product([0, 3, 8], [4, 8, 16], [8, 32], [1, 2, 4]))
    for sq in ([1, 5, 17, 40][i % 4],)]


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np32(got), np32(want), err_msg=what, **tol)


def qkv(seed, b, sq, sk, h, hkv, dh, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("sq,window,kblock,qblock,gqa,ref_chunked", GRID)
def test_chunked_equals_naive_and_reference(sq, window, kblock, qblock, gqa, ref_chunked):
    b, hkv, dh = 2, 2, 8
    q, k, v = qkv(sq * 1000 + window * 100 + kblock + qblock + gqa, b, sq, sq, hkv * gqa, hkv, dh)
    mask_j = JA.causal_window_mask(sq, sq, 0, window)
    want = jax.jit(JA._sdpa)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask_j)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    mask = TA.causal_window_mask(sq, sq, 0, window)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    naive = TA._sdpa(tq, tk, tv, mask)
    chunked = TA._chunked_sdpa(tq, tk, tv, q_offset=0, window=window, kblock=kblock,
                               qblock=qblock)
    close(chunked, naive, IMPL, "chunked vs naive")
    close(naive, want, F32, "naive vs reference")
    close(chunked, want, IMPL, "chunked vs reference naive")
    if ref_chunked:
        want_c = JA._chunked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=0,
                                  window=window, kblock=kblock, qblock=qblock)
        close(chunked, want_c, F32, "chunked vs reference chunked")


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_with_offset_and_padded_keys(causal):
    """Cross-attention shape (more keys than queries, keys padded to the
    block) and an offset query block, as decode uses it."""
    q, k, v = qkv(3, 2, 3, 13, 4, 2, 8)
    args = dict(q_offset=9, window=0, kblock=5, qblock=2, causal=causal)
    want = JA._chunked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **args)
    got = TA._chunked_sdpa(*(torch.from_numpy(a) for a in (q, k, v)), **args)
    close(got, want, F32)


def test_bf16_value_rounds_probabilities_like_the_reference():
    """``probs.astype(v.dtype)``: with a bf16 cache the probabilities and
    the context are bf16, and f32 queries meet bf16 keys in f32."""
    q, k, v = qkv(4, 2, 1, 24, 8, 2, 16)
    kb = jnp.asarray(k).astype(jnp.bfloat16)
    vb = jnp.asarray(v).astype(jnp.bfloat16)
    mask = JA.causal_window_mask(1, 24, 20, 0)
    want = JA._sdpa(jnp.asarray(q), kb, vb, mask)
    tkb = torch.from_numpy(k).to(torch.bfloat16)
    tvb = torch.from_numpy(v).to(torch.bfloat16)
    got = TA._sdpa(torch.from_numpy(q), tkb, tvb, TA.causal_window_mask(1, 24, 20, 0))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(got, want, BF16)
    args = dict(q_offset=20, window=0, kblock=8, qblock=1)
    want_c = JA._chunked_sdpa(jnp.asarray(q), kb, vb, **args)
    got_c = TA._chunked_sdpa(torch.from_numpy(q), tkb, tvb, **args)
    assert got_c.dtype == torch.bfloat16
    close(got_c, want_c, BF16)


def _layer_params(arch, **kw):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch)), **kw)
    init = JA.mla_init if cfg.attn_type == "mla" else JA.gqa_init
    jp = init(jax.random.PRNGKey(1), cfg)
    return cfg, tcfg, jp, lm_params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("impl,window,cache_dtype", [
    ("naive", 0, "float32"), ("naive", 3, "bfloat16"), ("chunked", 0, "bfloat16"),
    ("chunked", 3, "float32")])
def test_gqa_full_and_decode(impl, window, cache_dtype):
    cfg, tcfg, jp, tp = _layer_params("hymba-1.5b", attn_impl=impl, attn_kblock=4,
                                      attn_qblock=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    jo, (jk, jv) = JA.gqa_full(jp, jnp.asarray(x), cfg, window=window)
    to, (tk, tv) = TA.gqa_full(tp, torch.from_numpy(x), tcfg, window=window)
    close(to, jo, F32)
    close(tk, jk, F32)
    dt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    jdt, tdt = dt[cache_dtype]
    s_max = 9
    jck = jnp.zeros((2, s_max) + jk.shape[2:], jdt).at[:, :6].set(jk.astype(jdt))
    jcv = jnp.zeros((2, s_max) + jv.shape[2:], jdt).at[:, :6].set(jv.astype(jdt))
    tck = torch.zeros((2, s_max) + tuple(tk.shape[2:]), dtype=tdt)
    tcv = torch.zeros_like(tck)
    tck[:, :6], tcv[:, :6] = tk, tv
    tol = F32 if cache_dtype == "float32" else BF16
    close(tck, jck, tol)
    for pos in (6, 7, 8, 10):  # the last two past the cache: clamped writes
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, jck, jcv = JA.gqa_decode(jp, jnp.asarray(xt), jck, jcv, jnp.int32(pos), cfg,
                                     window=window)
        to, tck, tcv = TA.gqa_decode(tp, torch.from_numpy(xt), tck, tcv, pos, tcfg,
                                     window=window)
        close(to, jo, tol, f"pos {pos}")
        close(tck, jck, tol, f"cache k, pos {pos}")
        close(tcv, jcv, tol, f"cache v, pos {pos}")


@pytest.mark.parametrize("absorb,cache_dtype", [(True, "bfloat16"), (False, "bfloat16"),
                                               (True, "float32")])
def test_mla_full_and_decode(absorb, cache_dtype):
    cfg, tcfg, jp, tp = _layer_params("minicpm3-4b")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jo, (jc, jr) = JA.mla_full(jp, jnp.asarray(x), cfg)
    to, (tc, tr) = TA.mla_full(tp, torch.from_numpy(x), tcfg)
    close(to, jo, F32)
    close(tc, jc, F32)
    close(tr, jr, F32)
    q_j, r_j = JA._mla_q(jp, jnp.asarray(x), cfg)
    q_t, r_t = TA._mla_q(tp, torch.from_numpy(x), tcfg)
    close(q_t, q_j, F32)
    close(r_t, r_j, F32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cache_dtype]
    s_max = 8
    jckv = jnp.zeros((2, s_max, jc.shape[-1]), jdt).at[:, :5].set(jc.astype(jdt))
    jkr = jnp.zeros((2, s_max, jr.shape[-1]), jdt).at[:, :5].set(jr.astype(jdt))
    tckv = torch.zeros((2, s_max, tc.shape[-1]), dtype=tdt)
    tkr = torch.zeros((2, s_max, tr.shape[-1]), dtype=tdt)
    tckv[:, :5], tkr[:, :5] = tc, tr
    tol = F32 if cache_dtype == "float32" else BF16
    for pos in (5, 6, 7, 9):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, jckv, jkr = JA.mla_decode(jp, jnp.asarray(xt), jckv, jkr, jnp.int32(pos), cfg,
                                      absorb=absorb)
        to, tckv, tkr = TA.mla_decode(tp, torch.from_numpy(xt), tckv, tkr, pos, tcfg,
                                      absorb=absorb)
        close(to, jo, tol, f"pos {pos}")
        close(tckv, jckv, tol, f"ckv, pos {pos}")
        close(tkr, jkr, tol, f"kr, pos {pos}")


@pytest.mark.parametrize("arch", ["yi-6b", "minicpm3-4b", "hymba-1.5b"])
def test_model_forward_chunked_matches_naive(arch):
    """The reference's model-level check, in the port (its tolerance)."""
    tcfg = TC.reduced_config(TC.get_config(arch))
    tcfg_c = dataclasses.replace(tcfg, attn_impl="chunked", attn_kblock=8, attn_qblock=8)
    params = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    batch = make_demo_batch(tcfg, np.random.default_rng(11), 2, 24, device="cpu")
    l1, _ = T.forward_train(tcfg, params, batch)
    l2, _ = T.forward_train(tcfg_c, params, batch)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["yi-6b", "hymba-1.5b", "rwkv6-7b"])
def test_bf16_activations_as_close_to_f32_as_the_reference(arch):
    """``activations_bf16=True``: XLA and torch round a bf16 chain at other
    points (XLA may keep f32 inside a fusion), so the two bf16 results are
    not held to each other's tolerance. Each is held to f32: the port's
    bf16 logits lie no farther from the f32 logits than 1.5x the
    reference's bf16 logits do (max and rms), and the loss within the
    reference's 5%. MoE routing under bf16 can flip an expert on a near
    tie, which moves a token's output by O(1): no MoE arch here."""
    cfg = reduced_config(get_config(arch))
    cfg_b = dataclasses.replace(cfg, activations_bf16=True)
    tcfg_b = dataclasses.replace(TC.reduced_config(TC.get_config(arch)), activations_bf16=True)
    jp = J.init_params(cfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.device_get(jp), device="cpu")
    jb = j_demo_batch(cfg, np.random.default_rng(12), 2, 16)
    tb = make_demo_batch(tcfg_b, np.random.default_rng(12), 2, 16, device="cpu")
    f32 = np.asarray(J.forward_train(cfg, jp, jb)[0])
    ref = np.asarray(J.forward_train(cfg_b, jp, jb)[0]) - f32
    got = T.forward_train(tcfg_b, tp, tb)[0].numpy() - f32
    assert np.abs(got).max() <= 1.5 * np.abs(ref).max()
    assert np.sqrt((got ** 2).mean()) <= 1.5 * np.sqrt((ref ** 2).mean())
    l1 = float(J.loss_fn(cfg, jp, jb)[0])
    l2 = float(T.loss_fn(tcfg_b, tp, tb)[0])
    assert abs(l1 - l2) / abs(l1) < 0.05
