"""PyTorch port, the LM scaffold's serving path: ``repro_torch.models.lm``
against ``repro.models.lm`` for every architecture at its reduced config.

Both packages get the same weights (the reference's seeded init, carried
across by ``convert.lm_params_from_numpy``) and the same batch
(``make_demo_batch`` from one numpy seed). Compared: ``init_cache`` (keys,
shapes, dtypes), ``forward_train`` logits and aux, ``loss_fn``, ``prefill``
logits and cache, and four greedy ``decode_step``s (logits and cache).

Tolerances:
- f32 paths (forward, loss, prefill logits, f32 states): ``F32`` (rtol and
  atol 1e-5): XLA and torch sum in other orders; ``SSM_F32`` (atol 1e-4)
  for RWKV, whose chunked scan amplifies rounding (see there).
- bf16 cache entries: ``BF16_CACHE`` (one bf16 step, 2^-7 of the value):
  where the two f32 values before rounding differ in their last bit, the
  rounding to bf16 can fall on either side.
- decode logits, which read that cache: ``DECODE`` (5e-3): one rounding flip
  of a cache entry moves them by ~1e-3 at these widths.
Denormals: XLA's CPU backend flushes them and torch keeps them; the absolute
tolerances cover such differences (< 1.2e-38).

The port's own prefill/decode consistency is held as the reference's
``test_models_smoke.py`` holds its own (rtol = atol = 2e-2: the bf16 cache).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, reduced_config
from repro.launch.specs import make_demo_batch as j_demo_batch
from repro.models import lm as J
from repro_torch import configs as TC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.specs import make_demo_batch
from repro_torch.models import lm as T

F32 = dict(rtol=1e-5, atol=1e-5)
# RWKV's chunk-16 WKV rescales k by exp(-cumulative log-decay) (up to ~e^16
# inside a chunk) and r by its inverse, so a last-bit difference in a partial
# sum grows by that ratio before it cancels; the reference's own chunked vs
# recurrent test allows 2e-4.
SSM_F32 = dict(rtol=1e-5, atol=1e-4)
BF16_CACHE = dict(rtol=2**-7, atol=1e-6)
DECODE = dict(rtol=5e-3, atol=5e-3)
BATCH, SEQ, MAX_LEN, STEPS = 2, 12, 20, 4


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np32(got), np32(want), err_msg=what, **tol)


def f32_tol(cfg):
    return SSM_F32 if cfg.family == "ssm" else F32


def cache_close(got: dict, want: dict, what: str, f32=F32):
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), (what, k)
        tol = BF16_CACHE if want[k].dtype == jnp.bfloat16 else f32
        close(got[k], want[k], tol, f"{what} {k}")


_JITTED = {}


def jit(fn, *static):
    """The reference function compiled once per (function, static args)."""
    key = (fn, static)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(fn, static_argnums=static)
    return _JITTED[key]


def setup(arch, **kw):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch)), **kw)
    jp = J.init_params(cfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.device_get(jp), device="cpu")
    return cfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def runs():
    """Per architecture, once: both packages' outputs on the same inputs."""
    torch.manual_seed(0)
    done = {}

    def get(arch):
        if arch in done:
            return done[arch]
        cfg, tcfg, jp, tp = setup(arch)
        jb = j_demo_batch(cfg, np.random.default_rng(0), BATCH, SEQ)
        tb = make_demo_batch(tcfg, np.random.default_rng(0), BATCH, SEQ, device="cpu")
        out = {"cfg": cfg, "tcfg": tcfg, "jb": jb, "tb": tb}
        out["fwd"] = (jit(J.forward_train, 0)(cfg, jp, jb), T.forward_train(tcfg, tp, tb))
        out["loss"] = (jit(J.loss_fn, 0)(cfg, jp, jb), T.loss_fn(tcfg, tp, tb))
        jl, jc = jit(J.prefill, 0, 3)(cfg, jp, jb, MAX_LEN)
        tl, tc = T.prefill(tcfg, tp, tb, max_len=MAX_LEN)
        out["prefill"] = (jl, tl, jax.device_get(jc), {k: v.clone() for k, v in tc.items()})
        pos = (jb["patch_embeds"].shape[1] if cfg.family == "vlm" else 0) + SEQ
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
        steps = []
        for i in range(STEPS):
            jl, jc = jit(J.decode_step, 0)(cfg, jp, jc, jnp.asarray(tok), jnp.int32(pos + i))
            tl, tc = T.decode_step(tcfg, tp, tc, torch.from_numpy(tok), pos + i)
            steps.append((jl, tl))
            tok = np.array(jnp.argmax(jl, -1), np.int32)
        out["decode"] = steps
        out["final_cache"] = (jax.device_get(jc), tc)
        done[arch] = out
        return out

    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_demo_batch_bitwise(arch, runs):
    r = runs(arch)
    assert list(r["jb"]) == list(r["tb"])
    for k in r["jb"]:
        np.testing.assert_array_equal(np32(r["tb"][k]), np32(r["jb"][k]), err_msg=k)
        assert r["tb"][k].dtype == {jnp.int32: torch.int32,
                                    jnp.bfloat16: torch.bfloat16}[r["jb"][k].dtype.type]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_and_loss(arch, runs):
    r = runs(arch)
    tol = f32_tol(r["cfg"])
    (jl, ja), (tl, ta) = r["fwd"]
    assert tuple(tl.shape) == tuple(jl.shape) and tl.dtype == torch.float32
    close(tl, jl, tol, "logits")
    close(ta, ja, tol, "aux")
    (jloss, jm), (tloss, tm) = r["loss"]
    close(tloss, jloss, tol, "loss")
    close(tm["ce"], jm["ce"], tol, "ce")
    assert torch.isfinite(tl).all()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_matches_reference(arch, runs):
    r = runs(arch)
    cfg, tcfg = r["cfg"], r["tcfg"]
    src = SEQ if cfg.family == "encdec" else 0
    jc = J.init_cache(cfg, BATCH, MAX_LEN, src_len=src)
    tc = T.init_cache(tcfg, BATCH, MAX_LEN, src_len=src, device="cpu")
    assert list(tc) == list(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).removeprefix("torch.") == str(jc[k].dtype)
        assert not tc[k].any()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_reference(arch, runs):
    r = runs(arch)
    jl, tl, jc, tc = r["prefill"]
    assert tuple(tl.shape) == tuple(jl.shape)
    close(tl, jl, f32_tol(r["cfg"]), "prefill logits")
    cache_close(tc, jc, "prefill cache", f32_tol(r["cfg"]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_steps_match_reference(arch, runs):
    r = runs(arch)
    for i, (jl, tl) in enumerate(r["decode"]):
        assert tuple(tl.shape) == tuple(jl.shape) == (BATCH, r["cfg"].vocab)
        close(tl, jl, DECODE, f"decode step {i}")
    jc, tc = r["final_cache"]
    for k in jc:
        assert tc[k].dtype == {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[
            jc[k].dtype.type], k
    decode_tol = {k: (BF16_CACHE if jc[k].dtype == jnp.bfloat16 else DECODE) for k in jc}
    for k in jc:
        close(tc[k], jc[k], decode_tol[k], f"cache {k} after {STEPS} steps")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_consistency(arch):
    """Greedy decode after prefill(s-1 tokens) == forward logits at -1, in
    the port alone (the reference's own test and tolerance)."""
    tcfg = TC.reduced_config(TC.get_config(arch))
    params = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    batch = make_demo_batch(tcfg, np.random.default_rng(42), 2, 12, device="cpu")
    logits_full, _ = T.forward_train(tcfg, params, batch)
    prompt = {k: (v[:, :-1] if k in ("tokens", "targets") else v) for k, v in batch.items()}
    _, cache = T.prefill(tcfg, params, prompt, max_len=16)
    pos = batch["tokens"].shape[1] - 1
    if tcfg.family == "vlm":
        pos += batch["patch_embeds"].shape[1]
    logits_dec, _ = T.decode_step(tcfg, params, cache, batch["tokens"][:, -1], pos)
    np.testing.assert_allclose(logits_dec.numpy(), logits_full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_decode_past_the_cache_clamps_like_the_reference():
    """``pos >= max_len`` writes the cache's last slot (``dynamic_update_
    slice`` clamps) and token ids out of range clamp into the table."""
    cfg, tcfg, jp, tp = setup("yi-6b")
    jb = j_demo_batch(cfg, np.random.default_rng(7), 2, 6)
    tb = make_demo_batch(tcfg, np.random.default_rng(7), 2, 6, device="cpu")
    _, jc = J.prefill(cfg, jp, jb, max_len=8)
    _, tc = T.prefill(tcfg, tp, tb, max_len=8)
    tok = np.array([cfg.vocab + 5, -3], np.int32)  # past the end; from the end
    for pos in (6, 7, 8, 11):
        jl, jc = J.decode_step(cfg, jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc = T.decode_step(tcfg, tp, tc, torch.from_numpy(tok), pos)
        close(tl, jl, DECODE, f"pos {pos}")
        cache_close(tc, jax.device_get(jc), f"pos {pos}")
    emb = tp["embed"]
    assert torch.equal(T._embed(emb, torch.tensor([cfg.vocab + 5, -3, -cfg.vocab - 4])),
                       emb[[cfg.vocab - 1, cfg.vocab - 3, 0]])


def test_param_shapes_no_allocation():
    tcfg = TC.reduced_config(TC.get_config("yi-6b"))
    shapes = T.param_shapes(tcfg)
    real = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    cfg = reduced_config(get_config("yi-6b"))
    ref = J.param_shapes(cfg)

    def flat(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            else:
                yield prefix + k, v

    s, r, j = dict(flat(shapes)), dict(flat(real)), dict(flat(ref))
    assert list(s) == list(r) == list(j)
    for k in s:
        assert s[k].device.type == "meta"
        assert (tuple(s[k].shape), s[k].dtype) == (tuple(r[k].shape), r[k].dtype)
        assert tuple(s[k].shape) == j[k].shape and str(j[k].dtype) == "float32"


def test_init_params_seeded_and_on_the_generators_draws():
    tcfg = TC.reduced_config(TC.get_config("hymba-1.5b"))
    a = T.init_params(tcfg, torch.Generator().manual_seed(3), device="cpu")
    b = T.init_params(tcfg, torch.Generator().manual_seed(3), device="cpu")
    c = T.init_params(tcfg, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"], c["layers"]["attn"]["wq"])
    # layers differ from each other (each drawn in turn), norms start at one
    assert not torch.equal(a["layers"]["attn"]["wq"][0], a["layers"]["attn"]["wq"][1])
    assert bool((a["layers"]["ln1"] == 1).all())
    w = a["layers"]["ffn"]["w1"]
    assert abs(float(w.std()) - tcfg.d_model ** -0.5) < 0.01


def test_hymba_window_pattern():
    cfg = TC.get_config("hymba-1.5b")
    w = T.layer_windows(cfg).numpy()
    np.testing.assert_array_equal(w, np.asarray(J.layer_windows(get_config("hymba-1.5b"))))
    assert (w == 0).sum() == 3
    assert w[1] == cfg.sliding_window
