"""PyTorch port, DeepSeek-V2-Lite (``configs/deepseek_v2_lite.py``, a
port-only ``PortArchConfig``): its reduced configuration through
``lm.prefill`` and ``lm.decode_step`` against the plain reference
(``lm_moe_reference.py`` beside this file: no cache, no batching, nothing
of the port), and the parts it added one by one: the query without LoRA,
YaRN, the router's weights without renormalisation, the shared experts,
the leading dense layer, dropless routing, the spans.

Tolerance of the logits against the reference, ``TOL`` relative to ``1 +
max |logit|``: everything is float32 (the configuration's latent cache
too), so only the order of summation differs between the port's decode
(absorbed or expanded) and the reference's full forward pass, which reads
below 1e-6 here; a bf16 rounding anywhere on the way reads 1e-3 to 1e-2.
"""

import dataclasses
import math

import jax.numpy as jnp
import pytest
import torch

import lm_moe_reference as ref_lib
from repro.configs import base as JC
from repro_torch import obs
from repro_torch.configs import ARCH_IDS, PORT_ARCH_IDS, all_configs, get_config, reduced_config
from repro_torch.distributed import spmd
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (PortArchConfig, mla_softmax_scale, rope_angles, swiglu,
                                       yarn_mscale)
from repro_torch.serving.decode import DecodeSession

TOL = 1e-5
PROMPT, STEPS = 24, 8


def _cfg(**kw):
    return dataclasses.replace(reduced_config(get_config("deepseek-v2-lite")), **kw)


def _weights(cfg, seed=0):
    """The port's parameters, their norm scales moved off 1."""
    g = torch.Generator().manual_seed(seed)
    w = lm.init_params(cfg, g, device="cpu")

    def jitter(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                jitter(v)
            elif "norm" in k or k in ("ln1", "ln2"):
                v.add_(0.1 * torch.randn(v.shape, generator=g))
    jitter(w)
    return w


def _model(cfg):
    keys = ("n_layers", "n_heads", "qk_nope_dim", "qk_rope_dim", "v_head_dim", "first_k_dense",
            "rope_theta", "experts_per_token", "norm_topk_prob", "routed_scale")
    m = {k: getattr(cfg, k) for k in keys}
    m.update({f"yarn_{f.name}": getattr(cfg.yarn, f.name) for f in dataclasses.fields(cfg.yarn)})
    return m


def _gap(got, want):
    return ((got - want).abs().amax(-1) / (1 + want.abs().amax(-1))).max().item()


@pytest.mark.parametrize("absorb", [True, False], ids=["absorbed", "expanded"])
def test_prefill_then_decode_match_the_reference(absorb):
    """Prefill of a 24-token prompt and 8 decode steps (positions 24-31,
    past YaRN's original 16) of a batch of 2, against the reference's
    full forward pass of each sequence, in logits."""
    cfg = _cfg(mla_absorb=absorb)
    w = _weights(cfg)
    tokens = torch.randint(0, cfg.vocab, (2, PROMPT + STEPS),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        first, cache = lm.prefill(cfg, w, {"tokens": tokens[:, :PROMPT]}, PROMPT + STEPS)
        steps = [first[:, 0]]
        for j in range(PROMPT, PROMPT + STEPS - 1):
            logits, cache = lm.decode_step(cfg, w, cache, tokens[:, j], j)
            steps.append(logits)
    got = torch.stack(steps, 1)                             # [B, STEPS, V]
    for b in range(2):
        want = ref_lib.forward(w, _model(cfg), tokens[b], range(PROMPT - 1, PROMPT + STEPS - 1),
                               qblock=8)
        assert _gap(got[b], want) < TOL


def test_forward_train_matches_the_reference():
    cfg = _cfg()
    w = _weights(cfg, seed=2)
    tokens = torch.randint(0, cfg.vocab, (1, 40), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got, _ = lm.forward_train(cfg, w, {"tokens": tokens})
    assert _gap(got[0], ref_lib.forward(w, _model(cfg), tokens[0], range(40), qblock=16)) < TOL


def test_layout_and_reduced_config():
    """Layer 0's dense SwiGLU under ``dense_layers``, the MoE layers under
    ``layers``, one ``wq``; the reduced configuration keeps every option."""
    cfg = _cfg()
    assert (cfg.q_lora_rank, cfg.first_k_dense, cfg.n_layers) == (0, 1, 3)
    assert cfg.n_shared_experts == 2 and not cfg.norm_topk_prob and cfg.moe_dropless
    assert cfg.yarn.original_max_position == 16 and cfg.activ_dtype == torch.float32
    shapes = lm.param_shapes(cfg)
    dense, moe = shapes["dense_layers"], shapes["layers"]
    d = cfg.d_model
    assert dense["ffn"]["w1"].shape == (1, d, cfg.d_ff) and "router" not in dense["ffn"]
    assert moe["ffn"]["w1"].shape == (2, cfg.n_experts, d, cfg.moe_d_ff)
    assert moe["ffn"]["shared"]["w2"].shape == (2, 2 * cfg.moe_d_ff, d)
    assert moe["attn"]["wq"].shape == (2, d, cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim))
    assert "wdq" not in moe["attn"] and "q_norm" not in moe["attn"]


def test_registry_keeps_the_references_list():
    """The ten shared architectures stay the JAX package's, field for field;
    DeepSeek-V2-Lite resolves but is not among them."""
    def fields(cfg):
        out = dataclasses.asdict(cfg)
        for f in ("param_dtype", "activ_dtype"):
            out[f] = (str(out[f]).removeprefix("torch.") if isinstance(out[f], torch.dtype)
                      else jnp.dtype(out[f]).name)
        return out

    assert ARCH_IDS == JC.ARCH_IDS and list(all_configs()) == JC.ARCH_IDS
    for arch in ARCH_IDS:
        assert fields(get_config(arch)) == fields(JC.get_config(arch))
        assert not isinstance(get_config(arch), PortArchConfig)
    assert PORT_ARCH_IDS == ["deepseek-v2-lite"] and "deepseek-v2-lite" not in ARCH_IDS
    cfg = get_config("deepseek-v2-lite")
    assert isinstance(cfg, PortArchConfig) and cfg.name == "deepseek-v2-lite"
    # attention 27 x 13,762,560; the dense layer 67,239,936; 26 MoE layers of
    # 571,080,704 (64 routed and 2 shared experts of 1,408, the router); the
    # embedding and the head 2 x 209,715,200
    assert cfg.n_params() == 15_706_357_760
    assert cfg.n_active_params() == 15_706_357_760 - 26 * 58 * 3 * 2048 * 1408


def test_yarn_frequencies_and_softmax_scale():
    """The published YaRN at positions past the original 4,096, against the
    hand values: low 10, high 23, f'_i blended towards f_i / 40 between, the
    cos and sin factor 1, the softmax scale 192^-1/2 * m(40, 0.707)^2."""
    cfg = get_config("deepseek-v2-lite")
    pos = torch.arange(8192, 8256)
    cos, sin = rope_angles(pos, 64, 1e4, cfg.yarn)
    f = 1e4 ** (-torch.arange(32, dtype=torch.float64) / 32)
    ramp = ((torch.arange(32, dtype=torch.float64) - 10) / 13).clamp(0, 1)
    want = pos.double()[:, None] * (f / 40 * ramp + f * (1 - ramp))
    assert torch.allclose(cos.double(), torch.cos(want), atol=2e-3)
    assert torch.allclose(sin.double(), torch.sin(want), atol=2e-3)
    plain, _ = rope_angles(pos, 64, 1e4)
    assert (cos[:, 10:] - plain[:, 10:]).abs().max() > 0.5 and torch.equal(cos[:, :10],
                                                                            plain[:, :10])
    m = 0.1 * 0.707 * math.log(40) + 1
    assert yarn_mscale(40, 0.707) == pytest.approx(m) and m * m == pytest.approx(1.58963, abs=1e-5)
    assert mla_softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m)
    assert mla_softmax_scale(get_config("minicpm3-4b")) is None
    # the reduced configuration's YaRN acts past its original 16 positions
    r = _cfg()
    got, _ = rope_angles(torch.arange(16, 32), r.qk_rope_dim, r.rope_theta, r.yarn)
    plain, _ = rope_angles(torch.arange(16, 32), r.qk_rope_dim, r.rope_theta)
    assert not torch.allclose(got, plain)


def _moe_params(cfg, seed=4):
    return moe_lib.moe_init(torch.Generator().manual_seed(seed), cfg, device="cpu")


def test_router_weights_are_not_renormalised_and_the_shared_experts_add():
    """y = sum_k p_k E_k(x) + S(x), with p the router's probabilities as
    they are: they sum to under 1."""
    cfg = _cfg()
    p = _moe_params(cfg)
    x = torch.randn(3, 5, cfg.d_model, generator=torch.Generator().manual_seed(5))
    y, _ = moe_lib.moe_ffn(p, x, cfg)
    x2 = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(x2 @ p["router"], -1)
    w, idx = probs.topk(cfg.experts_per_token, -1)
    assert (w.sum(-1) < 0.99).all()
    want = swiglu(p["shared"], x2)
    for t in range(x2.shape[0]):
        for j in range(cfg.experts_per_token):
            e = int(idx[t, j])
            want[t] += w[t, j] * swiglu({n: p[n][e] for n in ("w1", "w3", "w2")}, x2[t])
    assert torch.allclose(y.reshape(-1, cfg.d_model), want, rtol=1e-5, atol=1e-6)
    renorm = dataclasses.replace(cfg, norm_topk_prob=True, n_shared_experts=0)
    y2, _ = moe_lib.moe_ffn({k: v for k, v in p.items() if k != "shared"}, x, renorm)
    assert not torch.allclose(y2, y - swiglu(p["shared"], x), atol=1e-3)


@pytest.mark.parametrize("seq", [1, 6], ids=["decode", "prefill"])
def test_planted_routing_drops_nothing(seq):
    """A router of zeros ties every expert, so every token goes to experts
    0, 1 and 2 (ties to the lowest id): expert 0's queue holds every token.
    Dropless routing keeps them all, at one token a sequence (the capacity
    path at the step's token count) and over full sequences (by expert);
    the capacity path at the registered factor would drop."""
    cfg = _cfg()
    p = dict(_moe_params(cfg), router=torch.zeros(cfg.d_model, cfg.n_experts))
    x = torch.randn(32, seq, cfg.d_model, generator=torch.Generator().manual_seed(6))
    x2 = x.reshape(-1, cfg.d_model)
    want = swiglu(p["shared"], x2)
    for e in range(cfg.experts_per_token):
        want = want + swiglu({n: p[n][e] for n in ("w1", "w3", "w2")}, x2) / cfg.n_experts
    with obs.recording():
        y, _ = moe_lib.moe_ffn(p, x, cfg)
        counts = {k: v for s in obs.spans() for k, v in s.counts.items()}
    obs.clear()
    assert torch.allclose(y.reshape(-1, cfg.d_model), want, rtol=1e-5, atol=1e-6)
    t = 32 * seq
    assert counts["moe.pairs"] == t * cfg.experts_per_token
    assert counts["moe.rows"] == (cfg.n_experts * t if seq == 1 else t * cfg.experts_per_token)
    capped, _ = moe_lib.moe_ffn(p, x, dataclasses.replace(cfg, moe_dropless=False,
                                                          capacity_factor=1.0))
    assert not torch.allclose(capped, y, atol=1e-3)


def test_dropless_paths_agree():
    """The by-expert path (full sequences) and the capacity path at the
    token count (one token a sequence) route and weigh the same pairs."""
    cfg = _cfg()
    p = _moe_params(cfg, seed=7)
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator().manual_seed(8))
    whole, _ = moe_lib.moe_ffn(p, x, cfg)
    by_token, _ = moe_lib.moe_ffn(p, x.reshape(18, 1, cfg.d_model), cfg)
    assert torch.allclose(whole.reshape(18, 1, -1), by_token, rtol=1e-5, atol=1e-6)


def test_decode_spans_and_counters():
    """Recorded steps of a decode session: the root ``serve.decode`` (the
    session's serial, the batch), each layer's ``mla.decode``, layer 0's
    ``ffn.dense``, each MoE layer's three spans and two counts; a later
    session has a higher serial."""
    cfg = _cfg()
    w = _weights(cfg)
    tokens = torch.randint(0, cfg.vocab, (4, 6), generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        _, cache = lm.prefill(cfg, w, {"tokens": tokens[:, :5]}, 8)
        session = DecodeSession(cfg, w, cache)
        with obs.recording():
            session.step(tokens[:, 5], 5)
            session.step(tokens[:, 5], 6)
        spans = obs.spans()
    obs.clear()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["serve.decode"] * 2
    assert roots[0].attrs == roots[1].attrs and roots[0].attrs["queries"] == 4
    one = [s for s in spans if s.call == roots[0].sid and s.parent is not None]
    names = [s.name for s in one]
    assert names.count("mla.decode") == 3 and names.count("ffn.dense") == 1
    for name in ("moe.route", "moe.routed", "moe.shared"):
        assert names.count(name) == 2
    counts = [s.counts for s in one if s.counts]
    assert {"moe.pairs": 4 * cfg.experts_per_token} in counts
    assert {"moe.rows": 4 * cfg.n_experts} in counts
    _, other = lm.prefill(cfg, w, {"tokens": tokens[:, :5]}, 8)
    with obs.recording():
        DecodeSession(cfg, w, other).step(tokens[:, 5], 5)
        newer = [s for s in obs.spans() if s.parent is None][0]
    obs.clear()
    assert newer.attrs["engine"] > roots[0].attrs["engine"]


def test_the_mesh_refuses_the_port_only_options():
    cfg = _cfg()
    with spmd.spmd_mesh((1, 1), ("data", "model"), backend="fake") as mesh:
        embed = spmd.DTensor.from_local(torch.empty((cfg.vocab, cfg.d_model), device="meta"),
                                        mesh, [spmd.Replicate(), spmd.Replicate()])
        with pytest.raises(NotImplementedError, match="one card"):
            lm.decode_step(cfg, {"embed": embed}, {}, torch.zeros(2, dtype=torch.long), 0)
