"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba2-style SSD.

Counterpart of ``repro.models.ssm``; the reference's ``lax.scan`` over time
or chunks is a Python loop here. Both mixers come in two algebraically
equivalent forms:
* ``*_recurrent`` — a step per token; the decode step uses one.
* ``*_chunked``   — chunk-parallel (intra-chunk matmuls + inter-chunk state
  carry): the sub-quadratic prefill path.

RWKV6: data-dependent per-channel decay w_t = exp(-exp(·)), data-dependent
token-shift (ddlerp), per-head bonus u, grouped rms-norm on the output. The
chunked form rescales k by the within-chunk inverse decay product (chunk 16).

Mamba2/SSD (hymba's mamba heads): scalar per-head decay, shared B/C
projections of state size N; the chunked form's decay ratios are <= 1.

Decays and their cumulative products can reach denormal floats, which torch
keeps and XLA's CPU backend flushes to zero; the two differ there by less
than 1.2e-38.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ArchConfig, dense_init, dot, einsum, full_init,
                                       normal_init, rms_norm, silu)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


# ===========================================================================
# RWKV6 time-mix
# ===========================================================================

DDLERP_RANK = 16
DECAY_RANK = 32


def rwkv_time_mix_init(generator: torch.Generator, cfg: ArchConfig,
                       device: str | torch.device | None = None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    hd = h * dh
    dt = cfg.param_dtype
    return {
        "mu_base": full_init((d,), 0.5, dt, device),
        "mu": full_init((5, d), 0.5, dt, device),                   # r,k,v,w,g
        "ddw1": dense_init(generator, (d, 5 * DDLERP_RANK), d, dt, device),
        "ddw2": dense_init(generator, (5, DDLERP_RANK, d), DDLERP_RANK, dt, device),
        "wr": dense_init(generator, (d, hd), d, dt, device),
        "wk": dense_init(generator, (d, hd), d, dt, device),
        "wv": dense_init(generator, (d, hd), d, dt, device),
        "wg": dense_init(generator, (d, hd), d, dt, device),
        "w0": normal_init(generator, (hd,), 0.3, dt, device),
        "ww1": dense_init(generator, (d, DECAY_RANK), d, dt, device),
        "ww2": dense_init(generator, (DECAY_RANK, hd), DECAY_RANK, dt, device),
        "u": normal_init(generator, (h, dh), 0.3, dt, device),
        "ln_x": full_init((hd,), 1.0, dt, device),
        "wo": dense_init(generator, (hd, d), hd, dt, device),
    }


def _rwkv_projections(p, x: torch.Tensor, x_prev: torch.Tensor, cfg: ArchConfig):
    """Token-shifted projections. x [B,T,d]; x_prev [B,d] = token before x[:,0]."""
    b, t, d = x.shape
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    xs = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)        # shift(x)
    sx = xs - x
    # data-dependent lerp (ddlerp)
    base = x + sx * p["mu_base"]
    lora = torch.tanh(dot(base, p["ddw1"])).reshape(b, t, 5, DDLERP_RANK)
    delta = einsum("btfa,fad->btfd", lora, p["ddw2"])                # [B,T,5,d]
    mix = x[:, :, None, :] + sx[:, :, None, :] * (p["mu"][None, None] + delta)
    mr, mk, mv, mw, mg = [mix[:, :, i, :] for i in range(5)]
    r = dot(mr, p["wr"]).reshape(b, t, h, dh)
    k = dot(mk, p["wk"]).reshape(b, t, h, dh)
    v = dot(mv, p["wv"]).reshape(b, t, h, dh)
    g = silu(dot(mg, p["wg"])).reshape(b, t, h, dh)
    # data-dependent decay in (0,1): w = exp(-exp(w0 + lora(mw)))
    z = p["w0"] + dot(torch.tanh(dot(mw, p["ww1"])), p["ww2"])
    logw = -torch.exp(torch.clamp(z.float(), -8.0, 2.0))            # log w <= 0
    logw = logw.reshape(b, t, h, dh)
    return r, k, v, g, logw, x[:, -1, :]


def _rwkv_out(p, o: torch.Tensor, g: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    b, t, h, dh = o.shape
    # grouped rms-norm per head
    ones = torch.ones((dh,), dtype=o.dtype, device=o.device)
    on = rms_norm(o, ones).reshape(b, t, h * dh)
    on = on * p["ln_x"]
    return dot(on * g.reshape(b, t, h * dh), p["wo"])


def wkv6_recurrent(r, k, v, logw, u, state):
    """Exact recurrence. r,k,v,logw [B,T,H,dh]; u [H,dh]; state [B,H,dh,dh].

    o_t = r_t · (S + (u ∘ k_t) ⊗ v_t);  S ← diag(w_t) S + k_t ⊗ v_t
    """
    s = state
    outs = []
    for i in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, i], k[:, i], v[:, i], logw[:, i]     # [B,H,dh]
        att = s + (u[None] * kt)[..., :, None] * vt[..., None, :]
        outs.append(einsum("bhk,bhkv->bhv", rt, att))
        s = torch.exp(lwt)[..., :, None] * s + kt[..., :, None] * vt[..., None, :]
    return torch.stack(outs, dim=1), s                              # [B,T,H,dh], state


def wkv6_chunked(r, k, v, logw, u, state, chunk: int = 16):
    """Chunk-parallel WKV (intra matmuls + state carry), == recurrent."""
    b, t, h, dh = r.shape
    pad = (-t) % chunk
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    nt = (t + pad) // chunk
    rs = r.reshape(b, nt, chunk, h, dh)
    ks = k.reshape(b, nt, chunk, h, dh)
    vs = v.reshape(b, nt, chunk, h, dh)
    lw = logw.reshape(b, nt, chunk, h, dh).float()
    cum = torch.cumsum(lw, dim=2)                          # L_i (inclusive)
    cum_prev = cum - lw                                    # L_{i-1} (exclusive)
    total = cum[:, :, -1]                                  # [B,nt,H,dh]

    r_dec = rs * torch.exp(cum_prev).to(rs.dtype)          # r_t ∘ P_{t-1}
    k_inc = ks * torch.exp(-cum).to(ks.dtype)              # k_i / P_i
    k_rem = ks * torch.exp(total[:, :, None] - cum).to(ks.dtype)  # P_n/P_i k_i

    # intra-chunk pairwise term A[t,i] = Σ_c r_dec[t,c] k_inc[i,c], i < t
    A = einsum("bncht,bnmht->bnhcm", r_dec, k_inc)         # [B,nt,H,chunk,chunk]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    A = torch.where(tri[None, None, None], A, 0.0)
    diag = einsum("bncht,bncht->bnch", rs, u[None, None, None] * ks)
    intra = einsum("bnhcm,bnmht->bncht", A, vs)
    intra = intra + diag[..., None] * vs

    s = state
    inter = []
    for n in range(nt):
        inter.append(einsum("bchk,bhkv->bchv", r_dec[:, n], s))   # [B,chunk,H,dh]
        s = torch.exp(total[:, n])[..., :, None] * s + einsum(
            "bchk,bchv->bhkv", k_rem[:, n], vs[:, n])
    out = intra + torch.stack(inter, dim=1)
    out = out.reshape(b, nt * chunk, h, dh)[:, :t]
    return out, s


def rwkv_time_mix(p, x, x_prev, state, cfg: ArchConfig, *, mode: str = "chunked"):
    """Full time-mix block. Returns (y [B,T,d], new_x_prev, new_state)."""
    r, k, v, g, logw, last = _rwkv_projections(p, x, x_prev, cfg)
    fn = wkv6_chunked if mode == "chunked" else wkv6_recurrent
    o, state = fn(r, k, v, logw, p["u"].float(), state)
    return _rwkv_out(p, o.to(x.dtype), g, cfg), last, state


def rwkv_channel_mix_init(generator: torch.Generator, cfg: ArchConfig,
                          device: str | torch.device | None = None
                          ) -> Dict[str, torch.Tensor]:
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    return {
        "mu_k": full_init((d,), 0.5, dt, device),
        "mu_r": full_init((d,), 0.5, dt, device),
        "wk": dense_init(generator, (d, ff), d, dt, device),
        "wv": dense_init(generator, (ff, d), ff, dt, device),
        "wr": dense_init(generator, (d, d), d, dt, device),
    }


def rwkv_channel_mix(p, x, x_prev):
    """y = σ(r) ∘ ((relu(k)²) Wv). Returns (y, new_x_prev)."""
    xs = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    mk = x + (xs - x) * p["mu_k"]
    mr = x + (xs - x) * p["mu_r"]
    k = torch.square(torch.relu(dot(mk, p["wk"])))
    return torch.sigmoid(dot(mr, p["wr"])) * dot(k, p["wv"]), x[:, -1, :]


# ===========================================================================
# Mamba2-style SSD (hymba's parallel mamba heads)
# ===========================================================================

def ssd_init(generator: torch.Generator, cfg: ArchConfig,
             device: str | torch.device | None = None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    h, dh, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    dt = cfg.param_dtype
    return {
        "wx": dense_init(generator, (d, h * dh), d, dt, device),
        "wB": dense_init(generator, (d, n), d, dt, device),
        "wC": dense_init(generator, (d, n), d, dt, device),
        "wdt": dense_init(generator, (d, h), d, dt, device),
        "dt_bias": full_init((h,), 0.0, dt, device),
        "a_log": normal_init(generator, (h,), 0.5, dt, device),
        "D": full_init((h, dh), 1.0, dt, device),
        "wo": dense_init(generator, (h * dh, d), h * dh, dt, device),
    }


def _ssd_projections(p, x, cfg: ArchConfig):
    b, t, d = x.shape
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    xv = dot(x, p["wx"]).reshape(b, t, h, dh)
    B = dot(x, p["wB"])                                    # [B,T,N]
    C = dot(x, p["wC"])
    dt = _softplus(dot(x, p["wdt"]) + p["dt_bias"])        # [B,T,H] > 0
    loga = -_softplus(p["a_log"].float())                  # per head, < 0
    logdecay = dt.float() * loga[None, None]               # [B,T,H] <= 0
    return xv, B, C, dt, logdecay


def ssd_recurrent(xv, B, C, dt, logdecay, D, state):
    """h_t = a_t h + dt_t B_t ⊗ x_t; y_t = C_t·h_t + D∘x_t. state [B,H,N,dh]."""
    s = state
    outs = []
    for i in range(xv.shape[1]):
        xt, bt, ct, dtt, ldt = xv[:, i], B[:, i], C[:, i], dt[:, i], logdecay[:, i]
        s = torch.exp(ldt)[..., None, None] * s + (
            dtt[..., None, None] * bt[:, None, :, None] * xt[..., None, :]
        )
        outs.append(einsum("bn,bhnv->bhv", ct, s) + D[None] * xt)
    return torch.stack(outs, dim=1), s


def ssd_chunked(xv, B, C, dt, logdecay, D, state, chunk: int = 32):
    """Chunk-parallel SSD; decay ratios exp(L_t-L_i) ≤ 1 => stable."""
    b, t, h, dh = xv.shape
    n = B.shape[-1]
    pad = (-t) % chunk
    if pad:
        xv = F.pad(xv, (0, 0, 0, 0, 0, pad))
        B, C, dt, logdecay = (F.pad(a, (0, 0, 0, pad)) for a in (B, C, dt, logdecay))
    nt = (t + pad) // chunk
    xs = xv.reshape(b, nt, chunk, h, dh)
    Bs = B.reshape(b, nt, chunk, n)
    Cs = C.reshape(b, nt, chunk, n)
    dts = dt.reshape(b, nt, chunk, h)
    ld = logdecay.reshape(b, nt, chunk, h).float()
    L = torch.cumsum(ld, dim=2)                            # inclusive
    total = L[:, :, -1]                                    # [B,nt,H]

    # intra: M[t,i] = exp(L_t - L_i) (C_t·B_i) dt_i   for i <= t
    cb = einsum("bnca,bnma->bncm", Cs, Bs)                 # [B,nt,chunk,chunk]
    gap = L[:, :, :, None, :] - L[:, :, None, :, :]        # [B,nt,c,m,H]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xv.device))
    M = torch.exp(torch.where(tri[None, None, :, :, None], gap, -torch.inf))
    M = M * cb[..., None] * dts[:, :, None, :, :]          # [B,nt,c,m,H]
    intra = einsum("bncmh,bnmhv->bnchv", M, xs)

    s = state
    inter = []
    for j in range(nt):
        cs, bs_, xx, dd, ll, tot = Cs[:, j], Bs[:, j], xs[:, j], dts[:, j], L[:, j], total[:, j]
        inter.append(torch.exp(ll)[..., None] * einsum("bca,bhav->bchv", cs, s))
        upd = einsum("bch,bca,bchv->bhav", dd * torch.exp(tot[:, None] - ll), bs_, xx)
        s = torch.exp(tot)[..., None, None] * s + upd
    out = intra + torch.stack(inter, dim=1)
    out = out + D[None, None, None] * xs
    out = out.reshape(b, nt * chunk, h, dh)[:, :t]
    return out, s


def ssd_mix(p, x, state, cfg: ArchConfig, *, mode: str = "chunked"):
    """Full SSD head block. Returns (y [B,T,d], new_state)."""
    b, t, d = x.shape
    xv, B, C, dt, logdecay = _ssd_projections(p, x, cfg)
    fn = ssd_chunked if mode == "chunked" else ssd_recurrent
    o, state = fn(xv.float(), B.float(), C.float(), dt.float(), logdecay,
                  p["D"].float(), state)
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    return dot(o.to(x.dtype).reshape(b, t, h * dh), p["wo"]), state
