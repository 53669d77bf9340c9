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
The token-shift state a block returns (its input's last token) is a copy:
a view would keep the whole ``[B, T, d]`` input of every layer alive in
prefill's collected cache (2 x 32 x 1.07 GB at rwkv6-7b's ``prefill_32k``
on one rank of the (16, 16) mesh).

Mamba2/SSD (hymba's mamba heads): scalar per-head decay, shared B/C
projections of state size N; the chunked form's decay ratios are <= 1.

Decays and their cumulative products can reach denormal floats, which torch
keeps and XLA's CPU backend flushes to zero; the two differ there by less
than 1.2e-38.

On DTensors (the LM as one program over a mesh, placed by the sharding
rules) the projections run through :func:`dot` (column- or row-parallel as
the rules place each weight), and the scans run unchanged on each rank's
local blocks, with no collective inside them: by heads over ``model``
where ``ssm_heads`` divides it, so the state block ``[B_l, H_l, ...]`` is
the cache's block (``cache_specs``), else every head on every model rank,
the scan replicated over ``model`` on the rank's own batch rows
(:func:`_rwkv_time_mix_sharded`, :func:`_ssd_mix_sharded`).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed import spmd
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
    return r, k, v, g, logw, x[:, -1, :].clone()


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
    if isinstance(x, DTensor):
        return _rwkv_time_mix_sharded(p, x, x_prev, state, cfg, mode)
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
    if isinstance(x, DTensor):
        return _rwkv_channel_mix_sharded(p, x, x_prev)
    xs = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    mk = x + (xs - x) * p["mu_k"]
    mr = x + (xs - x) * p["mu_r"]
    k = torch.square(torch.relu(dot(mk, p["wk"])))
    return torch.sigmoid(dot(mr, p["wr"])) * dot(k, p["wv"]), x[:, -1, :].clone()


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
    if isinstance(x, DTensor):
        return _ssd_mix_sharded(p, x, state, cfg, mode)
    b, t, d = x.shape
    xv, B, C, dt, logdecay = _ssd_projections(p, x, cfg)
    fn = ssd_chunked if mode == "chunked" else ssd_recurrent
    o, state = fn(xv.float(), B.float(), C.float(), dt.float(), logdecay,
                  p["D"].float(), state)
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    return dot(o.to(x.dtype).reshape(b, t, h * dh), p["wo"]), state


# ===========================================================================
# the mixers on DTensors (the LM as one program over a mesh)
# ===========================================================================

def _layout(x: DTensor, heads: int):
    """(mesh, the batch's placements, the model mesh dims, whether ``heads``
    divide the model axes) for an activation ``x`` ``[B, T, d]``."""
    mesh = x.device_mesh
    model = spmd.model_mesh_dims(mesh)
    size = spmd.mesh_size(mesh, model)
    return (mesh, spmd.batch_placements(x.shape, mesh), model,
            bool(model) and spmd.divides(heads, size))


def _over(rows: Sequence[spmd.Placement], model: Sequence[int], dim: int,
          split: bool = True) -> Tuple[spmd.Placement, ...]:
    """``rows`` with tensor dim ``dim`` over the model mesh dims (when
    ``split``)."""
    return tuple(spmd.Shard(dim) if split and i in model else p for i, p in enumerate(rows))


def _whole(mesh) -> Tuple[spmd.Placement, ...]:
    return (spmd.Replicate(),) * mesh.ndim


def _placed(t: torch.Tensor, mesh, places) -> DTensor:
    """``t`` (a DTensor, or a plain tensor every rank holds whole, such as
    a zero state) as a DTensor placed as ``places``."""
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == tuple(places) else t.redistribute(mesh, places)
    shape, off = spmd.local_shape(t.shape, mesh, places)
    local = t[tuple(slice(o, o + n) for o, n in zip(off, shape))]
    return spmd.from_block(local, mesh, places, t.shape)


def _heads_block(t: DTensor, places, dh: int) -> torch.Tensor:
    """This rank's block ``[B_l, T, H_l, dh]`` of a ``[B, T, H*dh]``
    DTensor (a partial sum of a row-parallel product is reduced onto it)
    placed as ``places``: the heads over ``model``, or all of them."""
    local = spmd.local_block(t, places)
    return local.reshape(*local.shape[:-1], local.shape[-1] // dh, dh)


def _rwkv_time_mix_sharded(p, x: DTensor, x_prev, state, cfg: ArchConfig, mode: str):
    """:func:`rwkv_time_mix` on DTensors placed by the sharding rules.

    The token shift and ``base`` are the batch's rows, replicated over
    ``model``. The ddlerp's low-rank ``ddw1`` product is column-parallel and
    gathered over ``model`` before its ``[.., 5, 16]`` split (80 floats a
    token); ``delta`` and the five mixes are computed on each rank's slice
    of ``d`` over ``model``, which the row-parallel ``wr`` / ``wg`` read as
    they are and the column-parallel ``wk`` / ``wv`` / ``ww1`` gather. ``r``,
    ``g`` and the decay's ``ww2`` product come out as partial sums over
    ``model`` and are reduce-scattered onto the heads once each; ``k``, ``v``
    come out on them. The scan (``wkv6_chunked`` / ``wkv6_recurrent``) runs
    unchanged on the local blocks ``[B_l, T, H_l, dh]``, its state block
    ``[B_l, H_l, dh, dh]`` being ``tm_s``'s cache block; no collective runs
    inside it. The grouped norm, ``ln_x`` and ``g`` act on the local heads,
    and ``wo`` is row-parallel on them: the output is a partial sum over
    ``model``.

    Where ``ssm_heads`` does not divide the model axes (the rules then give
    ``tm_s`` no ``model`` placement), ``r``, ``k``, ``v``, ``g`` and the
    decay are gathered instead and the scan runs on every head of the
    rank's rows, replicated over ``model``; ``wo`` takes its own slice of
    that replicated output.

    Returns (y, the last token ``[B, d]`` placed as the rows, the state
    placed as ``cache_specs`` places ``tm_s``)."""
    b, t, d = x.shape
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    mesh, rows, model, by_heads = _layout(x, h)
    split = spmd.split_rows(rows)
    heads = _over(rows, model, 2, by_heads)
    x = _placed(x, mesh, rows)
    xs = torch.cat([_placed(x_prev, mesh, rows)[:, None, :], x[:, :-1, :]], dim=1)
    sx = xs - x
    base = x + sx * p["mu_base"].redistribute(mesh, _whole(mesh))
    # each model rank applies the whole low-rank output to its own d slice
    lora = spmd.local_block(torch.tanh(dot(base, p["ddw1"])), rows, grad_partial=model)
    lora = lora.reshape(*lora.shape[:2], 5, DDLERP_RANK)
    ddw2 = spmd.local_block(p["ddw2"], _over(_whole(mesh), model, 2), grad_partial=split)
    mu = spmd.local_block(p["mu"], _over(_whole(mesh), model, 1), grad_partial=split)
    by_d = _over(rows, model, 2)
    delta = einsum("btfa,fad->btfd", lora, ddw2)                      # [B_l,T,5,d_l]
    mix = (spmd.local_block(x, by_d)[:, :, None, :]
           + spmd.local_block(sx, by_d)[:, :, None, :] * (mu[None, None] + delta))
    mr, mk, mv, mw, mg = [spmd.from_block(mix[:, :, i, :], mesh, by_d, (b, t, d))
                          for i in range(5)]
    r = _heads_block(dot(mr, p["wr"]), heads, dh)
    k = _heads_block(dot(mk, p["wk"]), heads, dh)
    v = _heads_block(dot(mv, p["wv"]), heads, dh)
    g = silu(spmd.local_block(dot(mg, p["wg"]), heads))
    vec = _over(_whole(mesh), model, 0, by_heads)
    z = spmd.local_block(p["w0"], vec, grad_partial=split) + spmd.local_block(
        dot(torch.tanh(dot(mw, p["ww1"])), p["ww2"]), heads)
    logw = -torch.exp(torch.clamp(z.float(), -8.0, 2.0))
    logw = logw.reshape(*logw.shape[:2], -1, dh)
    u = spmd.local_block(p["u"], vec, grad_partial=split).float()
    s_places = _over(rows, model, 1, by_heads)
    fn = wkv6_chunked if mode == "chunked" else wkv6_recurrent
    o, s = fn(r, k, v, logw, u, _placed(state, mesh, s_places).to_local())
    o = o.to(x.dtype)
    b_l, _, h_l, _ = o.shape
    ones = torch.ones((dh,), dtype=o.dtype, device=o.device)
    on = rms_norm(o, ones).reshape(b_l, t, h_l * dh)
    on = on * spmd.local_block(p["ln_x"], vec, grad_partial=split)
    y = dot(spmd.from_block(on * g, mesh, heads, (b, t, h * dh)), p["wo"])
    return y, x[:, -1, :].clone(), spmd.from_block(s, mesh, s_places, (b, h, dh, dh))


def _rwkv_channel_mix_sharded(p, x: DTensor, x_prev):
    """:func:`rwkv_channel_mix` on DTensors, in the rules' layouts: ``wk``
    column-parallel (``ff`` over ``model``), ``wv`` ``[ff, d]`` with its
    ``d`` over ``model`` wanting ``ff`` whole (gathered), ``wr``
    row-parallel (its partial sum reduce-scattered onto ``wv``'s ``d``
    blocks). Returns (y placed as the rows, the last token ``[B, d]``)."""
    mesh = x.device_mesh
    rows = spmd.batch_placements(x.shape, mesh)
    whole = _whole(mesh)
    x = _placed(x, mesh, rows)
    xs = torch.cat([_placed(x_prev, mesh, rows)[:, None, :], x[:, :-1, :]], dim=1)
    mk = x + (xs - x) * p["mu_k"].redistribute(mesh, whole)
    mr = x + (xs - x) * p["mu_r"].redistribute(mesh, whole)
    k = torch.square(torch.relu(dot(mk, p["wk"])))
    kv = spmd.reduced(dot(k, p["wv"]))
    y = torch.sigmoid(dot(mr, p["wr"]).redistribute(mesh, kv.placements)) * kv
    return y.redistribute(mesh, rows), x[:, -1, :].clone()


def _ssd_mix_sharded(p, x: DTensor, state, cfg: ArchConfig, mode: str):
    """:func:`ssd_mix` on DTensors placed by the sharding rules. ``xv``
    (``wx`` column-parallel) and ``dt`` are taken by heads over ``model``
    where ``ssm_heads`` divides it, else gathered: the scan then runs on
    every head of the rank's rows, replicated over ``model`` (hymba: 25
    heads on 16). ``B`` and ``C`` (``N`` wide, over ``model``) and ``D``
    (``dh`` over ``model``) are gathered. ``ssd_chunked`` /
    ``ssd_recurrent`` run unchanged on the local blocks, the state block
    being ``ssd_s``'s cache block. ``wo`` is row-parallel: the heads' block
    of its input is the rank's own, or its slice of the replicated output
    (no collective). Returns (y, a partial sum over ``model``; the state)."""
    b, t, d = x.shape
    h, dh, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    mesh, rows, model, by_heads = _layout(x, h)
    split = spmd.split_rows(rows)
    heads = _over(rows, model, 2, by_heads)
    vec = _over(_whole(mesh), model, 0, by_heads)
    # B and C feed every head: with the heads over ``model``, each model
    # rank's share of their gradient is a partial sum
    shared = model if by_heads else ()
    xv = _heads_block(dot(x, p["wx"]), heads, dh)
    B = spmd.local_block(dot(x, p["wB"]), rows, grad_partial=shared)
    C = spmd.local_block(dot(x, p["wC"]), rows, grad_partial=shared)
    dt = _softplus(spmd.local_block(dot(x, p["wdt"]), heads)
                   + spmd.local_block(p["dt_bias"], vec, grad_partial=split))
    loga = -_softplus(spmd.local_block(p["a_log"], vec, grad_partial=split).float())
    logdecay = dt.float() * loga[None, None]
    D = spmd.local_block(p["D"], vec, grad_partial=split)
    s_places = _over(rows, model, 1, by_heads)
    fn = ssd_chunked if mode == "chunked" else ssd_recurrent
    o, s = fn(xv.float(), B.float(), C.float(), dt.float(), logdecay, D.float(),
              _placed(state, mesh, s_places).to_local())
    b_l, _, h_l, _ = o.shape
    o = spmd.from_block(o.to(x.dtype).reshape(b_l, t, h_l * dh), mesh, heads, (b, t, h * dh))
    return dot(o, p["wo"]), spmd.from_block(s, mesh, s_places, (b, h, n, dh))
