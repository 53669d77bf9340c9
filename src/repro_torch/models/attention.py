"""Attention variants: GQA (llama-family), MLA (MiniCPM3), sliding window.

Counterpart of ``repro.models.attention``, in plain torch ops: the reference
leaves attention to XLA, and these compute what it computes, in its order of
operations and with its casts (scores in f32, probabilities rounded to the
value dtype, ``-1e30`` masking). No library attention kernel stands in.

Two execution modes per variant:
* full  — training / prefill over [B, S] with causal (+ optional window) mask
* decode — one query token against a KV cache of length S_max

MLA keeps the *compressed* cache (c_kv + rotary key); decode supports the
naive expand-per-step form and the "absorbed" form (projection matrices
folded into the query / output).

Decode writes the new key/value into the cache at ``pos`` in place and
returns the cache; the reference returns new arrays. A ``pos`` past the
cache's end writes the last slot, as the reference's ``dynamic_update_slice``
clamps it; the mask and the rotary angle use ``pos`` itself.

On DTensors (the LM as one program over a mesh, see
:mod:`repro_torch.distributed.spmd`) the masks are built as plain tensors
and made replicated DTensors where they meet one. Full-sequence attention
runs head-parallel: the key/value heads
are repeated to the query heads so that the head dim can be sharded over
``model`` even where ``n_kv_heads`` does not divide it (yi-6b: 4 kv heads,
16-way ``model``), so each rank holds the scores of its own heads only.
Decode runs flash-decode style on a cache whose sequence dim is sharded
over ``model``: the query replicated, each rank's scores over its own
block, the softmax's max and sum reduced across blocks; the new key and
value are written on the rank that owns slot ``pos``. The reference's
``_attn_act_specs`` / ``_maybe_constrain`` (off in every config) have no
counterpart.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed import spmd
from repro_torch.models.common import (ArchConfig, apply_rope, dense_init, dot, einsum,
                                       full_init, rms_norm, rope_angles, softmax)

NEG = -1e30  # the reference's mask value


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------

def causal_window_mask(s_q: int, s_k: int, q_offset, window,
                       device: str | torch.device | None = "cpu") -> torch.Tensor:
    """[s_q, s_k] bool; window 0 => plain causal."""
    qpos = torch.arange(s_q, device=device)[:, None] + int(q_offset)
    kpos = torch.arange(s_k, device=device)[None, :]
    mask = kpos <= qpos
    win = int(window)
    if win > 0:
        return mask & (qpos - kpos < max(win, 1))
    return mask


def _sdpa(q, k, v, mask, *, scores_bf16: bool = False) -> torch.Tensor:
    """q [B,Sq,H,dh], k [B,Sk,Hkv,dh], v [B,Sk,Hkv,dv]; GQA head grouping."""
    if isinstance(q, DTensor) and not spmd.sharding_dims(k, 1):
        return _sdpa_heads(q, k, v, mask, scores_bf16=scores_bf16)
    if isinstance(q, DTensor):
        q = q.redistribute(q.device_mesh, spmd.batch_placements(q.shape, q.device_mesh))
    b, sq, h, dh = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    g = h // hkv
    q = q.reshape(b, sq, hkv, g, dh)
    scores = einsum("bqkgd,bskd->bkgqs", q, k)
    if not scores_bf16:
        scores = scores.float()
    scale = spmd.replicate_like(torch.sqrt(torch.tensor(float(dh), dtype=scores.dtype,
                                                        device=scores.device)), scores)
    scores = scores / scale
    scores = torch.where(spmd.replicate_like(mask.to(scores.device)[None, None, None], scores),
                         scores, NEG)
    probs = softmax(scores, -1).to(v.dtype)
    out = einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, dv)


def _by_heads(x: DTensor, g: int) -> DTensor:
    """``x`` [B,S,Hkv,d] with each kv head repeated for its ``g`` query
    heads ([B,S,Hkv*g,d], head ``j`` from kv head ``j // g``, the grouping
    of :func:`_sdpa`), its head dim sharded over the mesh's model axes
    where it divides, the batch as :func:`spmd.batch_placements` places it.
    Where only the repeated heads divide those axes, each rank gathers the
    kv heads and repeats just those its own block of heads reads."""
    mesh = x.device_mesh
    rows = spmd.batch_placements(x.shape, mesh)
    b, s, hkv, d = x.shape
    heads = spmd.model_mesh_dims(mesh)
    size = spmd.mesh_size(mesh, heads)
    by = tuple(spmd.Shard(2) if i in heads else rows[i] for i in range(mesh.ndim))
    if hkv % size == 0:
        x = x.redistribute(mesh, by)
    else:
        x = x.redistribute(mesh, rows)
        if hkv * g % size == 0:
            _, off = spmd.local_shape((b, s, hkv * g, d), mesh, by)
            own = torch.arange(off[2], off[2] + hkv * g // size, device=x.device) // g
            grad = tuple(spmd.Partial() if i in heads else p for i, p in enumerate(rows))
            local = x.to_local(grad_placements=grad).index_select(2, own)
            return DTensor.from_local(local, mesh, by, run_check=False)
    if g > 1:
        x = x[:, :, :, None, :].expand(b, s, hkv, g, d).reshape(b, s, hkv * g, d)
    return x


def _sdpa_heads(q, k, v, mask, *, scores_bf16: bool = False):
    """:func:`_sdpa` on DTensors, head-parallel: with the kv heads repeated
    and every operand placed alike (the batch over the data axes, the heads
    over the others), each (batch row, head) is a rank's own, so the
    attention runs on the local blocks (:func:`_attend`, the arithmetic of
    :func:`_sdpa`) with no collective, and its output is placed as ``q``."""
    g = q.shape[2] // k.shape[2]
    q, k, v = _by_heads(q, 1), _by_heads(k, g), _by_heads(v, g)
    out = _attend(q.to_local(), k.to_local(), v.to_local(), mask, scores_bf16=scores_bf16)
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False)


def _attend(q, k, v, mask, *, scores_bf16: bool = False) -> torch.Tensor:
    """Attention of q [B,Sq,H,dh] on k, v [B,Sk,H,d] (heads already matched)
    with :func:`_sdpa`'s scale, mask, softmax and casts. Where autograd
    records nothing (prefill) the masking and the softmax run in place on
    the scores: at prefill_32k a rank's scores are 17 GB."""
    scores = einsum("bqhd,bshd->bhqs", q, k)
    if not scores_bf16:
        scores = scores.float()
    scale = torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=scores.dtype,
                                    device=scores.device))
    keep = mask.to(scores.device)[None, None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        probs = softmax(torch.where(keep, scores / scale, NEG), -1).to(v.dtype)
    else:
        scores.div_(scale).masked_fill_(~keep, NEG)
        scores.sub_(scores.amax(-1, keepdim=True)).exp_()
        probs = scores.div_(scores.sum(-1, keepdim=True)).to(v.dtype)
    return einsum("bhqs,bshd->bqhd", probs, v)


def _chunked_sdpa(q, k, v, *, q_offset, window, kblock: int, qblock: int,
                  causal: bool = True, full_unroll: bool = False) -> torch.Tensor:
    """Flash-style attention: online softmax over key blocks.

    Never materializes the [Sq, Sk] score matrix — peak intermediate is one
    [qblock, kblock] tile per head group. Same FLOPs as naive; equal up to
    fp reassociation. q [B,Sq,H,dh]. ``full_unroll`` is the reference's
    dry-run knob and has no effect here.
    """
    b, sq, h, dh = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    dev = q.device
    kblock = min(kblock, sk)
    qblock = min(qblock, sq)
    n_k = (sk + kblock - 1) // kblock
    pad_k = n_k * kblock - sk
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    win = int(window)
    scale = torch.rsqrt(torch.tensor(float(dh), dtype=torch.float32))
    qr = q.reshape(b, sq, hkv, g, dh)

    outs = []
    for q0 in range(0, sq, qblock):
        qb = qr[:, q0: q0 + qblock]
        qbs = qb.shape[1]
        qpos = (torch.arange(qbs, device=dev) + q0 + int(q_offset))[:, None]
        m = torch.full((b, hkv, g, qbs), -torch.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, qbs), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, qbs, dv), dtype=torch.float32, device=dev)
        for k0 in range(0, n_k * kblock, kblock):
            kb = k[:, k0: k0 + kblock]
            vb = v[:, k0: k0 + kblock]
            s = einsum("bqkgd,bskd->bkgqs", qb, kb).float() * scale
            kpos = (k0 + torch.arange(kblock, device=dev))[None, :]
            if causal:
                mask = (kpos <= qpos) & (kpos < sk)
                if win > 0:
                    mask = mask & (qpos - kpos < max(win, 1))
            else:
                mask = (kpos < sk).expand(qbs, kblock)
            s = torch.where(spmd.replicate_like(mask[None, None, None], s), s, NEG)
            m2 = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m2[..., None])
            corr = torch.exp(m - m2)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + einsum(
                "bkgqs,bskd->bkgqd", p.to(vb.dtype), vb).float()
            m = m2
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.to(v.dtype))
    out = torch.cat(outs, dim=3) if len(outs) > 1 else outs[0]
    # [B, hkv, g, Sq, dv] -> [B, Sq, H, dv]
    return out.movedim(3, 1).reshape(b, sq, h, dv)


def _write_slot(cache: torch.Tensor, val: torch.Tensor, pos: int) -> torch.Tensor:
    """Write ``val`` [B,1,...] at sequence slot ``pos`` of ``cache`` [B,S,...]
    in place, clamped into the cache as ``dynamic_update_slice`` clamps."""
    slot = min(max(int(pos), 0), cache.shape[1] - 1)
    if isinstance(cache, DTensor):
        spmd.write_block(cache, val, dim=1, start=slot)
    else:
        cache[:, slot: slot + 1] = val.to(cache.dtype)
    return cache


def _decode_mask(s_max: int, pos: int, window: int, device) -> torch.Tensor:
    kpos = torch.arange(s_max, device=device)
    mask = kpos <= pos
    if window > 0:
        mask = mask & (pos - kpos < max(window, 1))
    return mask


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_init(generator: torch.Generator, cfg: ArchConfig,
             device: str | torch.device | None = None) -> Dict[str, torch.Tensor]:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    return {
        "wq": dense_init(generator, (d, h * dh), d, dt, device),
        "wk": dense_init(generator, (d, hkv * dh), d, dt, device),
        "wv": dense_init(generator, (d, hkv * dh), d, dt, device),
        "wo": dense_init(generator, (h * dh, d), h * dh, dt, device),
    }


def _heads(t: torch.Tensor, b: int, s: int, n: int, d: int) -> torch.Tensor:
    """``t`` [B,S,n*d] as [B,S,n,d] (a DTensor gathered first where its
    shard of ``n*d`` does not split into whole heads)."""
    if isinstance(t, DTensor):
        t = spmd.split_dim(t, -1, n)
    return t.reshape(b, s, n, d)


def gqa_full(p, x: torch.Tensor, cfg: ArchConfig, *, window=0, q_offset=0):
    b, s, d = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _heads(dot(x, p["wq"]), b, s, h, dh)
    k = _heads(dot(x, p["wk"]), b, s, hkv, dh)
    v = _heads(dot(x, p["wv"]), b, s, hkv, dh)
    cos, sin = rope_angles(torch.arange(s, device=x.device) + int(q_offset), dh, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if cfg.attn_impl == "chunked":
        out = _chunked_sdpa(q, k, v, q_offset=q_offset, window=window,
                            kblock=cfg.attn_kblock, qblock=cfg.attn_qblock,
                            full_unroll=cfg.unroll_layers)
    else:
        mask = causal_window_mask(s, s, q_offset, window, x.device)
        out = _sdpa(q, k, v, mask, scores_bf16=cfg.attn_scores_bf16)
    return dot(out.reshape(b, s, h * dh), p["wo"]), (k, v)


def gqa_decode(p, x: torch.Tensor, cache_k, cache_v, pos, cfg: ArchConfig,
               *, window=0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,1,d]; cache_k/v [B,S,Hkv,dh], written in place; pos the write
    position (an int or a 0-d tensor)."""
    b, _, d = x.shape
    s_max = cache_k.shape[1]
    pos = int(pos)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _heads(dot(x, p["wq"]), b, 1, h, dh)
    k = _heads(dot(x, p["wk"]), b, 1, hkv, dh)
    v = _heads(dot(x, p["wv"]), b, 1, hkv, dh)
    cos, sin = rope_angles(torch.tensor([pos], device=x.device), dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache_k = _write_slot(cache_k, k, pos)
    cache_v = _write_slot(cache_v, v, pos)
    if cfg.attn_impl == "chunked":
        # flash-decode: online softmax over cache blocks
        out = _chunked_sdpa(q, cache_k, cache_v, q_offset=pos, window=window,
                            kblock=cfg.attn_kblock, qblock=1,
                            full_unroll=cfg.unroll_layers)
    else:
        mask = _decode_mask(s_max, pos, int(window), x.device)
        out = _sdpa(q, cache_k, cache_v, mask[None, :], scores_bf16=cfg.attn_scores_bf16)
    return dot(out.reshape(b, 1, h * dh), p["wo"]), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (MiniCPM3 / DeepSeek-style multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(generator: torch.Generator, cfg: ArchConfig,
             device: str | torch.device | None = None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    h = cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = cfg.param_dtype
    return {
        "wdq": dense_init(generator, (d, qr), d, dt, device),
        "q_norm": full_init((qr,), 1.0, dt, device),
        "wuq": dense_init(generator, (qr, h * (nope + rope_d)), qr, dt, device),
        "wdkv": dense_init(generator, (d, kvr), d, dt, device),
        "kv_norm": full_init((kvr,), 1.0, dt, device),
        "wkr": dense_init(generator, (d, rope_d), d, dt, device),
        "wukv": dense_init(generator, (kvr, h * (nope + vd)), kvr, dt, device),
        "wo": dense_init(generator, (h * vd, d), h * vd, dt, device),
    }


def _mla_q(p, x, cfg):
    b, s, _ = x.shape
    h, nope, rope_d = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_norm(dot(x, p["wdq"]), p["q_norm"])
    q = dot(cq, p["wuq"]).reshape(b, s, h, nope + rope_d)
    return q[..., :nope], q[..., nope:]


def mla_full(p, x: torch.Tensor, cfg: ArchConfig, *, q_offset=0):
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg)
    ckv = rms_norm(dot(x, p["wdkv"]), p["kv_norm"])              # [B,S,kvr]
    kr = dot(x, p["wkr"])[:, :, None, :]                         # [B,S,1,rope]
    cos, sin = rope_angles(torch.arange(s, device=x.device) + int(q_offset), rope_d,
                           cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    kr = apply_rope(kr, cos, sin)
    kv = dot(ckv, p["wukv"]).reshape(b, s, h, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, kr.expand(b, s, h, rope_d)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    if cfg.attn_impl == "chunked":
        out = _chunked_sdpa(q, k, v, q_offset=q_offset, window=0,
                            kblock=cfg.attn_kblock, qblock=cfg.attn_qblock,
                            full_unroll=cfg.unroll_layers)
    else:
        mask = causal_window_mask(s, s, q_offset, 0, x.device)
        out = _sdpa(q, k, v, mask, scores_bf16=cfg.attn_scores_bf16)
    return dot(out.reshape(b, s, h * vd), p["wo"]), (ckv, kr[:, :, 0, :])


def mla_decode(p, x, cache_ckv, cache_kr, pos, cfg: ArchConfig, *, absorb: bool = True):
    """Compressed-cache decode (caches written in place). absorb=True folds
    W_ukv into q/out; absorb=False expands keys/values per step."""
    b, _, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    s_max = cache_ckv.shape[1]
    pos = int(pos)
    q_nope, q_rope = _mla_q(p, x, cfg)                    # [B,1,H,*]
    cos, sin = rope_angles(torch.tensor([pos], device=x.device), rope_d, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    ckv_t = rms_norm(dot(x, p["wdkv"]), p["kv_norm"])     # [B,1,kvr]
    kr_t = apply_rope(dot(x, p["wkr"])[:, :, None, :], cos, sin)[:, :, 0, :]
    cache_ckv = _write_slot(cache_ckv, ckv_t, pos)
    cache_kr = _write_slot(cache_kr, kr_t, pos)
    mask = _decode_mask(s_max, pos, 0, x.device)          # [S]
    wukv = p["wukv"].reshape(kvr, h, nope + vd)
    wk = wukv[..., :nope]                                 # [kvr,H,nope]
    wv = wukv[..., nope:]                                 # [kvr,H,vd]
    scale = torch.sqrt(torch.tensor(float(nope + rope_d), dtype=torch.float32))
    if absorb:
        # score_h(s) = <q_nope_h W_k_h, ckv_s> + <q_rope_h, kr_s>
        q_eff = einsum("bqhn,chn->bqhc", q_nope, wk)      # [B,1,H,kvr]
        s_c = einsum("bqhc,bsc->bhqs", q_eff, cache_ckv)
        s_r = einsum("bqhr,bsr->bhqs", q_rope, cache_kr)
        scores = (s_c + s_r).float() / scale
        scores = torch.where(mask[None, None, None, :], scores, NEG)
        probs = softmax(scores, -1).to(cache_ckv.dtype)
        ctx = einsum("bhqs,bsc->bqhc", probs, cache_ckv)        # [B,1,H,kvr]
        out = einsum("bqhc,chv->bqhv", ctx, wv)                 # [B,1,H,vd]
    else:
        kv = einsum("bsc,chn->bshn", cache_ckv, wukv)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k = torch.cat(
            [k_nope, cache_kr[:, :, None, :].expand(*k_nope.shape[:3], rope_d)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        scores = einsum("bqhd,bshd->bhqs", q, k).float() / scale
        scores = torch.where(mask[None, None, None, :], scores, NEG)
        probs = softmax(scores, -1).to(v.dtype)
        out = einsum("bhqs,bshv->bqhv", probs, v)
    return dot(out.reshape(b, 1, h * vd), p["wo"]), cache_ckv, cache_kr
