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
folded into the query / output). A config with ``q_lora_rank`` 0 projects
the query with one ``wq`` (DeepSeek-V2-Lite); a config with YaRN
(``PortArchConfig.yarn``) scales the rotary frequencies and the softmax
(``common.rope_angles``, ``common.mla_softmax_scale``), in the full, the
chunked and the decode paths.

Decode writes the new key/value into the cache at ``pos`` in place and
returns the cache; the reference returns new arrays. A ``pos`` past the
cache's end writes the last slot, as the reference's ``dynamic_update_slice``
clamps it; the mask and the rotary angle use ``pos`` itself.

On DTensors (the LM as one program over a mesh, see
:mod:`repro_torch.distributed.spmd`) the masks are built as plain tensors
and made replicated DTensors where they meet one. GQA's and MLA's
full-sequence attention follow the reference's ``_attn_act_specs``: by
heads where the query heads divide ``model``, else by the query sequence
with keys and values whole on each rank (hymba: 25 heads, minicpm3: 40, on
a 16-way ``model``). By heads, GQA's key/value heads are repeated to the
query heads so that the head dim can be sharded over ``model`` even where
``n_kv_heads`` does not divide it (yi-6b: 4 kv heads), so each rank holds
the scores of its own heads only; MLA runs on local blocks.
Decode runs flash-decode style on a cache whose sequence dim is sharded
over ``model``: the query replicated, each rank's scores over its own
block, the softmax's max and sum reduced across blocks; the new key and
value (MLA: ``c_kv`` and the rotary key) are written on the rank that owns
slot ``pos``. The reference's ``_maybe_constrain`` calls have no
counterpart: the layouts are built directly.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed import spmd
from repro_torch.models.common import (ArchConfig, apply_rope, dense_init, dot,
                                       dot_by_sequence, einsum, full_init, mla_softmax_scale,
                                       rms_norm, rope_angles, softmax)

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


def _sdpa(q, k, v, mask, *, scores_bf16: bool = False,
          softmax_scale: float | None = None) -> torch.Tensor:
    """q [B,Sq,H,dh], k [B,Sk,Hkv,dh], v [B,Sk,Hkv,dv]; GQA head grouping.
    The scores are divided by ``sqrt(dh)``, or multiplied by
    ``softmax_scale`` where it is given."""
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
    if softmax_scale is None:
        scale = spmd.replicate_like(torch.sqrt(torch.tensor(float(dh), dtype=scores.dtype,
                                                            device=scores.device)), scores)
        scores = scores / scale
    else:
        scores = scores * softmax_scale
    scores = torch.where(spmd.replicate_like(mask.to(scores.device)[None, None, None], scores),
                         scores, NEG)
    probs = softmax(scores, -1).to(v.dtype)
    out = einsum("bkgqs,bskd->bqkgd", probs, v)
    if isinstance(out, DTensor):
        # reduced over the cache's blocks and placed as the batch: DTensor's
        # einsum may leave the heads sharded where nothing splits the batch
        out = out.redistribute(out.device_mesh, spmd.batch_placements(out.shape,
                                                                      out.device_mesh))
    return out.reshape(b, sq, h, dv)


def _by_heads(x: DTensor, g: int) -> DTensor:
    """``x`` [B,S,Hkv,d] with each kv head repeated for its ``g`` query
    heads ([B,S,Hkv*g,d], head ``j`` from kv head ``j // g``, the grouping
    of :func:`_sdpa`), its head dim sharded over the mesh's model axes
    where it divides, the batch as :func:`spmd.batch_placements` places it.
    Where only the repeated heads divide those axes, each rank gathers the
    kv heads and repeats just those its own block of heads reads. A model
    axis of one rank splits nothing (DTensor cannot repeat a single kv head
    sharded over it)."""
    mesh = x.device_mesh
    rows = spmd.batch_placements(x.shape, mesh)
    b, s, hkv, d = x.shape
    heads = tuple(i for i in spmd.model_mesh_dims(mesh) if mesh.size(i) > 1)
    size = spmd.mesh_size(mesh, heads)
    by = tuple(spmd.Shard(2) if i in heads else rows[i] for i in range(mesh.ndim))
    if spmd.divides(hkv, size):
        x = x.redistribute(mesh, by)
    else:
        x = x.redistribute(mesh, rows)
        if spmd.divides(hkv * g, size):
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
    out = _attend(*(spmd.to_local(t) for t in (q, k, v)), mask, scores_bf16=scores_bf16)
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
                  causal: bool = True, full_unroll: bool = False,
                  softmax_scale: float | None = None) -> torch.Tensor:
    """Flash-style attention: online softmax over key blocks.

    Never materializes the [Sq, Sk] score matrix — peak intermediate is one
    [qblock, kblock] tile per head group. Same FLOPs as naive; equal up to
    fp reassociation. q [B,Sq,H,dh]. The scores are scaled by
    ``softmax_scale`` (default ``1 / sqrt(dh)``). ``full_unroll`` is the
    reference's dry-run knob and has no effect here.
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
    scale = (torch.rsqrt(torch.tensor(float(dh), dtype=torch.float32)) if softmax_scale is None
             else torch.tensor(softmax_scale, dtype=torch.float32))
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


def position(pos):
    """A decode position as the decode paths take it: an int (a 0-d tensor
    read once), or a device tensor ``[1]``, which a CUDA graph of the step
    reads at each replay."""
    return pos if isinstance(pos, torch.Tensor) and pos.ndim == 1 else int(pos)


def _write_slot(cache: torch.Tensor, val: torch.Tensor, pos) -> torch.Tensor:
    """Write ``val`` [B,1,...] at sequence slot ``pos`` of ``cache`` [B,S,...]
    in place, clamped into the cache as ``dynamic_update_slice`` clamps
    (``pos``: see :func:`position`)."""
    if isinstance(pos, torch.Tensor):
        return cache.index_copy_(1, pos.clamp(0, cache.shape[1] - 1), val.to(cache.dtype))
    slot = min(max(int(pos), 0), cache.shape[1] - 1)
    if isinstance(cache, DTensor):
        spmd.write_block(cache, val, dim=1, start=slot)
    else:
        cache[:, slot: slot + 1] = val.to(cache.dtype)
    return cache


def _decode_mask(s_max: int, pos, window: int, device) -> torch.Tensor:
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


def _by_sequence(x: DTensor, heads: int) -> bool:
    """The reference's ``_attn_act_specs`` on ``x`` ``[B, S, d]``: True
    where the attention goes sequence-parallel, the query heads not
    dividing the model axes and the sequence dividing them."""
    mesh = x.device_mesh
    size = spmd.mesh_size(mesh, spmd.model_mesh_dims(mesh))
    s = x.shape[1]
    return not spmd.divides(heads, size) and spmd.divides(s, size) and s > 1


def gqa_full(p, x: torch.Tensor, cfg: ArchConfig, *, window=0, q_offset=0):
    if isinstance(x, DTensor) and _by_sequence(x, cfg.n_heads):
        return _gqa_full_by_sequence(p, x, cfg, window, q_offset)
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


def _gqa_full_by_sequence(p, x: DTensor, cfg: ArchConfig, window, q_offset):
    """:func:`gqa_full` on DTensors where the query heads do not divide the
    model axes (hymba: 25 heads, 5 kv heads on 16), sequence-parallel as the
    reference's ``_attn_act_specs`` lays it out: each rank projects its own
    block of query rows against the whole ``wq`` (``dot_by_sequence``),
    keys and values are column-parallel and gathered whole on each rank (a
    model rank's gradient of them is a partial sum), each rank's query rows
    attend to every key under the causal and window masks sliced at its
    rows' offset, and the output projection runs on the rank's rows against
    the whole ``wo``, then is gathered. A rank's scores are ``[B_l, H,
    S / model, S]``, not ``[B_l, H, S, S]``. Returns the output placed as
    the batch and the rotated keys and values as DTensors placed as the
    batch."""
    mesh = x.device_mesh
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = spmd.batch_placements(x.shape, mesh)
    places = spmd.sequence_placements(x.shape, mesh)
    split = spmd.sharding_dims(places, 1)
    (b_l, s_l, _), off = spmd.local_shape((b, s, h * dh), mesh, places)
    cos, sin = rope_angles(torch.arange(s, device=x.device) + int(q_offset), dh, cfg.rope_theta)
    q = dot_by_sequence(x, p["wq"]).to_local().reshape(b_l, s_l, h, dh)
    q = apply_rope(q, cos[off[1]: off[1] + s_l], sin[off[1]: off[1] + s_l])
    k = spmd.local_block(dot(x, p["wk"]), rows, grad_partial=split).reshape(b_l, s, hkv, dh)
    v = spmd.local_block(dot(x, p["wv"]), rows, grad_partial=split).reshape(b_l, s, hkv, dh)
    k = apply_rope(k, cos, sin)
    if cfg.attn_impl == "chunked":
        out = _chunked_sdpa(q, k, v, q_offset=int(q_offset) + off[1], window=window,
                            kblock=cfg.attn_kblock, qblock=cfg.attn_qblock,
                            full_unroll=cfg.unroll_layers)
    else:
        g = h // hkv
        mask = causal_window_mask(s, s, q_offset, window, x.device)[off[1]: off[1] + s_l]
        out = _attend(q, *(t[:, :, :, None, :].expand(b_l, s, hkv, g, dh).reshape(b_l, s, h, dh)
                           for t in (k, v)), mask, scores_bf16=cfg.attn_scores_bf16)
    out = spmd.from_block(out.reshape(b_l, s_l, h * dh), mesh, places, (b, s, h * dh))
    y = dot_by_sequence(out, p["wo"]).redistribute(mesh, rows)
    kv = tuple(spmd.from_block(t, mesh, rows, (b, s, hkv, dh)) for t in (k, v))
    return y, kv


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
    if qr:
        q = {"wdq": dense_init(generator, (d, qr), d, dt, device),
             "q_norm": full_init((qr,), 1.0, dt, device),
             "wuq": dense_init(generator, (qr, h * (nope + rope_d)), qr, dt, device)}
    else:
        q = {"wq": dense_init(generator, (d, h * (nope + rope_d)), d, dt, device)}
    return {
        **q,
        "wdkv": dense_init(generator, (d, kvr), d, dt, device),
        "kv_norm": full_init((kvr,), 1.0, dt, device),
        "wkr": dense_init(generator, (d, rope_d), d, dt, device),
        "wukv": dense_init(generator, (kvr, h * (nope + vd)), kvr, dt, device),
        "wo": dense_init(generator, (h * vd, d), h * vd, dt, device),
    }


def _mla_q(p, x, cfg):
    """The query ``[B, S, H, nope]``, ``[B, S, H, rope]`` (before RoPE):
    through the low-rank ``wdq``, ``q_norm``, ``wuq``, or one ``wq`` where
    ``q_lora_rank`` is 0."""
    b, s, _ = x.shape
    h, nope, rope_d = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = rms_norm(dot(x, p["wdq"]), p["q_norm"])
        q = dot(cq, p["wuq"]).reshape(b, s, h, nope + rope_d)
    else:
        q = dot(x, p["wq"]).reshape(b, s, h, nope + rope_d)
    return q[..., :nope], q[..., nope:]


def mla_full(p, x: torch.Tensor, cfg: ArchConfig, *, q_offset=0):
    if isinstance(x, DTensor):
        return _mla_full_sharded(p, x, cfg, q_offset)
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg)
    ckv = rms_norm(dot(x, p["wdkv"]), p["kv_norm"])              # [B,S,kvr]
    kr = dot(x, p["wkr"])[:, :, None, :]                         # [B,S,1,rope]
    cos, sin = rope_angles(torch.arange(s, device=x.device) + int(q_offset), rope_d,
                           cfg.rope_theta, getattr(cfg, "yarn", None))
    q_rope = apply_rope(q_rope, cos, sin)
    kr = apply_rope(kr, cos, sin)
    kv = dot(ckv, p["wukv"]).reshape(b, s, h, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, kr.expand(b, s, h, rope_d)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    if cfg.attn_impl == "chunked":
        out = _chunked_sdpa(q, k, v, q_offset=q_offset, window=0,
                            kblock=cfg.attn_kblock, qblock=cfg.attn_qblock,
                            full_unroll=cfg.unroll_layers, softmax_scale=mla_softmax_scale(cfg))
    else:
        mask = causal_window_mask(s, s, q_offset, 0, x.device)
        out = _sdpa(q, k, v, mask, scores_bf16=cfg.attn_scores_bf16,
                    softmax_scale=mla_softmax_scale(cfg))
    return dot(out.reshape(b, s, h * vd), p["wo"]), (ckv, kr[:, :, 0, :])


def _mla_full_sharded(p, x: DTensor, cfg: ArchConfig, q_offset):
    """:func:`mla_full` on DTensors, on each rank's local blocks. The
    low-rank projections are column-parallel (``c_q``, ``c_kv`` sharded over
    ``model``; their norms reduce the sum of squares over it), the rotary key
    is gathered (``[B, S, rope]``) and broadcast to the rank's own heads.
    The attention follows the reference's ``_attn_act_specs``:

    * the heads divide the model axes: head-parallel, the up-projections
      column-parallel, each rank attends with its own heads, the output
      projection row-parallel (a partial sum);
    * else the sequence divides them: sequence-parallel, the query
      up-projection on the rank's own sequence block against the whole
      ``wuq`` (gathered: the ``[B, S, H*(nope+rope)]`` product is never
      gathered), keys and values whole on each rank (the ``wukv`` product
      column-parallel, then gathered), each rank's query rows against every
      key, the output projection on its rows against the whole ``wo``, then
      gathered; at minicpm3 ``train_4k`` a rank's scores are [16, 40, 256,
      4096] f32, 2.7 GB, against 43 GB with every head's rows;
    * else every model rank computes the whole attention of its batch.

    Returns the output placed as the batch (or a partial sum over
    ``model``) and, for the cache, ``c_kv`` and the rotary key as
    DTensors."""
    mesh = x.device_mesh
    b, s, _ = x.shape
    h, nope, rope_d, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    model = spmd.model_mesh_dims(mesh)
    rows = spmd.batch_placements(x.shape, mesh)
    cq = rms_norm(dot(x, p["wdq"]), p["q_norm"])
    ckv = rms_norm(dot(x, p["wdkv"]), p["kv_norm"])
    pos = torch.arange(s, device=x.device) + int(q_offset)
    cos, sin = rope_angles(pos, rope_d, cfg.rope_theta)
    kr = apply_rope(dot(x, p["wkr"]).redistribute(mesh, rows)[:, :, None, :], cos, sin)
    by_heads = spmd.divides(h, spmd.mesh_size(mesh, model))
    if by_heads:
        places = tuple(spmd.Shard(2) if i in model else p_ for i, p_ in enumerate(rows))
        split = model
    else:
        places = spmd.sequence_placements(x.shape, mesh)
        split = spmd.sharding_dims(places, 1)
    (b_l, s_l, h_l), off = spmd.local_shape((b, s, h), mesh, places)
    # every rank along ``split`` (other heads, or other query rows) applies
    # the shared rotary key: its gradient is a partial sum there
    kr_l = spmd.local_block(kr, rows, grad_partial=split)
    if by_heads:
        q_l = dot(cq, p["wuq"]).redistribute(mesh, places).to_local()
        kv_l = dot(ckv, p["wukv"]).redistribute(mesh, places).to_local()
    else:
        q_l = dot_by_sequence(cq, p["wuq"]).to_local()
        kv_l = spmd.local_block(dot(ckv, p["wukv"]), rows, grad_partial=split)
    q_l = q_l.reshape(b_l, s_l, h_l, nope + rope_d)
    kv_l = kv_l.reshape(b_l, s, h_l, nope + vd)
    q_rope = apply_rope(q_l[..., nope:], cos[off[1]: off[1] + s_l], sin[off[1]: off[1] + s_l])
    q_l = torch.cat([q_l[..., :nope], q_rope], dim=-1)
    k_l = torch.cat([kv_l[..., :nope], kr_l.expand(b_l, s, h_l, rope_d)], dim=-1)
    v_l = kv_l[..., nope:]
    if cfg.attn_impl == "chunked":
        out = _chunked_sdpa(q_l, k_l, v_l, q_offset=int(q_offset) + off[1], window=0,
                            kblock=cfg.attn_kblock, qblock=cfg.attn_qblock,
                            full_unroll=cfg.unroll_layers)
    else:
        mask = causal_window_mask(s, s, q_offset, 0, x.device)[off[1]: off[1] + s_l]
        out = _attend(q_l, k_l, v_l, mask, scores_bf16=cfg.attn_scores_bf16)
    out = spmd.from_block(out.reshape(b_l, s_l, h_l * vd), mesh, places, (b, s, h * vd))
    y = dot(out, p["wo"]) if by_heads else dot_by_sequence(out, p["wo"]).redistribute(mesh, rows)
    return y, (ckv, kr[:, :, 0, :])


def mla_decode_tables(cfg: ArchConfig, pos, s_max: int, device):
    """What every layer's :func:`mla_decode` at position ``pos`` (see
    :func:`position`) of a cache of ``s_max`` slots shares: the rotary
    tables (cos, sin ``[1, rope/2]``) and the mask ``[s_max]``. An int
    position is made on the device: a copy from the host's pageable memory
    would wait for the stream."""
    pos = position(pos)
    at = pos if isinstance(pos, torch.Tensor) else torch.full((1,), pos, device=device)
    cos, sin = rope_angles(at, cfg.qk_rope_dim, cfg.rope_theta, getattr(cfg, "yarn", None))
    return cos, sin, _decode_mask(s_max, pos, 0, device)


def mla_decode(p, x, cache_ckv, cache_kr, pos, cfg: ArchConfig, *, absorb: bool = True,
               tables=None):
    """Compressed-cache decode (caches written in place). absorb=True folds
    W_ukv into q/out; absorb=False expands keys/values per step. ``tables``:
    :func:`mla_decode_tables` of ``pos``, made once for all the layers of a
    step (made here where None)."""
    if isinstance(cache_ckv, DTensor):
        return _mla_decode_sharded(p, x, cache_ckv, cache_kr, pos, cfg, absorb=absorb)
    b, _, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    pos = position(pos)
    q_nope, q_rope = _mla_q(p, x, cfg)                    # [B,1,H,*]
    cos, sin, mask = (mla_decode_tables(cfg, pos, cache_ckv.shape[1], x.device)
                      if tables is None else tables)      # mask [S]
    q_rope = apply_rope(q_rope, cos, sin)
    ckv_t = rms_norm(dot(x, p["wdkv"]), p["kv_norm"])     # [B,1,kvr]
    kr_t = apply_rope(dot(x, p["wkr"])[:, :, None, :], cos, sin)[:, :, 0, :]
    cache_ckv = _write_slot(cache_ckv, ckv_t, pos)
    cache_kr = _write_slot(cache_kr, kr_t, pos)
    wukv = p["wukv"].reshape(kvr, h, nope + vd)
    wk = wukv[..., :nope]                                 # [kvr,H,nope]
    wv = wukv[..., nope:]                                 # [kvr,H,vd]
    softmax_scale = mla_softmax_scale(cfg)
    scale = (torch.sqrt(torch.tensor(float(nope + rope_d), dtype=torch.float32))
             if softmax_scale is None else torch.tensor(1.0 / softmax_scale, dtype=torch.float32))
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


def _mla_decode_sharded(p, x: DTensor, cache_ckv: DTensor, cache_kr: DTensor, pos,
                        cfg: ArchConfig, *, absorb: bool):
    """:func:`mla_decode` on DTensors, flash-decode style on the compressed
    cache (its sequence sharded over ``model`` by ``cache_specs``): the new
    ``c_kv`` and rotary key written on the rank that owns slot ``pos``; the
    query's heads gathered (``[B, 1, H*(nope+rope)]``, tiny) and ``wukv``
    whole; each rank scores its own block of the cache, and the softmax's max
    and sum, then the context (absorbed) or the output (expanded), are
    reduced across the blocks. The cache is never gathered. No autograd
    runs here (serving)."""
    mesh = cache_ckv.device_mesh
    b = x.shape[0]
    h, nope, rope_d, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    s_max = cache_ckv.shape[1]
    pos = int(pos)
    rows = spmd.batch_placements(x.shape, mesh)
    cos, sin = rope_angles(torch.tensor([pos], device=x.device), rope_d, cfg.rope_theta)
    cq = rms_norm(dot(x, p["wdq"]), p["q_norm"])
    q = dot(cq, p["wuq"]).redistribute(mesh, rows).to_local()
    q = q.reshape(q.shape[0], 1, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], cos, sin)
    ckv_t = rms_norm(dot(x, p["wdkv"]), p["kv_norm"])
    kr_t = apply_rope(dot(x, p["wkr"])[:, :, None, :], cos, sin)[:, :, 0, :]
    cache_ckv = _write_slot(cache_ckv, ckv_t, pos)
    cache_kr = _write_slot(cache_kr, kr_t, pos)
    seq = spmd.sharding_dims(cache_ckv, 1)
    c_l, r_l = cache_ckv.to_local(), cache_kr.to_local()
    (_, s_l, _), off = spmd.local_shape(cache_ckv.shape, mesh, cache_ckv.placements)
    mask = _decode_mask(s_max, pos, 0, x.device)[off[1]: off[1] + s_l]
    wukv = p["wukv"].redistribute(mesh, [spmd.Replicate()] * mesh.ndim).to_local()
    wukv = wukv.reshape(kvr, h, nope + vd)
    wk, wv = wukv[..., :nope], wukv[..., nope:]
    scale = torch.sqrt(torch.tensor(float(nope + rope_d), dtype=torch.float32))
    if absorb:
        q_eff = einsum("bqhn,chn->bqhc", q_nope, wk)
        scores = (einsum("bqhc,bsc->bhqs", q_eff, c_l)
                  + einsum("bqhr,bsr->bhqs", q_rope, r_l)).float() / scale
        value = c_l
    else:
        kv = einsum("bsc,chn->bshn", c_l, wukv)
        k = torch.cat([kv[..., :nope], r_l[:, :, None, :].expand(*kv.shape[:3], rope_d)],
                      dim=-1)
        scores = einsum("bqhd,bshd->bhqs", torch.cat([q_nope, q_rope], dim=-1),
                        k).float() / scale
        value = kv[..., nope:]
    scores = torch.where(mask[None, None, None, :], scores, NEG)
    # the softmax of ``jax.nn.softmax`` over the whole cache: the max and the
    # sum of exponentials reduced over the ranks' blocks
    peak = spmd.reduce_over(scores.amax(-1, keepdim=True), rows, seq, mesh, "max").to_local()
    e = torch.exp(scores - peak)
    total = spmd.reduce_over(e.sum(-1, keepdim=True), rows, seq, mesh).to_local()
    probs = (e / total).to(value.dtype)
    if absorb:
        ctx = einsum("bhqs,bsc->bqhc", probs, c_l)
        ctx = spmd.reduce_over(ctx, rows, seq, mesh).to_local()
        out = einsum("bqhc,chv->bqhv", ctx, wv)
    else:
        out = spmd.reduce_over(einsum("bhqs,bshv->bqhv", probs, value), rows, seq,
                               mesh).to_local()
    out = spmd.from_block(out.reshape(out.shape[0], 1, h * vd), mesh, rows, (b, 1, h * vd))
    return dot(out, p["wo"]), cache_ckv, cache_kr
