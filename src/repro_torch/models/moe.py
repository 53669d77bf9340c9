"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Counterpart of ``repro.models.moe``. Tokens are scattered into per-expert
buffers of ``capacity = ceil(T·K/E · capacity_factor)`` slots; a (token, k)
pair's slot comes from a cumulative count over the (token, k) stream in
row-major order, so the pairs that overflow, and lose that expert's
contribution, are the reference's. Overflow goes to a scratch row that is
dropped; the per-token results are summed back in k order, as the
reference's ``segment_sum`` adds them.

Routing picks the top k experts with ``lax.top_k``'s tie-break (the lowest
expert id first), through the canonical (score desc, id asc) order of
:func:`repro_torch.core.beam.topk_canonical`; ``torch.topk`` promises no
order among ties.

``moe_dense_ref`` (all experts, dense) is the smoke-test oracle: with ample
capacity the two agree.

The port's own architectures (``common.PortArchConfig``, DeepSeek-V2) add
shared experts (one SwiGLU that every token runs, added to the routed sum),
routing weights that are the router's probabilities times
``routed_scale`` where ``norm_topk_prob`` is off, and dropless routing
(``moe_dropless``): at one token a sequence (decode) every expert runs on
the step's T tokens (:func:`_moe_every_expert`: the E x T rows that the
capacity path would compute at a capacity of T, without its dispatch), and
nothing waits on the host; over full sequences (prefill,
training) each expert runs on its own tokens, sorted by expert, with one
host sync for the counts (:func:`_moe_by_expert`).

Spans (``repro_torch.obs``): ``moe.route``, ``moe.routed`` and
``moe.shared``; counters ``moe.pairs`` (the (token, expert) pairs routed)
and ``moe.rows`` (the rows the routed experts compute, capacity padding
included), both from shapes.

On DTensors (the LM over a mesh) :func:`moe_ffn` runs each rank's own
experts on its own rows' pairs, with the plain path's slots, so the same
pairs drop (:func:`_moe_sharded`).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.core.beam import topk_canonical
from repro_torch.distributed import spmd
from repro_torch.models.common import (ArchConfig, checkpoint_name, dense_init, dot, einsum,
                                       silu, softmax, swiglu, swiglu_init)


def moe_init(generator: torch.Generator, cfg: ArchConfig,
             device: str | torch.device | None = None) -> Dict[str, torch.Tensor]:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = cfg.param_dtype
    p = {
        "router": dense_init(generator, (d, e), d, dt, device),
        "w1": dense_init(generator, (e, d, ff), d, dt, device),   # gate proj
        "w3": dense_init(generator, (e, d, ff), d, dt, device),   # up proj
        "w2": dense_init(generator, (e, ff, d), ff, dt, device),  # down proj
    }
    shared = getattr(cfg, "n_shared_experts", 0)
    if shared:
        p["shared"] = swiglu_init(generator, d, shared * ff, dt, device)
    return p


def _route(p, x2d: torch.Tensor, cfg: ArchConfig):
    """x2d [T, d] -> (weights [T, K], experts [T, K], probs [T, E])."""
    logits = dot(x2d, p["router"]).float()                  # [T, E]
    probs = softmax(logits, -1)
    experts = torch.arange(cfg.n_experts, device=x2d.device).expand_as(probs)
    idx, w = topk_canonical(probs, experts, cfg.experts_per_token)   # [T, K]
    if getattr(cfg, "norm_topk_prob", True):
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renormalize
    else:
        w = w * cfg.routed_scale
    return w, idx, probs


def moe_capacity(n_tokens: int, cfg: ArchConfig) -> int:
    cap = math.ceil(
        n_tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts
    )
    return max(8, cap)


def _queue_slots(flat_e: torch.Tensor, e: int, dim: int) -> torch.Tensor:
    """Each (token, k) pair's slot in its expert's queue: the number of
    earlier pairs along ``dim`` routed to the same expert."""
    onehot = F.one_hot(flat_e, e)
    pos = torch.cumsum(onehot, dim=dim) - onehot
    return pos.gather(-1, flat_e[..., None])[..., 0]


def _sum_over_k(y_tok: torch.Tensor, k: int) -> torch.Tensor:
    """[..., T*K, d] -> [..., T, d], adding each token's K terms in order."""
    y = y_tok.reshape(*y_tok.shape[:-2], -1, k, y_tok.shape[-1])
    out = torch.zeros_like(y[..., 0, :])
    for j in range(k):
        out = out + y[..., j, :]
    return out


def _aux_loss(idx: torch.Tensor, probs: torch.Tensor, e: int, k: int) -> torch.Tensor:
    """Switch-style load-balancing loss."""
    onehot = F.one_hot(idx.reshape(-1, k), e).float().sum(1)   # [T, E]
    frac_tokens = onehot.mean(0) / k
    return e * torch.sum(frac_tokens * probs.mean(0))


def moe_ffn_grouped(p, x: torch.Tensor, cfg: ArchConfig, w: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """Grouped dispatch of the routing ``w``, ``idx`` ``[T, K]``: per-batch-row
    expert queues (capacity per row and expert, ``ceil(S·K·capacity_factor
    / E)``)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    capg = max(1, math.ceil(s * k * cfg.capacity_factor / e))
    obs.count("moe.rows", b * e * capg)
    w = w.reshape(b, s, k)
    idx = idx.reshape(b, s, k)

    flat_e = idx.reshape(b, s * k)                           # [B, S*K]
    slot = _queue_slots(flat_e, e, dim=1)
    keep = slot < capg
    dest = torch.where(keep, flat_e * capg + slot, torch.full_like(flat_e, e * capg))

    tok_of = torch.arange(s, device=x.device).repeat_interleave(k)   # [S*K]
    x_rep = x[:, tok_of, :]                                  # [B, S*K, d]
    rows = torch.arange(b, device=x.device)[:, None]
    buf = torch.zeros((b, e * capg + 1, d), dtype=x.dtype, device=x.device)
    buf[rows, dest] = x_rep
    xin = checkpoint_name(buf[:, : e * capg].reshape(b, e, capg, d), "moe_xin")

    h = silu(einsum("becd,edf->becf", xin, p["w1"])) * einsum("becd,edf->becf", xin, p["w3"])
    out_e = checkpoint_name(einsum("becf,efd->becd", h, p["w2"]), "moe_out")  # [B,E,capg,d]

    flat_out = torch.cat(
        [out_e.reshape(b, e * capg, d),
         torch.zeros((b, 1, d), dtype=out_e.dtype, device=x.device)], dim=1)
    gathered = flat_out[rows, dest]                          # [B, S*K, d]
    y_tok = gathered * (w.reshape(b, s * k)[..., None] * keep[..., None]).to(x.dtype)
    return _sum_over_k(y_tok, k)                             # [B, S, d]


def moe_ffn(p, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux_loss scalar)."""
    if isinstance(x, DTensor):
        return _moe_sharded(p, x, cfg)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    dropless = getattr(cfg, "moe_dropless", False)
    with obs.span("moe.route", device=x.device):
        w, idx, probs = _route(p, x.reshape(-1, d), cfg)
        obs.count("moe.pairs", b * s * k)
    with obs.span("moe.routed", device=x.device):
        if dropless:
            y = _moe_by_expert(p, x, w, idx) if s > 1 else _moe_every_expert(p, x, w, idx)
        elif cfg.moe_dispatch == "grouped":
            y = moe_ffn_grouped(p, x, cfg, w, idx)
        else:
            y = _moe_global(p, x, cfg, w, idx, moe_capacity(b * s, cfg))
    if "shared" in p:
        with obs.span("moe.shared", device=x.device):
            y = y + swiglu(p["shared"], x)
    return y, _aux_loss(idx, probs, e, k)


def _moe_global(p, x: torch.Tensor, cfg: ArchConfig, w: torch.Tensor, idx: torch.Tensor,
                cap: int) -> torch.Tensor:
    """Global dispatch of the routing ``w``, ``idx`` ``[T, K]`` over one
    token stream, ``cap`` slots an expert."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    x2 = x.reshape(t, d)
    obs.count("moe.rows", e * cap)

    # position of each (token, k) in its expert's queue
    flat_e = idx.reshape(-1)                                 # [T*K]
    slot = _queue_slots(flat_e, e, dim=0)
    keep = slot < cap
    dest = torch.where(keep, flat_e * cap + slot, torch.full_like(flat_e, e * cap))

    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    tok_of = torch.arange(t, device=x.device).repeat_interleave(k)   # [T*K]
    buf[dest] = x2[tok_of]
    xin = checkpoint_name(buf[: e * cap].reshape(e, cap, d), "moe_xin")

    h = silu(einsum("ecd,edf->ecf", xin, p["w1"])) * einsum("ecd,edf->ecf", xin, p["w3"])
    out_e = checkpoint_name(einsum("ecf,efd->ecd", h, p["w2"]), "moe_out")  # [E, cap, d]

    flat_out = torch.cat(
        [out_e.reshape(e * cap, d), torch.zeros((1, d), dtype=out_e.dtype, device=x.device)])
    y_tok = flat_out[dest] * (w.reshape(-1)[:, None] * keep[:, None]).to(x.dtype)
    return _sum_over_k(y_tok, k).reshape(b, s, d)


def _moe_every_expert(p, x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Every (token, expert) pair of the routing ``w``, ``idx`` ``[T, K]``,
    dropless, at a few tokens: each expert runs on all T tokens (``[E, T,
    d]``, the products of the capacity path at a capacity of T, where every
    expert's weights are read once), and each pair's output is picked and
    weighed, the K summed. Nothing is dispatched and nothing waits on the
    host."""
    b, s, d = x.shape
    t, k = idx.shape
    e = p["w1"].shape[0]
    obs.count("moe.rows", e * t)
    xin = x.reshape(1, t, d).expand(e, t, d)
    h = silu(einsum("ecd,edf->ecf", xin, p["w1"])) * einsum("ecd,edf->ecf", xin, p["w3"])
    out_e = einsum("ecf,efd->ecd", h, p["w2"])                      # [E, T, d]
    pairs = out_e[idx, torch.arange(t, device=x.device)[:, None]]   # [T, K, d]
    return (pairs * w[..., None].to(x.dtype)).sum(1).reshape(b, s, d)


def _moe_by_expert(p, x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Every (token, expert) pair of the routing ``w``, ``idx`` ``[T, K]``,
    dropless: the pairs sorted by expert (stably, so each expert's tokens
    keep their order) and each expert run on its own tokens, as DeepSeek's
    ``moe_infer`` runs them; one host sync reads the per-expert counts.
    Nothing of ``[E, T, d]`` is allocated: at an 8,192-token prefill the
    pairs' rows are ``[T*K, d]``."""
    b, s, d = x.shape
    t, k = idx.shape
    x2 = x.reshape(t, d)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=p["w1"].shape[0]).tolist()
    obs.count("moe.rows", t * k)
    out = torch.empty((t * k, d), dtype=x.dtype, device=x.device)
    start = 0
    for j, n in enumerate(counts):
        if n:
            pairs = order[start:start + n]
            out[pairs] = swiglu({n_: p[n_][j] for n_ in ("w1", "w3", "w2")}, x2[pairs // k])
        start += n
    y_tok = out * w.reshape(-1, 1).to(x.dtype)
    return _sum_over_k(y_tok, k).reshape(b, s, d)


def _dispatch_slots(flat_e: torch.Tensor, e: int, cap: int, scan, mesh):
    """(slot, keep) of each local (token, expert) pair of ``flat_e``
    ``[G, N]``: its place in its expert's queue along its row, plus (a
    global queue, G = 1) the pairs of that expert on the ranks before this
    one along the mesh dims ``scan`` (``spmd.exclusive_scan`` of the
    per-expert counts); kept while under ``cap``."""
    slot = _queue_slots(flat_e, e, dim=1)
    if scan:
        before = spmd.exclusive_scan(F.one_hot(flat_e[0], e).sum(0), scan, mesh)
        slot = slot + before[flat_e]
    return slot, slot < cap


def _expert_blocks(p, mesh, rows):
    """Each rank's blocks of the expert weights for a product on its own
    rows: gathered over the data axes (their FSDP shard; the gradient comes
    back a partial sum over the axes that split the rows), and over the
    model axes either the rank's own experts (``E`` divides them: the rules
    place the experts there) or, for every expert, its slice of ``ff``
    (``w1`` / ``w3`` column-, ``w2`` row-parallel; grok's 8 experts on 16).
    Returns (w1, w3, w2, the first own expert, experts the rank holds)."""
    model = spmd.model_mesh_dims(mesh)
    e = p["w1"].shape[0]
    by_expert = bool(model) and all(isinstance(p["w1"].placements[i], spmd.Shard)
                                    and p["w1"].placements[i].dim == 0 for i in model)
    split = spmd.split_rows(rows)

    def block(w, dim):
        places = tuple(spmd.Shard(0 if by_expert else dim) if i in model else spmd.Replicate()
                       for i in range(mesh.ndim))
        return spmd.local_block(w, places, grad_partial=split)

    w1, w3, w2 = block(p["w1"], 2), block(p["w3"], 2), block(p["w2"], 1)
    if not by_expert:
        return w1, w3, w2, 0, e
    (n, _, _), (first, _, _) = spmd.local_shape(p["w1"].shape, mesh, tuple(
        spmd.Shard(0) if i in model else spmd.Replicate() for i in range(mesh.ndim)))
    return w1, w3, w2, first, n


def _moe_sharded(p, x: DTensor, cfg: ArchConfig) -> Tuple[DTensor, DTensor]:
    """:func:`moe_ffn` on DTensors, on each rank's local blocks.

    The router's logits (sharded over ``E`` with the router) are gathered,
    and every rank of a data group routes its tokens, with the plain path's
    top-k. Each rank then runs its own experts (or its ``ff`` slice of
    every expert, see :func:`_expert_blocks`) on the (token, expert) pairs
    of its own rows; a pair routed to an expert of another model rank goes
    to the scratch row. The outputs are a partial sum over the model axes,
    reduced by the caller with the rest of the layer's.

    Queue slots are the plain path's. ``grouped``: per batch row, so local
    to a data rank. ``global``: over the whole token stream, whose blocks
    the data ranks hold in order: each rank counts its pairs per expert, an
    exclusive scan of those counts over the data ranks gives its offsets,
    and its slots are its local slots plus them, the global cumsum; the
    same pairs drop. Each rank's dispatch buffer is the reference's
    ``[E, cap, d]`` (its own experts) holding its own pairs at their global
    slots, zeros elsewhere, so the buffers of a model rank's data group sum
    to the reference's (a partial sum over data: the reference's
    ``_moe_spec`` keeps ``cap`` whole too). Its expert FLOPs are those of
    the whole capacity, the data axes' size x the single-device count;
    grouped dispatch's buffer is ``[B, E, capg, d]`` with the batch over
    data and the experts over model (``_moe_spec_grouped``), no more than
    the single-device count. The buffers ``moe_xin`` / ``moe_out`` are
    DTensors in those placements, where a remat policy sees them.

    The aux loss's means run over the global token set (reduced over data).
    """
    mesh = x.device_mesh
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    model = spmd.model_mesh_dims(mesh)
    x = spmd.activation_placements(x)
    rows = spmd.batch_placements(x.shape, mesh)
    split = spmd.split_rows(rows)
    logits = dot(x.reshape(b * s, d), p["router"]).float().redistribute(mesh, rows)
    probs = softmax(logits, -1)                                 # [T, E], a DTensor
    # the routing weights feed each rank's own experts' outputs (a partial
    # sum over the model axes); the aux loss reads ``probs`` as it is
    probs_l = spmd.local_block(probs, rows, grad_partial=model)
    x_l = spmd.local_block(x, rows, grad_partial=model)         # [B_l, S, d]
    b_l = x_l.shape[0]
    t_l = b_l * s
    experts = torch.arange(e, device=x_l.device).expand_as(probs_l)
    idx, w = topk_canonical(probs_l, experts, k)                # [T_l, K]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    w1, w3, w2, first, n_own = _expert_blocks(p, mesh, rows)
    grouped = cfg.moe_dispatch == "grouped"
    if grouped:
        cap = max(1, math.ceil(s * k * cfg.capacity_factor / e))
        flat_e = idx.reshape(b_l, s * k)
    else:
        cap = moe_capacity(b * s, cfg)
        flat_e = idx.reshape(1, t_l * k)
    slot, keep = _dispatch_slots(flat_e, e, cap, () if grouped else split, mesh)
    own = (flat_e >= first) & (flat_e < first + n_own)
    scratch = n_own * cap
    dest = torch.where(keep & own, (flat_e - first) * cap + slot,
                       torch.full_like(flat_e, scratch))            # [G, N]
    g = dest.shape[0]
    dest = dest.reshape(g, -1, k)                                   # [G, tokens, K]
    at = torch.arange(g, device=x_l.device)[:, None, None]
    buf = torch.zeros((g, scratch + 1, d), dtype=x_l.dtype, device=x_l.device)
    # each token broadcast to its K pairs (not copied K times)
    buf[at, dest] = x_l.reshape(g, -1, 1, d)
    xin = buf[:, :scratch].reshape(g, n_own, cap, d)
    # the buffers as DTensors of the reference's [B, E, capg, d] / [E, cap, d]
    if grouped:
        lead, shape = rows, (b, e, cap, d)
    else:
        lead = tuple(spmd.Partial() if i in split else spmd.Replicate()
                     for i in range(mesh.ndim))
        shape = (1, e, cap, d)
    places = tuple(spmd.Shard(1) if i in model and n_own < e else lead[i]
                   for i in range(mesh.ndim))
    xin = checkpoint_name(spmd.from_block(xin, mesh, places, shape), "moe_xin").to_local()
    h = silu(einsum("becd,edf->becf", xin, w1)) * einsum("becd,edf->becf", xin, w3)
    out_e = einsum("becf,efd->becd", h, w2)
    out_places = tuple(spmd.Partial() if i in model and n_own == e else p_
                       for i, p_ in enumerate(places))
    out_e = checkpoint_name(spmd.from_block(out_e, mesh, out_places, shape),
                            "moe_out").to_local()
    flat_out = torch.cat([out_e.reshape(g, scratch, d),
                          torch.zeros((g, 1, d), dtype=out_e.dtype, device=x_l.device)], dim=1)
    # the plain path's weighted sum over k, one pair's [G, tokens, d] at a time
    scale = (w.reshape(g, -1, k) * keep.reshape(g, -1, k)).to(x_l.dtype)
    y = torch.zeros((g, dest.shape[1], d), dtype=out_e.dtype, device=x_l.device)
    for j in range(k):
        y = y + flat_out[at[..., 0], dest[..., j]] * scale[..., j, None]
    y = y.reshape(b_l, s, d)
    partial = tuple(spmd.Partial() if i in model else p_ for i, p_ in enumerate(rows))
    y = spmd.from_block(y, mesh, partial, (b, s, d))
    # Switch-style aux loss over the global token set
    counts = F.one_hot(idx, e).float().sum(1).sum(0)               # [E]
    frac_tokens = spmd.reduce_over(counts, [spmd.Replicate()] * mesh.ndim, split,
                                   mesh) / (b * s * k)
    aux = e * torch.sum(frac_tokens * probs.mean(0))
    return y, aux


def moe_dense_ref(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """All-experts dense reference (smoke-test oracle; O(E) compute)."""
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    w, idx, _ = _route(p, x2, cfg)
    h = silu(einsum("td,edf->tef", x2, p["w1"])) * einsum("td,edf->tef", x2, p["w3"])
    y_all = einsum("tef,efd->ted", h, p["w2"])               # [T, E, d]
    gates = torch.zeros((x2.shape[0], cfg.n_experts), dtype=x.dtype, device=x.device)
    gates = gates.scatter(1, idx, w.to(x.dtype))
    return einsum("ted,te->td", y_all, gates).reshape(b, s, d)
