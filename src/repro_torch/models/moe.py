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
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.beam import topk_canonical
from repro_torch.models.common import (ArchConfig, checkpoint_name, dense_init, dot, einsum,
                                       silu, softmax)


def moe_init(generator: torch.Generator, cfg: ArchConfig,
             device: str | torch.device | None = None) -> Dict[str, torch.Tensor]:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = cfg.param_dtype
    return {
        "router": dense_init(generator, (d, e), d, dt, device),
        "w1": dense_init(generator, (e, d, ff), d, dt, device),   # gate proj
        "w3": dense_init(generator, (e, d, ff), d, dt, device),   # up proj
        "w2": dense_init(generator, (e, ff, d), ff, dt, device),  # down proj
    }


def _route(p, x2d: torch.Tensor, cfg: ArchConfig):
    """x2d [T, d] -> (weights [T, K], experts [T, K], probs [T, E])."""
    logits = dot(x2d, p["router"]).float()                  # [T, E]
    probs = softmax(logits, -1)
    experts = torch.arange(cfg.n_experts, device=x2d.device).expand_as(probs)
    idx, w = topk_canonical(probs, experts, cfg.experts_per_token)   # [T, K]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renormalize
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


def moe_ffn_grouped(p, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped dispatch: per-batch-row expert queues (capacity per row and
    expert, ``ceil(S·K·capacity_factor / E)``)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    capg = max(1, math.ceil(s * k * cfg.capacity_factor / e))
    w, idx, probs = _route(p, x.reshape(-1, d), cfg)
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
    y = _sum_over_k(y_tok, k)                                # [B, S, d]
    return y, _aux_loss(idx, probs, e, k)


def moe_ffn(p, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux_loss scalar)."""
    if cfg.moe_dispatch == "grouped":
        return moe_ffn_grouped(p, x, cfg)
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = moe_capacity(t, cfg)
    x2 = x.reshape(t, d)
    w, idx, probs = _route(p, x2, cfg)

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
    y = _sum_over_k(y_tok, k)
    return y.reshape(b, s, d), _aux_loss(idx, probs, e, k)


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
