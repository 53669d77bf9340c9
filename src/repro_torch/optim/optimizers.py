"""Optimizers: AdamW and Adafactor, as pure functions over nested dicts of
tensors.

Counterpart of ``repro.optim.optimizers``. The interface is the reference's:
``init(params) -> state`` and ``update(grads, state, params, lr) -> (params,
state)``, and the state has its keys (``m`` / ``v`` / ``step``; Adafactor's
``v`` holds ``{"vr", "vc"}`` or ``{"v"}`` per leaf), so a checkpoint of it
has the reference's paths. ``step`` is an int32 0-d tensor, and every scalar
of the schedule and the bias corrections is an f32 0-d tensor on the
parameters' device, as JAX computes a Python float against an f32 array.

``update`` writes the parameters and the moment tensors in place (the
reference donates both to its jitted step) and returns them; it leaves
``grads`` as they were. Adafactor works a stacked leaf (``[L, ...]``, three
or more dims) one layer at a time, in two passes: its RMS clip takes a mean
over the whole leaf, so the first pass updates the moments and sums the
squared update, and the second recomputes the update and applies it. At
yi-6b's width that keeps its temporaries to a layer's slice (~180 MB), where
the reference's per-leaf expressions would hold four copies of a 5.77 GB
leaf at once.

On DTensors (the LM over a mesh) each update first brings every gradient to
its parameter's placements (:func:`match_placements`: a reduce-scatter
where autograd leaves a partial sum), and the state follows
``shard_opt_state``, so each rank updates its own blocks. The reductions
that span a leaf (AdamW's global norm, Adafactor's factored means and its
whole-leaf RMS) are DTensor reductions: partial sums over the sharded dims,
reduced over every mesh axis they span: an MoE expert leaf ``[L, E, d, ff]``
is sharded on two of its dims (experts and ``d``, or ``d`` and ``ff``), and
its factored row and column means and whole-leaf RMS reduce over both.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Tuple

import torch
from torch.distributed.tensor import DTensor

Params = Any
State = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], State]
    update: Callable[[Params, State, Params, torch.Tensor], Tuple[Params, State]]
    name: str = "opt"


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (nested dicts with the same keys)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree) -> Iterator[torch.Tensor]:
    """The leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _placed(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s placements when both are DTensors."""
    if isinstance(x, DTensor) and tuple(x.placements) != tuple(like.placements):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def match_placements(grads: Params, params: Params) -> Params:
    """``grads`` with each DTensor redistributed to its parameter's
    placements (plain tensors as they are)."""
    return _tree_map(_placed, grads, params)


def _sub_into(p: torch.Tensor, delta: torch.Tensor) -> None:
    """``p <- (f32(p) - delta)`` in ``p``'s dtype."""
    if p.dtype == torch.float32:
        p.sub_(delta)
    else:
        p.copy_(p.float() - delta)


def warmup_cosine(step: torch.Tensor, *, peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup -> cosine decay to floor·peak (f32, on ``step``'s
    device); 0 at step 0."""
    s = step.float()
    warm = peak * s / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(_f32(torch.pi, s) * frac))
    return torch.where(s < warmup, warm, cos)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01, clip_norm: float = 1.0) -> Optimizer:
    def init(params: Params) -> State:
        zeros = _tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return {"m": zeros, "v": _tree_map(torch.clone, zeros),
                "step": torch.zeros((), dtype=torch.int32, device=_device(params))}

    def update(grads, state, params, lr):
        grads = clip_by_global_norm(match_placements(grads, params), clip_norm)
        t = state["step"] + 1
        tf = t.float()
        c1 = 1 - _f32(b1, tf) ** tf
        c2 = 1 - _f32(b2, tf) ** tf

        def upd(p, g, m, v):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            step_ = (m / c1).div_((v / c2).sqrt_().add_(eps))
            if weight_decay:
                step_.add_(weight_decay * p.float())
            _sub_into(p, lr * step_)
            return p

        new_params = _tree_map(upd, params, grads, state["m"], state["v"])
        return new_params, {"m": state["m"], "v": state["v"], "step": t}

    return Optimizer(init=init, update=update, name="adamw")


def _device(params: Params) -> torch.device:
    return next(_leaves(params)).device


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), momentum-free, factored v for ndim >= 2
# ---------------------------------------------------------------------------

def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, min_dim_factor: int = 2) -> Optimizer:
    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] >= min_dim_factor and shape[-2] >= min_dim_factor

    def init(params: Params) -> State:
        def per_leaf(p):
            if _factored(p.shape):
                return {
                    "vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),          # row
                    "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32),  # col
                }
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"v": _tree_map(per_leaf, params),
                "step": torch.zeros((), dtype=torch.int32, device=_device(params))}

    def update(grads, state, params, lr):
        grads = match_placements(grads, params)
        t = state["step"] + 1
        beta2 = 1.0 - (t.float() + 1.0) ** -0.8

        def move_moments(g, s):
            """Move the second-moment slices ``s`` on by ``g``."""
            g2 = g.float().square().add_(eps)
            if "vr" in s:
                s["vr"].mul_(beta2).add_(_placed((1 - beta2) * g2.mean(dim=-1), s["vr"]))
                s["vc"].mul_(beta2).add_(_placed((1 - beta2) * g2.mean(dim=-2), s["vc"]))
            else:
                s["v"].mul_(beta2).add_(_placed((1 - beta2) * g2, s["v"]))

        def update_of(g, s):
            """The unclipped update of ``g`` under the moments ``s``."""
            if "vr" in s:
                vr, vc = s["vr"], s["vc"]
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)[..., None])
                return g.float() * _placed(denom.clamp_(min=eps).rsqrt_(), g)
            return g.float() * _placed(torch.rsqrt(torch.clamp(s["v"], min=eps)), g)

        def per_leaf(p, g, s):
            # a stacked leaf one layer at a time: its factored axes are the
            # last two, so each layer's moments are its own
            parts = range(p.shape[0]) if p.dim() >= 3 else (...,)
            sq = 0.0
            for i in parts:
                s_i = {k: v[i] for k, v in s.items()}
                move_moments(g[i], s_i)
                sq = update_of(g[i], s_i).square().sum() + sq
            # update clipping (RMS over the whole leaf)
            rms = torch.sqrt(sq / p.numel() + eps)
            scale = torch.clamp(rms / clip_threshold, min=1.0)
            for i in parts:
                upd = update_of(g[i], {k: v[i] for k, v in s.items()}).div_(scale)
                if weight_decay:
                    upd.add_(weight_decay * p[i].float())
                p_i = p[i]
                _sub_into(p_i, _placed(lr * upd, p_i))
            return p

        new_params = _tree_map(per_leaf, params, grads, state["v"])
        return new_params, {"v": state["v"], "step": t}

    return Optimizer(init=init, update=update, name="adafactor")


def get_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return adamw()
    if name == "adafactor":
        return adafactor()
    raise ValueError(f"unknown optimizer {name}")


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """``grads`` scaled so that their global L2 norm is at most
    ``max_norm`` (new tensors; the squares summed in the reference's leaf
    order)."""
    sq = None
    for g in _leaves(grads):
        s = torch.sum(torch.square(g.float()))
        sq = s if sq is None else sq + s
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


# ---------------------------------------------------------------------------
# Error-feedback gradient compression (pod-axis all-reduce payload reduction)
# ---------------------------------------------------------------------------

def ef_compress(grads: Params, residual: Params, dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[Params, Params]:
    """Compress grads to ``dtype`` with error feedback.

    Returns (compressed grads — what would cross a slow inter-node link —
    and the new residual). The residual re-enters next step, so the
    quantization error is not lost, only delayed (EF-SGD)."""
    def per_leaf(g, r):
        full = g.float() + r
        c = full.to(dtype)
        return c, full - c.float()

    pairs = _tree_map(per_leaf, grads, residual)
    return _tree_map(lambda pr: pr[0], pairs), _tree_map(lambda pr: pr[1], pairs)


def ef_init(params: Params) -> Params:
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
