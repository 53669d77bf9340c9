"""The plain reference that the port's DeepSeek-V2 tests hold it to: the
full forward pass of one sequence through DeepSeek-V2's decoder (MLA
attention without q LoRA under YaRN, leading dense layers, then MoE layers
of routed and shared experts), in plain ``torch``, float32, TF32 off. The
benchmark keeps its own copy (``xmrbench/lm_moe_reference.py``).

No cache, no batching, nothing of the program: it imports no module of
``repro_torch`` and reads only the weights (a nested dict in the program's
layout: ``dense_layers`` for the leading dense layers and ``layers`` for
the MoE layers, each stacked on a leading axis) and the tokens. Each block,
with ``x`` the residual stream of the sequence's ``S`` tokens at positions
``0 .. S-1``:

    h     = RMSNorm(x) * ln1
    q     = h W_q -> per head [q_nope (128) | q_rope (64)]
    c_kv  = RMSNorm(h W_dkv) * kv_norm;  k_r = h W_kr (one rotary key, shared by the heads)
    k, v  = c_kv W_ukv -> per head [k_nope | v]
    k     = [k_nope | RoPE(k_r)],  q = [q_nope | RoPE(q_rope)]
    x    += softmax(q k^T * scale, causal) v  W_o
    h2    = RMSNorm(x) * ln2
    dense layer:  x += (silu(h2 W_1) * h2 W_3) W_2
    MoE layer:    p = softmax(h2 W_router)  (f32, over the E routed experts)
                  top-K experts by p, ties to the lowest id; w_k = p_k * routed_scale
                  (renormalised to sum 1 first where norm_topk_prob)
                  x += sum_k w_k E_k(h2) + S(h2)

``E_e`` is routed expert ``e``'s SwiGLU (``moe_d_ff``), each run on its own
tokens in a loop over the experts, as DeepSeek's ``moe_infer`` runs them;
``S`` the shared experts' one SwiGLU of ``n_shared_experts * moe_d_ff``.
Then ``RMSNorm(x) * final_norm`` and the head ``W_lm``. RMSNorm's epsilon
is 1e-6.

RoPE rotates the two halves of each rotary vector (DeepSeek interleaves
pairs: a fixed permutation of the rotary columns of ``W_q`` and ``W_kr``,
which with drawn weights is a layout). YaRN, with ``i`` over the
``rope / 2`` pairs and ``f_i = theta^(-2i/rope)``:

    corr(r) = rope * ln(original / (2 pi r)) / (2 ln theta)
    low = max(floor(corr(beta_fast)), 0),  high = min(ceil(corr(beta_slow)), rope - 1)
    ramp_i = clamp((i - low) / (high - low), 0, 1)
    f'_i = (f_i / factor) * ramp_i + f_i * (1 - ramp_i)
    cos, sin times m(factor, mscale) / m(factor, mscale_all_dim),  m(s, mu) = 0.1 mu ln s + 1
    scale = (nope + rope)^-1/2 * m(factor, mscale_all_dim)^2

(DeepSeek-V2-Lite: low 10, high 23, the cos and sin factor 1, the scale
``192^-1/2 * 1.58963``.) Attention runs in blocks of queries, each against
the keys up to its last row, so that the scores fit.

``dtype`` below float32 gives the control: the weights rounded to it and
every activation kept in it (norms, the router's and the attention's
softmax computed in float32 and rounded back), as a program serving in
that precision would.

``with_margins`` also returns each row's routing margins, one a MoE layer:
the gap between the router's K-th and (K+1)-th largest logits (float32).
Where a margin is within the rounding of two float32 programs, the two may
route the token differently, each rightly. ``swap`` gives that other
routing: at each ``(row, MoE layer)`` it names, the row's K-th expert is
replaced by its (K+1)-th, weighed by that expert's probability.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

EPS = 1e-6


def no_tf32() -> None:
    """Float32 products in float32 (the card would otherwise take TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    scale = scale.to(x.dtype).float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + EPS) * scale).to(x.dtype)


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _rope(x: torch.Tensor, pos: torch.Tensor, model: Dict) -> torch.Tensor:
    """``x`` [S, ..., r] rotated at positions ``pos`` [S] under YaRN."""
    r = x.shape[-1]
    theta = float(model["rope_theta"])
    factor, original = float(model["yarn_factor"]), float(model["yarn_original_max_position"])
    # DeepSeek-V2's float32 operations (DeepseekV2YarnRotaryEmbedding)
    pows = theta ** (torch.arange(0, r, 2, dtype=torch.float32, device=x.device) / r)
    freq_extra, freq_inter = 1.0 / pows, 1.0 / (factor * pows)

    def corr(rotations):
        return r * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr(float(model["yarn_beta_fast"]))), 0)
    high = min(math.ceil(corr(float(model["yarn_beta_slow"]))), r - 1)
    if high == low:
        high += 0.001
    i = torch.arange(r // 2, dtype=torch.float32, device=x.device)
    mask = 1.0 - ((i - low) / (high - low)).clamp(0, 1)
    freq = freq_inter * (1 - mask) + freq_extra * mask
    m = (_mscale(factor, float(model["yarn_mscale"]))
         / _mscale(factor, float(model["yarn_mscale_all_dim"])))
    ang = pos.float()[:, None] * freq                               # [S, r/2]
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (r // 2,)
    c, s = (torch.cos(ang) * m).reshape(shape), (torch.sin(ang) * m).reshape(shape)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def softmax_scale(model: Dict) -> float:
    m = _mscale(float(model["yarn_factor"]), float(model["yarn_mscale_all_dim"]))
    return (int(model["qk_nope_dim"]) + int(model["qk_rope_dim"])) ** -0.5 * m * m


def _attention(q, k, v, scale: float, qblock: int) -> torch.Tensor:
    """Causal attention of q [S, H, dq] on k [S, H, dq], v [S, H, dv]."""
    s_len = q.shape[0]
    out = torch.empty((s_len,) + v.shape[1:], dtype=v.dtype, device=v.device)
    for q0 in range(0, s_len, qblock):
        q1 = min(s_len, q0 + qblock)
        scores = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]).float() * scale
        keep = (torch.arange(q1, device=q.device)[None, :]
                <= torch.arange(q0, q1, device=q.device)[:, None])
        scores.masked_fill_(~keep, -torch.inf)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out[q0:q1] = torch.einsum("hqk,khd->qhd", probs, v[:q1])
    return out


def _swiglu(x, w1, w3, w2):
    return (torch.nn.functional.silu(x @ w1) * (x @ w3)) @ w2


def _moe(h: torch.Tensor, f: Dict, model: Dict, dtype: torch.dtype, swap: Sequence[int] = ()):
    """The routed experts' weighted sum plus the shared experts, each routed
    expert on its own tokens, the rows ``swap`` routed to their (K+1)-th
    expert in place of their K-th; and each token's routing margin."""
    k = int(model["experts_per_token"])
    logits = (h @ f["router"]).float()                               # [S, E]
    top = logits.topk(k + 1, dim=-1).values
    margin = top[:, k - 1] - top[:, k]
    probs = torch.softmax(logits, dim=-1)
    # descending, stable: among equal probabilities the lowest id first
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    if swap:
        rows = torch.as_tensor(list(swap), device=h.device)
        top_p[rows, k - 1:k + 1] = top_p[rows, k - 1:k + 1].flip(-1)
        top_e[rows, k - 1:k + 1] = top_e[rows, k - 1:k + 1].flip(-1)
    w, idx = top_p[:, :k], top_e[:, :k]
    if model["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    else:
        w = w * float(model["routed_scale"])
    w = w.to(dtype)
    pair_out = torch.zeros(idx.shape + (h.shape[-1],), dtype=dtype, device=h.device)
    for e in range(probs.shape[-1]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            pair_out[tok, slot] = _swiglu(h[tok], f["w1"][e], f["w3"][e], f["w2"][e])
    y = (pair_out * w[..., None]).sum(1)
    sh = f["shared"]
    return y + _swiglu(h, sh["w1"], sh["w3"], sh["w2"]), margin


def _cast(tree, i: int, dtype):
    return {k: _cast(v, i, dtype) if isinstance(v, dict) else v[i].to(dtype)
            for k, v in tree.items()}


def forward(weights: Dict, model: Dict, tokens: torch.Tensor, rows: Sequence[int], *,
            dtype: torch.dtype = torch.float32, qblock: int = 1024, with_margins: bool = False,
            swap: Sequence[Tuple[int, int]] = ()):
    """Logits ``[len(rows), vocab]`` (float32) at positions ``rows`` of the
    sequence ``tokens`` [S] (ids in range); with ``with_margins``, also the
    rows' routing margins ``[len(rows), MoE layers]``. ``swap``: ``(row,
    MoE layer)`` pairs routed to the (K+1)-th expert in place of the K-th."""
    no_tf32()
    h_n = int(model["n_heads"])
    nope, rope, vd = int(model["qk_nope_dim"]), int(model["qk_rope_dim"]), int(model["v_head_dim"])
    n_dense = int(model["first_k_dense"])
    scale = softmax_scale(model)
    s_len = tokens.shape[0]
    pos = torch.arange(s_len, device=tokens.device)
    margins = []
    with torch.no_grad():
        x = weights["embed"][tokens.long()].to(dtype)
        for i in range(int(model["n_layers"])):
            stack, j = (weights["dense_layers"], i) if i < n_dense else (weights["layers"],
                                                                        i - n_dense)
            lp = _cast(stack, j, dtype)
            a = lp["attn"]
            h = _rms(x, stack["ln1"][j])
            q = (h @ a["wq"]).reshape(s_len, h_n, nope + rope)
            q = torch.cat([q[..., :nope], _rope(q[..., nope:], pos, model)], dim=-1)
            ckv = _rms(h @ a["wdkv"], a["kv_norm"])
            k_r = _rope((h @ a["wkr"])[:, None, :], pos, model)      # [S, 1, rope]
            kv = (ckv @ a["wukv"]).reshape(s_len, h_n, nope + vd)
            k = torch.cat([kv[..., :nope], k_r.expand(s_len, h_n, rope)], dim=-1)
            out = _attention(q, k, kv[..., nope:], scale, qblock)
            x = x + out.reshape(s_len, h_n * vd) @ a["wo"]
            h2 = _rms(x, stack["ln2"][j])
            f = lp["ffn"]
            if i < n_dense:
                x = x + _swiglu(h2, f["w1"], f["w3"], f["w2"])
            else:
                y, margin = _moe(h2, f, model, dtype,
                                 [r for r, layer in swap if layer == i - n_dense])
                x = x + y
                margins.append(margin)
        idx = torch.as_tensor(list(rows), device=x.device)
        logits = (_rms(x[idx], weights["final_norm"]) @ weights["lm_head"].to(dtype)).float()
        if not with_margins:
            return logits
        return logits, torch.stack(margins, -1)[idx] if margins else logits.new_empty(len(idx), 0)
