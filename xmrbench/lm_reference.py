"""The plain reference of the ``lm_decode`` kind: the full forward pass of
one sequence through a decoder of MLA attention and SwiGLU feed-forward
blocks (MiniCPM3's), in plain ``torch``, float32, TF32 off.

No cache, no batching, nothing of the program: it imports no module of
``repro_torch`` and reads only the weights the benchmark drew (a nested
dict in the program's layout, stacked layers on a leading axis) and the
tokens. Each block, with ``x`` the residual stream of the sequence's ``S``
tokens:

    h     = RMSNorm(x) * ln1
    c_q   = RMSNorm(h W_dq) * q_norm;  q = c_q W_uq  -> per head [nope | rope]
    c_kv  = RMSNorm(h W_dkv) * kv_norm; k_r = h W_kr (one rotary key, shared by the heads)
    k, v  = c_kv W_ukv -> per head [k_nope | v];  k = [k_nope | RoPE(k_r)]
    q     = [q_nope | RoPE(q_rope)]
    x    += softmax(q k^T / sqrt(nope + rope), causal) v  W_o
    x    += (silu(h2 W_1) * h2 W_3) W_2,  h2 = RMSNorm(x) * ln2

then ``RMSNorm(x) * final_norm`` and the head ``W_lm``. RoPE rotates the
two halves of each rotary vector (theta ``rope_theta``, frequencies
``theta^(-2i/rope)``); RMSNorm's epsilon is 1e-6. Attention runs in blocks
of queries, each against the keys up to its last row, so that the scores
fit.

Departures from the published MiniCPM3-4B, as the port's configuration
has them: MiniCPM's ``scale_emb``, ``scale_depth`` and ``dim_model_base``
scalings (of the embeddings, the residual branches and the logits) are not
applied; the published rotary scaling (LongRoPE) is not applied, RoPE is
plain at theta 10,000; RMSNorm's epsilon is the port's 1e-6.

``dtype`` below float32 gives the control: the weights rounded to it and
every activation kept in it (norms and softmax computed in float32 and
rounded back), as a program serving in that precision would.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

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


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """``x`` [S, ..., r] rotated at positions ``pos`` [S]."""
    r = x.shape[-1]
    freq = theta ** (-torch.arange(0, r, 2, dtype=torch.float32, device=x.device) / r)
    ang = pos.float()[:, None] * freq                               # [S, r/2]
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (r // 2,)
    c, s = torch.cos(ang).reshape(shape), torch.sin(ang).reshape(shape)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _attention(q, k, v, qblock: int) -> torch.Tensor:
    """Causal attention of q [S, H, dq] on k [S, H, dq], v [S, H, dv]."""
    s_len = q.shape[0]
    scale = 1.0 / math.sqrt(q.shape[-1])
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


def forward(weights: Dict, model: Dict, tokens: torch.Tensor, rows: Sequence[int], *,
            dtype: torch.dtype = torch.float32, qblock: int = 1024) -> torch.Tensor:
    """Logits ``[len(rows), vocab]`` (float32) at positions ``rows`` of the
    sequence ``tokens`` [S] (ids in range)."""
    no_tf32()
    n_layers, h_n = int(model["n_layers"]), int(model["n_heads"])
    nope, rope, vd = int(model["qk_nope_dim"]), int(model["qk_rope_dim"]), int(model["v_head_dim"])
    theta = float(model["rope_theta"])
    s_len = tokens.shape[0]
    pos = torch.arange(s_len, device=tokens.device)
    layers = weights["layers"]
    with torch.no_grad():
        x = weights["embed"][tokens.long()].to(dtype)
        for i in range(n_layers):
            a = {k: t[i].to(dtype) for k, t in layers["attn"].items()}
            f = {k: t[i].to(dtype) for k, t in layers["ffn"].items()}
            h = _rms(x, layers["ln1"][i])
            q = (_rms(h @ a["wdq"], a["q_norm"]) @ a["wuq"]).reshape(s_len, h_n, nope + rope)
            q = torch.cat([q[..., :nope], _rope(q[..., nope:], pos, theta)], dim=-1)
            ckv = _rms(h @ a["wdkv"], a["kv_norm"])
            k_r = _rope((h @ a["wkr"])[:, None, :], pos, theta)      # [S, 1, rope]
            kv = (ckv @ a["wukv"]).reshape(s_len, h_n, nope + vd)
            k = torch.cat([kv[..., :nope], k_r.expand(s_len, h_n, rope)], dim=-1)
            out = _attention(q, k, kv[..., nope:], qblock)
            x = x + out.reshape(s_len, h_n * vd) @ a["wo"]
            h2 = _rms(x, layers["ln2"][i])
            x = x + (torch.nn.functional.silu(h2 @ f["w1"]) * (h2 @ f["w3"])) @ f["w2"]
        idx = torch.as_tensor(list(rows), device=x.device)
        x = _rms(x[idx], weights["final_norm"])
        return (x @ weights["lm_head"].to(dtype)).float()
