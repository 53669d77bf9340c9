"""Shared model components: config schema, norms, RoPE, initializers.

Counterpart of ``repro.models.common``. One :class:`ArchConfig` covers all
ten architecture families; the family field selects the code path in
:mod:`repro_torch.models.lm`.

Parameters keep the reference's layout (nested dicts, a leading ``L`` axis
on stacked layer leaves), so a parameter's key is the reference's checkpoint
key. Random initializers take an explicit ``torch.Generator`` where the
reference takes a PRNG key; the draws differ from ``jax.random``'s, so tests
carry the reference's weights across with
:func:`repro_torch.convert.lm_params_from_numpy`.

Mixed dtypes follow JAX's promotion: :func:`dot` and :func:`einsum` compute
in the promoted dtype of their operands (``f32 x bf16 -> f32``), and a
product of bf16 operands is summed in f32 and rounded to bf16 once, as the
reference's CPU backend computes it. ``torch.matmul`` would refuse the mixed
pair.

``get_abstract_mesh`` has no counterpart: the reference uses it to skip
sharding constraints outside a device mesh; the port's constraints act on
DTensors (:mod:`repro_torch.distributed.spmd`) and pass plain tensors
through. :func:`dot`, :func:`einsum` and :func:`softmax` keep their
promotions on DTensors (the casts are elementwise, on each rank's block);
:func:`cross_entropy_loss` takes vocab-sharded logits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.core.tree import resolve_device
from repro_torch.distributed import spmd


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | encdec | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # attention
    attn_type: str = "gqa"          # gqa | mla | none
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None   # hymba SWA width
    global_every: int = 0           # every k-th layer is full attention (0=all)

    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM (rwkv6 / hymba-mamba)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0

    # enc-dec (seamless)
    n_enc_layers: int = 0

    # MLA decode: absorbed (projections folded into q / out) vs naive expand
    mla_absorb: bool = False

    # Kept so configs compare equal with the reference's; no effect here
    # (the port's layer loop is Python, always unrolled).
    unroll_layers: bool = False

    # chunked attention: online softmax over key blocks, never materializes
    # the [S,S] score matrix
    attn_impl: str = "naive"        # naive | chunked
    attn_kblock: int = 1024
    attn_qblock: int = 2048
    # mixed precision: bf16 activations + bf16 weight use (f32 master params)
    activations_bf16: bool = False
    # Sharding knobs of the reference (its with_sharding_constraint calls
    # that steer XLA's partitioner), kept so configs compare equal. Neither
    # changes a value, on one card or on a mesh. On a mesh the port lays
    # out by the layouts those constraints ask for whatever the knobs say:
    # MLA's attention by heads over "model" where they divide it, else by
    # the query sequence (_attn_act_specs); the MoE dispatch buffers with
    # the experts over "model" where they divide it and, for grouped
    # dispatch, the batch rows over "data" (_moe_spec_grouped) (see
    # attention._mla_full_sharded, moe._moe_sharded).
    moe_shard_constraints: bool = False
    attn_act_shard: str = "none"
    # keep attention scores in bf16 end-to-end
    attn_scores_bf16: bool = False
    # remat of a layer under autograd (models.lm._remat): full | dots | moe |
    # none
    remat_policy: str = "full"
    # MoE dispatch: "global" (one token stream) or "grouped" (per-batch-row
    # queues, see moe.moe_ffn_grouped)
    moe_dispatch: str = "global"

    # modality frontend stub (audio frames / vision patches)
    frontend: Optional[str] = None  # audio | vision
    frontend_tokens: int = 0        # image tokens per example (vlm)

    # training knobs
    optimizer: str = "adamw"        # adamw | adafactor (large MoE)
    remat: bool = True
    param_dtype: Any = torch.float32
    activ_dtype: Any = torch.bfloat16
    tie_embeddings: bool = False

    # long-context capability: sub-quadratic path exists for this arch
    @property
    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (enc-dec included)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for rooflines."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.attn_type == "mla":
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        elif self.attn_type == "gqa":
            attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.head_dim * d
        else:
            attn = 0
        if self.family == "ssm":  # rwkv6: time-mix + channel-mix
            h = self.ssm_heads * self.ssm_head_dim
            attn = 4 * d * h + h * d  # r,k,v,g,out (w is low-rank, small)
            ffn = 2 * d * ff  # channel mix has 2 mats + small r
        elif self.n_experts:
            ffn = 3 * d * self.moe_d_ff * self.n_experts + d * self.n_experts
        else:
            ffn = 3 * d * ff
        if self.family == "hybrid":
            h = self.ssm_heads * self.ssm_head_dim
            attn += 3 * d * h  # mamba in/out/gate projections (approx)
        blocks = L * (attn + ffn)
        if self.family == "encdec":
            enc_attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) + d * d
            blocks += self.n_enc_layers * (enc_attn + 3 * d * ff) + L * (2 * d * d)
        return emb + blocks

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.n_experts:
            return self.n_params()
        full = self.n_params()
        expert_p = self.n_layers * 3 * self.d_model * self.moe_d_ff * self.n_experts
        active_e = expert_p * self.experts_per_token / self.n_experts
        return int(full - expert_p + active_e)


@dataclasses.dataclass(frozen=True)
class YaRN:
    """YaRN's rotary scaling, as DeepSeek-V2's ``rope_scaling`` (type
    ``yarn``) states it: the rotary frequencies between the correction dims
    of ``beta_fast`` and ``beta_slow`` rotations over
    ``original_max_position`` positions blended towards ``1 / factor`` of
    themselves (see :func:`rope_angles`), and the softmax scale times
    ``yarn_mscale(factor, mscale_all_dim) ** 2``."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    """An architecture that the port registers and the JAX package does not
    (``configs.base.PORT_ARCH_IDS``): :class:`ArchConfig`'s fields, with
    their meanings, and the settings that only such architectures use, so
    that the ten shared configurations keep the reference's fields. An MLA
    model with ``q_lora_rank`` 0 projects its query with one ``wq``.

    These run on one card: the DTensor program refuses them
    (``models.lm``)."""

    # shared experts: one SwiGLU of n_shared_experts * moe_d_ff that every
    # token of an MoE layer runs, added to the routed experts' sum
    n_shared_experts: int = 0
    # leading layers whose feed-forward is a dense SwiGLU of d_ff
    first_k_dense: int = 0
    # renormalise the top-k routing weights to sum to 1; otherwise they are
    # the router's probabilities times routed_scale
    norm_topk_prob: bool = True
    routed_scale: float = 1.0
    # route every (token, expert) pair: no capacity, nothing dropped
    moe_dropless: bool = False
    # rotary scaling of the MLA's rotary dims (None: plain RoPE)
    yarn: Optional[YaRN] = None

    def n_params(self) -> int:
        d, h, V, L = self.d_model, self.n_heads, self.vocab, self.n_layers
        nope, rope, vd = self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim
        q = (d * self.q_lora_rank + self.q_lora_rank * h * (nope + rope) if self.q_lora_rank
             else d * h * (nope + rope))
        attn = q + d * (self.kv_lora_rank + rope) + self.kv_lora_rank * h * (nope + vd) + h * vd * d
        k = self.first_k_dense if self.n_experts else 0
        moe = (3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
               + d * self.n_experts)
        ffn = k * 3 * d * self.d_ff + (L - k) * (moe if self.n_experts else 3 * d * self.d_ff)
        return V * d * (1 if self.tie_embeddings else 2) + L * attn + ffn

    def n_active_params(self) -> int:
        if not self.n_experts:
            return self.n_params()
        idle = (self.n_layers - self.first_k_dense) * (self.n_experts - self.experts_per_token)
        return self.n_params() - idle * 3 * self.d_model * self.moe_d_ff


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 * mscale * ln(factor) + 1`` (1 where
    ``factor`` is at most 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def mla_softmax_scale(cfg: ArchConfig) -> Optional[float]:
    """The MLA softmax's scale where YaRN sets it, ``(nope + rope)^-1/2 *
    yarn_mscale(factor, mscale_all_dim)^2``; None for the plain
    ``1 / sqrt(nope + rope)``."""
    yarn = getattr(cfg, "yarn", None)
    if yarn is None:
        return None
    m = yarn_mscale(yarn.factor, yarn.mscale_all_dim)
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5 * m * m


# ---------------------------------------------------------------------------
# products in JAX's promoted dtype
# ---------------------------------------------------------------------------

def _promoted(*xs: torch.Tensor) -> torch.dtype:
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return dt


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of ``a`` and ``b``; a sub-f32 result
    is summed in f32 and rounded once. With a 2-D weight DTensor ``b``, the
    operands are placed first (``spmd.matmul_operands``: the weight's FSDP
    gather, a column- or row-parallel product)."""
    if isinstance(b, DTensor) and b.ndim == 2 and a.ndim > 2:
        # one mm over the rows: DTensor's stride of a size-1 dim defeats
        # matmul's folding, which would expand the weight over the batch
        return dot(a.reshape(-1, a.shape[-1]), b).reshape(*a.shape[:-1], b.shape[-1])
    if isinstance(b, DTensor) and b.ndim == 2:
        a, b = spmd.matmul_operands(a, b)
    dt = _promoted(a, b)
    if dt == torch.float32:
        return a.float() @ b.float()
    return (a.float() @ b.float()).to(dt)


def dot_by_sequence(a: DTensor, w: DTensor) -> DTensor:
    """``a @ w`` for an activation DTensor ``a`` ``[B, S, k]`` on its
    sequence blocks (``spmd.sequence_placements``: ``S`` over the model
    axes) against the whole of a 2-D weight DTensor ``w``, gathered, whose
    gradient comes back a partial sum over the axes that split ``a``'s
    rows. For an output dim that does not split into whole blocks over the
    model axes (MLA's 40 heads on 16; minicpm3's vocab of 73,448): no rank
    computes or holds all of ``a @ w``. The result is placed as ``a``'s
    blocks (the batch's placements where ``S`` does not divide)."""
    mesh = a.device_mesh
    places = spmd.sequence_placements(a.shape, mesh)
    a_l = a.redistribute(mesh, places).to_local()
    w_l = spmd.local_block(w, [spmd.Replicate()] * mesh.ndim,
                           grad_partial=spmd.split_rows(places))
    return spmd.from_block(dot(a_l, w_l), mesh, places, (*a.shape[:-1], w.shape[-1]))


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted dtype of the operands, as :func:`dot`."""
    dt = _promoted(*xs)
    out = torch.einsum(eq, *(x.float() for x in xs))
    return out if dt == torch.float32 else out.to(dt)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``'s arithmetic: ``exp(x - max) / sum``."""
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# names a remat policy can see
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_named.register_fake
def _(x: torch.Tensor, name: str) -> torch.Tensor:
    return torch.empty_like(x)


_named.register_autograd(lambda ctx, grad: (grad, None))


@register_sharding(torch.ops.repro_torch.checkpoint_name.default)
def _named_sharding(x, name):
    """DTensor's rule for the op: an identity, the output placed as ``x``
    (replicated, sharded on any dim, or a partial sum), one mesh dim at a
    time."""
    same = [([spmd.Replicate()], [spmd.Replicate(), None]),
            ([spmd.Partial()], [spmd.Partial(), None])]
    return same + [([spmd.Shard(d)], [spmd.Shard(d), None]) for d in range(x.ndim)]


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` marked ``name`` for a selective remat policy, as
    ``jax.ad_checkpoint.checkpoint_name``: where autograd records ``x``, a
    copy of it made by the op ``repro_torch::checkpoint_name``, which a
    policy sees with its name (``models.lm._remat``); elsewhere (serving)
    ``x`` itself."""
    return _named(x, name) if torch.is_grad_enabled() and x.requires_grad else x


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x`` normalized over its last dim, times ``scale``. On DTensors (a
    norm feeds each block's column-parallel products): a sharded scale (a
    stacked one is sharded over ``model`` by the rules) is gathered, so the
    output keeps ``x``'s placements, and the output's partial gradient is
    reduced once (``spmd.reduce_grad``). Where ``x``'s last dim is itself
    sharded (MLA's low-rank ``c_q`` and ``c_kv``), see
    :func:`_rms_norm_sharded`."""
    if isinstance(x, DTensor) and spmd.sharding_dims(x, x.ndim - 1):
        return _rms_norm_sharded(x, scale, eps)
    if isinstance(scale, DTensor):
        scale = scale.redistribute(scale.device_mesh, [spmd.Replicate()] * scale.device_mesh.ndim)
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return spmd.reduce_grad((x * scale).to(dt))


def _rms_norm_sharded(x: DTensor, scale: DTensor, eps: float) -> DTensor:
    """:func:`rms_norm` of ``x`` whose last dim is sharded, on each rank's
    block: its sum of squares reduced over the mesh dims that shard that dim
    (an all-reduce of ``[..., 1]``), the block normalized and times the
    matching block of ``scale``; placed as ``x``. Left to DTensor's
    propagation, the backward came back with the rows sharded over ``model``
    and, on a (pod, data, model) mesh, the weight gradient upstream
    computed whole on every model rank."""
    mesh = x.device_mesh
    last = x.ndim - 1
    over = spmd.sharding_dims(x, last)
    lead = tuple(spmd.Replicate() if i in over else p for i, p in enumerate(x.placements))
    x_l = x.to_local()
    dt = x_l.dtype
    xf = x_l.float()
    # every block's share of the loss reads the whole sum: its gradient is a
    # partial sum over ``over``, reduced in the backward of the all-reduce
    ss = spmd.reduce_over((xf * xf).sum(-1, keepdim=True), lead, over, mesh).to_local(
        grad_placements=tuple(spmd.Partial() if i in over else p for i, p in enumerate(lead)))
    rows = tuple(i for i, p in enumerate(x.placements) if isinstance(p, spmd.Shard)
                 and p.dim != last)
    s_l = spmd.local_block(scale, tuple(spmd.Shard(0) if i in over else spmd.Replicate()
                                        for i in range(mesh.ndim)), grad_partial=rows)
    out = (xf * torch.rsqrt(ss / x.shape[-1] + eps) * s_l).to(dt)
    return spmd.from_block(out, mesh, x.placements, x.shape)


def rope_angles(positions: torch.Tensor, dim: int, theta: float,
                yarn: Optional[YaRN] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...]; returns (cos, sin) of shape [..., dim/2].

    Under ``yarn`` the frequencies ``f_i = theta^(-2i/dim)`` become
    ``f_i / factor * ramp_i + f_i * (1 - ramp_i)``, with ``ramp_i`` rising
    linearly from 0 at the correction dim ``low`` of ``beta_fast``
    rotations to 1 at ``high`` of ``beta_slow`` (``corr(r) = dim *
    ln(original / (2 pi r)) / (2 ln theta)``, ``low = floor(corr(beta_fast))``
    and ``high = ceil(corr(beta_slow))`` clamped into [0, dim - 1]), and cos
    and sin are multiplied by ``yarn_mscale(factor, mscale) /
    yarn_mscale(factor, mscale_all_dim)``. The float32 operations are
    DeepSeek-V2's own (``DeepseekV2YarnRotaryEmbedding``): at positions past
    8k an angle's float32 rounding is ~5e-4 rad, so another order of the
    same arithmetic moves the rotary scores by about 1e-4."""
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device)
    freq = 1.0 / (theta ** (ar / dim))
    if yarn is not None:
        def corr(rotations):
            turns = yarn.original_max_position / (rotations * 2 * math.pi)
            return dim * math.log(turns) / (2 * math.log(theta))
        low = max(math.floor(corr(yarn.beta_fast)), 0)
        high = min(math.ceil(corr(yarn.beta_slow)), dim - 1)
        if high == low:
            high += 0.001
        i = torch.arange(dim // 2, dtype=torch.float32, device=positions.device)
        keep = 1.0 - ((i - low) / (high - low)).clamp(0, 1)
        inter = 1.0 / (yarn.factor * theta ** (ar / dim))
        freq = inter * (1 - keep) + freq * keep
    ang = positions.float()[..., None] * freq
    if yarn is None:
        return torch.cos(ang), torch.sin(ang)
    m = yarn_mscale(yarn.factor, yarn.mscale) / yarn_mscale(yarn.factor, yarn.mscale_all_dim)
    return torch.cos(ang) * m, torch.sin(ang) * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, dh]; cos/sin [S, dh/2] (broadcast over batch/heads).
    On a DTensor ``x`` the tables are made replicated DTensors (autograd
    saves them for a backward that runs outside ``implicit_replication``)."""
    x1, x2 = x.chunk(2, dim=-1)
    c = spmd.replicate_like(cos[..., None, :], x)
    s = spmd.replicate_like(sin[..., None, :], x)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    """The SwiGLU feed-forward ``(silu(x W1) * x W3) W2``."""
    return dot(silu(dot(x, p["w1"])) * dot(x, p["w3"]), p["w2"])


def swiglu_init(generator: torch.Generator, d: int, ff: int, dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None):
    """:func:`swiglu`'s leaves: ``w1``, ``w3`` ``[d, ff]`` (gate, up), ``w2``
    ``[ff, d]`` (down), drawn in that order."""
    return {
        "w1": dense_init(generator, (d, ff), d, dtype, device),
        "w3": dense_init(generator, (d, ff), d, dtype, device),
        "w2": dense_init(generator, (ff, d), ff, dtype, device),
    }


def dense_init(generator: torch.Generator, shape: Tuple[int, ...], in_dim: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device | None = None) -> torch.Tensor:
    """``N(0, 1) / sqrt(in_dim)`` in ``dtype`` on ``device`` (CUDA unless
    named), drawn in f32 from ``generator`` on the generator's device. On the
    ``meta`` device nothing is drawn or allocated."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return (x / math.sqrt(in_dim)).to(device=dev, dtype=dtype)


def normal_init(generator: torch.Generator, shape: Tuple[int, ...], std: float,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> torch.Tensor:
    """``std * N(0, 1)``, drawn as :func:`dense_init` draws (the reference's
    ``std * jax.random.normal(...)`` leaves)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return (std * x).to(device=dev, dtype=dtype)


def full_init(shape: Tuple[int, ...], value: float, dtype: torch.dtype = torch.float32,
              device: str | torch.device | None = None) -> torch.Tensor:
    """A constant leaf (``jnp.full`` / ``ones`` / ``zeros``) on ``device``."""
    return torch.full(shape, value, dtype=dtype, device=resolve_device(device))


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE; logits [..., V] f32, targets int [...]."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        nll = _sharded_nll(logits, targets)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets[..., None].long())[..., 0]
        nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _sharded_nll(logits: DTensor, targets: torch.Tensor) -> DTensor:
    """``logsumexp(logits) - logits[target]`` on logits whose vocab dim is
    sharded over ``model``, without gathering them (``[B, S, V]`` is 16.8 GB
    a device at yi-6b ``train_4k``): a local max, sum of exponentials and
    gold pick (on the rank that owns the target id, zero elsewhere), each
    reduced over the vocab's mesh dims. Where the vocab does not divide
    ``model`` the logits keep the sequence blocks they come in
    (``dot_by_sequence``). The result is placed as the batch (or those
    blocks)."""
    mesh = logits.device_mesh
    last = logits.ndim - 1
    rows = tuple(p if isinstance(p, spmd.Shard) and p.dim < last else b
                 for p, b in zip(logits.placements, spmd.batch_placements(logits.shape, mesh)))
    vocab = spmd.model_mesh_dims(mesh)
    if logits.shape[-1] % spmd.mesh_size(mesh, vocab):
        vocab = ()
    logits = logits.redistribute(mesh, tuple(spmd.Shard(last) if i in vocab else rows[i]
                                             for i in range(mesh.ndim)))
    targets = (targets.redistribute(mesh, rows) if isinstance(targets, DTensor)
               else spmd.distribute_tensor(targets, mesh, rows, src_data_rank=None))
    local = logits.to_local()
    peak = local.detach().amax(-1)
    if vocab:
        peak = DTensor.from_local(peak, mesh, tuple(
            spmd.Partial("max") if i in vocab else rows[i] for i in range(mesh.ndim)),
            run_check=False).redistribute(mesh, rows).to_local()
    sum_exp = spmd.reduce_over(torch.exp(local - peak[..., None]).sum(-1), rows, vocab, mesh)
    _, off = spmd.local_shape(logits.shape, mesh, logits.placements)
    n = local.shape[-1]
    ids = targets.to_local().long() - off[-1]
    own = (ids >= 0) & (ids < n)
    pick = torch.where(own, local.gather(-1, ids.clamp(0, n - 1)[..., None])[..., 0], 0.0)
    gold = spmd.reduce_over(pick, rows, vocab, mesh)
    peak = DTensor.from_local(peak, mesh, rows, run_check=False)
    return torch.log(sum_exp) + peak - gold
