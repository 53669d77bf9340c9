"""Unified LM: parameter init, forward, prefill, decode — all families.

Counterpart of ``repro.models.lm``: ``init_params``, ``param_shapes``,
``forward_train`` and ``loss_fn`` (differentiated by autograd, see
``repro_torch.launch.train``), ``init_cache``, ``prefill`` and
``decode_step``. Layers are stacked on a leading L axis, in the reference's
parameter layout, and driven by a Python loop where the reference scans: each
stacked leaf is split into its layers by one ``torch.unbind``, whose backward
stacks the layers' gradients once (an ``a[i]`` view per layer would add a
zero-filled copy of the whole leaf into its gradient at every layer). Under
autograd, the layer body runs under the config's remat policy (``_remat``).
Families:

  dense | moe | vlm   decoder-only attention (GQA or MLA) + SwiGLU/MoE FFN
  ssm                 RWKV6 blocks (time-mix + channel-mix)
  hybrid              Hymba: parallel GQA + SSD heads per layer, SwiGLU FFN,
                      sliding-window attention except a few global layers
  encdec              Seamless: bidirectional encoder over frame embeddings +
                      causal decoder with cross-attention

Modality frontends are stubs: VLM/audio inputs arrive as precomputed
patch/frame embeddings (see ``launch.specs``). Token ids index the embedding
table clamped into range, as the reference's gather clamps them.
``decode_step`` writes the cache's tensors in place and returns a dict of
them; the reference returns new arrays.

The same functions run as one program over a device mesh when the
parameters are DTensors (:mod:`repro_torch.distributed.spmd`, placed by the
sharding rules): the layer loops pin their activations as the reference's
``_shard_act`` does, the embedding and the loss work on vocab-sharded
tables and logits with explicit reductions, and the cache's sequence blocks
are written on the rank that owns them. MLA attention, GQA attention whose
heads do not divide ``model`` (by the query sequence), the MoE FFN and the
SSM mixers have DTensor paths of their own (``attention._mla_full_sharded``
/ ``_mla_decode_sharded`` / ``_gqa_full_by_sequence``,
``moe._moe_sharded``, ``ssm._rwkv_time_mix_sharded`` /
``_rwkv_channel_mix_sharded`` / ``_ssd_mix_sharded``); the recurrent states
(RWKV's ``tm_s``, ``tm_x``, ``cm_x``, hymba's ``ssd_s``) are written into
the cache in ``cache_specs``' placements, each rank its own block
(``_put``). The enc-dec encoder and cross attention run by heads like the
decoder's attention, and the cross cache is written in ``cache_specs``'
placements (its source sequence over ``model``, ``_place``) and read
block by block in decode. The VLM's patch embeddings go ahead of the text
in the batch's placements, so the concat and the text slice stay local
(the sequence is never sharded between layers). The MoE layer's aux loss
(a DTensor over the global token set) is summed over the layers as the
plain path sums it. Each entry point (``forward_train``,
``loss_fn``, ``prefill``, ``decode_step``) runs its body under
``spmd.program``: ``implicit_replication()``, so that the plain scalars and
tensors it makes act as replicated. The ones autograd saves for the backward,
which runs outside that context (RoPE's tables, attention's masks and
scale), are made replicated DTensors where they meet one
(``spmd.replicate_like``), everywhere the same way.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch import obs
from repro_torch.core.tree import resolve_device
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import cache_specs
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (ArchConfig, PortArchConfig, apply_rope,
                                       cross_entropy_loss, dense_init, dot, dot_by_sequence,
                                       full_init, rms_norm, rope_angles, swiglu, swiglu_init)

Params = Dict[str, Any]
Device = Optional[str | torch.device]


# ---------------------------------------------------------------------------
# pytree helpers (nested dicts of tensors)
# ---------------------------------------------------------------------------

def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layers(stacked: Params, n: int) -> List[Params]:
    """The ``n`` layers' leaves (views) of a stack with a leading L axis,
    each leaf split by one ``torch.unbind``."""
    split = _map(torch.unbind, stacked)
    return [_map(lambda parts: parts[i], split) for i in range(n)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _ffn_init(generator, cfg: ArchConfig, device: Device = None) -> Params:
    return swiglu_init(generator, cfg.d_model, cfg.d_ff, cfg.param_dtype, device)


def _layer_init(generator, cfg: ArchConfig, device: Device = None, *,
                moe: Optional[bool] = None) -> Params:
    """One layer's leaves; its feed-forward is the MoE where ``moe`` (by
    default: where the config has experts), else the dense SwiGLU."""
    dt = cfg.param_dtype
    d = cfg.d_model
    layer: Params = {"ln1": full_init((d,), 1.0, dt, device),
                     "ln2": full_init((d,), 1.0, dt, device)}
    if cfg.family == "ssm":
        layer["tm"] = ssm_lib.rwkv_time_mix_init(generator, cfg, device)
        layer["cm"] = ssm_lib.rwkv_channel_mix_init(generator, cfg, device)
        return layer
    if cfg.attn_type == "mla":
        layer["attn"] = attn_lib.mla_init(generator, cfg, device)
    else:
        layer["attn"] = attn_lib.gqa_init(generator, cfg, device)
    if cfg.family == "hybrid":
        layer["ssd"] = ssm_lib.ssd_init(generator, cfg, device)
    if bool(cfg.n_experts) if moe is None else moe:
        layer["ffn"] = moe_lib.moe_init(generator, cfg, device)
    else:
        layer["ffn"] = _ffn_init(generator, cfg, device)
    return layer


def _enc_layer_init(generator, cfg: ArchConfig, device: Device = None) -> Params:
    dt = cfg.param_dtype
    d = cfg.d_model
    return {
        "ln1": full_init((d,), 1.0, dt, device),
        "ln2": full_init((d,), 1.0, dt, device),
        "attn": attn_lib.gqa_init(generator, cfg, device),
        "ffn": _ffn_init(generator, cfg, device),
    }


def _cross_init(generator, cfg: ArchConfig, device: Device = None) -> Params:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    return {
        "ln": full_init((d,), 1.0, dt, device),
        "wq": dense_init(generator, (d, h * dh), d, dt, device),
        "wk": dense_init(generator, (d, hkv * dh), d, dt, device),
        "wv": dense_init(generator, (d, hkv * dh), d, dt, device),
        "wo": dense_init(generator, (h * dh, d), h * dh, dt, device),
    }


def _stack_layers(generator, cfg: ArchConfig, n: int, init_fn, device: torch.device) -> Params:
    """``n`` layers drawn one after another into leaves with a leading L
    axis, allocated once (one layer's worth of memory on top)."""
    first = init_fn(generator, cfg, device)
    stacked = _map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    if device.type == "meta":
        return stacked
    for i in range(n):
        _copy_into(stacked, first if i == 0 else init_fn(generator, cfg, device), i)
    return stacked


def _copy_into(stacked: Params, layer: Params, i: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_into(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


def layer_windows(cfg: ArchConfig) -> torch.Tensor:
    """Per-layer attention window (0 = full/global), int32 on the CPU.
    Hymba keeps 3 global layers."""
    if cfg.sliding_window is None:
        return torch.zeros((cfg.n_layers,), dtype=torch.int32)
    w = torch.full((cfg.n_layers,), cfg.sliding_window, dtype=torch.int32)
    for g in (0, cfg.n_layers // 2, cfg.n_layers - 1):
        w[g] = 0
    return w


def _first_dense(cfg: ArchConfig) -> int:
    """Leading layers of an MoE model whose feed-forward is dense."""
    return getattr(cfg, "first_k_dense", 0) if cfg.n_experts else 0


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device: Device = None) -> Params:
    """Random parameters in the reference's layout, drawn from ``generator``
    (on its device) and placed on ``device`` (CUDA unless named). An MoE
    model with leading dense layers (``first_k_dense``) stacks those apart,
    under ``dense_layers`` (their ``ffn`` a dense SwiGLU of ``d_ff``), and
    ``layers`` holds the MoE layers that follow."""
    device = resolve_device(device)
    dt = cfg.param_dtype
    k = _first_dense(cfg)
    params: Params = {
        "embed": dense_init(generator, (cfg.vocab, cfg.d_model), cfg.d_model, dt, device),
        "final_norm": full_init((cfg.d_model,), 1.0, dt, device),
    }
    if k:
        params["dense_layers"] = _stack_layers(
            generator, cfg, k, functools.partial(_layer_init, moe=False), device)
    params["layers"] = _stack_layers(generator, cfg, cfg.n_layers - k, _layer_init, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab), cfg.d_model, dt,
                                       device)
    if cfg.family == "encdec":
        params["enc_layers"] = _stack_layers(generator, cfg, cfg.n_enc_layers,
                                             _enc_layer_init, device)
        params["enc_norm"] = full_init((cfg.d_model,), 1.0, dt, device)
        params["cross_layers"] = _stack_layers(generator, cfg, cfg.n_layers, _cross_init,
                                               device)
    return params


def param_shapes(cfg: ArchConfig, generator: Optional[torch.Generator] = None) -> Params:
    """The parameter pytree as ``meta`` tensors (shapes and dtypes) — no
    allocation, nothing drawn."""
    g = torch.Generator() if generator is None else generator
    return init_params(cfg, g, device="meta")


# ---------------------------------------------------------------------------
# layer bodies (full-sequence mode: train / prefill)
# ---------------------------------------------------------------------------

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of matrix
    products without batch dims (``x @ w`` folds to ``mm``; an einsum with a
    batch dim runs as ``bmm`` and is recomputed)."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def _save_moe_buffers(ctx, op, *args, **kwargs):
    """``save_only_these_names("moe_xin", "moe_out")``."""
    if op is torch.ops.repro_torch.checkpoint_name.default and args[1] in ("moe_xin",
                                                                          "moe_out"):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {"dots": _save_dots, "moe": _save_moe_buffers}


def _remat(cfg: ArchConfig, body: Callable) -> Callable:
    """The layer body under the config's remat policy: ``full`` saves only
    the body's inputs and recomputes the rest in backward; ``dots`` also
    keeps the outputs of its matrix products without batch dims; ``moe``
    keeps the MoE dispatch buffers marked ``moe_xin`` and ``moe_out`` (the
    forward scatter chain is not run again); ``none`` (or ``remat=False``)
    keeps everything. A call that autograd does not record (under
    ``torch.no_grad``, or with no input that requires grad: prefill, decode)
    runs the body as it is."""
    if not cfg.remat or cfg.remat_policy == "none":
        return body
    policy = _POLICIES.get(cfg.remat_policy)
    extra = {} if policy is None else {
        "context_fn": functools.partial(create_selective_checkpoint_contexts, policy)}

    def run(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves(args))):
            return body(*args)
        return checkpoint(body, *args, use_reentrant=False, **extra)

    return run


def _cast_layer(cfg: ArchConfig, lp):
    """Mixed precision: bf16 copies of the layer weights in compute (f32
    master params) when activations_bf16."""
    if not cfg.activations_bf16:
        return lp
    return _map(lambda a: a.to(torch.bfloat16) if a.dtype == torch.float32 else a, lp)


def _attn_block_full(cfg, lp, x, window, q_offset):
    h = rms_norm(x, lp["ln1"])
    if cfg.attn_type == "mla":
        out, kv = attn_lib.mla_full(lp["attn"], h, cfg, q_offset=q_offset)
    else:
        out, kv = attn_lib.gqa_full(lp["attn"], h, cfg, window=window, q_offset=q_offset)
    if cfg.family == "hybrid":
        sstate = torch.zeros((x.shape[0], cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                             dtype=torch.float32, device=x.device)
        ssd_out, sstate = ssm_lib.ssd_mix(lp["ssd"], h, sstate, cfg, mode="chunked")
        out = 0.5 * (_alike(out, ssd_out) + _alike(ssd_out, out))
        kv = kv + (sstate,)
    return x + spmd.reduced(out), kv


def _alike(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` ready to be added to ``b`` (hybrid's two mixers): where both
    are partial sums placed alike, ``a`` itself, so that their sum is
    reduced once; otherwise ``a`` reduced."""
    if isinstance(a, DTensor) and tuple(a.placements) != tuple(b.placements):
        return spmd.reduced(a)
    return a


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn_block(cfg, lp, x):
    h = rms_norm(x, lp["ln2"])
    if "router" in lp["ffn"]:
        out, aux = moe_lib.moe_ffn(lp["ffn"], h, cfg)
    else:
        with obs.span("ffn.dense", device=x.device):
            out, aux = swiglu(lp["ffn"], h), _zero(x)
    return x + spmd.reduced(out), aux


def _rwkv_block_full(cfg, lp, x, mode="chunked"):
    b = x.shape[0]
    h = rms_norm(x, lp["ln1"])
    tm_x0 = torch.zeros((b, cfg.d_model), dtype=x.dtype, device=x.device)
    tm_s0 = torch.zeros((b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_head_dim),
                        dtype=torch.float32, device=x.device)
    out, tm_x, tm_s = ssm_lib.rwkv_time_mix(lp["tm"], h, tm_x0, tm_s0, cfg, mode=mode)
    x = x + spmd.reduced(out)
    h2 = rms_norm(x, lp["ln2"])
    cm_x0 = torch.zeros((b, cfg.d_model), dtype=x.dtype, device=x.device)
    out2, cm_x = ssm_lib.rwkv_channel_mix(lp["cm"], h2, cm_x0)
    return x + out2, (tm_x, tm_s, cm_x)


# ---------------------------------------------------------------------------
# full forward (train / prefill)
# ---------------------------------------------------------------------------

def _decoder_layers(cfg: ArchConfig, params: Params) -> List[Params]:
    """The decoder's layers in order, each leaf a view of its stack: the
    leading dense layers (``dense_layers``), then ``layers``."""
    k = _first_dense(cfg)
    lead = _layers(params["dense_layers"], k) if k else []
    return lead + _layers(params["layers"], cfg.n_layers - k)


def _decoder_stack(cfg: ArchConfig, params: Params, x: torch.Tensor, *,
                   q_offset: int = 0, collect_cache: bool = False,
                   enc_out: Optional[torch.Tensor] = None):
    """Run the decoder layers over a full sequence.

    Returns (hidden [B,S,d], per-layer caches stacked on L or None, aux)."""
    windows = layer_windows(cfg).tolist()
    use_cross = cfg.family == "encdec"
    layers = _decoder_layers(cfg, params)
    cross = (_layers(params["cross_layers"], cfg.n_layers) if use_cross
             else [None] * cfg.n_layers)

    def body(x, lp, cp, w):
        x = spmd.activation_placements(x)
        lp = _cast_layer(cfg, lp)
        if cfg.family == "ssm":
            x, cache = _rwkv_block_full(cfg, lp, x)
            return x, cache, _zero(x)  # channel-mix IS the ffn for rwkv
        x, cache = _attn_block_full(cfg, lp, x, w, q_offset)
        if use_cross:
            x, ck, cv = _cross_attn(cfg, _cast_layer(cfg, cp), x, enc_out)
            cache = cache + (ck, cv)
        x, a = _ffn_block(cfg, lp, x)
        return x, cache, a

    body_fn = _remat(cfg, body)
    aux = _zero(x)
    caches = []
    for lp, cp, w in zip(layers, cross, windows):
        x, cache, a = body_fn(x, lp, cp, w)
        aux = aux + a
        if collect_cache:
            caches.append(cache)
    stacked = None
    if collect_cache:
        stacked = tuple(torch.stack(parts) for parts in zip(*caches))
    return x, stacked, aux


def _cross_attn(cfg, cp, x, enc_out, cached_kv=None):
    """The decoder's attention over the encoder's output ``enc_out`` (train,
    prefill) or over the cross cache ``cached_kv`` (decode). On DTensors:
    queries, keys and values are column-parallel products split into heads
    (``attention._heads``), the attention runs by heads on local blocks
    (``_sdpa`` -> ``_sdpa_heads``), and the output projection is
    row-parallel, reduced once. In decode the cross cache's source sequence
    is sharded over ``model`` (``cache_specs``): ``_sdpa`` scores each
    rank's own block and reduces the softmax's max and sum across blocks, as
    the self-attention's decode does on its cache; the cache is never
    gathered."""
    b, s, d = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hq = rms_norm(x, cp["ln"])
    q = attn_lib._heads(dot(hq, cp["wq"]), b, s, h, dh)
    if cached_kv is None:
        se = enc_out.shape[1]
        k = attn_lib._heads(dot(enc_out, cp["wk"]), b, se, hkv, dh)
        v = attn_lib._heads(dot(enc_out, cp["wv"]), b, se, hkv, dh)
    else:
        k, v = cached_kv
    if cfg.attn_impl == "chunked":
        out = attn_lib._chunked_sdpa(q, k, v, q_offset=0, window=0,
                                     kblock=cfg.attn_kblock,
                                     qblock=cfg.attn_qblock, causal=False,
                                     full_unroll=cfg.unroll_layers)
    else:
        mask = torch.ones((s, k.shape[1]), dtype=torch.bool, device=x.device)
        out = attn_lib._sdpa(q, k, v, mask)
    return x + spmd.reduced(dot(out.reshape(b, s, h * dh), cp["wo"])), k, v


def _encoder_stack(cfg: ArchConfig, params: Params, src: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over frame embeddings (stub frontend). On
    DTensors each layer runs as the decoder's do: its input pinned to the
    batch's placements, the attention by heads on local blocks, the
    row-parallel outputs reduced once. The output leaves through
    ``rms_norm``, whose backward reduces once the partial gradients that
    every decoder layer's cross keys and values send back to it."""
    hh, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def body(x, lp):
        x = spmd.activation_placements(x)
        lp = _cast_layer(cfg, lp)
        h = rms_norm(x, lp["ln1"])
        b, s, d = h.shape
        q = attn_lib._heads(dot(h, lp["attn"]["wq"]), b, s, hh, dh)
        k = attn_lib._heads(dot(h, lp["attn"]["wk"]), b, s, hkv, dh)
        v = attn_lib._heads(dot(h, lp["attn"]["wv"]), b, s, hkv, dh)
        cos, sin = rope_angles(torch.arange(s, device=x.device), dh, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        out = attn_lib._sdpa(q, k, v, torch.ones((s, s), dtype=torch.bool, device=x.device))
        x = x + spmd.reduced(dot(out.reshape(b, s, hh * dh), lp["attn"]["wo"]))
        h2 = rms_norm(x, lp["ln2"])
        return x + spmd.reduced(swiglu(lp["ffn"], h2))

    body_fn = _remat(cfg, body)
    x = src
    for lp in _layers(params["enc_layers"], cfg.n_enc_layers):
        x = body_fn(x, lp)
    return rms_norm(x, params["enc_norm"])


def _logits(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The head's logits; on DTensors whose vocab does not divide the
    model axes (minicpm3's 73,448 on 16), on each rank's sequence block
    (``dot_by_sequence``) rather than the whole ``[B, S, V]`` on every rank
    (19 GB at minicpm3 ``train_4k``)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if isinstance(head, DTensor) and not spmd.sharding_dims(head, 1):
        return dot_by_sequence(x, head).float()
    return dot(x, head).float()


def _maybe_bf16(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return x.to(cfg.activ_dtype) if cfg.activations_bf16 else x


def _embed(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``emb[tokens]`` with the reference's gather semantics: a negative id
    counts from the end, and an id out of range clamps to the nearest row."""
    v = emb.shape[0]
    idx = tokens.long()
    idx = torch.where(idx < 0, idx + v, idx).clamp(0, v - 1)
    if isinstance(emb, DTensor):
        return _embed_sharded(emb, idx)
    return emb[idx]


def _embed_sharded(emb: DTensor, idx: DTensor) -> DTensor:
    """The lookup on a vocab-sharded table (a DTensor ``[V, d]``): the
    table's feature dim gathered (its FSDP shard), each rank's rows looked up
    for the ids it owns and zeros for the rest, then summed over the vocab
    axes. Nothing of ``[V, d]`` is gathered over the vocab."""
    mesh = emb.device_mesh
    vocab = spmd.sharding_dims(emb, 0)
    rows = spmd.batch_placements(idx.shape, mesh)
    idx = idx.redistribute(mesh, rows) if isinstance(idx, DTensor) else spmd.distribute_tensor(
        idx, mesh, rows, src_data_rank=None)
    table = emb.redistribute(mesh, tuple(p if i in vocab else spmd.Replicate()
                                         for i, p in enumerate(emb.placements)))
    # each data rank's lookups reach the table's rows with its own tokens:
    # the table's gradient is a partial sum over the batch's axes
    local = table.to_local(grad_placements=tuple(
        spmd.Partial() if isinstance(rows[i], spmd.Shard) else p
        for i, p in enumerate(table.placements)))
    (n, _), (off, _) = spmd.local_shape(emb.shape, mesh, table.placements)
    ids = idx.to_local() - off
    own = (ids >= 0) & (ids < n)
    out = torch.where(own[..., None], local[ids.clamp(0, n - 1)], 0.0)
    return spmd.reduce_over(out, rows, vocab, mesh)


def _program(cfg: ArchConfig, params: Params):
    """``spmd.program(params)``, refused for the port's own architectures
    (``PortArchConfig``) on DTensors: their shared experts, leading dense
    layers, routing options, YaRN and query without LoRA have no DTensor
    path."""
    if isinstance(cfg, PortArchConfig) and isinstance(params["embed"], DTensor):
        raise NotImplementedError(
            f"{cfg.name} runs on one card: the port's own architectures have no DTensor path")
    return spmd.program(params)


def forward_train(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """Full training forward. Returns (logits [B,S,V], aux_loss)."""
    with _program(cfg, params):
        return _forward_train(cfg, params, batch)


def _forward_train(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]):
    emb = params["embed"]
    if cfg.family == "encdec":
        enc_out = _encoder_stack(cfg, params,
                                 _maybe_bf16(cfg, batch["src_embeds"].to(emb.dtype)))
        x = _maybe_bf16(cfg, _embed(emb, batch["tokens"]))
        x, _, aux = _decoder_stack(cfg, params, x, enc_out=enc_out)
    elif cfg.family == "vlm":
        tok = _embed(emb, batch["tokens"])
        x = torch.cat([batch["patch_embeds"].to(emb.dtype), tok], dim=1)
        x = _maybe_bf16(cfg, x)
        x, _, aux = _decoder_stack(cfg, params, x)
        x = x[:, batch["patch_embeds"].shape[1]:]  # only text positions score
    else:
        x = _maybe_bf16(cfg, _embed(emb, batch["tokens"]))
        x, _, aux = _decoder_stack(cfg, params, x)
    x = rms_norm(x, params["final_norm"])
    return _logits(cfg, params, x), aux


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]):
    with _program(cfg, params):
        logits, aux = forward_train(cfg, params, batch)
        mask = batch.get("loss_mask")
        ce = cross_entropy_loss(logits, batch["targets"], mask)
        loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# prefill / decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, src_len: int = 0, *,
               device: Device = None, mesh=None) -> Dict[str, torch.Tensor]:
    """Allocate an empty cache for ``decode_step`` on ``device`` (CUDA
    unless named; ``"meta"`` gives shapes and dtypes only). With a DTensor
    ``mesh``, each leaf is a DTensor placed by ``cache_specs``, and each
    rank allocates its own block only."""
    dev = resolve_device(device)
    if mesh is not None:
        shapes = init_cache(cfg, batch, max_len, src_len, device="meta")
        return spmd.zeros_tree(shapes, cache_specs(cfg, shapes, spmd.RuleMesh(mesh)), mesh,
                               device=dev)
    L, b = cfg.n_layers, batch
    dt = cfg.activ_dtype

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: Dict[str, torch.Tensor] = {}
    if cfg.family == "ssm":
        cache["tm_x"] = zeros((L, b, cfg.d_model))
        cache["tm_s"] = zeros((L, b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_head_dim),
                              torch.float32)
        cache["cm_x"] = zeros((L, b, cfg.d_model))
        return cache
    if cfg.attn_type == "mla":
        cache["ckv"] = zeros((L, b, max_len, cfg.kv_lora_rank))
        cache["kr"] = zeros((L, b, max_len, cfg.qk_rope_dim))
    else:
        cache["k"] = zeros((L, b, max_len, cfg.n_kv_heads, cfg.head_dim))
        cache["v"] = zeros((L, b, max_len, cfg.n_kv_heads, cfg.head_dim))
    if cfg.family == "hybrid":
        cache["ssd_s"] = zeros((L, b, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                               torch.float32)
    if cfg.family == "encdec":
        cache["cross_k"] = zeros((L, b, src_len, cfg.n_kv_heads, cfg.head_dim))
        cache["cross_v"] = zeros((L, b, src_len, cfg.n_kv_heads, cfg.head_dim))
    return cache


def prefill(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            max_len: int):
    """Process the prompt; returns (last-position logits, filled cache) on
    the parameters' device (over their mesh, for DTensors)."""
    with _program(cfg, params):
        return _prefill(cfg, params, batch, max_len)


def _prefill(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
             max_len: int):
    emb = params["embed"]
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encoder_stack(cfg, params, batch["src_embeds"].to(emb.dtype))
        x = _embed(emb, batch["tokens"])
    elif cfg.family == "vlm":
        tok = _embed(emb, batch["tokens"])
        x = torch.cat([batch["patch_embeds"].to(emb.dtype), tok], dim=1)
    else:
        x = _embed(emb, batch["tokens"])
    x = _maybe_bf16(cfg, x)
    b, s, _ = x.shape
    x, caches, _ = _decoder_stack(cfg, params, x, collect_cache=True, enc_out=enc_out)
    x = rms_norm(x, params["final_norm"])
    logits = _logits(cfg, params, x[:, -1:])
    cache = init_cache(cfg, b, max_len, src_len=0 if enc_out is None else enc_out.shape[1],
                       device=emb.device,
                       mesh=emb.device_mesh if isinstance(emb, DTensor) else None)
    if cfg.family == "ssm":
        for key, val in zip(("tm_x", "tm_s", "cm_x"), caches):
            _put(cache, key, val)
    else:
        k, v = caches[0], caches[1]
        if cfg.attn_type == "mla":
            _place(cache["ckv"], k)
            _place(cache["kr"], v)
        else:
            _place(cache["k"], k)
            _place(cache["v"], v)
        extra = 2
        if cfg.family == "hybrid":
            _put(cache, "ssd_s", caches[extra])
            extra += 1
        if cfg.family == "encdec":
            _place(cache["cross_k"], caches[extra])
            _place(cache["cross_v"], caches[extra + 1])
    return logits, cache


def _put(cache: Dict[str, torch.Tensor], key: str, val: torch.Tensor, layer=None) -> None:
    """``cache[key]`` (or its layer ``layer``) set to ``val`` in the cache's
    dtype. Over a mesh the DTensor cache is written in place, each rank its
    own block in ``cache_specs``' placements (the reference's jitted decode
    takes the cache ``in_shardings`` them), whatever placements ``val``
    came in."""
    buf = cache[key] if layer is None else cache[key][layer]
    if isinstance(buf, DTensor):
        spmd.write_block(buf, val, dim=0, start=0)
    elif layer is None:
        cache[key] = val.to(buf.dtype)
    else:
        cache[key][layer] = val


def _place(buf: torch.Tensor, val: torch.Tensor) -> None:
    """Write [L,B,S,...] prefill values into the [L,B,max,...] cache (over a
    mesh: each rank its own sequence blocks)."""
    if isinstance(buf, DTensor):
        spmd.write_block(buf, val, dim=2, start=0)
    else:
        buf[:, :, : val.shape[2]] = val.to(buf.dtype)


def decode_step(cfg: ArchConfig, params: Params, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos):
    """One token for every sequence. tokens [B] int; pos the position (an
    int or a 0-d tensor). Writes the cache in place.

    An MLA decoder also takes ``pos`` as a device tensor ``[1]``
    (``attention.position``), which a CUDA graph of the step reads at each
    replay (``serving.decode.DecodeSession``).

    Spans (``repro_torch.obs``): in each layer ``mla.decode`` or
    ``gqa.decode`` and the feed-forward's (``ffn.dense``, or the MoE's).

    Returns (logits [B, V], the cache)."""
    with _program(cfg, params):
        return _decode_step(cfg, params, cache, tokens, pos)


def _decode_step(cfg: ArchConfig, params: Params, cache: Dict[str, torch.Tensor],
                 tokens: torch.Tensor, pos):
    emb = params["embed"]
    x = _maybe_bf16(cfg, _embed(emb, tokens)[:, None, :])     # [B,1,d]
    windows = layer_windows(cfg).tolist()
    use_cross = cfg.family == "encdec"
    pos = attn_lib.position(pos)
    cache = dict(cache)
    if cfg.family == "ssm":
        # The reference's scan returns the token-shift states in the
        # activations' dtype, so after a step they are no longer the cache's.
        for key in ("tm_x", "cm_x"):
            cache[key] = cache[key].to(x.dtype)
    layers = _decoder_layers(cfg, params)
    cross = _layers(params["cross_layers"], cfg.n_layers) if use_cross else None
    tables = None
    if cfg.attn_type == "mla" and not isinstance(cache["ckv"], DTensor):
        tables = attn_lib.mla_decode_tables(cfg, pos, cache["ckv"].shape[2], x.device)
    for i, w in enumerate(windows):
        x = spmd.activation_placements(x)
        lp = _cast_layer(cfg, layers[i])
        if cfg.family == "ssm":
            h = rms_norm(x, lp["ln1"])
            out, tm_x, tm_s = ssm_lib.rwkv_time_mix(
                lp["tm"], h, cache["tm_x"][i].to(h.dtype), cache["tm_s"][i], cfg,
                mode="recurrent")
            x = x + spmd.reduced(out)
            h2 = rms_norm(x, lp["ln2"])
            out2, cm_x = ssm_lib.rwkv_channel_mix(lp["cm"], h2, cache["cm_x"][i].to(h2.dtype))
            x = x + out2
            for key, val in (("tm_x", tm_x), ("tm_s", tm_s), ("cm_x", cm_x)):
                _put(cache, key, val, i)
            continue
        h = rms_norm(x, lp["ln1"])
        with obs.span(f"{cfg.attn_type}.decode", device=x.device):
            if cfg.attn_type == "mla":
                out, _, _ = attn_lib.mla_decode(lp["attn"], h, cache["ckv"][i], cache["kr"][i],
                                                pos, cfg, absorb=cfg.mla_absorb, tables=tables)
            else:
                out, _, _ = attn_lib.gqa_decode(lp["attn"], h, cache["k"][i], cache["v"][i],
                                                pos, cfg, window=w)
        if cfg.family == "hybrid":
            sout, ss = ssm_lib.ssd_mix(lp["ssd"], h, cache["ssd_s"][i], cfg, mode="recurrent")
            _put(cache, "ssd_s", ss, i)
            out = 0.5 * (_alike(out, sout) + _alike(sout, out))
        x = x + spmd.reduced(out)
        if use_cross:
            cp = _cast_layer(cfg, cross[i])
            x, _, _ = _cross_attn(cfg, cp, x, None,
                                  cached_kv=(cache["cross_k"][i], cache["cross_v"][i]))
        x, _ = _ffn_block(cfg, lp, x)
    x = rms_norm(x, params["final_norm"])
    return _logits(cfg, params, x)[:, 0], cache
