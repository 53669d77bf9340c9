"""Config registry: ``get_config(arch_id)`` + reduced configs for smoke tests.

Counterpart of ``repro.configs.base``."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.common import ArchConfig, PortArchConfig

ARCH_IDS: List[str] = [
    "yi-9b",
    "minicpm3-4b",
    "phi3-medium-14b",
    "yi-6b",
    "qwen3-moe-235b-a22b",
    "grok-1-314b",
    "seamless-m4t-large-v2",
    "llava-next-mistral-7b",
    "hymba-1.5b",
    "rwkv6-7b",
]

#: The port's own architectures (``PortArchConfig``s): ``get_config``
#: resolves them, and they stay out of ``ARCH_IDS`` and ``all_configs``,
#: which hold the JAX package's list.
PORT_ARCH_IDS: List[str] = [
    "deepseek-v2-lite",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS + PORT_ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS + PORT_ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.CONFIG


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
    kw = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab=256,
        remat=False,
    )
    if cfg.attn_type == "mla":
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=16,
                  v_head_dim=16)
    if cfg.n_experts:
        # ample capacity: no token drops at smoke scale (keeps the
        # prefill/decode equivalence exact; production keeps 1.25)
        kw.update(n_experts=4, experts_per_token=2, moe_d_ff=32,
                  capacity_factor=4.0)
    if cfg.ssm_heads:
        kw.update(ssm_heads=4, ssm_head_dim=16, ssm_state=8)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2)
    if cfg.family == "vlm":
        kw.update(frontend_tokens=8)
    if cfg.sliding_window:
        kw.update(sliding_window=8)
    if isinstance(cfg, PortArchConfig):
        # one leading dense layer and two MoE layers, the query without
        # LoRA where it has none, shared experts and the routing as
        # registered, YaRN over an original 16 positions so that a short
        # test sequence runs past it
        kw.update(n_layers=cfg.first_k_dense + 2, q_lora_rank=min(cfg.q_lora_rank, 32))
        if cfg.n_experts:
            kw.update(n_experts=8, experts_per_token=3)
        if cfg.yarn is not None:
            kw.update(yarn=dataclasses.replace(cfg.yarn, original_max_position=16))
    return dataclasses.replace(cfg, **kw)


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
