"""DeepSeek-V2-Lite: MLA without q LoRA under YaRN, MoE with shared experts
[hf:deepseek-ai/DeepSeek-V2-Lite; hf].

27 layers over d_model 2,048, vocab 102,400, untied embeddings, RMSNorm
epsilon 1e-6. Attention: MLA with 16 heads, kv LoRA 512, no q LoRA (one
``wq`` of ``[2048, 16 * 192]``), rope 64 + nope 128, v 128; rotary YaRN
(factor 40 over the original 4,096 positions, beta_fast 32, beta_slow 1,
mscale = mscale_all_dim = 0.707, theta 10,000). Feed-forward: layer 0 a
dense SwiGLU of 10,944 (``first_k_dense_replace`` 1); layers 1-26 MoE, 64
routed experts of 1,408, top-6 of a softmax over the 64 logits, the
weights not renormalised (``norm_topk_prob`` false), ``routed_scaling_factor``
1, and 2 shared experts, one SwiGLU of 2 x 1,408 = 2,816 on every token.
Every (token, expert) pair is routed (dropless), as the published model
routes them. 15.71 B parameters, 62.8 GB in the port's float32.

The port rotates the two halves of each rotary vector where DeepSeek
interleaves pairs: a fixed permutation of the rotary columns of ``wq`` and
``wkr``, which with drawn weights is a layout and not a departure. Decode
runs the absorbed form (``mla_absorb``), which a decode session on a card
replays as CUDA graphs (``serving.decode``); prefill the chunked online-softmax
attention (``attn_impl`` ``chunked``), which never holds a ``[S, S]`` score
matrix. The published checkpoint is bf16; the port's weights are float32
(its ``param_dtype``), and so is the latent cache (``activ_dtype``): a
rounding of the cache as large as bf16's moves the router's logits across
the near-ties of its top-6 on about one decision in a hundred, and each such
flip swaps an expert of that token, so decoding against a bf16 cache is held
to a float32 reference only as loosely as a bf16 model is.

A port-only architecture (``PortArchConfig``): it is not in ``ARCH_IDS``,
which holds the JAX package's list.
"""
import torch

from repro_torch.models.common import PortArchConfig, YaRN

CONFIG = PortArchConfig(
    name="deepseek-v2-lite", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
    d_ff=10944, vocab=102400, attn_type="mla",
    q_lora_rank=0, kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    n_experts=64, experts_per_token=6, moe_d_ff=1408,
    mla_absorb=True, attn_impl="chunked", activ_dtype=torch.float32,
    n_shared_experts=2, first_k_dense=1, norm_topk_prob=False, routed_scale=1.0,
    moe_dropless=True,
    yarn=YaRN(factor=40.0, original_max_position=4096, beta_fast=32.0, beta_slow=1.0,
              mscale=0.707, mscale_all_dim=0.707),
)
