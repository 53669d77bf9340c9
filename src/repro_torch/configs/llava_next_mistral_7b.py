"""LLaVA-NeXT (mistral-7b backbone): anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Vision frontend is a stub: input_specs() provides precomputed anyres patch
embeddings [B, frontend_tokens, d] (up to 2880 tokens = 5 tiles x 576).
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, rope_theta=1e6,
    frontend="vision", frontend_tokens=2880,
)
