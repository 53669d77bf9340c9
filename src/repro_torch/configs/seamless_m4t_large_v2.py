"""SeamlessM4T-large-v2: enc-dec, multimodal [arXiv:2308.11596; hf].

Transformer BACKBONE only — the audio frontend is a stub: input_specs()
provides precomputed frame embeddings [B, S_src, d].
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206, n_enc_layers=24, frontend="audio",
)
