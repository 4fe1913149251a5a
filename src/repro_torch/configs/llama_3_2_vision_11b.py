"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision]

Frontend carve-out: the ViT vision encoder is STUBBED, as in the
reference — the caller passes precomputed patch embeddings (B, 1601, 1280)
as ``encoder_embeds``; a linear projector
(1280 -> d_model) and the cross-attention blocks are implemented.  Cross
K/V is computed once per image and cached across the decode loop (an
HE-friendly property: it is part of phase-entry setup, not the hot loop).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    encoder_dim=1280,
    encoder_len=1601,
    logit_chunk=512,
)
