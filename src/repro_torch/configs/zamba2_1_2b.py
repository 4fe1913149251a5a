"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64; Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]

Layout: repeating unit of 5 Mamba2 layers + 1 full-attention layer
(``attn_every=6`` -> 6 units = 36 layers) + 2 trailing Mamba2 layers = 38.
Attention layers use a sliding-window ring cache at 500k decode.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    attn_every=6,
    logit_chunk=512,
)
