"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 (+1 shared expert, llama4-style).
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500_000.0,
    moe=True,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    capacity_factor=1.25,
    logit_chunk=512,
)
