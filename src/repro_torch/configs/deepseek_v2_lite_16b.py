"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400; MLA kv_lora=512; MoE 2 shared + 64 routed, top-6.
[arXiv:2405.04434]

Spec note: the assignment's bracket text says "160 routed"; the primary
spec line says "MoE 64e top-6", which matches the real DeepSeek-V2-Lite
(64 routed + 2 shared).  We follow the primary spec.  (Deviation from the
HF checkpoint: the real model's layer-0 MLP is dense d_ff=10944; we keep
all 27 layers MoE for a homogeneous scan — kept here as in the reference.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    capacity_factor=1.25,
    logit_chunk=512,
)
