"""mamba2-370m [ssm] — 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]

No KV cache: decode carries a (conv, ssm) recurrent state per layer —
O(1) per token, so ``long_500k`` runs natively (sub-quadratic).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    logit_chunk=512,
)
