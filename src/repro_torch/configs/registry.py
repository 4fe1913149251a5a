"""Architecture registry: ``--arch <id>`` resolves here (counterpart of
``repro/configs/registry.py``).

Every architecture id of the reference resolves: the OPT family, the
dense GQA decoders ``smollm-135m``, ``llama3.2-3b``, ``qwen3-8b`` and
``yi-9b``, the MoE decoders ``llama4-scout-17b-a16e`` and
``deepseek-v2-lite-16b`` (MLA), the SSM / hybrid pair ``mamba2-370m`` and
``zamba2-1.2b``, the cross-attention VLM ``llama-3.2-vision-11b`` and the
embedding-input audio decoder ``musicgen-medium``.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_lite_16b, llama3_2_3b,
                                  llama4_scout_17b_a16e,
                                  llama_3_2_vision_11b, mamba2_370m,
                                  musicgen_medium, opt_family, qwen3_8b,
                                  smollm_135m, yi_9b, zamba2_1_2b)
from repro_torch.models.config import ModelConfig

# in the reference's order
ARCHS = {"qwen3-8b": qwen3_8b.CONFIG,
         "musicgen-medium": musicgen_medium.CONFIG,
         "yi-9b": yi_9b.CONFIG,
         "llama3.2-3b": llama3_2_3b.CONFIG,
         "llama4-scout-17b-a16e": llama4_scout_17b_a16e.CONFIG,
         "mamba2-370m": mamba2_370m.CONFIG,
         "zamba2-1.2b": zamba2_1_2b.CONFIG,
         "deepseek-v2-lite-16b": deepseek_v2_lite_16b.CONFIG,
         "smollm-135m": smollm_135m.CONFIG,
         "llama-3.2-vision-11b": llama_3_2_vision_11b.CONFIG}

# the reference's architecture ids still to port: none
_NOT_PORTED: list = []


def list_archs():
    return list(ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in opt_family.OPT_CONFIGS:
        return opt_family.OPT_CONFIGS[arch_id]
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(f"arch {arch_id!r}: not yet ported")
    raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCHS)} + "
                   f"{list(opt_family.OPT_CONFIGS)}")


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (≤2 layers, d_model
    ≤ 256, ≤4 experts; one cross-attention unit with a short encoder): the
    reference's rule, field for field."""
    kw = dict(
        n_layers=2, d_model=min(cfg.d_model, 256),
        vocab_size=min(cfg.vocab_size, 512),
        compute_dtype="float32", remat=False, logit_chunk=0,
    )
    if cfg.n_heads:
        kw["n_heads"] = min(cfg.n_heads, 4)
        kw["n_kv_heads"] = max(1, min(cfg.n_kv_heads,
                                      kw["n_heads"] // 2) or 1)
        kw["head_dim"] = 32
        kw["d_ff"] = min(cfg.d_ff, 512) if cfg.d_ff else 0
    if cfg.moe:
        kw["n_experts"] = min(cfg.n_experts, 4)
        kw["top_k"] = min(cfg.top_k, 2)
        kw["moe_d_ff"] = min(cfg.moe_d_ff, 128)
        kw["capacity_factor"] = 2.0
    if cfg.mla:
        kw["kv_lora_rank"] = 64
        kw["qk_nope_head_dim"] = 32
        kw["qk_rope_head_dim"] = 16
        kw["v_head_dim"] = 32
    if cfg.ssm_state:
        kw["ssm_state"] = min(cfg.ssm_state, 32)
        kw["ssm_headdim"] = 32
        kw["ssm_chunk"] = 32
    if cfg.attn_every:
        kw["n_layers"] = cfg.attn_every  # one full hybrid unit
    if cfg.cross_attn_every:
        kw["n_layers"] = cfg.cross_attn_every
        kw["encoder_dim"] = min(cfg.encoder_dim, 128)
        kw["encoder_len"] = min(cfg.encoder_len, 16)
    if cfg.sliding_window:
        kw["sliding_window"] = min(cfg.sliding_window, 64)
    return cfg.replace(name=cfg.name + "-reduced", **kw)
