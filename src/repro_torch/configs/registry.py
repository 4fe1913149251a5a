"""Architecture registry: ``--arch <id>`` resolves here (counterpart of
``repro/configs/registry.py``).

The ported configs resolve: the OPT family, ``smollm-135m`` and the
SSM / hybrid pair ``mamba2-370m`` and ``zamba2-1.2b``.  Every other
architecture id of the reference raises ``NotImplementedError`` until its
slice is ported.
"""
from __future__ import annotations

from repro_torch.configs import (mamba2_370m, opt_family, smollm_135m,
                                  zamba2_1_2b)
from repro_torch.models.config import ModelConfig

ARCHS = {"smollm-135m": smollm_135m.CONFIG,
         "mamba2-370m": mamba2_370m.CONFIG,
         "zamba2-1.2b": zamba2_1_2b.CONFIG}

# the reference's other architecture ids, not yet ported
_NOT_PORTED = [
    "qwen3-8b",
    "musicgen-medium",
    "yi-9b",
    "llama3.2-3b",
    "llama4-scout-17b-a16e",
    "deepseek-v2-lite-16b",
    "llama-3.2-vision-11b",
]


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
    """Reduced same-family variant for CPU smoke tests (the reference's
    rule for the dense, SSM and hybrid fields)."""
    if cfg.arch_type not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(f"arch_type {cfg.arch_type!r}: "
                                  "not yet ported")
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
    if cfg.ssm_state:
        kw["ssm_state"] = min(cfg.ssm_state, 32)
        kw["ssm_headdim"] = 32
        kw["ssm_chunk"] = 32
    if cfg.attn_every:
        kw["n_layers"] = cfg.attn_every  # one full hybrid unit
    if cfg.sliding_window:
        kw["sliding_window"] = min(cfg.sliding_window, 64)
    return cfg.replace(name=cfg.name + "-reduced", **kw)
