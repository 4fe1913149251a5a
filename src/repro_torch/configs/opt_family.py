"""OPT-family configs: the models the paper itself benchmarks (actor sizes
1.3B..175B, reward 350M).  [arXiv:2205.01068]

Copy of ``repro/configs/opt_family.py``.  As there, the blocks are this
framework's (RoPE + SwiGLU) with d_ff = 8·d/3 (rounded to 256), so the
parameter count, and with it the FLOP and memory profile, matches the
original 4·d two-matrix MLP.
"""
from repro_torch.models.config import ModelConfig

_V = 50272


def _opt(name, L, d, h):
    ff = int(round(8 * d / 3 / 256) * 256)   # param-matched SwiGLU width
    return ModelConfig(name=name, arch_type="dense", n_layers=L, d_model=d,
                       n_heads=h, n_kv_heads=h, d_ff=ff, vocab_size=_V,
                       logit_chunk=512)


OPT_CONFIGS = {
    "opt-125m": _opt("opt-125m", 12, 768, 12),
    "opt-350m": _opt("opt-350m", 24, 1024, 16),
    "opt-1.3b": _opt("opt-1.3b", 24, 2048, 32),
    "opt-2.7b": _opt("opt-2.7b", 32, 2560, 32),
    "opt-6.7b": _opt("opt-6.7b", 32, 4096, 32),
    "opt-13b": _opt("opt-13b", 40, 5120, 40),
    "opt-30b": _opt("opt-30b", 48, 7168, 56),
    "opt-66b": _opt("opt-66b", 64, 9216, 72),
    "opt-175b": _opt("opt-175b", 96, 12288, 96),
}
