"""Model/architecture configuration (counterpart of ``repro/models/config.py``).

A single ``ModelConfig`` describes every architecture family of the
reference (dense GQA, MoE, MLA, SSM/Mamba2, hybrid, VLM cross-attn, audio
decoder).  The decoder is a list of *segments*; each segment is a repeated
*unit* of layers (``unit_spec``) whose parameters are stacked on a leading
``layers`` axis.  The port walks that axis with a Python loop where the
reference scans it.  Every layout of the reference runs: dense GQA, MoE
and MLA attention segments, Mamba2 (SSD) segments in ``ssm`` and
``hybrid`` configs, cross-attention units in ``vlm`` configs, and
embedding inputs (``embed_inputs=False``, the ``audio`` decoder).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# Layer kinds.
ATTN = "attn"        # self-attention (GQA / qk-norm / sliding-window / MLA)
SSM = "ssm"          # Mamba2 SSD block
CROSS = "cross"      # cross-attention over encoder (image/audio) embeddings

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class LayerSpec:
    """Static description of one layer inside a scan unit."""
    kind: str = ATTN            # ATTN | SSM | CROSS
    moe: bool = False           # MoE MLP instead of dense MLP
    sliding_window: Optional[int] = None  # per-layer SW override


@dataclass(frozen=True)
class Segment:
    """``n_units`` repetitions of ``unit_spec`` (params stacked)."""
    unit_spec: Tuple[LayerSpec, ...]
    n_units: int

    @property
    def n_layers(self) -> int:
        return len(self.unit_spec) * self.n_units


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads

    # --- attention ---
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # if set, ALL attn layers are SW
    # MLA (DeepSeek-V2 style multi-head latent attention)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                  # per-expert hidden size
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0                 # N, state size
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    attn_every: int = 0                # hybrid: 1 attn layer per `attn_every`

    # --- VLM / audio frontends (embeddings arrive precomputed) ---
    cross_attn_every: int = 0          # vlm: 1 cross-attn block per N layers
    encoder_dim: int = 0               # dim of incoming patch/frame embeds
    encoder_len: int = 0               # number of patch/frame tokens
    embed_inputs: bool = True          # False -> inputs are embeddings

    # --- distribution ---
    # the reference's activation-sharding fields, kept for parity of the
    # config's fields only: the port never reads them (compute runs on each
    # rank's local rows with gathered weights).
    batch_axes: Tuple[str, ...] = ()
    tp_axis: str = ""

    # --- numerics / misc ---
    kv_quant: bool = False             # int8 KV cache + fp32 row scales
    tie_embeddings: bool = False
    rms_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # counterpart of the reference's ``use_pallas``: route RMSNorm and
    # attention through ``repro_torch.kernels.ops`` (the CUDA kernels on a
    # CUDA tensor, their plain versions on a CPU tensor).  False runs the
    # model's own plain PyTorch code, the port of the reference's jnp path.
    # On by default: the kernels are the port's main path.
    use_kernels: bool = True
    remat: bool = True                 # activation checkpointing (training)
    logit_chunk: int = 0               # chunked loss: 0 = off

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------ #
    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    # ------------------------------------------------------------------ #
    def segments(self) -> Tuple[Segment, ...]:
        """Decoder layout as segments of stacked units."""
        moe = self.moe
        if self.arch_type == "ssm":
            return (Segment((LayerSpec(SSM),), self.n_layers),)
        if self.arch_type == "hybrid":
            k = self.attn_every
            assert k > 1
            unit = tuple([LayerSpec(SSM)] * (k - 1) + [LayerSpec(ATTN)])
            n_units = self.n_layers // k
            rem = self.n_layers - n_units * k
            segs = [Segment(unit, n_units)]
            if rem:
                segs.append(Segment((LayerSpec(SSM),), rem))
            return tuple(segs)
        if self.arch_type == "vlm":
            k = self.cross_attn_every
            assert k > 1
            unit = tuple([LayerSpec(ATTN, moe=moe)] * (k - 1)
                         + [LayerSpec(CROSS, moe=moe)])
            n_units = self.n_layers // k
            rem = self.n_layers - n_units * k
            segs = [Segment(unit, n_units)]
            if rem:
                segs.append(Segment((LayerSpec(ATTN, moe=moe),), rem))
            return tuple(segs)
        # dense / moe / audio: homogeneous stack
        return (Segment((LayerSpec(ATTN, moe=moe),), self.n_layers),)

    def n_params(self) -> int:
        """Analytic parameter count."""
        from repro_torch.models.transformer import count_params  # lazy
        return count_params(self)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RankConfig(ModelConfig):
    """One rank's share of a config under tensor parallelism, for the
    shapes of its cache: ``n_heads`` / ``n_kv_heads`` are the rank's, and
    ``ssm_parts`` divides the Mamba2 mixer's inner width and heads (the
    reference's fields stay as they are)."""
    ssm_parts: int = 1

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model // self.ssm_parts


def rank_config(cfg: ModelConfig, ssm_parts: int = 1, **kw) -> RankConfig:
    """``cfg`` as a :class:`RankConfig` with ``kw`` replaced."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    return RankConfig(**{**fields, **kw}, ssm_parts=ssm_parts)


@dataclass(frozen=True)
class InputShape:
    """One of the assigned benchmark input shapes."""
    name: str
    seq_len: int
    global_batch: int
    phase: str                  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
