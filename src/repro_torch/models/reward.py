"""Reward / critic models: transformer backbone + scalar value head
(counterpart of ``repro/models/reward.py``).

Matches DeepSpeed-Chat's design: the reward model scores a (prompt,
response) pair with the value at the *last response token*; the critic
reuses the same structure and emits per-token values for PPO.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import ParamSpec, init_tree


def param_specs(cfg: ModelConfig) -> dict:
    specs = T.param_specs(cfg)
    specs.pop("lm_head", None)           # value head instead of LM head
    specs["v_head"] = ParamSpec((cfg.d_model, 1), ("embed", None))
    return specs


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Parameters in ``cfg.param_dtype`` on ``generator``'s device."""
    return init_tree(param_specs(cfg), generator, cfg.pdtype)


def values(cfg: ModelConfig, params, tokens, *, embeds=None):
    """Per-token scalar values: (B, L) fp32."""
    hidden, _, _ = T.forward(cfg, params, tokens=tokens, embeds=embeds,
                             mode="full")
    head = params["v_head"]
    # the reference's promotion: a bf16 hidden times the fp32 head is fp32
    dt = torch.promote_types(hidden.dtype, head.dtype)
    return (hidden.to(dt) @ head.to(dt)).float()[..., 0]


def end_scores(cfg: ModelConfig, params, tokens, attn_mask):
    """Score at the last non-pad token of each sequence: (B,)."""
    v = values(cfg, params, tokens)
    last = torch.clamp(attn_mask.sum(-1) - 1, min=0).long()
    return torch.gather(v, 1, last[:, None])[:, 0]


def pairwise_loss(cfg: ModelConfig, params, chosen, rejected, chosen_mask,
                  rejected_mask):
    """DeepSpeed-Chat reward loss: -log sigmoid(r_chosen - r_rejected)."""
    rc = end_scores(cfg, params, chosen, chosen_mask)
    rr = end_scores(cfg, params, rejected, rejected_mask)
    loss = -F.logsigmoid(rc - rr).mean()
    acc = (rc > rr).float().mean()
    return loss, acc
