"""LR schedules (cosine with linear warmup — DeepSpeed-Chat's default);
counterpart of ``repro/training/schedules.py``.  Each schedule maps a step
to a 0-d float32 CPU tensor, computed in float32 as the reference does."""
from __future__ import annotations

import math

import torch


def cosine_warmup(base_lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn


def constant(base_lr: float):
    return lambda step: torch.full((), base_lr, dtype=torch.float32)
