"""Rollout batches (counterpart of ``repro/core/replay.py``).

Only :class:`RolloutBatch`, the seam between generation and scoring, is
ported.  The rest of the reference module (replay queue, weight publisher,
experience producer) is asynchronous RLHF and not yet ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class RolloutBatch:
    """One generated batch plus its behavior-policy version tag.

    The per-token behavior logprobs are not kept here: scoring recomputes
    them from the params of the policy that sampled the batch
    (``PPOTrainer.score_rollout``)."""
    sequences: Any                 # (B, W) int tokens, prompt | generated
    response_mask: Any             # (B, W) bool, True on generated tokens
    attn_mask: Any = None          # (B, W) float, None = no padding tail
    version: int = 0               # policy version that generated this
