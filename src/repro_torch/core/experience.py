"""Experience construction for PPO: per-token KL-shaped rewards + GAE
(counterpart of ``repro/core/experience.py``).

Follows DeepSpeed-Chat / InstructGPT:
  r_t      = -kl_coef * (logp_actor - logp_ref)          (every token)
  r_last  += clip(reward_score, ±clip_reward)             (final token)
  A_t      = GAE(gamma, lam) over the response region
  R_t      = A_t + V_t

Where the reference scans right to left with ``jax.lax.scan``, :func:`gae`
walks the T positions with a Python loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sharding import runtime


class Experience(NamedTuple):
    sequences: torch.Tensor     # (B, T) int  prompt + response
    logprobs: torch.Tensor      # (B, T-1) actor logprobs at generation time
    ref_logprobs: torch.Tensor  # (B, T-1)
    values: torch.Tensor        # (B, T-1) critic values at generation time
    rewards: torch.Tensor       # (B, T-1) KL-shaped per-token rewards
    advantages: torch.Tensor    # (B, T-1)
    returns: torch.Tensor       # (B, T-1)
    mask: torch.Tensor          # (B, T-1) response-token mask (float)


def kl_rewards(logprobs, ref_logprobs, mask, score, *, kl_coef=0.1,
               clip_reward=5.0):
    r = -kl_coef * (logprobs - ref_logprobs) * mask
    # add the clipped env reward at the last valid response token
    n = mask.sum(-1)
    last = torch.clamp(n - 1, min=0).long()
    first_resp = torch.argmax(mask, dim=-1)      # first maximum, as jnp
    last_idx = first_resp + last
    bonus = torch.clamp(score, -clip_reward, clip_reward) * (n > 0)
    rows = torch.arange(r.shape[0], device=r.device)
    return r.index_put((rows, last_idx), bonus.to(r.dtype), accumulate=True)


def gae(rewards, values, mask, *, gamma=1.0, lam=0.95, group=None):
    """Generalized advantage estimation, right to left, masked; returns
    (advantages normalized over the response tokens, returns).  With a data
    ``group`` the rows are this rank's part of a batch sharded over it, and
    the normalization's count, mean and variance are the global batch's."""
    B, T = rewards.shape
    adv_next = torch.zeros(B, dtype=rewards.dtype, device=rewards.device)
    v_next = torch.zeros_like(adv_next)
    advs = [None] * T
    for t in range(T - 1, -1, -1):
        r, v, m = rewards[:, t], values[:, t], mask[:, t]
        delta = r + gamma * v_next * m - v
        adv = delta + gamma * lam * adv_next * m
        # outside the response region, carry through unchanged
        adv = adv * m
        adv_next, v_next = adv, v * m + v_next * (1 - m)
        advs[t] = adv
    advantages = torch.stack(advs, dim=1) * mask
    returns = advantages + values * mask
    # normalize advantages over response tokens (standard PPO practice)
    gsum = (lambda *xs: runtime.all_sum(list(xs), group)) if group \
        is not None else (lambda *xs: list(xs))
    tot, cnt = gsum((advantages * mask).sum(), mask.sum())
    n = torch.clamp(cnt, min=1.0)
    mean = tot / n
    var = gsum(((advantages - mean) ** 2 * mask).sum())[0] / n
    advantages = (advantages - mean) * torch.rsqrt(var + 1e-8) * mask
    return advantages, returns
