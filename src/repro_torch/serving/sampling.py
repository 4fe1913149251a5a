"""Token sampling: temperature / top-k / top-p (nucleus) / greedy
(counterpart of ``repro/serving/sampling.py``).

Two entry points:

- :func:`sample` — scalar parameters; the whole batch shares one
  temperature/top_k/top_p, and disabled filters cost nothing.
- :func:`sample_rows` — *per-row* parameter vectors over the batch dim,
  used by the serving engine so each KV slot carries its own
  temperature/top_k/top_p.

Randomness comes from ``torch.Generator``s in place of JAX keys.  A draw
is the Gumbel-max of the filtered logits (``argmax(logits + G)``, the
same rule ``jax.random.categorical`` applies), but the two frameworks'
random bits differ, so sampled tokens match the reference only in
distribution; greedy rows match token for token.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

NEG_INF = -1e30


def _top_p_mask(logits, top_p):
    """Nucleus filter: keep the smallest set of tokens whose cumulative
    probability reaches ``top_p`` (the top-1 token is always kept; ties
    with the threshold logit are kept, mirroring the top-k rule).
    ``top_p`` is a scalar or a ``(B, 1)`` column; returns masked logits.
    """
    srt = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p               # exclusive cumsum below p
    kp = torch.clamp(keep.sum(dim=-1, keepdim=True) - 1, min=0)
    kth = torch.gather(srt, -1, kp)
    return torch.where(logits < kth, NEG_INF, logits)


def _gumbel(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def _noise(shape, generator, device, noise_rows=None):
    """Gumbel noise of a ``shape`` ``(B, V)`` batch, or with ``noise_rows
    = (r0, n)`` rows ``r0 .. r0 + B`` of an ``n``-row batch's noise (a
    data-parallel rank's rows draw what the whole batch would, so the
    shared generator advances alike on every rank)."""
    if noise_rows is None:
        return _gumbel(shape, generator, device)
    r0, n = noise_rows
    return _gumbel((n,) + tuple(shape[1:]), generator,
                   device)[r0:r0 + shape[0]]


def sample(logits, generator: torch.Generator, *, temperature: float = 1.0,
           top_k: int = 0, top_p: float = 1.0, noise_rows=None):
    """logits: (B, V) -> (B,) int64.  Static (whole-batch) parameters;
    ``temperature <= 0`` is greedy, ``top_k == 0`` / ``top_p == 1.0``
    disable the respective filter.  ``noise_rows = (r0, n)`` draws the
    noise of an ``n``-row batch and keeps rows ``r0 .. r0 + B`` (a
    data-parallel rank's rows draw what the whole batch would)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        logits = _top_p_mask(logits, top_p)
    noise = _noise(logits.shape, generator, logits.device, noise_rows)
    return torch.argmax(logits + noise, dim=-1)


def filter_rows(logits, *, temperature, top_k, top_p):
    """The per-row filtered logits :func:`sample_rows` draws from:
    temperature-scaled (``<= 0`` leaves the row unscaled), top-k then top-p
    masked with ``NEG_INF`` where a row's filter is on."""
    V = logits.shape[-1]
    t = temperature.float()
    scaled = logits / torch.where(t > 0, t, 1.0)[:, None]
    # top-k: threshold at the k-th largest scaled logit where k is set
    k = torch.clamp(top_k.long(), 0, V)
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, torch.clamp(k - 1, min=0)[:, None])
    masked = torch.where(scaled < kth, NEG_INF, scaled)
    scaled = torch.where((k > 0)[:, None], masked, scaled)
    # top-p on the post-top-k distribution
    p = top_p.float()
    return torch.where((p < 1.0)[:, None], _top_p_mask(scaled, p[:, None]),
                       scaled)


def sample_rows(logits, generator: torch.Generator, *, temperature, top_k,
                top_p,
                row_generators: Optional[Sequence[Optional[torch.Generator]]]
                = None, noise_rows=None):
    """Per-row-parameter sampling: logits (B, V) -> (B,) int64.

    ``temperature`` (float), ``top_k`` (int) and ``top_p`` (float) are
    ``(B,)`` tensors; row ``i`` is sampled with its own configuration
    (``temperature[i] <= 0`` greedy, ``top_k[i] == 0`` / ``top_p[i] ==
    1.0`` filter off).  Every row draws its noise from the shared
    ``generator``, except rows whose entry in ``row_generators`` is a
    generator of their own (the engine's seeded requests).
    ``noise_rows``: as :func:`sample` (the shared draw is then the
    ``n``-row batch's; ``row_generators`` are this call's rows')."""
    scaled = filter_rows(logits, temperature=temperature, top_k=top_k,
                         top_p=top_p)
    noise = _noise(scaled.shape, generator, scaled.device, noise_rows)
    for i, g in enumerate(row_generators or ()):
        if g is not None:
            noise[i] = _gumbel(scaled.shape[-1:], g, scaled.device)
    sampled = torch.argmax(scaled + noise, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temperature > 0, sampled, greedy)
