"""AdamW over parameter trees (counterpart of ``repro/training/optimizer.py``,
the repo's own optimizer, not ``torch.optim``).

b1 = 0.9, b2 = 0.95, eps = 1e-8, a global fp32 grad-norm clip of 1.0 and
fp32 moments; the update is ``(m / bc1) / (sqrt(v / bc2) + eps)`` plus
``weight_decay * p``, times ``lr``, cast back to the parameter's dtype.
``trainable_mask`` (a tree of bools or bool tensors shaped like params)
freezes the masked-off leaves: their params and moments stay as they were.

Where the reference returns new trees, :func:`update` writes the new
params and moments into the tensors it is given (and scales ``grads`` in
place): on the card that saves three model-sized copies per step.  The
step counters are 0-d int32 tensors on the host, so the bias corrections
never wait on the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.modules import tree_leaves, tree_map


class AdamState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor


def init(params) -> AdamState:
    z = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamState(m=tree_map(z, params), v=tree_map(z, params),
                     step=torch.zeros((), dtype=torch.int32))


def update(params, grads, state: AdamState, *, lr, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.0, grad_clip: Optional[float] = 1.0,
           trainable_mask=None):
    """One AdamW step.  Returns ``(params, AdamState, gnorm)``; ``params``
    and the moments are the input tensors, updated in place."""
    step = state.step + 1
    # leaves in params' order, matched by path (dict order may differ)
    like = lambda tree: tree_leaves(tree_map(lambda _, x: x, params, tree))
    ps, gs, ms, vs = (tree_leaves(params), like(grads), like(state.m),
                      like(state.v))
    gs = [g if g.dtype == torch.float32 else g.float() for g in gs]
    if grad_clip is not None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in gs))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        torch._foreach_mul_(gs, scale)
    else:
        gnorm = torch.zeros((), device=ps[0].device if ps else None)

    # fp32 on the host, as the reference computes them (exact fp32 values)
    stepf = step.float()
    bc1 = float(1 - b1 ** stepf)
    bc2 = float(1 - b2 ** stepf)
    lr = float(lr)

    masks = (like(trainable_mask) if trainable_mask is not None
             else [True] * len(ps))
    sel = [i for i, t in enumerate(masks)
           if not (isinstance(t, bool) and not t)]          # leaves to touch
    partial = [i for i in sel if isinstance(masks[i], torch.Tensor)]
    old = {i: (ps[i].clone(), ms[i].clone(), vs[i].clone()) for i in partial}

    P = [ps[i] for i in sel]
    G = [gs[i] for i in sel]
    Mo = [ms[i] for i in sel]
    Vo = [vs[i] for i in sel]
    if P:
        torch._foreach_mul_(Mo, b1)                 # m = b1 m + (1-b1) g
        torch._foreach_add_(Mo, G, alpha=1 - b1)
        torch._foreach_mul_(Vo, b2)                 # v = b2 v + (1-b2) g^2
        torch._foreach_addcmul_(Vo, G, G, value=1 - b2)
        upd = torch._foreach_div(Mo, bc1)
        den = torch._foreach_div(Vo, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(upd, den)
        del den
        P32 = [p if p.dtype == torch.float32 else p.float() for p in P]
        if weight_decay:
            torch._foreach_add_(upd, P32, alpha=weight_decay)
        if all(p is q for p, q in zip(P, P32)):
            torch._foreach_add_(P, upd, alpha=-lr)
        else:
            for p, p32, u in zip(P, P32, upd):
                p.copy_(p32 - lr * u)
    for i in partial:                               # elementwise masks
        keep = ~masks[i].to(torch.bool)
        for new, prev in zip((ps[i], ms[i], vs[i]), old[i]):
            new.copy_(torch.where(keep, prev, new))
    return params, AdamState(m=state.m, v=state.v, step=step), gnorm
