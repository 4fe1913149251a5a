"""Exponential moving average of the actor's weights (counterpart of
``repro/core/ema.py``; InstructGPT / DS-Chat optional feature 1): an fp32
shadow of the actor params updated after every PPO step; the EMA weights
are what ships.

The port's optimizer updates the actor's params in place, so :func:`init`
and :func:`to_params` always copy (``Tensor.float()`` of an fp32 tensor
would return the tensor itself, and the shadow would follow the actor).
:func:`update` writes into the EMA's own tensors in place.
"""
from __future__ import annotations

import torch

from repro_torch.models.modules import tree_leaves, tree_map


def init(params):
    """An fp32 copy of ``params`` that shares no storage with them."""
    return tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                    params)


@torch.no_grad()
def update(ema, params, decay: float = 0.992):
    """``ema = decay * ema + (1 - decay) * params``, in place on the EMA's
    tensors (leaves matched by path); returns ``ema``."""
    es = tree_leaves(ema)
    ps = [p.float() for p in tree_leaves(tree_map(lambda _, p: p, ema,
                                                  params))]
    torch._foreach_mul_(es, decay)
    torch._foreach_add_(es, ps, alpha=1.0 - decay)
    return ema


def to_params(ema, like):
    """The EMA weights as a new tree in the dtypes of ``like``."""
    return tree_map(lambda e, p: e.detach().to(p.dtype, copy=True), ema,
                    like)
