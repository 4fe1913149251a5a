"""LoRA (DS-Chat's memory optimization for RL training; counterpart of
``repro/core/lora.py``).

Adapters live in a parallel dict ``{path: {"a": (..., in, r), "b": (...,
r, out)}}`` over the 2-D (and layer-stacked 3-D) projection weights whose
``/``-joined path matches the pattern.  :func:`merge` gives the effective
params ``W.detach() + (alpha / r) * A @ B``, so gradients reach only the
adapters and the frozen base gets neither grads nor optimizer state (the
memory win the paper uses to fit larger actors on one GPU).  Paths and
their order are the reference's (dict keys sorted).

``init`` draws ``a`` from the caller's ``torch.Generator``; JAX and torch
draws differ (ROADMAP Queue 3, R6), so adapters that must match the
reference are carried across through numpy, as weights are.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from repro_torch.models.modules import (flatten_with_path,
                                        tree_unflatten_paths)

DEFAULT_TARGETS = r"(wq|wk|wv|wo|w_gate|w_up|w_down|w_in|w_out)$"


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _target_paths(params, pattern: str):
    # only plain 2D (or layer-stacked 3D) matrices
    return [(_key(path), leaf) for path, leaf in flatten_with_path(params)
            if re.search(pattern, _key(path)) and leaf.ndim in (2, 3)]


def init(params, rank: int, generator: torch.Generator,
         pattern: str = DEFAULT_TARGETS) -> Dict:
    """Adapters of rank ``rank`` on every target of ``params``: ``a`` from
    ``generator`` (on its device) over sqrt(in), ``b`` zeros, both in the
    target's dtype and on its device."""
    adapters = {}
    for path, w in _target_paths(params, pattern):
        *lead, din, dout = w.shape
        a = torch.randn((*lead, din, rank), generator=generator,
                        dtype=torch.float32, device=generator.device)
        adapters[path] = {
            "a": (a / np.sqrt(din)).to(device=w.device, dtype=w.dtype),
            "b": torch.zeros((*lead, rank, dout), dtype=w.dtype,
                             device=w.device)}
    return adapters


def merge(params, adapters: Dict, alpha: float = 16.0):
    """Effective params; gradients flow only into ``adapters``."""
    leaves = []
    for path, w in flatten_with_path(params):
        base = w.detach()
        ad = adapters.get(_key(path))
        if ad is not None:
            r = ad["a"].shape[-1]
            delta = (alpha / r) * (ad["a"] @ ad["b"])
            base = base + delta.to(base.dtype)
        leaves.append(base)
    return tree_unflatten_paths(params, leaves)


@torch.no_grad()
def fold(params, adapters: Dict, alpha: float = 16.0):
    """Permanently fold adapters into the base weights (export path): a
    new tree (the untargeted leaves are the base's own tensors)."""
    return merge(params, adapters, alpha)
