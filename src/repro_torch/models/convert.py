"""Weights carried across frameworks.

The port keeps the reference's parameter tree (same dict/tuple paths, the
stacked ``layers`` axis) and its weight orientation (``x @ W`` with ``W`` of
shape ``(D_in, D_out)``), so a tree of numpy arrays taken from the JAX
package (``jax.tree.map(np.asarray, params)``) maps leaf for leaf onto
tensors and back, bit for bit.  A whole train state (params, both Adam
moments and the step counters) crosses the same way, so both packages can
start training from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.modules import tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:        # numpy has no bfloat16: widen
        t = t.float()                    # (exact: every bf16 is an fp32)
    return t.numpy()


def params_from_numpy(tree, device=None):
    """Tree of numpy arrays -> the same tree of tensors on ``device``."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree):
    """Tree of tensors -> the same tree of numpy arrays (bf16 leaves come
    back as fp32)."""
    return tree_map(_to_numpy, tree)


def train_state_from_numpy(state, device=None):
    """A whole train state as numpy leaves (``jax.tree.map(np.asarray,
    state)`` of the reference's ``TrainState``, or anything with its
    ``params`` / ``opt.m`` / ``opt.v`` / ``opt.step`` / ``step`` fields) ->
    the port's :class:`~repro_torch.training.train_state.TrainState`:
    params and both Adam moments on ``device``, the step counters as 0-d
    int32 host tensors.  :func:`params_to_numpy` takes the state back."""
    # imported here: the training modules import repro_torch.models
    from repro_torch.training.optimizer import AdamState
    from repro_torch.training.train_state import TrainState

    step = lambda s: torch.tensor(int(np.asarray(s)), dtype=torch.int32)
    return TrainState(
        params=params_from_numpy(state.params, device),
        opt=AdamState(m=params_from_numpy(state.opt.m, device),
                      v=params_from_numpy(state.opt.v, device),
                      step=step(state.opt.step)),
        step=step(state.step))
