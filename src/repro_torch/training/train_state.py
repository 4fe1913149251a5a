"""TrainState: params + AdamW state + step counter (counterpart of
``repro/training/train_state.py``).  On a mesh the params and the fp32
moments are trees of ``DTensor``s in the training layout; the step
counters stay host tensors."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.training import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.AdamState
    step: torch.Tensor

    @classmethod
    def create(cls, params, shardings=None) -> "TrainState":
        """``shardings`` (a TrainState-shaped tree of
        :class:`~repro_torch.sharding.strategy.Sharding`, e.g. from
        :func:`repro_torch.sharding.strategy.train_state_shardings`)
        commits the fresh state to a mesh layout: each rank keeps its piece
        of the params (which every rank holds whole), and the fp32 Adam
        moments are *born* as local shards, so ZeRO'd optimizer state never
        exists unsharded on any rank."""
        if shardings is None:
            return cls(params=params, opt=opt.init(params),
                       step=torch.zeros((), dtype=torch.int32))
        from repro_torch.sharding import runtime
        placed = runtime.place_tree(params, shardings.params)
        return cls(params=placed, opt=opt.init_sharded(placed, shardings.opt),
                   step=torch.zeros((), dtype=torch.int32))

    def apply_gradients(self, grads, *, lr, weight_decay=0.0,
                        grad_clip=1.0, trainable_mask=None):
        """Returns ``(TrainState, gnorm)``.  The params and moments are
        updated in place (see :func:`repro_torch.training.optimizer.update`).
        In a mesh layout the grads are ``DTensor``\\ s laid out over the mesh
        (:func:`repro_torch.sharding.runtime.to_layout`), see
        :func:`repro_torch.training.optimizer.update_sharded`."""
        from repro_torch.sharding import runtime
        if any(runtime.is_dtensor(p) for p in opt.tree_leaves(self.params)):
            p, o, gnorm = opt.update_sharded(
                self.params, grads, self.opt, lr=lr,
                weight_decay=weight_decay, grad_clip=grad_clip,
                trainable_mask=trainable_mask)
        else:
            p, o, gnorm = opt.update(self.params, grads, self.opt, lr=lr,
                                     weight_decay=weight_decay,
                                     grad_clip=grad_clip,
                                     trainable_mask=trainable_mask)
        return TrainState(params=p, opt=o, step=self.step + 1), gnorm
