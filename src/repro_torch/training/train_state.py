"""TrainState: params + AdamW state + step counter (counterpart of
``repro/training/train_state.py``).  Sharded creation belongs to the
multi-device slice and is not ported yet."""
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
        if shardings is not None:
            raise NotImplementedError(
                "TrainState.create(shardings=...): not yet ported")
        return cls(params=params, opt=opt.init(params),
                   step=torch.zeros((), dtype=torch.int32))

    def apply_gradients(self, grads, *, lr, weight_decay=0.0,
                        grad_clip=1.0, trainable_mask=None):
        """Returns ``(TrainState, gnorm)``.  The params and moments are
        updated in place (see :func:`repro_torch.training.optimizer.update`)."""
        p, o, gnorm = opt.update(self.params, grads, self.opt, lr=lr,
                                 weight_decay=weight_decay,
                                 grad_clip=grad_clip,
                                 trainable_mask=trainable_mask)
        return TrainState(params=p, opt=o, step=self.step + 1), gnorm
