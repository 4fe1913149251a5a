"""Train steps: causal-LM (SFT / pretrain-mixture) and reward (pairwise
ranking); counterpart of ``repro/training/steps.py``.

Where the reference takes ``jax.value_and_grad`` of a pure loss, the port
runs the loss on detached leaves that require grad and collects the
gradients with ``torch.autograd.grad`` (:func:`value_and_grad`).  The
multi-device pieces (``gather_pspecs``, ``grad_pspecs``,
:func:`make_sharded_lm_step`) belong to the multi-device slice and raise.
"""
from __future__ import annotations

import torch

from repro_torch.models import reward as R
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import tree_leaves, tree_map, tree_unflatten
from repro_torch.training.train_state import TrainState


def value_and_grad(loss_fn, params):
    """``loss_fn(params) -> (loss, metrics)``.  Returns ``((loss, metrics),
    grads)`` with ``grads`` shaped like ``params`` (zeros for a leaf the
    loss does not reach) and the outputs detached."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(torch.is_floating_point(p))
            for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, live))
    wrt = [p for p in live if p.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in live:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def lm_loss_fn(cfg: ModelConfig, params, batch):
    if batch.get("encoder_embeds") is not None:
        raise NotImplementedError("encoder_embeds (VLM): not yet ported")
    hidden, _, aux = T.forward(cfg, params, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"), mode="full")
    loss = T.lm_loss(cfg, params, hidden, batch["labels"], batch["mask"])
    return loss + aux, {"lm_loss": loss, "aux_loss": aux}


def lm_value_and_grad(cfg: ModelConfig, params, batch, micro: int = 1):
    """Loss, metrics and grads of :func:`lm_loss_fn`.  With ``micro > 1``
    the batch is cut into ``micro`` slices along its leading axis whose
    grads are accumulated in fp32 and averaged (gradient accumulation: the
    activations of one slice at a time)."""
    if micro <= 1:
        return value_and_grad(lambda p: lm_loss_fn(cfg, p, batch), params)
    mb = {k: v.reshape((micro, v.shape[0] // micro) + tuple(v.shape[1:]))
          for k, v in batch.items() if v is not None}
    gacc, losses, mets = None, [], []
    for i in range(micro):
        (l, met), g = value_and_grad(
            lambda p: lm_loss_fn(cfg, p, {k: v[i] for k, v in mb.items()}),
            params)
        if gacc is None:
            gacc = tree_map(lambda x: x.float(), g)
        else:
            torch._foreach_add_(tree_leaves(gacc),
                                [x.float() for x in tree_leaves(g)])
        losses.append(l)
        mets.append(met)
    grads = tree_map(lambda x: x / micro, gacc)
    loss = torch.stack(losses).mean()
    metrics = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
    return (loss, metrics), grads


def lm_train_step(cfg: ModelConfig, state: TrainState, batch, lr,
                  weight_decay=0.0, trainable_mask=None, micro: int = 1,
                  gather_pspecs=None, grad_pspecs=None):
    """One LM step: grads (accumulated over ``micro`` slices), then AdamW.
    Returns ``(state, metrics)`` with ``loss`` and ``grad_norm``."""
    if gather_pspecs is not None or grad_pspecs is not None:
        raise NotImplementedError(
            "lm_train_step(gather_pspecs=/grad_pspecs=): not yet ported")
    (loss, metrics), grads = lm_value_and_grad(cfg, state.params, batch,
                                               micro)
    state, gnorm = state.apply_gradients(
        grads, lr=lr, weight_decay=weight_decay,
        trainable_mask=trainable_mask)
    return state, dict(metrics, loss=loss, grad_norm=gnorm)


def make_sharded_lm_step(*args, **kwargs):
    raise NotImplementedError("make_sharded_lm_step (DP x TP mesh): "
                              "not yet ported")


def reward_loss_fn(cfg: ModelConfig, params, batch):
    loss, acc = R.pairwise_loss(cfg, params, batch["chosen"],
                                batch["rejected"], batch["chosen_mask"],
                                batch["rejected_mask"])
    return loss, {"rm_loss": loss, "rm_acc": acc}


def reward_train_step(cfg: ModelConfig, state: TrainState, batch, lr,
                      weight_decay=0.0):
    (loss, metrics), grads = value_and_grad(
        lambda p: reward_loss_fn(cfg, p, batch), state.params)
    state, gnorm = state.apply_gradients(grads, lr=lr,
                                         weight_decay=weight_decay)
    return state, dict(metrics, loss=loss, grad_norm=gnorm)
