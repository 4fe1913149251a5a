"""Train steps: causal-LM (SFT / pretrain-mixture) and reward (pairwise
ranking); counterpart of ``repro/training/steps.py``.

Where the reference takes ``jax.value_and_grad`` of a pure loss, the port
runs the loss on detached leaves that require grad and collects the
gradients with ``torch.autograd.grad`` (:func:`value_and_grad`).

On a data-parallel mesh (a state from ``TrainState.create(params,
shardings=...)``, a batch from ``shard_batch``; see
:func:`make_sharded_lm_step`) a step gathers the params once, computes the
loss of the rank's rows with every batch-wide count taken over the data
group, so that the ranks' losses sum to the global batch's, and hands the
partial grads to the optimizer, which reduce-scatters them into the ZeRO
layout (or all-reduces them for replicated moments).  The result is the
single-device result of the global batch, up to the order of the sums.
"""
from __future__ import annotations

import torch

from repro_torch.models import reward as R
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding import runtime
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


def lm_loss_fn(cfg: ModelConfig, params, batch, count=None):
    """LM loss (+ the MoE aux loss).  ``count``, when given, is the
    token count the masked sum is divided by (the global batch's on a
    mesh) in place of this batch's own.  The batch holds ``tokens``, or
    ``embeds`` for an embedding-input model, and ``encoder_embeds`` for a
    ``vlm`` one."""
    hidden, _, aux = T.forward(cfg, params, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"),
                               encoder_embeds=batch.get("encoder_embeds"),
                               mode="full")
    loss = T.lm_loss(cfg, params, hidden, batch["labels"], batch["mask"],
                     count=count)
    return loss + aux, {"lm_loss": loss, "aux_loss": aux}


def lm_value_and_grad(cfg: ModelConfig, params, batch, micro: int = 1,
                      group=None):
    """Loss, metrics and grads of :func:`lm_loss_fn`.  With ``micro > 1``
    the batch is cut into ``micro`` slices of contiguous rows whose grads
    are accumulated in fp32 and averaged (gradient accumulation: the
    activations of one slice at a time); the loss is the mean of the
    slices' means.

    With a data ``group`` the batch is this rank's rows of a global batch
    sharded over it.  Slice ``i`` is then the reference's: global rows
    ``[i*B/micro, (i+1)*B/micro)``.  The rank computes its own rows of
    each slice (none, for a slice other ranks hold), divided by the
    slice's global token count; the loss and metrics are the global
    batch's, the grads this rank's partial sums."""
    batch = {k: v for k, v in batch.items() if v is not None}
    n_loc = next(iter(batch.values())).shape[0]
    row0, n = _rows(n_loc, group)
    if n % micro:
        raise ValueError(f"batch {n} is not a multiple of micro={micro}")
    size = n // micro
    spans = [(max(i * size, row0) - row0,
              min((i + 1) * size, row0 + n_loc) - row0)
             for i in range(micro)]
    counts = [None] * micro
    if group is not None:
        mask = batch["mask"].float()
        counts = runtime.all_sum(
            [mask[lo:hi].sum() if hi > lo else mask.new_zeros(())
             for lo, hi in spans], group)
    gacc, parts = None, []
    for (lo, hi), cnt in zip(spans, counts):
        if hi <= lo:
            parts.append(None)
            continue
        sub = {k: v[lo:hi] for k, v in batch.items()}
        (l, met), g = value_and_grad(
            lambda p: lm_loss_fn(cfg, p, sub, count=cnt), params)
        if micro > 1:
            g = tree_map(lambda x: x.float(), g)
            if gacc is None:
                gacc = g
            else:
                torch._foreach_add_(tree_leaves(gacc), tree_leaves(g))
        else:
            gacc = g
        parts.append((l, met))
    first = next(p for p in parts if p is not None)
    keys, zero = list(first[1]), torch.zeros_like(first[0])
    flat = runtime.all_sum(
        [v for p in parts for v in ((zero,) * (1 + len(keys)) if p is None
                                    else (p[0], *(p[1][k] for k in keys)))],
        group)
    per = [flat[i::1 + len(keys)] for i in range(1 + len(keys))]
    if micro == 1:
        return (per[0][0], {k: v[0] for k, v in zip(keys, per[1:])}), gacc
    loss = torch.stack(per[0]).mean()
    metrics = {k: torch.stack(v).mean() for k, v in zip(keys, per[1:])}
    return (loss, metrics), tree_map(lambda x: x / micro, gacc)


def lm_train_step(cfg: ModelConfig, state: TrainState, batch, lr,
                  weight_decay=0.0, trainable_mask=None, micro: int = 1,
                  gather_pspecs=None, grad_pspecs=None):
    """One LM step: grads (accumulated over ``micro`` slices), then AdamW.
    Returns ``(state, metrics)`` with ``loss`` and ``grad_norm``.

    A state in a mesh layout takes the data-parallel step: the params are
    gathered once, the rank's rows computed (:func:`lm_value_and_grad`
    with the batch's data group) and the partial grads handed to the
    optimizer.  There ``gather_pspecs`` (the reference's phase-amortized
    gather) casts the params to the compute dtype before the one gather
    of the step when ``micro > 1``, so the gather moves compute-dtype
    bytes and the accumulated grads come back through that cast, as in
    the reference; ``grad_pspecs`` is the layout the accumulated grads
    are reduced into before the update."""
    on_mesh = in_mesh_layout(state)
    if not on_mesh and (gather_pspecs is not None
                        or grad_pspecs is not None):
        raise ValueError("gather_pspecs / grad_pspecs need a state in a "
                         "mesh layout (TrainState.create(shardings=))")
    local, group = runtime.batch_local(batch)
    if on_mesh:
        check_mesh_compute(cfg, state, group, "lm_train_step")
    cast = gather_pspecs is not None and micro > 1
    params = tree_map(
        lambda p: runtime.full(_cast_local(cfg, p) if cast else p),
        state.params)
    (loss, metrics), grads = lm_value_and_grad(cfg, params, local, micro,
                                               group)
    if cast:             # back through the compute-dtype cast
        grads = tree_map(lambda g, p: g.to(cfg.cdtype).to(p.dtype),
                         grads, state.params)
    if grad_pspecs is not None:
        grads = _reduce_into(grads, grad_pspecs, _state_mesh(state), group)
    state, gnorm = state.apply_gradients(
        grads, lr=lr, weight_decay=weight_decay,
        trainable_mask=trainable_mask, group=group)
    return state, dict(metrics, loss=loss, grad_norm=gnorm)


def in_mesh_layout(state) -> bool:
    return any(runtime.is_dtensor(p) for p in tree_leaves(state.params))


def _state_mesh(state):
    return next(p.device_mesh for p in tree_leaves(state.params)
                if runtime.is_dtensor(p))


def check_mesh_compute(cfg: ModelConfig, state, group, what: str) -> None:
    runtime.check_compute_mesh(_state_mesh(state), what)
    if cfg.moe and group is not None and group.size() > 1:
        # capacity couples the rows of a call (ROADMAP R13): the rows of
        # one rank route apart from the global batch's
        raise NotImplementedError(f"{what}: MoE over a sharded batch "
                                  "(expert parallelism) is not yet ported")


def _rows(local_n: int, group):
    """``(first global row, global rows)`` of this rank's ``local_n``."""
    if group is None:
        return 0, local_n
    return group.rank() * local_n, group.size() * local_n


def _reduce_into(grads, pspecs, mesh, group):
    """Partial grads reduced (or, for a replicated batch, sliced) into the
    layout of ``pspecs``, as ``DTensor``s."""
    from repro_torch.sharding import strategy as S

    def one(g, ps):
        pl = S.placements(ps, mesh)
        loc = (runtime.reduce_partial(g, mesh, pl) if group is not None
               else runtime.chunk(g, mesh, pl))
        return runtime.from_local(loc, mesh, pl, g.shape)
    return tree_map(one, grads, pspecs)


def _cast_local(cfg: ModelConfig, p):
    """``p`` in the compute dtype, cast on its local shard (a float leaf)."""
    if not torch.is_floating_point(runtime.local(p)):
        return p
    loc = runtime.local(p).to(cfg.cdtype)
    if not runtime.is_dtensor(p):
        return loc
    return runtime.wrap(loc, p)


def mesh_value_and_grad(cfg: ModelConfig, what: str, loss_fn, state,
                        batch):
    """``loss_fn(params, local_batch, group) -> (loss, metrics)``.  On a
    state in a mesh layout: the params gathered, the loss of this rank's
    rows (each a partial sum of the global loss), the loss and metrics
    summed over the data group.  On a plain state it is
    :func:`value_and_grad` of ``loss_fn(params, batch, None)``.  Returns
    ``((loss, metrics), grads, group)``, the grads this rank's partial
    sums."""
    local, group = runtime.batch_local(batch)
    if in_mesh_layout(state):
        check_mesh_compute(cfg, state, group, what)
    params = runtime.full_tree(state.params)
    (loss, metrics), grads = value_and_grad(
        lambda p: loss_fn(p, local, group), params)
    keys = list(metrics)
    vals = runtime.all_sum([loss] + [metrics[k] for k in keys], group)
    return (vals[0], dict(zip(keys, vals[1:]))), grads, group


def make_sharded_lm_step(cfg: ModelConfig, mesh, strategy: str, *,
                         zero: int = 1, micro: int = 1,
                         weight_decay: float = 0.0):
    """The LM step on a DP mesh.  Returns ``(step, state_shardings,
    shard_batch)`` as the reference does:

    - ``step(state, batch, lr)`` — :func:`lm_train_step` on a state in the
      training layout (``strategy`` params, ZeRO-``zero`` Adam moments);
      the state stays in that layout and the metrics are global;
    - ``state_shardings`` — pass to ``TrainState.create(params,
      shardings=...)`` to commit a fresh state;
    - ``shard_batch(batch)`` — commits a batch's leading dim to the data
      axis (replicated when indivisible)."""
    from repro_torch.sharding import strategy as S
    runtime.check_compute_mesh(mesh, "make_sharded_lm_step")
    st_sh = S.train_state_shardings(cfg, mesh, strategy, zero=zero)

    def step(state, batch, lr):
        return lm_train_step(cfg, state, batch, lr,
                             weight_decay=weight_decay, micro=micro)

    def shard_batch(batch):
        return S.shard_batch(batch, mesh)

    return step, st_sh, shard_batch


def reward_loss_fn(cfg: ModelConfig, params, batch, group=None):
    loss, acc = R.pairwise_loss(cfg, params, batch["chosen"],
                                batch["rejected"], batch["chosen_mask"],
                                batch["rejected_mask"], group=group)
    return loss, {"rm_loss": loss, "rm_acc": acc}


def reward_train_step(cfg: ModelConfig, state: TrainState, batch, lr,
                      weight_decay=0.0):
    (loss, metrics), grads, group = mesh_value_and_grad(
        cfg, "reward_train_step",
        lambda p, b, g: reward_loss_fn(cfg, p, b, g), state, batch)
    state, gnorm = state.apply_gradients(grads, lr=lr,
                                         weight_decay=weight_decay,
                                         group=group)
    return state, dict(metrics, loss=loss, grad_norm=gnorm)
