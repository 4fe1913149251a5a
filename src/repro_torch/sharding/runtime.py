"""Layouts at run time: trees of ``DTensor``\\ s on a ``DeviceMesh`` and the
few collectives the data-parallel paths make.

A tree in a mesh layout holds ``DTensor`` leaves whose local tensors are
exactly what the pspec gives this rank (:func:`place` slices a full tensor
locally; every rank holds the same full tensor, so nothing is sent).
Compute runs on plain tensors: :func:`full` gathers a leaf (one all-gather
over the dims that shard it, nothing for a replicated leaf), and the
model code and the CUDA kernels run on the result unchanged.

Over ``model`` the compute is tensor-parallel (Megatron's split): each
rank computes on its own heads, MLP width, vocabulary rows or experts.
:func:`compute_view` gives a tree's leaves as the ranks compute on them:
gathered over ``data`` (ZeRO-3's rule, a gather at use), and over
``model`` the rank's slice, the local shard itself where the pspec cuts
exactly that slice and a local slice of the gathered leaf where it does
not (kv heads cut into half heads at ``tp > KV``; the Mamba2 mixer's
concatenated ``[z | x | B | C | dt]`` columns, whose rank's heads are
ranges of the gathered leaf), or the whole leaf (a layer kind whose
heads ``tp`` does not split whole is computed whole on every rank).
:func:`to_layout` takes the grads of that view back into
``DTensor``\\ s that the optimizer reduces into its layout.  The model
code takes a :class:`TP` context (the model group, the rank in it and its
size) and makes its
collectives through three autograd functions (:func:`copy_to_model`,
:func:`reduce_from_model`, :func:`gather_last`); on a one-rank model
group each is the identity, so the 1 x 1 mesh computes the plain path's
arithmetic.  :func:`check_compute_mesh` refuses what ``model > 1`` does
not compute yet (Mamba2 mixers of several groups that ``model`` does not
divide).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.sharding.strategy import mesh_axes


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _wait(t):
    """A functional collective's result as a plain tensor."""
    return t.wait() if hasattr(t, "wait") else t


def local(x):
    """The local tensor of a ``DTensor`` (the tensor itself otherwise)."""
    if not is_dtensor(x):
        return x
    with torch.no_grad():
        return _wait(x.to_local())


def mesh_size(mesh) -> int:
    return math.prod(mesh_axes(mesh).values())


def check_compute_mesh(mesh, what: str, cfg=None) -> None:
    """Refuse what a ``model`` axis larger than 1 does not compute yet:
    Mamba2 mixers of more than one group that ``model`` does not divide
    (every config of the repo has one)."""
    tp = 1 if mesh is None else mesh_axes(mesh).get("model", 1)
    if tp == 1 or cfg is None:
        return
    from repro_torch.models.config import SSM
    kinds = {ls.kind for seg in cfg.segments() for ls in seg.unit_spec}
    if SSM in kinds and cfg.ssm_ngroups > 1 and cfg.ssm_ngroups % tp:
        raise NotImplementedError(
            f"{what}: a Mamba2 mixer of {cfg.ssm_ngroups} groups over "
            f"model = {tp}: not yet ported")


# ===================================================================== #
# tensor parallelism over ``model``
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class TP:
    """The tensor-parallel context the model code takes: the ``model``
    process group, this rank's index in it and its size; ``rows`` is the
    data group whose rows an MoE layer routes together (``None``: the
    rows of the call), and ``counts`` the number of rows each rank of it
    holds (``None``: the same number on every rank)."""
    group: Any
    rank: int
    size: int
    rows: Any = None
    counts: Optional[tuple] = None

    def with_rows(self, rows, counts=None) -> "TP":
        return dataclasses.replace(self, rows=rows, counts=counts)

    def row_offset(self, n: int) -> int:
        """The first of this rank's ``n`` rows in the data group's rows,
        gathered in rank order."""
        r = self.rows.rank()
        return r * n if self.counts is None else sum(self.counts[:r])


def tp_context(mesh, rows=None) -> Optional[TP]:
    """The :class:`TP` context of ``mesh``'s ``model`` axis (``None``
    without a mesh)."""
    if mesh is None:
        return None
    i = mesh.mesh_dim_names.index("model")
    return TP(mesh.get_group("model"), mesh.get_coordinate()[i],
              mesh.size(i), rows)


def _split(tp) -> bool:
    return tp is not None and tp.size > 1


def _all_reduce(x, group):
    import torch.distributed as dist
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    """Into the model region: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Out of the model region: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """The ranks' last-dim slices concatenated in rank order; backward
    keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        import torch.distributed as dist
        ctx.rank, ctx.n = rank, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.n
        return g[..., lo:lo + ctx.n], None, None, None


class _GatherRows(torch.autograd.Function):
    """The data group's rows concatenated in rank order (``counts``: each
    rank's number of rows, ``None`` where they are equal); backward sums
    the grads over the group and keeps this rank's rows (each rank
    computes on every row, so a row's grad is the sum of the ranks')."""

    @staticmethod
    def forward(ctx, x, group, rank, counts):
        ctx.group, ctx.n = group, x.shape[0]
        ctx.lo = rank * ctx.n if counts is None else sum(counts[:rank])
        if counts is None:
            return gather_rows(x, group)
        m = max(counts)                     # padded to the most rows
        pad = torch.cat([x, x.new_zeros((m - ctx.n,) + tuple(x.shape[1:]))])
        out = gather_rows(pad, group)
        return torch.cat([out[j * m:j * m + c] for j, c in enumerate(counts)])

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        return g[ctx.lo:ctx.lo + ctx.n], None, None, None


def copy_to_model(x, tp):
    """``x`` entering a model-parallel region (grads summed over
    ``model`` in the backward); ``x`` itself on a one-rank group."""
    return _CopyToModel.apply(x, tp.group) if _split(tp) else x


def reduce_from_model(x, tp):
    """The sum over ``model`` of the ranks' partial ``x``."""
    return _ReduceFromModel.apply(x, tp.group) if _split(tp) else x


def gather_last(x, tp):
    """The ranks' slices of the last dim, concatenated."""
    return (_GatherLast.apply(x, tp.group, tp.rank, tp.size)
            if _split(tp) else x)


def max_over_model(x, tp):
    """The elementwise max over ``model`` (no grad)."""
    if not _split(tp):
        return x
    import torch.distributed as dist
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=tp.group)
    return out


def gather_data_rows(x, tp):
    """The rows of every rank of ``tp.rows`` (the data group), in rank
    order (``tp.counts`` of them on each rank: a rank may hold none), with
    the backward of :class:`_GatherRows`; ``x`` itself without one."""
    g = None if tp is None else tp.rows
    if g is None or g.size() == 1:
        return x
    return _GatherRows.apply(x, g, g.rank(), tp.counts)


# ===================================================================== #
# the compute view of a tree over ``model``
# ===================================================================== #
def _model_dim(x) -> Optional[int]:
    """The tensor dim ``x`` shards over ``model`` (None: replicated)."""
    if not is_dtensor(x):
        return None
    names = x.device_mesh.mesh_dim_names
    pl = x.placements[names.index("model")]
    return pl.dim if pl.is_shard() and x.device_mesh.size(
        names.index("model")) > 1 else None


def leaf_views(cfg, params, specs, tp):
    """A :class:`~repro_torch.sharding.strategy.View` for each leaf of
    ``params`` (a tree of ``DTensor``\\ s laid out by the pspecs of
    ``specs``) at ``tp``: :func:`repro_torch.sharding.strategy.
    compute_slices` of the dims the leaves shard over ``model``."""
    from repro_torch.sharding import strategy as S
    dims = tree_map(_model_dim, params)
    return S.compute_slices(specs, dims, cfg, 1 if tp is None else tp.size,
                            0 if tp is None else tp.rank)


def _gather_data(x):
    """``x`` gathered over every mesh dim but ``model`` (the model shard
    stays): a plain tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names
    pls = tuple(pl if n == "model" else Replicate()
                for n, pl in zip(names, x.placements))
    if pls == tuple(x.placements):
        return local(x)
    return local(redistribute(x, pls))


def mesh_view(cfg, params, mesh, rows=None):
    """``(view, views, tp)`` of the LM's or the reward model's params (the
    latter hold ``v_head``) on ``mesh``: the plain tensors this rank
    computes on (:func:`compute_view`), their
    :class:`~repro_torch.sharding.strategy.View`\\ s (what :func:`to_layout`
    takes the grads back through) and the :class:`TP` context, whose
    ``rows`` is the data group the batch is sharded over (an MoE layer
    routes its rows together)."""
    from repro_torch.models import reward as R
    from repro_torch.models import transformer as T
    specs = (R.param_specs(cfg) if "v_head" in params
             else T.param_specs(cfg))
    tp = tp_context(mesh, rows=rows)
    views = leaf_views(cfg, params, specs, tp)
    return compute_view(params, views), views, tp


def _view_leaf(x, v):
    from repro_torch.sharding.strategy import ALIGNED, SEGMENTS, SLICED
    if v.kind == ALIGNED:
        return _gather_data(x)
    t = full(x)
    if v.kind == SLICED:
        n = t.shape[v.dim] // v.parts
        t = t.narrow(v.dim, v.index * n, n).contiguous()
    elif v.kind == SEGMENTS:
        t = torch.cat([t.narrow(v.dim, a, b - a) for a, b in v.cols],
                      dim=v.dim)
    return t


def _is_view(x) -> bool:
    from repro_torch.sharding.strategy import View
    return isinstance(x, View)


def compute_view(params, views):
    """The plain tensors each rank computes on (see :func:`leaf_views`)."""
    return tree_map(lambda v, p: _view_leaf(p, v), views, params,
                    is_leaf=_is_view)


def to_layout(grads, params, views, group):
    """Grads of the compute view as ``DTensor``\\ s laid out over the params'
    mesh: partial over ``data`` when the batch is sharded over ``group``
    (replicated with ``group=None``), and over ``model`` the shard
    (aligned), a partial full-shape leaf (sliced or segments: zeros
    outside the rank's columns; where the ranks' columns overlap, as the
    Mamba2 mixer's ``B`` and ``C`` do, each holds its partial sum) or the
    whole leaf (full)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.sharding.strategy import ALIGNED, SEGMENTS, SLICED

    def one(v, g, p):
        if not is_dtensor(p):
            return g
        mesh = p.device_mesh
        pls = []
        for n in mesh.mesh_dim_names:
            if n != "model":
                pls.append(Partial() if group is not None else Replicate())
            elif v.kind == ALIGNED:
                pls.append(Shard(v.dim))
            elif v.kind in (SLICED, SEGMENTS):
                pls.append(Partial())
            else:
                pls.append(Replicate())
        if v.kind == SLICED:
            z = g.new_zeros(p.shape)
            n = p.shape[v.dim] // v.parts
            z.narrow(v.dim, v.index * n, n).copy_(g)
            g = z
        elif v.kind == SEGMENTS:
            z, o = g.new_zeros(p.shape), 0
            for a, b in v.cols:
                z.narrow(v.dim, a, b - a).copy_(g.narrow(v.dim, o, b - a))
                o += b - a
            g = z
        return from_local(g.contiguous(), mesh, pls, p.shape)
    return tree_map(one, views, grads, params, is_leaf=_is_view)


def data_group(mesh):
    """The process group of ``mesh``'s ``data`` axis."""
    return mesh.get_group("data")


def _from_local(t, mesh, placements, shape=None, stride=None):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def chunk(t, mesh, placements):
    """This rank's piece of the full tensor ``t`` under ``placements``."""
    coord = mesh.get_coordinate()
    out = t
    for mdim, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(mdim)
            out = out.chunk(n, dim=pl.dim)[coord[mdim]]
    return out


def place(t, mesh, placements):
    """``t`` (the same full tensor on every rank) as a ``DTensor`` under
    ``placements``: the local piece is sliced here, and copied when it is a
    proper part of ``t`` so that the full tensor can be freed."""
    with torch.no_grad():
        loc = chunk(t, mesh, placements)
        if loc.numel() != t.numel():
            loc = loc.contiguous().clone()
    return _from_local(loc, mesh, tuple(placements), t.shape, t.stride())


def from_local(loc, mesh, placements, shape):
    """The local tensor ``loc`` as a ``DTensor`` of global ``shape``."""
    stride = torch.empty(tuple(shape), device="meta").stride()
    return _from_local(loc, mesh, tuple(placements), torch.Size(shape),
                       stride)


def wrap(loc, like):
    """The local tensor ``loc`` as a ``DTensor`` laid out as ``like``."""
    return _from_local(loc, like.device_mesh, tuple(like.placements),
                       like.shape, like.stride())


def zeros_like_global(p, dtype, sharding):
    """Zeros of ``p``'s global shape in ``sharding``'s layout, made as the
    local shard only."""
    shape = chunk(torch.empty(p.shape, device="meta"), sharding.mesh,
                  sharding.placements).shape
    loc = torch.zeros(shape, dtype=dtype, device=local(p).device)
    return from_local(loc, sharding.mesh, sharding.placements, p.shape)


def place_tree(tree, shardings):
    """A tree of full tensors placed by a matching tree of
    :class:`~repro_torch.sharding.strategy.Sharding`\\ s."""
    return tree_map(lambda s, t: place(t, s.mesh, s.placements), shardings,
                    tree, is_leaf=is_sharding)


def is_sharding(x) -> bool:
    from repro_torch.sharding.strategy import Sharding
    return isinstance(x, Sharding)


def redistribute(x, placements):
    """``x`` under other placements (all-gather, slice or reduce-scatter,
    as the two layouts need), its local tensor materialized."""
    with torch.no_grad():
        out = x.redistribute(x.device_mesh, tuple(placements))
        return _from_local(_wait(out.to_local()), x.device_mesh,
                           tuple(placements), x.shape, x.stride())


def replicated(x) -> bool:
    """Whether every rank holds the whole of ``x``."""
    if not is_dtensor(x):
        return True
    m = x.device_mesh
    return all(not pl.is_shard() or m.size(i) == 1
               for i, pl in enumerate(x.placements))


def full(x):
    """The whole tensor on this rank as a plain tensor (gathered when
    ``x`` is sharded; the local tensor itself when it is replicated)."""
    if not is_dtensor(x):
        return x
    if replicated(x):
        return local(x)
    from torch.distributed.tensor import Replicate
    return local(redistribute(x, (Replicate(),) * x.device_mesh.ndim))


def full_tree(tree):
    return tree_map(full, tree)


def local_bytes(tree) -> int:
    """Bytes of this rank's local tensors."""
    return sum(local(t).numel() * local(t).element_size()
               for t in tree_leaves(tree) if t is not None)


def all_sum(values, group):
    """The sums over ``group`` of a list of tensors (one all-reduce of
    their concatenation); the values themselves when ``group`` is None."""
    if group is None or not values:
        return list(values)
    import torch.distributed as dist
    flat = torch.stack([v.detach().float().reshape(()) for v in values])
    dist.all_reduce(flat, group=group)
    return list(flat.unbind())


def all_true(flags, group) -> bool:
    """Whether every one of ``flags`` (a bool tensor) is set on every rank
    of ``group``: one all-reduce, so that the ranks take the same branch
    (``bool(flags.all())`` when ``group`` is None)."""
    if group is None:
        return bool(flags.all())
    import torch.distributed as dist
    t = flags.all().to(torch.int32).reshape(1).to(_group_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(t.item())


def _group_device(group) -> torch.device:
    import torch.distributed as dist
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def batch_local(tree):
    """``(local tree, group)`` of a tree made by
    :func:`repro_torch.sharding.strategy.shard_batch`: the rank's rows as
    plain tensors, and the data group they are sharded over (``None`` when
    the batch is replicated, holds plain tensors or the group is one
    rank)."""
    leaves = [t for t in tree_leaves(tree) if t is not None]
    group = None
    if leaves and is_dtensor(leaves[0]):
        x = leaves[0]
        names = x.device_mesh.mesh_dim_names
        for i, pl in enumerate(x.placements):
            if (pl.is_shard(0) and names[i] == "data"
                    and x.device_mesh.size(i) > 1):
                group = data_group(x.device_mesh)
    return tree_map(lambda t: None if t is None else local(t), tree), group


def wrap_rows(tree, like):
    """A tree of local row tensors as ``DTensor``\\ s with the batch
    placements of ``like`` (a ``DTensor`` made by ``shard_batch``); the
    tree itself when ``like`` is a plain tensor."""
    if not is_dtensor(like):
        return tree
    mesh, pls, n = like.device_mesh, like.placements, like.shape[0]
    return tree_map(lambda t: from_local(t, mesh, pls,
                                         (n,) + tuple(t.shape[1:])), tree)


def gather_rows(x, group) -> torch.Tensor:
    """The rows of all ranks of ``group`` concatenated in rank order (the
    tensor itself when ``group`` is None)."""
    if group is None:
        return x
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def data_share(n: int, mesh) -> tuple:
    """``(start, stop, group)``: this rank's contiguous share of ``n`` rows
    (a batch, or the slots of a request core) over ``mesh``'s data axis
    and the data group they are split over, so that gathering the ranks'
    rows in rank order gives row order; ``(0, n, None)`` without a mesh
    or when ``n`` does not divide the axis (every rank then holds every
    row).  On a one-rank data axis the group is that one rank."""
    if mesh is None:
        return 0, n, None
    dp = mesh_axes(mesh)["data"]
    if n % dp:
        return 0, n, None
    r = mesh.get_coordinate()[mesh.mesh_dim_names.index("data")]
    return r * (n // dp), (r + 1) * (n // dp), data_group(mesh)


def gather_chunk(toks, was, done, group):
    """A serve chunk's ``(chunk, n)`` tokens and pre-step done flags and
    the ``(n,)`` done flags after it, for this rank's ``n`` slots, as host
    arrays over every rank's slots of ``group`` in rank order: one
    all-gather of the three packed together, then one copy to the host
    (the rank's own arrays when ``group`` is None)."""
    c = toks.shape[0]
    packed = torch.cat([toks.T, was.T.long(), done[:, None].long()], dim=1)
    h = gather_rows(packed, group).cpu().numpy()
    return (h[:, :c].T.astype(np.int32), h[:, c:2 * c].T.astype(bool),
            h[:, 2 * c].astype(bool))
