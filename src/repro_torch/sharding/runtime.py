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

A sharded checkpoint addresses a rank's piece by its window
(:func:`window`: each dim's ``[start, stop)`` at a mesh coordinate, from
the pspec alone, the inverse of :func:`chunk`); a restore builds the
piece from the windows the files hold and wraps it with
:func:`from_local` (:mod:`repro_torch.training.checkpoint`).
"""
from __future__ import annotations

import dataclasses
import itertools
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


def pspec_of(placements, names, ndim: int) -> tuple:
    """The pspec of ``placements`` on a mesh of axes ``names``: for each of
    ``ndim`` tensor dims the axes that shard it (``None``, a name, or a
    tuple of names major-first: mesh-dim order, as ``DTensor`` applies
    them)."""
    from torch.distributed.tensor import Replicate, Shard
    axes = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if type(pl) is Shard:
            axes[pl.dim].append(name)
        elif type(pl) is not Replicate:
            raise ValueError(f"placement {pl} is neither Shard nor "
                             f"Replicate")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in axes)


def window(pspec, axes: dict, shape, coord) -> tuple:
    """The piece of a tensor of global ``shape`` laid out by ``pspec`` that
    the rank at mesh coordinate ``coord`` holds, on a mesh of ``axes``
    (``{name: size}``; ``coord`` one index per axis, in that order): each
    dim's ``(start, stop)``, or ``None`` where the rank holds the whole
    dim.  An entry naming several axes splits the dim over them
    major-first, as the reference's ``PartitionSpec`` does.  The inverse
    of :func:`chunk`; a pure function (no process group).  The strategies
    shard a dim only where its axes divide it, so every piece is even: a
    dim they do not divide raises ``ValueError``."""
    names = list(axes)
    out = []
    for d, n in enumerate(shape):
        e = pspec[d] if d < len(pspec) else None
        parts, idx = 1, 0
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            parts *= axes[a]
            idx = idx * axes[a] + coord[names.index(a)]
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)}: {n} does not "
                             f"split evenly over {e!r} ({parts} ways)")
        lo, hi = idx * (n // parts), (idx + 1) * (n // parts)
        out.append(None if (lo, hi) == (0, n) else (lo, hi))
    return tuple(out)


def mesh_coords(axes: dict) -> list:
    """Every coordinate of a mesh of ``axes``, in row-major order: the
    order of its ranks (:func:`repro_torch.launch.mesh.make_mesh`) and of
    the reference's devices."""
    return list(itertools.product(*(range(s) for s in axes.values())))


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


def move(x, sharding):
    """``x`` (a ``DTensor``, or a plain tensor that every rank holds whole)
    in ``sharding``'s layout: itself when it is laid out so already."""
    if is_dtensor(x):
        if tuple(x.placements) == tuple(sharding.placements):
            return x
        return redistribute(x, sharding.placements)
    return place(x, sharding.mesh, sharding.placements)


def place_tree(tree, shardings):
    """A tree of full tensors (or ``DTensor``\\ s, moved) placed by a
    matching tree of :class:`~repro_torch.sharding.strategy.Sharding`\\ s."""
    return tree_map(lambda s, t: move(t, s), shardings, tree,
                    is_leaf=is_sharding)


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


def all_max(x, group):
    """The elementwise max of ``x`` over ``group`` (no grad)."""
    import torch.distributed as dist
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


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


def same_on_mesh(value: int, mesh) -> bool:
    """Whether the integer ``value`` is the same on every rank of ``mesh``
    (one all-reduce over each of its axes of more than one rank)."""
    import torch.distributed as dist
    t = torch.tensor([value, -value], dtype=torch.int64,
                     device=_group_device(mesh.get_group(0)))
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    return int(t[0]) == value == -int(t[1])


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


# ===================================================================== #
# from one mesh to another: windows sent point to point
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class Side:
    """One end of a cross-mesh transfer: the mesh's ``axes``
    (``{name: size}``) and its global ``ranks`` in row-major order (one
    rank and no axes for a tree of plain tensors)."""
    axes: dict
    ranks: tuple


def side_of(mesh) -> Side:
    """The :class:`Side` of a ``DeviceMesh``."""
    return Side(dict(mesh_axes(mesh)),
                tuple(int(r) for r in mesh.mesh.flatten().tolist()))


def _box(win, shape) -> tuple:
    """A :func:`window` with every dim as ``(start, stop)``."""
    return tuple((0, n) if w is None else tuple(w)
                 for w, n in zip(win, shape))


def _meet(a, b):
    """The intersection of two boxes, ``None`` when it is empty."""
    out = tuple((max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1)
                in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def bridge_plan(leaves, src: Side, dst: Side) -> list:
    """Who sends what to whom, for leaves ``(global shape, source pspec,
    destination pspec)`` laid out on ``src`` and wanted on ``dst``: per
    leaf the pieces ``(source rank, destination rank, box, source box,
    destination box)``, boxes as ``(start, stop)`` per dim.  Each
    destination rank's window is covered exactly once, by its overlaps
    with the distinct source windows; an overlap that several source ranks
    hold goes to the one given the fewest elements so far (the lowest on a
    tie), as a checkpoint's writers are chosen.  A pure function: both
    sides derive the same plan, and run its pieces in its order."""
    load = [0] * len(src.ranks)
    s_coords, d_coords = mesh_coords(src.axes), mesh_coords(dst.axes)
    plan = []
    for shape, s_ps, d_ps in leaves:
        s_wins = [_box(window(s_ps, src.axes, shape, c), shape)
                  for c in s_coords]
        pieces = []
        for di, c in enumerate(d_coords):
            dw = _box(window(d_ps, dst.axes, shape, c), shape)
            for sw in dict.fromkeys(s_wins):
                box = _meet(sw, dw)
                if box is None:
                    continue
                si = min((i for i, w in enumerate(s_wins) if w == sw),
                         key=lambda i: (load[i], i))
                load[si] += math.prod(hi - lo for lo, hi in box)
                pieces.append((src.ranks[si], dst.ranks[di], box, sw, dw))
        plan.append(pieces)
    return plan


def _rel(box, origin) -> tuple:
    """``box`` as slices of a tensor whose window is ``origin``."""
    return tuple(slice(lo - o, hi - o) for (lo, hi), (o, _) in
                 zip(box, origin))


def tree_meta(leaves) -> dict:
    """What the destination needs to know of a source tree's leaves
    (``DTensor``\\ s on one mesh, or plain tensors at one rank): each
    leaf's global shape, dtype and pspec, and the source :class:`Side`."""
    import torch.distributed as dist
    out, src = [], None
    for x in leaves:
        if is_dtensor(x):
            m = x.device_mesh
            side = side_of(m)
            ps = pspec_of(x.placements, m.mesh_dim_names, x.dim())
        else:
            side = Side({}, (dist.get_rank(),))
            ps = (None,) * x.dim()
        if src is None:
            src = side
        elif side != src:
            raise ValueError("cross-mesh transfer: the source tree's "
                             "leaves lie on more than one mesh")
        out.append((tuple(x.shape), str(x.dtype).removeprefix("torch."),
                    ps))
    return {"leaves": out, "src": src}


def _plan_of(meta: dict, dst_shardings: list) -> list:
    dst = side_of(dst_shardings[0].mesh)
    leaves = [(shape, ps, sh.spec) for (shape, _, ps), sh in
              zip(meta["leaves"], dst_shardings)]
    return bridge_plan(leaves, meta["src"], dst)


def window_bytes(meta: dict, dst_shardings: list) -> int:
    """Bytes the destination ranks hold of the tree after a transfer: each
    rank's window, replicas counted once per rank (the reference's
    ``_tree_device_bytes`` of the placed tree)."""
    dst = side_of(dst_shardings[0].mesh)
    total = 0
    for (shape, dt, _), sh in zip(meta["leaves"], dst_shardings):
        item = torch.empty((), dtype=getattr(torch, dt)).element_size()
        for c in mesh_coords(dst.axes):
            box = _box(window(sh.spec, dst.axes, shape, c), shape)
            total += item * math.prod(hi - lo for lo, hi in box)
    return total


# a piece is spread over the lanes from this many bytes up
_LANE_MIN_BYTES = 4 << 20


def _lanes_of(host, groups) -> list:
    """``(chunk, group)``: the bytes of the pinned (or CPU) tensor ``host``
    in contiguous chunks, one per group (one alone below
    ``_LANE_MIN_BYTES``)."""
    flat = host.view(-1).view(torch.uint8)
    n = len(groups) if flat.numel() >= _LANE_MIN_BYTES else 1
    return list(zip(flat.chunk(n), groups))


def send_windows(leaves, meta: dict, dst_shardings: list, groups,
                 ready=None) -> None:
    """This rank's pieces of a transfer (:func:`bridge_plan`) sent over the
    gloo ``groups`` (a large piece's bytes spread over all of them, sent
    at once), one piece after another in the plan's order.  A piece on
    the card is copied to pinned host memory first, on a stream of its own
    that waits for ``ready`` (an event after the tree's last write, or
    ``None``); the next piece's copy runs while this one is sent, so at
    most two pieces are held on the host."""
    import torch.distributed as dist
    me = dist.get_rank()
    plan = _plan_of(meta, dst_shardings)
    mine = [(i, p) for i, pieces in enumerate(plan) for p in pieces
            if p[0] == me]
    if not mine:
        return
    dev = local(leaves[mine[0][0]]).device
    cuda = dev.type == "cuda"
    stream = torch.cuda.Stream(dev) if cuda else None
    if cuda and ready is not None:
        stream.wait_event(ready)

    def stage(i, box, sw):
        piece = local(leaves[i])[_rel(box, sw)]
        if not cuda:
            return piece.contiguous(), None
        host = torch.empty(piece.shape, dtype=piece.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(piece, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return host, done

    works = []
    nxt = stage(mine[0][0], mine[0][1][2], mine[0][1][3])
    for k, (_, (_, dst, _, _, _)) in enumerate(mine):
        host, done = nxt
        if done is not None:
            done.synchronize()
        for w in works:                       # the previous piece is out
            w.wait()
        works = [dist.isend(chunk, dst, group=g)
                 for chunk, g in _lanes_of(host, groups)]
        if k + 1 < len(mine):
            i, (_, _, box, sw, _) = mine[k + 1]
            nxt = stage(i, box, sw)
    for w in works:
        w.wait()


def recv_windows(meta: dict, dst_shardings: list, groups, device):
    """The other end of :func:`send_windows` on a destination rank: this
    rank's window of every leaf, received piece by piece in the plan's
    order into tensors on ``device`` (through pinned host memory and a
    stream of its own on the card; the tensors are made on the calling
    thread's stream and are complete on return), as ``DTensor``\\ s on the
    destination mesh, or plain tensors when it has one rank."""
    import torch.distributed as dist
    me = dist.get_rank()
    plan = _plan_of(meta, dst_shardings)
    mesh = dst_shardings[0].mesh
    coord = mesh.get_coordinate()
    axes = mesh_axes(mesh)
    cuda = torch.device(device).type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    out = []
    for (shape, dt, _), sh, pieces in zip(meta["leaves"], dst_shardings,
                                          plan):
        dtype = getattr(torch, dt)
        dw = _box(window(sh.spec, axes, shape, coord), shape)
        loc = torch.empty(tuple(hi - lo for lo, hi in dw), dtype=dtype,
                          device=device)
        if cuda:
            stream.wait_stream(torch.cuda.current_stream(device))
        for src, dst, box, _, _ in pieces:
            if dst != me:
                continue
            host = torch.empty(tuple(hi - lo for lo, hi in box),
                               dtype=dtype, pin_memory=cuda)
            for w in [dist.irecv(chunk, src, group=g)
                      for chunk, g in _lanes_of(host, groups)]:
                w.wait()
            if cuda:
                with torch.cuda.stream(stream):
                    loc[_rel(box, dw)].copy_(host, non_blocking=True)
            else:
                loc[_rel(box, dw)].copy_(host)
        out.append(loc if mesh_size(mesh) == 1 else from_local(
            loc, mesh, sh.placements, shape))
    if cuda:
        done = torch.cuda.Event()
        done.record(stream)
        done.synchronize()
    return out
