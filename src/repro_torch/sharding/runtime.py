"""Layouts at run time: trees of ``DTensor``\\ s on a ``DeviceMesh`` and the
few collectives the data-parallel paths make.

A tree in a mesh layout holds ``DTensor`` leaves whose local tensors are
exactly what the pspec gives this rank (:func:`place` slices a full tensor
locally; every rank holds the same full tensor, so nothing is sent).
Compute runs on plain tensors: :func:`full` gathers a leaf (one all-gather
over the dims that shard it, nothing for a replicated leaf), and the
model code and the CUDA kernels run on the result unchanged.

Only the ``data`` axis carries compute in this port; a mesh whose
``model`` axis is larger than 1 holds layouts and reshards them, and
:func:`check_compute_mesh` refuses compute on it.
"""
from __future__ import annotations

import math
from typing import Optional

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


def check_compute_mesh(mesh, what: str) -> None:
    """Compute runs on the ``data`` axis only: refuse a ``model`` axis
    larger than 1."""
    if mesh is not None and mesh_axes(mesh).get("model", 1) > 1:
        raise NotImplementedError(
            f"{what} on a mesh with model > 1 (tensor-parallel compute): "
            "not yet ported")


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


def reduce_partial(g, mesh, placements):
    """This rank's piece, under ``placements``, of the sum over the data
    axis of the full-shape partial tensors ``g`` (a reduce-scatter, or an
    all-reduce where ``placements`` replicate)."""
    from torch.distributed.tensor import Partial, Replicate
    src = tuple(Partial() if n == "data" else Replicate()
                for n in mesh.mesh_dim_names)
    with torch.no_grad():
        dt = _from_local(g, mesh, src, g.shape, g.stride())
        return _wait(dt.redistribute(mesh, tuple(placements)).to_local())


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


def all_max(value: float, group) -> float:
    if group is None:
        return value
    import torch.distributed as dist
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_group_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def _group_device(group) -> torch.device:
    import torch.distributed as dist
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def batch_local(tree):
    """``(local tree, group)`` of a tree made by
    :func:`repro_torch.sharding.strategy.shard_batch`: the rank's rows as
    plain tensors, and the data group they are sharded over (``None`` when
    the batch is replicated or holds plain tensors)."""
    leaves = [t for t in tree_leaves(tree) if t is not None]
    group = None
    if leaves and is_dtensor(leaves[0]):
        x = leaves[0]
        names = x.device_mesh.mesh_dim_names
        for i, pl in enumerate(x.placements):
            if pl.is_shard(0) and names[i] == "data":
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


def rows_of(n: int, mesh) -> Optional[tuple]:
    """``(start, stop)`` of this rank's rows of an ``n``-row batch on
    ``mesh``'s data axis, or ``None`` when ``n`` does not divide it (every
    rank then takes every row)."""
    dp = mesh_axes(mesh)["data"]
    if n % dp:
        return None
    r = mesh.get_coordinate()[mesh.mesh_dim_names.index("data")]
    return r * (n // dp), (r + 1) * (n // dp)
