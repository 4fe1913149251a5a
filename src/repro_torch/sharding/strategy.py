"""Sharding strategies: logical param axes -> mesh axes (counterpart of
``repro/sharding/strategy.py``).

The paper's parallelism vocabulary:

- ``ddp``   — pure data parallelism: params replicated, grads all-reduced.
- ``zero1`` — params replicated, *optimizer state* sharded over data
              (ZeRO stage 1).
- ``zero3`` — params + optimizer state sharded over the data axis on the
              ``embed`` dimension, composed with tensor parallelism over
              ``model`` (ZeRO stage 3 + TP).  The training layout.
- ``tp``    — tensor parallelism only, params replicated across data: the
              Hybrid Engine's *generation* layout.

Resolution is shape-aware, as in the reference: an axis is sharded only if
its size divides the mesh-axis product and the mesh axis is not already
used by that tensor; otherwise it degrades to replication.

A pspec is a tuple with one entry per dim: ``None``, a mesh-axis name, or
a tuple of names (the reference's ``PartitionSpec`` as a plain tuple).  A
mesh is anything with ``.shape`` (a dict of axis sizes, in order) and
``.axis_names``, or a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``.  :func:`placements` turns a pspec into the
``DTensor`` placements of a ``DeviceMesh``; :class:`Sharding` (a mesh and
its placements) is the counterpart of ``NamedSharding``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import (ParamSpec, tree_leaves, tree_map,
                                        tree_unflatten)

STRATEGIES = ("ddp", "zero1", "zero3", "tp")

# logical axes that carry tensor-parallel shards
_TP_AXES = ("heads", "kv_heads", "mlp", "experts", "vocab")


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of ``mesh``, in the mesh's order."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def data_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def rules_for(strategy: str, mesh) -> dict:
    """logical axis -> mesh axis (or tuple) for parameter tensors."""
    dp = data_axes(mesh)
    tp = {a: "model" for a in _TP_AXES}
    if strategy in ("ddp", "zero1"):
        return {}
    if strategy == "tp":
        # inference layout: TP over `model`, plus expert parallelism over
        # `data`
        return {**tp, "experts": "data"}
    if strategy == "zero3":
        return {**tp, "embed": dp}
    raise ValueError(strategy)


def opt_rules_for(strategy: str, mesh) -> dict:
    """Optimizer-state sharding; ZeRO-1 shards state even when params are
    replicated."""
    if strategy in ("zero1", "zero3"):
        return rules_for("zero3", mesh)
    if strategy == "tp":
        return rules_for("tp", mesh)
    return {}


def zero1_opt_rules(strategy: str, mesh) -> dict:
    """ZeRO-1 composed with any *param* strategy: the moments take the
    param layout plus their ``embed`` dimension over the data axes."""
    dp = data_axes(mesh)
    rules = dict(rules_for(strategy, mesh))
    if dp:
        rules.setdefault("embed", dp[0] if len(dp) == 1 else dp)
    return rules


def _mesh_size(mesh, axes) -> int:
    shape = mesh_axes(mesh)
    return math.prod(shape[a] for a in axes) if axes else 1


def spec_to_pspec(spec: ParamSpec, rules: dict, mesh) -> tuple:
    used = set()
    entries = []
    for dim, ax in zip(spec.shape, spec.axes):
        cand = rules.get(ax)
        if cand is None or ax is None or ax == "layers":
            entries.append(None)
            continue
        cand_t = (cand,) if isinstance(cand, str) else tuple(cand)
        cand_t = tuple(a for a in cand_t if a not in used)
        if cand_t and dim % _mesh_size(mesh, cand_t) == 0:
            entries.append(cand_t[0] if len(cand_t) == 1 else cand_t)
            used.update(cand_t)
        else:
            entries.append(None)
    return tuple(entries)


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _resolve(specs, rules: dict, mesh):
    return tree_map(lambda s: spec_to_pspec(s, rules, mesh), specs,
                    is_leaf=_is_spec)


def param_pspecs(cfg: ModelConfig, mesh, strategy: str):
    return _resolve(T.param_specs(cfg), rules_for(strategy, mesh), mesh)


def pspecs_for_tree(specs, mesh, strategy: str, *, opt=False):
    rules = (opt_rules_for if opt else rules_for)(strategy, mesh)
    return _resolve(specs, rules, mesh)


def train_state_pspecs(cfg: ModelConfig, mesh, strategy: str, *,
                       zero: int = 0, specs=None):
    """Pspecs of a :class:`~repro_torch.training.train_state.TrainState`
    (params, Adam moments, step counters) under ``strategy`` params.
    ``zero=1`` shards the fp32 moments over the data axes as well; the
    ``zero1`` / ``zero3`` strategies always do.  ``specs`` overrides the
    param-spec tree (``reward.param_specs`` for the critic)."""
    from repro_torch.training.optimizer import AdamState
    from repro_torch.training.train_state import TrainState
    specs = T.param_specs(cfg) if specs is None else specs
    if strategy in ("zero1", "zero3"):
        zero = 1
    prules = rules_for(strategy, mesh)
    orules = zero1_opt_rules(strategy, mesh) if zero else prules
    opt_ps = _resolve(specs, orules, mesh)
    return TrainState(params=_resolve(specs, prules, mesh),
                      opt=AdamState(m=opt_ps, v=opt_ps, step=()), step=())


def batch_pspec(mesh, batch: int, ndim: int = 2) -> tuple:
    """Shard the leading (batch) axis over the data axes if divisible."""
    dp = data_axes(mesh)
    if dp and batch % _mesh_size(mesh, dp) == 0:
        lead = dp[0] if len(dp) == 1 else dp
    elif "data" in dp and batch % mesh_axes(mesh)["data"] == 0:
        lead = "data"
    else:
        lead = None
    return (lead,) + (None,) * (ndim - 1)


# ===================================================================== #
# the compute slices of tensor parallelism
# ===================================================================== #
# how a leaf's compute view relates to its layout over ``model``
FULL = "full"          # the whole leaf (replicated over model)
ALIGNED = "aligned"    # the local model shard itself
SLICED = "sliced"      # a local slice of the leaf gathered over model
SEGMENTS = "segments"  # column ranges of the leaf gathered over model


@dataclasses.dataclass(frozen=True)
class View:
    """The piece of a leaf one rank of a ``tp``-way model group computes
    on: the whole leaf (``FULL``), ``chunk(parts, dim)[index]`` of it,
    which is the rank's shard itself (``ALIGNED``) or a slice of the leaf
    gathered over ``model`` (``SLICED``), or the ranges ``cols`` (``(start,
    stop)`` pairs) of dim ``dim`` of the gathered leaf, concatenated
    (``SEGMENTS``)."""
    kind: str
    dim: int = 0
    parts: int = 1
    index: int = 0
    cols: tuple = ()


def heads_split_whole(cfg: ModelConfig, tp: int) -> bool:
    """Whether ``tp`` ranks each compute whole heads of ``cfg``'s attention
    layers: ``n_heads % tp == 0``, and (but for MLA, whose latents carry no
    heads) ``tp`` divides the kv heads or they divide ``tp``.  Where they do
    not, every rank computes the attention layers whole."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    return H % tp == 0 and (cfg.mla or KV % tp == 0 or tp % KV == 0)


def ssm_columns(cfg: ModelConfig, name: str, tp: int, rank: int) -> tuple:
    """The ``(start, stop)`` column ranges rank ``rank`` of ``tp`` computes
    on of the Mamba2 leaf ``name`` (``w_in``'s last dim is ``[z | x | B |
    C | dt]``, ``conv_w``'s and ``conv_b``'s ``[x | B | C]``): its heads of
    ``z``, ``x`` and ``dt`` and the whole of ``B`` and ``C`` (one group,
    read by every head)."""
    di, nh = cfg.d_inner, cfg.ssm_nheads
    gn = cfg.ssm_ngroups * cfg.ssm_state
    dl, hl = di // tp, nh // tp
    x = (rank * dl, (rank + 1) * dl)
    if name == "w_in":
        return ((x[0], x[1]), (di + x[0], di + x[1]),
                (2 * di, 2 * di + 2 * gn),
                (2 * di + 2 * gn + rank * hl, 2 * di + 2 * gn
                 + (rank + 1) * hl))
    return (x, (di, di + 2 * gn))


def compute_slice(axes: tuple, model_dim, *, heads_cut: bool,
                  n_kv_heads: int, tp: int, rank: int) -> View:
    """The :class:`View` of a leaf of logical ``axes`` whose pspec puts
    dim ``model_dim`` (``None``: none) on a ``tp``-way ``model`` axis.  A
    cut dim is computed on as cut (heads, kv heads, MLP width, vocabulary
    or experts: whole heads, since ``n_heads % tp == 0`` where heads are
    cut), except the kv heads at ``tp % n_kv_heads == 0``: the pspec cuts
    ``n_kv_heads * head_dim`` into half heads there, and the rank takes
    the one kv head its q heads read (head ``h`` reads ``h // G``: kv
    head ``rank // (tp / n_kv_heads)``).  Kv heads that the pspec leaves
    whole under cut q heads (``heads_cut``) are sliced the same way."""
    KV = n_kv_heads

    def kv_view(dim):
        if KV % tp == 0:
            return View(SLICED, dim, tp, rank)
        return View(SLICED, dim, KV, rank // (tp // KV))
    if model_dim is None:
        if heads_cut and "kv_heads" in axes:
            return kv_view(axes.index("kv_heads"))
        return View(FULL)
    if axes[model_dim] == "kv_heads" and KV % tp:
        return kv_view(model_dim)
    return View(ALIGNED, model_dim, tp, rank)


def _ssm_slice(cfg: ModelConfig, name: str, axes: tuple, model_dim,
               tp: int, rank: int) -> View:
    """The :class:`View` of the Mamba2 leaf ``name`` when its heads are
    split over ``model``: ``w_in``, ``conv_w`` and ``conv_b`` by
    :func:`ssm_columns` (the pspec cuts their concatenated dim into
    contiguous chunks, which do not follow the heads), ``out_norm`` and
    ``w_out`` on their head-major ``mlp`` dim, and the per-head vectors
    ``A_log``, ``D_skip`` and ``dt_bias`` whole (the mixer takes the
    rank's heads)."""
    if name in ("w_in", "conv_w", "conv_b"):
        return View(SEGMENTS, axes.index("mlp"), tp, rank,
                    ssm_columns(cfg, name, tp, rank))
    if "mlp" in axes:
        d = axes.index("mlp")
        return View(ALIGNED if model_dim == d else SLICED, d, tp, rank)
    return View(FULL)


def model_dim(pspec: tuple):
    """The dim a pspec puts on ``model`` (``None``: none)."""
    return next((d for d, e in enumerate(pspec)
                 if e == "model" or (isinstance(e, tuple) and "model" in e)),
                None)


def compute_slices(specs, dims, cfg: ModelConfig, tp: int, rank: int):
    """A tree of :class:`View`: each leaf of the ParamSpec tree ``specs``
    at the dim ``dims`` (a matching tree) puts on a ``tp``-way ``model``
    axis, for ``rank``.  With ``tp == 1`` every leaf is ``FULL``.

    A layer kind whose leaves the layout cuts over ``model`` is split over
    the ranks by its heads (:func:`compute_slice`; the Mamba2 mixer by
    :func:`_ssm_slice`), unless its heads do not split whole
    (:func:`heads_split_whole`; ``ssm_nheads % tp`` for the mixer): then
    its leaves
    are ``FULL`` and every rank computes it whole, while the MLP, the
    experts and the vocabulary stay split."""
    flat_s = tree_leaves(specs, is_leaf=_is_spec)
    paths = _spec_paths(specs)
    flat_d = tree_leaves(tree_map(lambda s, d: d, specs, dims,
                                  is_leaf=_is_spec), is_leaf=_is_dim)
    if tp == 1:
        flat_d = [None] * len(flat_s)
    ssm = ["ssm" in p for p in paths]
    heads_cut = any(d is not None and s.axes[d] == "heads"
                    for s, d in zip(flat_s, flat_d))
    attn_whole = tp > 1 and not heads_split_whole(cfg, tp)
    ssm_cut = any(d is not None for d, m in zip(flat_d, ssm) if m)
    ssm_whole = not ssm_cut or cfg.ssm_nheads % tp != 0
    views = []
    for s, d, p, m in zip(flat_s, flat_d, paths, ssm):
        if m:
            views.append(View(FULL) if ssm_whole else
                         _ssm_slice(cfg, p[-1], s.axes, d, tp, rank))
        elif attn_whole and ("heads" in s.axes or "kv_heads" in s.axes):
            views.append(View(FULL))
        else:
            views.append(compute_slice(
                s.axes, d, heads_cut=heads_cut, n_kv_heads=cfg.n_kv_heads,
                tp=tp, rank=rank))
    it = iter(views)
    return tree_map(lambda s: next(it), specs, is_leaf=_is_spec)


def _spec_paths(tree, path=()) -> list:
    """The key path of each ParamSpec leaf, in :func:`tree_leaves`
    order."""
    if _is_spec(tree):
        return [path]
    if isinstance(tree, dict):
        return [q for k, v in tree.items()
                for q in _spec_paths(v, path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [q for i, v in enumerate(tree)
                for q in _spec_paths(v, path + (i,))]
    return []


def _is_dim(x) -> bool:
    return x is None or isinstance(x, int)


def cache_pspecs(cache_struct_tree, mesh, batch: int):
    """Pspecs of the KV / SSM cache tree (leading axis = stacked units;
    leaves as :func:`repro_torch.models.transformer.cache_struct` gives
    them, ``(shape, dtype)``).  Batch shards over data; the KV length axis
    over ``model``; SSM states shard heads over ``model``."""
    dp = data_axes(mesh)
    model = mesh_axes(mesh)["model"]
    bshard = (dp[0] if len(dp) == 1 else dp) if (
        dp and batch % _mesh_size(mesh, dp) == 0) else None

    def leaf(key, shape):
        if key in ("k_scale", "v_scale"):          # (u, B, S, KV)
            s_ok = shape[2] % model == 0
            return (None, bshard, "model" if s_ok else None, None)
        if key in ("k", "v", "ckv", "krope"):
            s_ok = shape[2] % model == 0
            return (None, bshard, "model" if s_ok else None) + (
                (None,) * (len(shape) - 3))
        if key == "conv":
            c_ok = shape[3] % model == 0
            return (None, bshard, None, "model" if c_ok else None)
        if key == "state":
            h_ok = shape[2] % model == 0
            return (None, bshard, "model" if h_ok else None, None, None)
        if key in ("xk", "xv"):
            return (None, bshard, None, None, None)
        raise KeyError(key)

    def walk(t):
        if isinstance(t, dict):
            return {k: leaf(k, v[0]) for k, v in t.items()}
        return type(t)(walk(x) for x in t)
    return walk(cache_struct_tree)


# ===================================================================== #
# placements on a DeviceMesh
# ===================================================================== #
def placements(pspec: tuple, mesh) -> tuple:
    """The ``DTensor`` placements of ``pspec`` on ``mesh``: ``Shard(d)`` on
    the mesh dim named in entry ``d``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in mesh_axes(mesh):
        dims = [d for d, e in enumerate(pspec)
                if e == ax or (isinstance(e, tuple) and ax in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and the placements of one tensor on it (the counterpart of
    ``NamedSharding``); ``spec`` is the pspec they came from."""
    mesh: Any
    placements: tuple
    spec: tuple


def is_pspec(x) -> bool:
    """Whether ``x`` is a pspec (a leaf of a pspec tree), not a tuple of
    subtrees."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def shardings_of(pspec_tree, mesh):
    """A tree of :class:`Sharding` for a tree of pspecs."""
    return tree_map(lambda ps: Sharding(mesh, placements(ps, mesh), ps),
                    pspec_tree, is_leaf=is_pspec)


def param_shardings(cfg: ModelConfig, mesh, strategy: str):
    return shardings_of(param_pspecs(cfg, mesh, strategy), mesh)


def shardings_for_tree(specs, mesh, strategy: str, *, opt=False):
    """Shardings for any ParamSpec tree (reward / critic models)."""
    return shardings_of(pspecs_for_tree(specs, mesh, strategy, opt=opt),
                        mesh)


def train_state_shardings(cfg: ModelConfig, mesh, strategy: str, *,
                          zero: int = 0, specs=None):
    return shardings_of(train_state_pspecs(cfg, mesh, strategy, zero=zero,
                                           specs=specs), mesh)


def cross_mesh_put(tree, shardings, bridge=None):
    """``tree`` placed onto ``shardings`` on a disjoint set of ranks: the
    disaggregated weight push from the training mesh to the rollout mesh,
    a collective over ``bridge`` (a
    :class:`repro_torch.launch.mesh.Bridge`, its ``weights`` group).

    On a training rank ``tree`` is in the training layout (``DTensor``\\ s
    on the training mesh, ZeRO-sharded and cut over ``model``, or plain
    tensors when that mesh has one rank); the first training rank sends
    every rollout rank the tree's shapes, dtypes and layout, then each
    piece of a rollout rank's window goes from one training rank that
    holds it (:func:`repro_torch.sharding.runtime.bridge_plan`), leaf by
    leaf, through pinned host memory on gloo; returns ``None``.  On a
    rollout rank ``tree`` is not read, and the result is this rank's
    window of every leaf, bit for bit (``DTensor``\\ s on the rollout mesh,
    plain tensors when it has one rank).  Other ranks get ``None``.
    ``shardings=None`` returns ``tree`` unchanged (one device)."""
    if shardings is None:
        return tree
    if bridge is None:
        raise ValueError("cross_mesh_put to another mesh needs the bridge "
                         "between the two meshes (launch.mesh.bridge_of)")
    role = bridge.role
    if role == "train":
        push_tree(tree, shardings, bridge)
        return None
    if role == "rollout":
        import torch
        header = recv_header(bridge)
        if header.get("kind") != "weights":
            raise ValueError(f"cross_mesh_put: expected weights, got "
                             f"{header.get('kind')!r}")
        mesh = tree_leaves(shardings, is_leaf=_is_sharding)[0].mesh
        dev = torch.device("cuda", torch.cuda.current_device()) if (
            mesh.device_type == "cuda") else torch.device("cpu")
        return pull_tree(header, shardings, bridge, dev)
    return None


def _is_sharding(x) -> bool:
    return isinstance(x, Sharding)


def push_tree(tree, shardings, bridge, ready=None, **header) -> dict:
    """The training side of :func:`cross_mesh_put`: the first training rank
    sends each rollout rank a header (``kind="weights"``, the tree's meta
    and ``header``'s keys), then every training rank sends its pieces
    (``ready``: see :func:`repro_torch.sharding.runtime.send_windows`).
    Returns ``bytes``, what the rollout ranks hold after it
    (:func:`repro_torch.sharding.runtime.window_bytes`)."""
    from repro_torch.sharding import runtime
    sh = tree_leaves(shardings, is_leaf=_is_sharding)
    # the tree's leaves in the shardings' order
    leaves = tree_leaves(tree_map(lambda _, x: x, shardings, tree,
                                  is_leaf=_is_sharding))
    meta = runtime.tree_meta(leaves)
    if bridge.train_ranks[0] == _rank():
        for r in bridge.rollout_ranks:
            send_header(bridge, r, dict(header, kind="weights", meta=meta))
    runtime.send_windows(leaves, meta, sh,
                         (bridge.weights,) + tuple(bridge.lanes), ready)
    return {"bytes": runtime.window_bytes(meta, sh)}


def pull_tree(header: dict, shardings, bridge, device):
    """The rollout side of :func:`cross_mesh_put` after its ``header``:
    this rank's windows as a tree shaped as ``shardings``."""
    from repro_torch.sharding import runtime
    sh = tree_leaves(shardings, is_leaf=_is_sharding)
    leaves = runtime.recv_windows(header["meta"], sh,
                                  (bridge.weights,) + tuple(bridge.lanes),
                                  device)
    return tree_unflatten(shardings, leaves, is_leaf=_is_sharding)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def send_header(bridge, dst: int, msg: dict, group=None) -> None:
    """One message (a small picklable dict) to rank ``dst`` over the
    bridge's ``weights`` group (or ``group``)."""
    import torch.distributed as dist
    dist.send_object_list([msg], dst,
                          group=bridge.weights if group is None else group)


def recv_header(bridge, src: Optional[int] = None, group=None) -> dict:
    """The next message from ``src`` (default: the first training rank)
    over the bridge's ``weights`` group (or ``group``)."""
    import torch.distributed as dist
    box = [None]
    dist.recv_object_list(box, bridge.train_ranks[0] if src is None
                          else src,
                          group=bridge.weights if group is None else group)
    return box[0]


def shard_batch(tree, mesh):
    """Commit a batch tree's leading dim to the data axes (replicated when
    the batch does not divide them): each leaf becomes a ``DTensor`` whose
    local tensor is this rank's rows, sliced locally (every rank holds the
    whole batch; nothing is communicated).  The one copy of the placement
    rule: the PPO trainer and the sharded LM step both call it."""
    from repro_torch.sharding import runtime
    leaves = [x for x in tree_leaves(tree) if x is not None]
    if not leaves:
        return tree
    lead = batch_pspec(mesh, int(leaves[0].shape[0]), 1)[0]
    return tree_map(
        lambda x: None if x is None else runtime.place(
            x, mesh, placements((lead,) + (None,) * (x.dim() - 1), mesh)),
        tree)
