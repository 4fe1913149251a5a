"""Device meshes on ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

One process per device: under ``torchrun`` every rank calls
:func:`init_distributed` and then builds the same mesh.  On ``cuda`` the
group is NCCL with one GPU per rank (``LOCAL_RANK``); on ``cpu`` it is
gloo.  A mesh is a ``DeviceMesh`` named ``("data", "model")`` over the
first ``dp * tp`` ranks; ranks beyond it take no part in its collectives
(``mesh.get_coordinate()`` is ``None`` there).

:func:`make_disaggregated_meshes` splits the world into a rollout mesh
(generation) and a disjoint training mesh (asynchronous RLHF), and makes
the two gloo groups that bridge them (:class:`Bridge`).  On ``cuda`` such
a world joins with ``init_distributed(..., shared_cards=True)``: the
default group is gloo for host tensors and NCCL for CUDA tensors, each
role mesh's groups inherit both, and a rank's card is ``LOCAL_RANK`` modulo
the cards there are, so that one card can hold one rank of each role (two
ranks of one role mesh on one card are refused).

The reference's TPU constants (its roofline table) are not carried over;
:func:`make_production_mesh` gives the production mesh's shape and axis
names only, for the dry-run tools.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from types import SimpleNamespace
from typing import Any, Optional

import torch

DEFAULT_TIMEOUT_S = 60.0


def init_distributed(device, *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     shared_cards: bool = False) -> torch.device:
    """Join the default process group and return this rank's device.

    The rank, world size and rendezvous come from the ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``) unless ``init_method`` (e.g.
    ``file://...``) with ``rank`` and ``world_size`` is given; a process
    started without either is a group of its own (one rank, its store in
    memory), so a launcher's ``--mesh 1,1`` runs without ``torchrun``.
    ``cuda`` uses NCCL on GPU ``LOCAL_RANK``, never gloo; ``cpu`` uses
    gloo.  ``shared_cards`` (a disaggregated world, see the module's
    docstring) takes GPU ``LOCAL_RANK % device_count`` and joins with gloo
    for host tensors and NCCL for CUDA tensors.  Every
    collective of the group fails after ``timeout_s`` rather than hang."""
    import torch.distributed as dist
    dev = torch.device(device)
    if dist.is_initialized():
        return _rank_device(dev)
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed('cuda'): CUDA is not "
                               "available; pass device='cpu' for gloo")
        card = int(os.environ.get("LOCAL_RANK", 0))
        if shared_cards:
            card %= torch.cuda.device_count()
        torch.cuda.set_device(card)
        backend = "cpu:gloo,cuda:nccl" if shared_cards else "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r}")
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is None and world_size == 1 and (
            "MASTER_ADDR" not in os.environ):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world_size, timeout=timeout)
    return _rank_device(dev)


def _rank_device(dev: torch.device) -> torch.device:
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def make_mesh(dp: int, tp: int):
    """A ``("data", "model")`` ``DeviceMesh`` of shape ``(dp, tp)`` over the
    first ``dp * tp`` ranks of the default group (which must hold them).
    Every rank of the group must call it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh {dp}x{tp}: sizes must be >= 1")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call init_distributed first")
    n, world = dp * tp, dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {dp}x{tp} needs {n} ranks, have {world}")
    return DeviceMesh(_device_type(), torch.arange(n).view(dp, tp),
                      mesh_dim_names=("data", "model"))


def mesh_from_spec(spec: str):
    """Parse a ``--mesh dp,tp`` flag (e.g. ``"2,1"``) into a mesh."""
    parts = [int(x) for x in spec.split(",")]
    if len(parts) != 2 or any(p < 1 for p in parts):
        raise ValueError(f"--mesh expects 'dp,tp' (got {spec!r})")
    return make_mesh(*parts)


def make_local_mesh(model: int = 1):
    """A mesh over every rank of the default group: ``(world // model,
    model)``."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model:
        raise ValueError(f"model={model} does not divide {world} ranks")
    return make_mesh(world // model, model)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh's shape and axis names, with no devices: 16 x 16
    ``("data", "model")``, or 2 x 16 x 16 with a leading ``"pod"`` axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)


def _submesh_shape(spec, default_axis: str, flag: str):
    """A disaggregated sub-mesh spec as ``(dp, tp)``: a bare int ``n``
    spreads the ``n`` ranks over the natural axis of its group (``model``
    for rollout: generation wants the whole model resident; ``data`` for
    training: the PPO step is batch-parallel), and ``"dp,tp"`` or
    ``(dp, tp)`` is taken as written."""
    if isinstance(spec, str):
        parts = [int(x) for x in spec.split(",")]
        if len(parts) == 1:
            spec = parts[0]
        elif len(parts) == 2:
            spec = tuple(parts)
        else:
            raise ValueError(f"{flag} expects 'n' or 'dp,tp' "
                             f"(got {spec!r})")
    if isinstance(spec, (tuple, list)):
        dp, tp = (int(spec[0]), int(spec[1])) if len(spec) == 2 else (0, 0)
        if dp < 1 or tp < 1:
            raise ValueError(f"{flag} expects positive 'dp,tp' "
                             f"(got {spec!r})")
        return dp, tp
    n = int(spec)
    if n < 1:
        raise ValueError(f"{flag} needs >= 1 device (got {n})")
    return (1, n) if default_axis == "model" else (n, 1)


# gloo groups a weight window's bytes are spread over (each a TCP
# connection of its own, sent and received at once)
BRIDGE_LANES = 4


@dataclasses.dataclass(frozen=True)
class Bridge:
    """The gloo groups between a rollout mesh and a training mesh, each
    over the ranks of both: ``weights`` carries what the training ranks
    send the rollout ranks (weights, the start, credits, the lockstep
    flip), ``rollouts`` what the rollout ranks send back (rollout
    batches); a large weight window is spread over ``weights`` and the
    ``lanes`` (:data:`BRIDGE_LANES` groups in all), which the thread that
    uses ``weights`` uses with it.  On each rank one thread at a time uses
    a group.  Their ops time out after ``timeout_s``."""
    rollout_ranks: tuple
    train_ranks: tuple
    weights: Any
    rollouts: Any
    timeout_s: float
    lanes: tuple = ()

    @property
    def role(self) -> Optional[str]:
        """``"rollout"``, ``"train"`` or ``None`` for this rank."""
        import torch.distributed as dist
        r = dist.get_rank()
        return ("rollout" if r in self.rollout_ranks
                else "train" if r in self.train_ranks else None)


_BRIDGES: dict = {}


def _ranks(mesh) -> tuple:
    return tuple(int(r) for r in mesh.mesh.flatten().tolist())


def bridge_of(rollout_mesh, train_mesh) -> Bridge:
    """The :class:`Bridge` that :func:`make_disaggregated_meshes` made for
    these two meshes."""
    key = (_ranks(rollout_mesh), _ranks(train_mesh))
    if key not in _BRIDGES:
        raise ValueError("a rollout mesh and a training mesh come from "
                         "make_disaggregated_meshes, which bridges them")
    return _BRIDGES[key]


def _card_of_each_rank() -> list:
    """``(host, card)`` of every rank of the default group."""
    import socket

    import torch.distributed as dist
    where = [None] * dist.get_world_size()
    dist.all_gather_object(where, (socket.gethostname(),
                                   torch.cuda.current_device()))
    return where


def check_cards(where: list, role_ranks: dict) -> None:
    """Refuse a role mesh (``role_ranks``: ``{role: ranks}``) with two
    ranks on one card: ``where[r]`` is rank ``r``'s ``(host, card)``."""
    for role, ranks in role_ranks.items():
        seen = {}
        for r in ranks:
            if where[r] in seen:
                raise ValueError(
                    f"disaggregated meshes: ranks {seen[where[r]]} and {r} "
                    f"of the {role} mesh share card {where[r][1]} of "
                    f"{where[r][0]}; one card holds at most one rank of "
                    f"each role")
            seen[where[r]] = r


def make_disaggregated_meshes(*, rollout, train,
                              timeout_s: float = DEFAULT_TIMEOUT_S):
    """A rollout (generation) mesh and a disjoint training mesh over the
    ranks of the default group, the disaggregated asynchronous-RLHF
    topology: ``rollout`` and ``train`` are each a rank count or a
    ``"dp,tp"`` spec (:func:`_submesh_shape`); the rollout mesh takes the
    first ranks, the training mesh the next ones, as the reference takes
    the first devices.  Every rank of the group calls it.  Returns
    ``(rollout_mesh, train_mesh, role)``, ``role`` this rank's
    (``"rollout"``, ``"train"``, or ``None`` beyond both meshes), and
    makes their :class:`Bridge` (:func:`bridge_of`), whose ops time out
    after ``timeout_s``.  Raises ``ValueError`` when the two meshes need
    more ranks than the group has, or, on ``cuda``, put two ranks of one
    mesh on one card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    r_dp, r_tp = _submesh_shape(rollout, "model", "--rollout-mesh")
    t_dp, t_tp = _submesh_shape(train, "data", "--train-mesh")
    nr, nt = r_dp * r_tp, t_dp * t_tp
    world = dist.get_world_size() if dist.is_initialized() else 1
    if nr + nt > world:
        raise ValueError(
            f"disaggregated meshes need {nr} rollout + {nt} train "
            f"= {nr + nt} ranks, have {world}")
    dev = _device_type()
    roles = {"rollout": tuple(range(nr)),
             "train": tuple(range(nr, nr + nt))}
    if dev == "cuda":
        check_cards(_card_of_each_rank(), roles)
    names = ("data", "model")
    rollout_mesh = DeviceMesh(dev, torch.arange(nr).view(r_dp, r_tp),
                              mesh_dim_names=names)
    train_mesh = DeviceMesh(dev, torch.arange(nr, nr + nt).view(t_dp, t_tp),
                            mesh_dim_names=names)
    timeout = datetime.timedelta(seconds=timeout_s)
    both = list(range(nr + nt))
    groups = [dist.new_group(both, backend="gloo", timeout=timeout)
              for _ in range(1 + BRIDGE_LANES)]
    bridge = Bridge(roles["rollout"], roles["train"], groups[0], groups[1],
                    timeout_s=timeout_s, lanes=tuple(groups[2:]))
    _BRIDGES[(roles["rollout"], roles["train"])] = bridge
    return rollout_mesh, train_mesh, bridge.role
