"""Device meshes on ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

One process per device: under ``torchrun`` every rank calls
:func:`init_distributed` and then builds the same mesh.  On ``cuda`` the
group is NCCL with one GPU per rank (``LOCAL_RANK``); on ``cpu`` it is
gloo.  A mesh is a ``DeviceMesh`` named ``("data", "model")`` over the
first ``dp * tp`` ranks; ranks beyond it take no part in its collectives
(``mesh.get_coordinate()`` is ``None`` there).

The reference's TPU constants (its roofline table) are not carried over;
:func:`make_production_mesh` gives the production mesh's shape and axis
names only, for the dry-run tools.
"""
from __future__ import annotations

import datetime
import os
from types import SimpleNamespace
from typing import Optional

import torch

DEFAULT_TIMEOUT_S = 60.0


def init_distributed(device, *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group and return this rank's device.

    The rank, world size and rendezvous come from the ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``) unless ``init_method`` (e.g.
    ``file://...``) with ``rank`` and ``world_size`` is given; a process
    started without either is a group of its own (one rank, its store in
    memory), so a launcher's ``--mesh 1,1`` runs without ``torchrun``.
    ``cuda`` uses NCCL on GPU ``LOCAL_RANK``, never gloo; ``cpu`` uses
    gloo.  Every
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
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
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
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


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


def make_disaggregated_meshes(*, rollout, train):
    """A rollout mesh and a disjoint training mesh (asynchronous RLHF):
    not yet ported."""
    raise NotImplementedError("make_disaggregated_meshes (disaggregated "
                              "rollout / train meshes): not yet ported")
