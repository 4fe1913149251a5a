"""DeepSpeed Hybrid Engine (DeepSpeed-HE) on ``torch.distributed``
(counterpart of ``repro/core/hybrid_engine.py``).

The paper's core systems idea: RLHF stage 3 alternates between an
inference-dominated *generation* phase and a compute-bound *training*
phase.  Running generation under the training layout (ZeRO-3) costs one
all-gather of every weight shard per layer **per generated token**; the
Hybrid Engine instead reshards the actor **once per phase**:

    train layout  = ZeRO-3 + TP   (params sharded over data & model axes)
    infer layout  = TP only       (params replicated over data axes)

Here a layout is a tree of ``DTensor``\\ s on a ``DeviceMesh`` and the mode
switch is one ``redistribute`` per parameter to the other layout (an
all-gather over ``data`` into the inference layout, a local slice back),
the counterpart of the reference's jitted identity with
``out_shardings``.  Each switch is measured into ``last_reshard_stats``;
the analytic methods quantify the win as the reference counts it.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import ParamSpec, tree_leaves, tree_map
from repro_torch.sharding import runtime
from repro_torch.sharding import strategy as S


def _move(x, sharding: S.Sharding):
    """``x`` (a ``DTensor``, or a plain tensor that every rank holds whole)
    in ``sharding``'s layout."""
    if runtime.is_dtensor(x):
        if tuple(x.placements) == tuple(sharding.placements):
            return x
        return runtime.redistribute(x, sharding.placements)
    return runtime.place(x, sharding.mesh, sharding.placements)


def mesh_total(value: int, mesh) -> int:
    """The sum of an integer over every rank of ``mesh``."""
    import torch.distributed as dist
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_mesh_device(mesh))
    for name in mesh.mesh_dim_names:
        if mesh.size(mesh.mesh_dim_names.index(name)) > 1:
            dist.all_reduce(t, group=mesh.get_group(name))
    return int(t.item())


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _sync(mesh) -> None:
    if mesh.device_type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class HybridEngine:
    cfg: ModelConfig
    mesh: object
    train_strategy: str = "zero3"
    infer_strategy: str = "tp"
    zero: int = 1                      # ZeRO stage for the optimizer state

    def __post_init__(self):
        self.train_pspecs = S.param_pspecs(self.cfg, self.mesh,
                                           self.train_strategy)
        self.infer_pspecs = S.param_pspecs(self.cfg, self.mesh,
                                           self.infer_strategy)
        self.train_shardings = S.shardings_of(self.train_pspecs, self.mesh)
        self.infer_shardings = S.shardings_of(self.infer_pspecs, self.mesh)
        # measured stats of the LAST phase transition: wall time between
        # two device synchronizations, and the bytes of the local tensors
        # before and after, summed over every rank of the mesh
        self.last_reshard_stats: dict = {}
        self._warm: set = set()        # directions already run once

    @property
    def n_ranks(self) -> int:
        return runtime.mesh_size(self.mesh)

    # ---------------------------------------------------------------- #
    # phase transitions (the Hybrid Engine switch)
    # ---------------------------------------------------------------- #
    def _reshard(self, params, shardings, direction: str):
        in_bytes = mesh_total(runtime.local_bytes(params), self.mesh)
        first = direction not in self._warm
        _sync(self.mesh)
        t0 = time.perf_counter()
        out = tree_map(lambda s, p: _move(p, s), shardings, params,
                       is_leaf=runtime.is_sharding)
        _sync(self.mesh)
        dt = time.perf_counter() - t0
        self._warm.add(direction)
        out_bytes = mesh_total(runtime.local_bytes(out), self.mesh)
        # an all-gather materializes exactly the replica bytes the input
        # did not hold; the reverse slice frees them.  `first_call` marks
        # the first transition in each direction.
        self.last_reshard_stats = {
            "direction": direction,
            "seconds": dt,
            "first_call": first,
            "in_bytes": in_bytes,
            "out_bytes": out_bytes,
            "gathered_bytes": max(out_bytes - in_bytes, 0),
            "freed_bytes": max(in_bytes - out_bytes, 0),
        }
        return out

    def to_inference(self, params):
        """Enter generation mode: one all-gather pass over the params,
        measured (bytes and wall time) into ``last_reshard_stats``."""
        return self._reshard(params, self.infer_shardings, "to_inference")

    def to_train(self, params):
        """Back to training mode (a local slice per param: no
        communication beyond dropping replicas)."""
        return self._reshard(params, self.train_shardings, "to_train")

    # ---------------------------------------------------------------- #
    # training-side layouts (the sharded PPO step consumes these)
    # ---------------------------------------------------------------- #
    def train_state_shardings(self, cfg: Optional[ModelConfig] = None,
                              specs=None):
        """Shardings of a whole TrainState in the training layout:
        ``train_strategy`` params, ``zero``-staged moments.  ``specs``
        overrides the param-spec tree (the critic's value head)."""
        return S.train_state_shardings(cfg or self.cfg, self.mesh,
                                       self.train_strategy, zero=self.zero,
                                       specs=specs)

    def shard_train_state(self, state, cfg: Optional[ModelConfig] = None,
                          specs=None):
        """Place a TrainState of full tensors into the training layout."""
        from repro_torch.training.optimizer import AdamState
        from repro_torch.training.train_state import TrainState
        sh = self.train_state_shardings(cfg, specs)
        put = lambda shard, tree: runtime.place_tree(tree, shard)
        return TrainState(
            params=put(sh.params, state.params),
            opt=AdamState(m=put(sh.opt.m, state.opt.m),
                          v=put(sh.opt.v, state.opt.v), step=state.opt.step),
            step=state.step)

    # ---------------------------------------------------------------- #
    # generation engine
    # ---------------------------------------------------------------- #
    def generation_engine(self, cfg=None, **gen_kwargs):
        """A :class:`repro_torch.serving.engine.GenerationEngine` for this
        actor (``cfg`` overrides its config, e.g. ``kv_quant``; it must
        describe the same parameters).  The engine expects the params of
        :meth:`to_inference`: one reshard per phase, then the decode loop.
        On a mesh of more than one rank the engine is handed the mesh: it
        decodes the data rank's rows of each batch, tensor-parallel over
        ``model``."""
        from repro_torch.serving.engine import GenerationEngine
        mesh = self.mesh if self.n_ranks > 1 else None
        return GenerationEngine(cfg if cfg is not None else self.cfg,
                                mesh=mesh, **gen_kwargs)

    # ---------------------------------------------------------------- #
    # analytics
    # ---------------------------------------------------------------- #
    def param_bytes(self) -> int:
        specs = T.param_specs(self.cfg)
        n = sum(math.prod(s.shape) for s in tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, ParamSpec)))
        return int(n * self.cfg.pdtype.itemsize)

    def reshard_bytes_per_phase(self) -> int:
        """Bytes all-gathered by ONE train->infer transition (global)."""
        dp = S.data_axes(self.mesh)
        shape = S.mesh_axes(self.mesh)
        n_dp = math.prod(shape[a] for a in dp) if dp else 1
        # each param sharded over data gathers (n_dp - 1)/n_dp of its
        # bytes on each of the n_dp replicas
        return int(self.param_bytes() * (n_dp - 1))

    def naive_generation_gather_bytes(self, n_tokens: int) -> int:
        """Baseline (ZeRO-3 generation without HE): every decode step
        re-gathers every sharded param."""
        return self.reshard_bytes_per_phase() * n_tokens

    def hybrid_speedup_estimate(self, n_tokens: int) -> float:
        naive = self.naive_generation_gather_bytes(n_tokens)
        he = self.reshard_bytes_per_phase()
        return naive / max(he, 1)
