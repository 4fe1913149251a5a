"""The reference's asynchronous stage 3, for ``tests/test_torch_async_rlhf.py``::

    JAX_PLATFORMS=cpu python tests/_jax_async_reference.py IN.pkl OUT.pkl

``IN`` holds numpy trees in the reference's structure (the port's weights,
carried across with ``repro_torch/models/convert.py``): ``actor``, ``ref``,
``critic``, ``reward``, the model and stage sizes, the ``PPOConfig``
keywords and ``modes`` ``{name: AsyncConfig keywords}``.  For each mode
this process runs the reference's own ``RLHFPipeline.run_ppo`` (stage 3
only, from those weights, on the copy + constant blend) and writes, as
numpy: the sequences each scored rollout held, the per-iteration metrics,
``async_stats`` and the final actor, critic and EMA params.

With ``split`` ``(rollout, train)`` in ``IN`` (for
``tests/test_torch_disaggregated.py``; run it with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) every mode runs
disaggregated, on ``make_disaggregated_meshes(rollout=, train=)``; a mode
whose keywords are ``None`` is the synchronous loop over the split; and
``put`` holds, for each rollout device in mesh order, the shard of every
leaf of the actor that ``cross_mesh_put`` placed there.

With ``mesh`` ``(dp, tp)`` in ``IN`` (for ``tests/test_torch_async_mesh.py``;
run it with ``XLA_FLAGS=--xla_force_host_platform_device_count=2``) every
mode runs on the shared mesh ``make_mesh(dp, tp)``: the Hybrid Engine's,
asynchronous stage 3 publishing to its inference layout; ``None``
keywords again mean the synchronous loop.

``repro.core`` does not import on Python 3.12 (ROADMAP Queue 3, R1):
``tests/_jax_mesh_reference.py``'s loader, imported first, gives
``repro.serving.engine``'s one field a ``default_factory``; the file is
read as it is, and nothing else changes.
"""
from __future__ import annotations

import pickle
import sys

import _jax_mesh_reference  # noqa: F401  (installs the R1 loader)
import jax  # noqa: E402
import jax.numpy as jnp
import numpy as np

from repro.core import (AsyncConfig, PPOConfig, RLHFEngine, RLHFPipeline,
                        StageConfig)
from repro.core.ppo import PPOTrainer
from repro.data import ConstantTaskDataset, CopyTaskDataset, DataBlender
from repro.models.config import ModelConfig


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(tree):
    return jax.tree.map(lambda a: jnp.array(a, copy=True), tree)


def blender(V: int, width: int):
    ds = [ConstantTaskDataset(200, width, width, V, seed=1),
          CopyTaskDataset(200, width, width, V, seed=2)]
    return DataBlender(ds, [0.7, 0.3], seed=0)


def run_mode(inp, async_kw, meshes=None) -> dict:
    actor_cfg = ModelConfig(name="a", **inp["model"])
    critic_cfg = actor_cfg.replace(name="c")
    rollout_mesh, mesh = meshes or (None, None)
    eng = RLHFEngine(actor_cfg, critic_cfg, jax.random.PRNGKey(0),
                     mesh=mesh, rollout_mesh=rollout_mesh)
    for k in ("actor", "ref", "critic", "reward"):
        setattr(eng, f"{k}_params", _jnp(inp[k]))
    pipe = RLHFPipeline(eng, blender(inp["model"]["vocab_size"],
                                     inp["width"]),
                        StageConfig(**inp["stages"]),
                        PPOConfig(**inp["ppo_kw"]),
                        async_cfg=(None if async_kw is None
                                   else AsyncConfig(**async_kw)))
    seen = []
    score = PPOTrainer.score_rollout

    def recording(self, rollout, **kw):
        seen.append(np.asarray(rollout.sequences))
        return score(self, rollout, **kw)

    PPOTrainer.score_rollout = recording
    try:
        pipe.run_ppo()
    finally:
        PPOTrainer.score_rollout = score
    tr = pipe.trainer
    return {"sequences": seen, "log": pipe.log["stage3"],
            "async_stats": pipe.async_stats,
            "actor": _np(tr.actor.params), "critic": _np(tr.critic.params),
            "ema": _np(tr.ema_params())}


def put_shards(inp, rollout_mesh) -> list:
    """Each rollout device's shard of every actor leaf after
    ``cross_mesh_put`` into the rollout mesh's ``tp`` layout."""
    from repro.sharding import strategy as S
    cfg = ModelConfig(name="a", **inp["model"])
    out = S.cross_mesh_put(_jnp(inp["actor"]),
                           S.param_shardings(cfg, rollout_mesh, "tp"))
    return [jax.tree.map(lambda leaf, d=d: np.asarray(next(
        sh.data for sh in leaf.addressable_shards if sh.device == d)), out)
        for d in rollout_mesh.devices.flat]


def main(src: str, dst: str) -> None:
    with open(src, "rb") as f:
        inp = pickle.load(f)
    meshes = None
    if "split" in inp:
        from repro.launch.mesh import make_disaggregated_meshes
        meshes = make_disaggregated_meshes(rollout=inp["split"][0],
                                           train=inp["split"][1])
    elif "mesh" in inp:
        from repro.launch.mesh import make_mesh
        meshes = (None, make_mesh(*inp["mesh"]))
    out = {name: run_mode(inp, kw, meshes)
           for name, kw in inp["modes"].items()}
    if "split" in inp:
        out["put"] = put_shards(inp, meshes[0])
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
