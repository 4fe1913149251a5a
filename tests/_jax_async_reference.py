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


def run_mode(inp, async_kw) -> dict:
    actor_cfg = ModelConfig(name="a", **inp["model"])
    critic_cfg = actor_cfg.replace(name="c")
    eng = RLHFEngine(actor_cfg, critic_cfg, jax.random.PRNGKey(0))
    for k in ("actor", "ref", "critic", "reward"):
        setattr(eng, f"{k}_params", _jnp(inp[k]))
    pipe = RLHFPipeline(eng, blender(inp["model"]["vocab_size"],
                                     inp["width"]),
                        StageConfig(**inp["stages"]),
                        PPOConfig(**inp["ppo_kw"]),
                        async_cfg=AsyncConfig(**async_kw))
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


def main(src: str, dst: str) -> None:
    with open(src, "rb") as f:
        inp = pickle.load(f)
    out = {name: run_mode(inp, kw) for name, kw in inp["modes"].items()}
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
