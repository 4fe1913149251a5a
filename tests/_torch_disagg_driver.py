"""Rank driver for ``tests/test_torch_disaggregated.py``: the disaggregated
split on gloo ranks over the CPU::

    PYTHONPATH=src:tests python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 tests/_torch_disagg_driver.py --out DIR \\
        --rollout 2 --train 2 --cases put,sync,lockstep,stale,abort

(or each rank started alone with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` set, as the test does, so that a
failing rank ends on its own and is not stopped by the others').  Every
rank joins one gloo world, makes ``make_disaggregated_meshes(rollout=,
train=)`` and runs the cases in order, each writing ``DIR/CASE.RANK.pt``
when it is done:

- ``meshes``: this rank's role, both meshes' ranks, shapes and this
  rank's coordinate on each, and the error of a split the world does not
  hold (``1,2`` | ``2,2``);
- ``put``: the actor (:func:`ref_models`) in the training layout
  (``zero3``) pushed by ``cross_mesh_put`` into the rollout mesh's ``tp``
  layout: each rollout rank's windows, as numpy;
- ``sync``, ``lockstep``, ``stale``, ``abort``: stage 3 alone from those
  weights (greedy fp32 PPO, :data:`MODES`), synchronous or under
  ``AsyncConfig``: on the training ranks the sequences each scored batch
  held, the per-iteration metrics, ``async_stats``, the final actor,
  critic and EMA params (full, numpy) and their SHA-256; on the rollout
  ranks ``async_stats``;
- ``one_sync``, ``one_lockstep``: the same at temperature 1.0 (the
  stage-3 generator draws), for the ``1 | 1`` world;
- ``launcher``: ``launch.train --rlhf --rollout-mesh --train-mesh
  --async-rlhf`` in this world, its output and summary;
- ``die``: lockstep with a checkpoint a PPO iteration under ``--ckpt``;
  the training ranks exit hard (code 37) at the top of iteration 2, once
  the checkpoint of iteration 2 is written; ``resume``: the same run
  again, which resumes there;
- ``fail``: a producer failure injected on the first rollout rank before
  batch 2, not caught: every rank must end with ``RuntimeError("rollout
  producer failed")``.

It is launched by the test; it is not a pytest module.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os

import torch

from repro_torch.core import (AsyncConfig, PPOConfig, RLHFEngine,
                              RLHFPipeline, StageConfig)
from repro_torch.core import ppo as tppo
from repro_torch.core.pipeline import clone_params
from repro_torch.data import ConstantTaskDataset, CopyTaskDataset, DataBlender
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import (bridge_of, init_distributed,
                                     make_disaggregated_meshes)
from repro_torch.models import convert
from repro_torch.models import reward as TR
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.sharding import runtime
from repro_torch.sharding import strategy as S
from repro_torch.training.checkpoint import CheckpointManager, tree_sha256

V = 64
# the reference's async comparison model (tests/test_torch_async_rlhf.py):
# head_dim 16 below the kernels' smallest, the plain path
MODEL = dict(arch_type="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=V, compute_dtype="float32",
             remat=False)
STAGES = dict(sft_steps=0, sft_batch=4, rm_steps=0, rm_batch=4, ppo_steps=4,
              ppo_batch=4, seed=0)
PPO = dict(max_new_tokens=4, temperature=0.0)
STALE = dict(queue_depth=2, publish_every=2, max_lag=1)
MODES = {"sync": None,
         "lockstep": dict(queue_depth=1, publish_every=1, max_lag=0),
         "stale": STALE,
         # trips at the first lag-1 batch (iteration 1): lags 0, 1, 0, 0
         "abort": dict(STALE, is_ratio_abort=1.0)}
DIE_EXIT_CODE = 37


def ref_models():
    """Four models from one seed: the actor and critic, the reference
    policy and reward model as copies of them (the state after stage 2)."""
    g = torch.Generator().manual_seed(11)
    cfg = ModelConfig(name="a", use_kernels=False, **MODEL)
    actor = TT.init_params(cfg, g)
    critic = TR.init_params(cfg.replace(name="c"), g)
    return cfg, {"actor": actor, "ref": clone_params(actor),
                 "critic": critic, "reward": clone_params(critic)}


def blender(width: int = 6):
    ds = [ConstantTaskDataset(200, width, width, V, seed=1),
          CopyTaskDataset(200, width, width, V, seed=2)]
    return DataBlender(ds, [0.7, 0.3], seed=0)


def _np_tree(tree):
    return convert.params_to_numpy(runtime.full_tree(tree))


def _sha(tree) -> str:
    return tree_sha256(runtime.full_tree(tree))


def stage3(meshes, async_kw, *, ppo=PPO, ckpt=None, iter_hook=None,
           rollout_hook=None) -> tuple:
    """Stage 3 from :func:`ref_models` over the split; ``(pipeline,
    record)``."""
    rollout_mesh, train_mesh = meshes
    cfg, models = ref_models()
    eng = RLHFEngine(cfg, cfg.replace(name="c"),
                     torch.Generator().manual_seed(0), mesh=train_mesh,
                     rollout_mesh=rollout_mesh)
    if eng.role == "train":
        for k, v in models.items():
            setattr(eng, f"{k}_params", v)
    pipe = RLHFPipeline(eng, blender(), StageConfig(**STAGES),
                        PPOConfig(**ppo), checkpointer=ckpt,
                        async_cfg=None if async_kw is None
                        else AsyncConfig(**async_kw))
    pipe.iter_hook = iter_hook
    pipe.rollout_hook = rollout_hook
    seen, score = [], tppo.PPOTrainer.score_rollout

    def recording(self, rollout, **kw):
        seen.append(torch.as_tensor(rollout.sequences).numpy().copy())
        return score(self, rollout, **kw)

    tppo.PPOTrainer.score_rollout = recording
    try:
        pipe.run_ppo()
    finally:
        tppo.PPOTrainer.score_rollout = score
    rec = {"role": eng.role, "async_stats": pipe.async_stats}
    if eng.role == "train":
        tr = pipe.trainer
        rec.update(sequences=seen, log=pipe.log["stage3"],
                   actor=_np_tree(tr.actor.params),
                   critic=_np_tree(tr.critic.params),
                   ema=_np_tree(tr.ema_params()),
                   sha={k: _sha(getattr(tr, k))
                        for k in ("actor", "critic", "ema")})
    return pipe, rec


def case_put(meshes) -> dict:
    rollout_mesh, train_mesh = meshes
    cfg, models = ref_models()
    bridge = bridge_of(rollout_mesh, train_mesh)
    sh = S.param_shardings(cfg, rollout_mesh, "tp")
    if bridge.role == "train":
        tree = runtime.place_tree(models["actor"],
                                  S.param_shardings(cfg, train_mesh,
                                                    "zero3"))
        meta = runtime.tree_meta(tree_leaves(tree))
        return {"role": "train", "result": S.cross_mesh_put(tree, sh, bridge),
                "bytes": runtime.window_bytes(
                    meta, tree_leaves(sh, is_leaf=S._is_sharding))}
    out = S.cross_mesh_put(None, sh, bridge)
    return {"role": "rollout", "local_bytes": runtime.local_bytes(out),
            "tree": convert.params_to_numpy(tree_map(runtime.local, out)),
            "coord": rollout_mesh.get_coordinate(),
            "dtensor": runtime.is_dtensor(tree_leaves(out)[0])}


def case_launcher(args) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summ = tlaunch.main([
            "--device", "cpu", "--arch", "smollm-135m", "--reduced",
            "--rlhf", "--steps", "2", "--batch", "4", "--seq", "16",
            "--max-new", "4", "--rollout-mesh", args.rollout,
            "--train-mesh", args.train, "--async-rlhf", "--max-lag", "1"])
    return {"stdout": out.getvalue(), "async": summ["async"],
            "ppo_scores": summ["ppo_scores"],
            "sha": summ["state_sha256"]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--rollout", default="2")
    ap.add_argument("--train", default="2")
    ap.add_argument("--cases", required=True)
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args()
    # spread every piece over the bridge's lanes, as the full-size
    # models' pieces are on the card (the tiny models' are below 4 MiB)
    runtime._LANE_MIN_BYTES = 0
    init_distributed("cpu", timeout_s=60.0)
    import torch.distributed as dist
    rank = dist.get_rank()
    rm, tm, role = make_disaggregated_meshes(rollout=args.rollout,
                                             train=args.train,
                                             timeout_s=60.0)
    meshes = (rm, tm)
    for case in args.cases.split(","):
        if case == "meshes":
            rec = {"role": role, "world": dist.get_world_size()}
            for name, m in (("rollout", rm), ("train", tm)):
                rec[name] = {"ranks": m.mesh.flatten().tolist(),
                             "shape": dict(zip(m.mesh_dim_names, m.shape)),
                             "coord": m.get_coordinate()}
            try:
                make_disaggregated_meshes(rollout="1,2", train="2,2")
            except ValueError as e:
                rec["oversubscribed"] = str(e)
        elif case == "put":
            rec = case_put(meshes)
        elif case in MODES:
            rec = stage3(meshes, MODES[case])[1]
        elif case.startswith("one_"):
            rec = stage3(meshes, MODES[case[4:]],
                         ppo=dict(PPO, temperature=1.0))[1]
        elif case == "launcher":
            rec = case_launcher(args)
        elif case in ("die", "resume"):
            mgr = CheckpointManager(args.ckpt)

            def die(pipe_i, mgr=mgr):
                if case == "die" and pipe_i == 2:
                    mgr.wait_for_save()
                    os._exit(DIE_EXIT_CODE)
            rec = stage3(meshes, MODES["lockstep"], ckpt=mgr,
                         iter_hook=die)[1]
            rec["steps"] = mgr.all_steps()
        elif case == "fail":
            def fail(i):
                if i == 2:
                    raise ValueError("decode failed")
            stage3(meshes, MODES["stale"],
                   rollout_hook=fail if rank == 0 else None)
            rec = {}
        else:
            raise ValueError(f"unknown case {case!r}")
        torch.save(rec, os.path.join(args.out, f"{case}.{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
