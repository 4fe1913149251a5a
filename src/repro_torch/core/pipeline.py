"""The three-stage RLHF pipeline (InstructGPT / DeepSpeed-Chat Fig. 1;
counterpart of ``repro/core/pipeline.py``, single device, synchronous):

  Step 1  SFT          — supervised finetuning on prompt+chosen
  Step 2  RM           — pairwise reward-model finetuning
  Step 3  PPO (RLHF)   — PPO with optional EMA + mixture training

``RLHFEngine`` mirrors ``DeepSpeedRLHFEngine``: it owns the four models
(actor, ref, critic, reward); ``RLHFPipeline.run`` is the single-script
experience of the paper's §2.1.

The port's optimizer updates params in place, so the frozen snapshots the
reference takes for free (``jax.tree.map(lambda x: x, params)`` of
immutable arrays) are clones here: the reference policy is a copy of the
SFT actor and the critic starts from a copy of the trained reward model,
so neither the actor's nor the critic's updates move them.  The
reference's Hybrid Engine and meshes (``mesh=``, ``rollout_mesh=``),
checkpoints (``checkpointer=``) and asynchronous stage 3 (``async_cfg=``)
are not yet ported and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.core.ppo import PPOConfig, PPOTrainer
from repro_torch.data.blending import DataBlender
from repro_torch.models import reward as R
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.training import schedules
from repro_torch.training.steps import lm_train_step, reward_train_step
from repro_torch.training.train_state import TrainState


def clone_params(params):
    """A copy of ``params`` that shares no storage with them."""
    return tree_map(lambda p: p.detach().clone(), params)


@dataclasses.dataclass
class StageConfig:
    sft_steps: int = 50
    sft_batch: int = 8
    sft_lr: float = 3e-4
    rm_steps: int = 50
    rm_batch: int = 8
    rm_lr: float = 3e-4
    ppo_steps: int = 30
    ppo_batch: int = 8
    seed: int = 0


class RLHFEngine:
    """Owns the actor/ref/critic/reward params.  The actor and the critic
    are drawn one after the other from ``generator`` (the reference splits
    one key in two; weights that must match the reference are carried
    across with ``models/convert.py``) on ``generator``'s device."""

    def __init__(self, actor_cfg: ModelConfig, critic_cfg: ModelConfig,
                 generator: torch.Generator, mesh=None, rollout_mesh=None):
        if mesh is not None or rollout_mesh is not None:
            raise NotImplementedError("RLHFEngine(mesh=/rollout_mesh=): "
                                      "not yet ported")
        self.actor_cfg, self.critic_cfg = actor_cfg, critic_cfg
        self.actor_params = T.init_params(actor_cfg, generator)
        self.critic_params = R.init_params(critic_cfg, generator)
        self.ref_params = None       # cloned from the SFT actor
        self.reward_params = None    # the trained RM (critic gets a clone)

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.actor_params)[0].device


class RLHFPipeline:
    """The synchronous 3-stage run.  ``log`` holds the stage-1 losses, the
    stage-2 losses and one metrics dict per PPO iteration; ``step_ms`` the
    host-clock time of each (synchronized) SFT and RM step; ``timings``
    the seconds per stage; ``gen_tok_s`` the mean stage-3 generation
    throughput.  ``iter_hook(i)``, when set, is called at the top of each
    PPO iteration."""

    def __init__(self, engine: RLHFEngine, blender: DataBlender,
                 stages: StageConfig, ppo: PPOConfig, checkpointer=None,
                 async_cfg=None):
        if checkpointer is not None:
            raise NotImplementedError("RLHFPipeline(checkpointer=): "
                                      "not yet ported")
        if async_cfg is not None:
            raise NotImplementedError("RLHFPipeline(async_cfg=): "
                                      "asynchronous RLHF is not yet ported")
        self.e = engine
        self.blender = blender
        self.stages = stages
        self.ppo = ppo
        self.iter_hook = None
        self.log = {"stage1": [], "stage2": [], "stage3": []}
        self.step_ms = {"stage1": [], "stage2": []}
        self.rm_acc = []
        self.timings = {}          # seconds per stage
        self.gen_tok_s = 0.0       # mean stage-3 generation throughput
        self.trainer: Optional[PPOTrainer] = None

    # ------------------------- Step 1: SFT ------------------------- #
    def run_sft(self):
        cfg, st, dev = self.e.actor_cfg, self.stages, self.e.device
        state = TrainState.create(self.e.actor_params)
        lr = schedules.cosine_warmup(st.sft_lr, st.sft_steps // 10 + 1,
                                     st.sft_steps)
        t0 = time.perf_counter()
        for i, batch in enumerate(self.blender.sft_batches(
                st.sft_batch, st.sft_steps)):
            ts = time.perf_counter()
            state, m = lm_train_step(cfg, state, to_device(batch, dev),
                                     lr(i))
            self.log["stage1"].append(float(m["loss"]))   # synchronizes
            self.step_ms["stage1"].append((time.perf_counter() - ts) * 1e3)
        self.timings["stage1"] = time.perf_counter() - t0
        self.e.actor_params = state.params
        self.e.ref_params = clone_params(state.params)
        return self.log["stage1"]

    # ----------------------- Step 2: Reward ------------------------ #
    def run_reward(self):
        cfg, st, dev = self.e.critic_cfg, self.stages, self.e.device
        state = TrainState.create(self.e.critic_params)
        lr = schedules.cosine_warmup(st.rm_lr, st.rm_steps // 10 + 1,
                                     st.rm_steps)
        accs = []
        t0 = time.perf_counter()
        for i, batch in enumerate(self.blender.reward_batches(
                st.rm_batch, st.rm_steps)):
            ts = time.perf_counter()
            state, m = reward_train_step(cfg, state, to_device(batch, dev),
                                         lr(i))
            self.log["stage2"].append(float(m["rm_loss"]))
            accs.append(float(m["rm_acc"]))
            self.step_ms["stage2"].append((time.perf_counter() - ts) * 1e3)
        self.timings["stage2"] = time.perf_counter() - t0
        self.e.reward_params = state.params
        self.e.critic_params = clone_params(state.params)
        self.rm_acc = accs
        return accs

    # ------------------------ Step 3: PPO -------------------------- #
    def run_ppo(self, generator: Optional[torch.Generator] = None):
        """``ppo_steps`` iterations of generate -> score -> train.  Draws
        advance ``generator`` (default: seeded with ``seed + 3`` on the
        engine's device).  Returns the mean reward score of each
        iteration."""
        st, dev = self.stages, self.e.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(st.seed + 3)
        trainer = PPOTrainer(
            actor_cfg=self.e.actor_cfg, critic_cfg=self.e.critic_cfg,
            actor_params=self.e.actor_params,
            critic_params=self.e.critic_params,
            ref_params=self.e.ref_params,
            reward_params=self.e.reward_params, ppo=self.ppo)
        self.trainer = trainer
        ptx_iter = (self.blender.pretrain_batches(st.ppo_batch, st.ppo_steps)
                    if self.ppo.ptx_coef > 0 else None)
        scores = [m["reward_score"] for m in self.log["stage3"]]
        t0 = time.perf_counter()
        for i, batch in enumerate(self.blender.prompt_batches(
                st.ppo_batch, st.ppo_steps)):
            if self.iter_hook is not None:
                self.iter_hook(i)
            exp, gm = trainer.generate_experience(batch["prompts"],
                                                  generator)
            ptx = (to_device(next(ptx_iter), dev) if ptx_iter is not None
                   else None)
            tm = trainer.train_rlhf(exp, ptx)
            scores.append(gm["reward_score"])
            self.log["stage3"].append({**gm, **tm})
        self.timings["stage3"] = time.perf_counter() - t0
        if self.log["stage3"]:
            self.gen_tok_s = float(np.mean(
                [m["gen_tok_s"] for m in self.log["stage3"]]))
        self.e.actor_params = trainer.actor.params
        return scores

    # ----------------------------- run ----------------------------- #
    def run(self, generator: Optional[torch.Generator] = None):
        """End-to-end 3-stage run."""
        self.run_sft()
        self.run_reward()
        scores = self.run_ppo(generator)
        return {"sft_loss": self.log["stage1"], "rm_acc": self.rm_acc,
                "ppo_scores": scores, "timings": self.timings}
