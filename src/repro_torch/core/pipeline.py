"""The three-stage RLHF pipeline (InstructGPT / DeepSpeed-Chat Fig. 1;
counterpart of ``repro/core/pipeline.py``):

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
so neither the actor's nor the critic's updates move them.

With a ``checkpointer`` (a
:class:`repro_torch.training.checkpoint.CheckpointManager`) the run is
durable, as in the reference: the stage boundaries commit the stage-1/2
outputs, and every ``save_every`` PPO iterations the whole stage-3 state
(actor and critic TrainStates with their Adam moments, the EMA shadow,
the frozen ref and reward params, the state of the stage-3
``torch.Generator``, the data cursor and the metrics log) is copied to
host memory and written in the background.  A rerun resumes from the
latest valid checkpoint and continues bit for bit as an uninterrupted run
would.  Every stage-3 draw comes from that one generator.  A reference
checkpoint taken mid-PPO does not resume here: its PRNG carry is a JAX
key (``uint32[2]``), which restore refuses by shape; stage-boundary
checkpoints hold params only and cross both ways.  On a mesh of more than
one rank every checkpoint is a sharded one: the stage-boundary params are
saved placed in their stage-3 layouts, stage 3's state as the trainer and
the engine hold it, and each restore reads every tree straight into the
current mesh's layouts (``restore(shardings=)``), whatever mesh it was
saved on; every rank must then hold the same generator state, and a save
checks that it does.

``RLHFEngine(mesh=)`` builds the Hybrid Engine over a ``dp x tp`` mesh
(``train_strategy`` params, ZeRO-1 moments), and stage 3 trains through
it: one reshard per generation phase, the actor and critic in the training
layout, tensor-parallel over ``model`` (see :mod:`repro_torch.core.ppo`).  Stages 1 and 2 run on every rank
of the mesh alike, as the reference runs them outside the mesh.

``async_cfg`` (an :class:`~repro_torch.core.replay.AsyncConfig`) runs
stage 3 asynchronously, on one device, the 1 x 1 mesh or the
disaggregated split: a producer thread generates batch N+1 while this
thread scores and trains batch N (:meth:`RLHFPipeline._run_ppo_async`).
``AsyncConfig.lockstep()`` gives the synchronous run bit for bit,
checkpoints included: a checkpoint saves the generator state carried by
the item just consumed, never the live state, which the producer may
already be advancing.

``RLHFEngine(mesh=, rollout_mesh=)`` with the two meshes of
:func:`repro_torch.launch.mesh.make_disaggregated_meshes` is the
disaggregated split: every rank runs the pipeline, each its role's half.
The training ranks run stages 1 and 2 (on every rank of the training
mesh alike) while the rollout ranks wait, then the consumer of stage 3:
scoring and the PPO steps on the training mesh, each version of the actor
pushed across the bridge to the rollout mesh's ``tp`` layout, each batch
taken from the rollout channel (:class:`~repro_torch.core.replay.
SplitEnds`).  The rollout ranks run the producer: generation on the
rollout mesh with the versions that have landed there, drawing from the
stage-3 generator (seeded ``seed + 3``, or the state the training ranks
restored and sent).  Synchronous stage 3 is the same exchange one batch
at a time, each batch generated with the actor pushed just before it.  A
producer error on a rollout rank ends the run on every rank with
``RuntimeError("rollout producer failed")``; a consumer error stops the
rollout ranks (``RuntimeError("training consumer failed: ...")``).
Checkpoints are the training ranks': the generator state saved is the one
that came back with the last consumed batch, and a resume publishes the
restored actor and hands the rollout ranks that state.  Every rank
constructs the :class:`~repro_torch.training.checkpoint.CheckpointManager`
(its constructor is a barrier of the world).

Asynchronous stage 3 on a shared mesh of more than one rank (two threads
issuing collectives on one process group would have to keep the same
order on every rank) is not yet ported and raises
``NotImplementedError``: run it disaggregated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.core.hybrid_engine import HybridEngine
from repro_torch.core.ppo import PPOConfig, PPOTrainer
from repro_torch.core.replay import (AsyncConfig, ExperienceProducer,
                                     RemoteProducer, ReplayClosed,
                                     ReplayQueue, SplitEnds, WeightPublisher)
from repro_torch.data.blending import DataBlender
from repro_torch.models import reward as R
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.sharding import runtime
from repro_torch.sharding import strategy as S
from repro_torch.training import checkpoint, schedules
from repro_torch.training.optimizer import AdamState
from repro_torch.training.steps import lm_train_step, reward_train_step
from repro_torch.training.train_state import TrainState


def clone_params(params):
    """A copy of ``params`` that shares no storage with them."""
    return tree_map(lambda p: p.detach().clone(), params)


def _like_train_state(params_like):
    """The restore target of ``TrainState.create`` over ``params_like``
    (:class:`checkpoint.Like` leaves): fp32 moments, host step counters."""
    fp32 = tree_map(lambda x: checkpoint.Like(x.shape, torch.float32,
                                              x.device), params_like)
    step = lambda: torch.zeros((), dtype=torch.int32)
    return TrainState(params=params_like,
                      opt=AdamState(m=fp32, v=fp32, step=step()),
                      step=step())


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
    """Owns the actor/ref/critic/reward params and, with ``mesh``, the
    Hybrid Engine.  The actor and the critic are drawn one after the other
    from ``generator`` (the reference splits one key in two; weights that
    must match the reference are carried across with
    ``models/convert.py``) on ``generator``'s device; on a mesh every rank
    draws the same weights from the same seed.  With ``rollout_mesh`` (the
    disaggregated split; ``mesh`` is then the training mesh) ``role`` is
    this rank's, and a rollout rank holds no params."""

    def __init__(self, actor_cfg: ModelConfig, critic_cfg: ModelConfig,
                 generator: torch.Generator, mesh=None,
                 train_strategy: str = "zero3", rollout_mesh=None,
                 zero: int = 1):
        self.actor_cfg, self.critic_cfg = actor_cfg, critic_cfg
        self.rollout_mesh, self.role = rollout_mesh, None
        if rollout_mesh is not None:
            from repro_torch.launch.mesh import bridge_of
            if mesh is None:
                raise ValueError("RLHFEngine(rollout_mesh=) needs mesh=, "
                                 "the training mesh")
            self.bridge = bridge_of(rollout_mesh, mesh)
            self.role = self.bridge.role
        self._device = torch.device(generator.device)
        self.actor_params = self.critic_params = None
        self.ref_params = None       # cloned from the SFT actor
        self.reward_params = None    # the trained RM (critic gets a clone)
        self.hybrid = (HybridEngine(actor_cfg, mesh,
                                    train_strategy=train_strategy, zero=zero)
                       if mesh is not None else None)
        if self.role != "rollout":
            self.actor_params = T.init_params(actor_cfg, generator)
            self.critic_params = R.init_params(critic_cfg, generator)

    @property
    def device(self) -> torch.device:
        if self.actor_params is None:
            return self._device
        return tree_leaves(self.actor_params)[0].device


class RLHFPipeline:
    """The 3-stage run.  ``log`` holds the stage-1 losses, the stage-2
    losses and one metrics dict per PPO iteration; ``step_ms`` the
    host-clock time of each (synchronized) SFT and RM step; ``timings``
    the seconds per stage; ``gen_tok_s`` the mean stage-3 generation
    throughput.  ``iter_hook(i)``, when set, is called at the top of each
    PPO iteration (the crash-injection tests die there).
    ``checkpointer`` and ``save_every`` make the run durable, ``async_cfg``
    overlaps stage 3 (see the module's docstring); then
    ``rollout_hook(i)``, when set, is called on the producer thread before
    batch ``i`` (the soak tests slow it there), and ``async_stats`` holds
    the queue's, the publisher's and the producer's telemetry after the
    run."""

    def __init__(self, engine: RLHFEngine, blender: DataBlender,
                 stages: StageConfig, ppo: PPOConfig, checkpointer=None,
                 save_every: int = 1,
                 async_cfg: Optional[AsyncConfig] = None):
        if (async_cfg is not None and engine.hybrid is not None
                and getattr(engine, "rollout_mesh", None) is None
                and runtime.mesh_size(engine.hybrid.mesh) > 1):
            raise NotImplementedError(
                "RLHFPipeline(async_cfg=) on a shared mesh of more than one "
                "rank: not yet ported; run it disaggregated "
                "(RLHFEngine(rollout_mesh=), launch.train --rollout-mesh "
                "--train-mesh)")
        self.e = engine
        self.blender = blender
        self.stages = stages
        self.ppo = ppo
        self.ckpt = checkpointer
        self.save_every = save_every
        self.async_cfg = async_cfg
        self.iter_hook = None
        self.rollout_hook = None
        self.async_stats = {}      # queue/publisher/producer telemetry
        self.log = {"stage1": [], "stage2": [], "stage3": []}
        self.step_ms = {"stage1": [], "stage2": []}
        self.rm_acc = []
        self.timings = {}          # seconds per stage
        self.gen_tok_s = 0.0       # mean stage-3 generation throughput
        self.trainer: Optional[PPOTrainer] = None
        self.ends: Optional[SplitEnds] = None   # the split's, during a run

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
        if self.ckpt is not None:
            self.ckpt.save(self.SFT_STEP,
                           self._boundary_tree(("actor", "ref")),
                           self._meta("sft_done"))
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
        if self.ckpt is not None:
            self.ckpt.save(self.RM_STEP, self._boundary_tree(
                ("actor", "ref", "critic", "reward")), self._meta("rm_done"))
        return accs

    # ------------------------ Step 3: PPO -------------------------- #
    def run_ppo(self, generator: Optional[torch.Generator] = None):
        """``ppo_steps`` iterations of generate -> score -> train.  Draws
        advance ``generator`` (default: seeded with ``seed + 3`` on the
        engine's device).  With a checkpointer whose latest checkpoint is
        a stage-3 one, the run resumes from it: trainer states, frozen
        models, logs, the data cursor and ``generator``'s state.  With
        ``async_cfg`` the iterations overlap (:meth:`_run_ppo_async`), and
        the producer thread draws from ``generator``.  On the
        disaggregated split each rank runs its role's half (see the
        module's docstring); a rollout rank's ``generator`` is the one
        drawn from.  Returns the mean reward score of each iteration (none
        on a rollout rank)."""
        st = self.stages
        if generator is None:
            generator = torch.Generator(
                device=self.e.device).manual_seed(st.seed + 3)
        with self._split():
            if self.e.role == "rollout":
                return self._rollout_ppo(generator)
            return self._run_ppo(generator)

    @contextlib.contextmanager
    def _split(self):
        """This rank's ends of the bridge (:class:`SplitEnds`) for a run of
        the disaggregated split: opened here unless a run holds them
        already, and ended with it (``close``, or ``cancel`` with its
        error); nothing without a rollout mesh."""
        e = self.e
        if getattr(e, "rollout_mesh", None) is None or self.ends is not None:
            yield
            return
        acfg = self.async_cfg or AsyncConfig.lockstep()
        one = len(e.bridge.rollout_ranks) == 1
        self.ends = SplitEnds(
            e.bridge, depth=acfg.queue_depth,
            shardings=S.param_shardings(e.actor_cfg, e.rollout_mesh, "tp"),
            device=e.device, keep=1 if one else acfg.max_lag + 2,
            get_timeout_s=acfg.get_timeout_s)
        error = None
        try:
            yield
        except BaseException as err:
            error = err
            raise
        finally:
            ends, self.ends = self.ends, None
            if ends.role == "train":
                ends.finish(error)
            else:
                ends.end_up(error)
                ends.wait_end()
            ends.release()

    def _rollout_ppo(self, generator: torch.Generator) -> list:
        """A rollout rank's stage 3: once the training ranks send the
        start (and the generator state to draw from, on a resume), the
        producer generates every batch with the versions that land here
        (``AsyncConfig.lockstep()`` for the synchronous loop: a batch per
        pushed version) and sends it to the training ranks, until they
        end the run."""
        st, ends = self.stages, self.ends
        msg = ends.wait_start()
        start = msg["start"]
        if msg["rng"] is not None:
            generator.set_state(msg["rng"])
        acfg = self.async_cfg or AsyncConfig.lockstep()
        trainer = PPOTrainer(
            actor_cfg=self.e.actor_cfg, critic_cfg=self.e.critic_cfg,
            actor_params=None, critic_params=None, ref_params=None,
            reward_params=None, ppo=self.ppo, engine=self.e.hybrid,
            rollout_mesh=self.e.rollout_mesh, ends=ends)
        self.trainer = trainer
        producer = ExperienceProducer(
            trainer=trainer, generator=generator, start=start,
            steps=st.ppo_steps,
            batches=self.blender.prompt_batches(st.ppo_batch,
                                                st.ppo_steps, skip=start),
            queue=ends, publisher=ends.publisher, cfg=acfg,
            rollout_hook=self.rollout_hook, lockstep=ends.lockstep,
            decide=ends.decide)
        t0 = time.perf_counter()
        producer.start()
        producer.join()
        ends.end_up(producer.error)
        ends.wait_end()
        self.timings["stage3"] = time.perf_counter() - t0
        self.async_stats = {"produced": producer.produced,
                            "rollout": ends.stats(),
                            "publisher": ends.publisher.stats()}
        if producer.error is not None:
            raise RuntimeError("rollout producer failed") \
                from producer.error
        if ends.cancelled is not None:
            raise RuntimeError(ends._ended_message())
        return []

    def _run_ppo(self, generator: torch.Generator):
        st, dev = self.stages, self.e.device
        start, restored = 0, None
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if (latest is not None and self.ckpt.restore_metadata(
                    latest).get("stage") == "ppo"):
                restored = self._restore_ppo(latest, generator)
                generator.set_state(restored["rng"])
                start = restored["ppo_iter"]
        trainer = PPOTrainer(
            actor_cfg=self.e.actor_cfg, critic_cfg=self.e.critic_cfg,
            actor_params=self.e.actor_params,
            critic_params=self.e.critic_params,
            ref_params=self.e.ref_params,
            reward_params=self.e.reward_params, ppo=self.ppo,
            engine=self.e.hybrid,
            rollout_mesh=getattr(self.e, "rollout_mesh", None),
            ends=self.ends)
        if restored is not None:
            trainer.load_state_tree(restored["trainer"])
        self.trainer = trainer
        if self.ends is not None:
            self.ends.start(start, restored["rng"] if restored else None)
        ptx_iter = (self.blender.pretrain_batches(st.ppo_batch, st.ppo_steps,
                                                  skip=start)
                    if self.ppo.ptx_coef > 0 else None)
        scores = [m["reward_score"] for m in self.log["stage3"]]
        t0 = time.perf_counter()
        elapsed = self.timings.get("stage3", 0.0) if restored else 0.0
        if self.async_cfg is not None:
            self._run_ppo_async(trainer, generator, start, scores, ptx_iter,
                                t0, elapsed)
        else:
            for i, batch in enumerate(self.blender.prompt_batches(
                    st.ppo_batch, st.ppo_steps, skip=start), start=start):
                if self.iter_hook is not None:
                    self.iter_hook(i)
                exp, gm = trainer.generate_experience(batch["prompts"],
                                                      generator)
                ptx = (to_device(next(ptx_iter), dev)
                       if ptx_iter is not None else None)
                tm = trainer.train_rlhf(exp, ptx)
                scores.append(gm["reward_score"])
                self.log["stage3"].append({**gm, **tm})
                if self._save_due(i):
                    self.timings["stage3"] = (elapsed
                                              + time.perf_counter() - t0)
                    self._save_ppo(trainer, generator.get_state(), i + 1)
        self.timings["stage3"] = elapsed + time.perf_counter() - t0
        if self.log["stage3"]:
            self.gen_tok_s = float(np.mean(
                [m["gen_tok_s"] for m in self.log["stage3"]]))
        self.e.actor_params = trainer.actor.params
        if self.ckpt is not None:
            self.ckpt.wait_for_save()     # durable before we return
        return scores

    # ------------------- Step 3, asynchronous --------------------- #
    def _run_ppo_async(self, trainer, generator, start, scores, ptx_iter,
                       t0, elapsed):
        """Overlapped stage 3: a producer thread generates batch N+1 while
        this (consumer) thread scores and trains batch N.

        Staleness protocol (the reference's): the consumer's policy
        ``version`` counts completed PPO steps; after every
        ``publish_every``-th step the actor's params are published (a
        clone, retained per version).  The producer may generate batch
        ``i`` only under a published version ``>= i - max_lag``, each
        rollout is scored with its own tagged behavior policy (exact
        importance ratios), and consuming with ``lag > 0`` emits the guard
        metrics; ``is_ratio_max`` above ``is_ratio_abort`` drops the run
        to on-policy lockstep.

        With ``max_lag=0`` (lockstep) the gate admits exactly the data,
        params and generator draws of the synchronous loop, so the run is
        bit-identical to it, checkpoints included: the producer owns
        ``generator``, and a checkpoint saves the state its item carried
        (the producer may already be drawing the next batch).

        A producer failure raises ``RuntimeError("rollout producer
        failed")`` from the producer's exception, also when this thread
        was waiting on the queue the producer cancelled (the reference
        raises the queue's ``ReplayClosed`` then, ROADMAP Queue 3, R17)."""
        st, acfg, dev = self.stages, self.async_cfg, self.e.device
        publisher = WeightPublisher(shardings=trainer.publish_shardings(),
                                    keep=acfg.max_lag + 2,
                                    async_push=acfg.async_publish,
                                    ends=self.ends)
        publisher.publish(trainer.actor.params, start)
        if self.ends is not None:
            # the producer runs on the rollout ranks: the rollout channel
            # and a handle on it
            queue, producer = self.ends.queue, RemoteProducer(self.ends,
                                                              acfg)
        else:
            queue = ReplayQueue(acfg.queue_depth)
            producer = ExperienceProducer(
                trainer=trainer, generator=generator, start=start,
                steps=st.ppo_steps,
                batches=self.blender.prompt_batches(st.ppo_batch,
                                                    st.ppo_steps,
                                                    skip=start),
                queue=queue, publisher=publisher, cfg=acfg,
                rollout_hook=self.rollout_hook)
            producer.start()
        version, fallbacks = start, 0
        try:
            for i in range(start, st.ppo_steps):
                if self.iter_hook is not None:
                    self.iter_hook(i)
                item = queue.get(timeout=acfg.get_timeout_s)
                lag = version - item.rollout.version
                exp, sm = trainer.score_rollout(
                    item.rollout,
                    behavior_params=publisher.train_params(
                        item.rollout.version),
                    policy_lag=lag)
                gm = {**item.gen_metrics, **sm,
                      "queue_depth": float(len(queue))}
                ps = publisher.last_publish_stats
                if ps:
                    gm["publish_s"] = float(ps["seconds"])
                    gm["publish_bytes"] = float(ps["bytes"])
                ptx = (to_device(next(ptx_iter), dev)
                       if ptx_iter is not None else None)
                tm = trainer.train_rlhf(exp, ptx)
                del exp
                version += 1
                tripped = (acfg.is_ratio_abort is not None and lag > 0
                           and sm["is_ratio_max"] > acfg.is_ratio_abort)
                if tripped:
                    # staleness guard: fall back to on-policy lockstep for
                    # the rest of the run.  Flip the producer's gate BEFORE
                    # publishing this version, or the producer could admit
                    # one more stale batch between the publish and the flip
                    producer.force_lockstep()
                    fallbacks += 1
                    gm["lockstep_fallback"] = 1.0
                if (tripped or version % acfg.publish_every == 0
                        or producer.lockstep_active):
                    publisher.publish(trainer.actor.params, version)
                scores.append(gm["reward_score"])
                self.log["stage3"].append({**gm, **tm})
                if self._save_due(i):
                    self.timings["stage3"] = (elapsed
                                              + time.perf_counter() - t0)
                    self._save_ppo(trainer, item.generator_state, i + 1)
        except ReplayClosed:
            # the producer cancelled the queue under this thread's get:
            # its own error is raised below, with this as its context
            if producer.error is None:
                raise
        finally:
            producer.stop()
            publisher.close()      # wakes a version-gated producer
            queue.cancel()         # wakes a blocked put
            producer.join(timeout=60.0)
            self.async_stats = {
                "queue": queue.stats(), "publisher": publisher.stats(),
                "produced": producer.produced,
                "lockstep_fallbacks": fallbacks,
                "retained_bytes": publisher.retained_bytes(),
            }
            if self.ends is not None:
                self.async_stats["rollout"] = self.ends.producer_stats
        if producer.error is not None:
            raise RuntimeError("rollout producer failed") \
                from producer.error

    # -------------------- checkpoint/resume seam ------------------- #
    # monotonic checkpoint step ids: stage boundaries, then one per
    # completed PPO iteration (k completed -> RM_STEP + k)
    SFT_STEP, RM_STEP = 1, 2

    def _save_due(self, i: int) -> bool:
        """Whether PPO iteration ``i`` ends with a checkpoint."""
        return bool(self.ckpt is not None and self.save_every
                    and ((i + 1) % self.save_every == 0
                         or i == self.stages.ppo_steps - 1))

    def _meta(self, stage: str) -> dict:
        return {"stage": stage, "log": self.log, "rm_acc": self.rm_acc,
                "timings": self.timings}

    def _layouts(self) -> Optional[dict]:
        """Where stage 3 keeps each model on a mesh of more than one rank
        (``None`` otherwise): the actor's and the critic's TrainStates in
        the training layout, and under ``"params"`` the four models'
        params, the frozen ref and reward models in the ``tp`` layout as
        the trainer places them."""
        he = self.e.hybrid
        if he is None or runtime.mesh_size(he.mesh) == 1:
            return None
        crit = R.param_specs(self.e.critic_cfg)
        a = he.train_state_shardings(self.e.actor_cfg)
        c = he.train_state_shardings(self.e.critic_cfg, specs=crit)
        return {"actor": a, "critic": c, "params": {
            "actor": a.params, "critic": c.params,
            "ref": S.param_shardings(self.e.actor_cfg, he.mesh, "tp"),
            "reward": S.shardings_for_tree(crit, he.mesh, "tp")}}

    def _boundary_tree(self, names) -> dict:
        """The stage-boundary params ``names`` as a checkpoint holds them:
        placed in their stage-3 layouts on a mesh of more than one rank,
        so that each rank writes its own pieces."""
        tree = {n: getattr(self.e, f"{n}_params") for n in names}
        lay = self._layouts()
        if lay is None:
            return tree
        return {n: runtime.place_tree(t, lay["params"][n])
                for n, t in tree.items()}

    def _save_ppo(self, trainer, rng_state: torch.Tensor,
                  done: int) -> None:
        """Commit the whole stage-3 state after ``done`` completed
        iterations: trainer states (moments + EMA), frozen ref/reward
        params, ``rng_state`` (the generator state iteration ``done`` will
        draw from), and (in metadata) the data cursor + metrics log."""
        if self._layouts() is not None and not runtime.same_on_mesh(
                zlib.crc32(rng_state.numpy().tobytes()), self.e.hybrid.mesh):
            raise RuntimeError("the stage-3 generator's state differs "
                               "between the ranks of the mesh")
        tree = {"trainer": trainer.state_tree(),
                "ref": trainer.ref_params,
                "reward": trainer.reward_params,
                "rng": rng_state}
        self.ckpt.save(self.RM_STEP + done, tree,
                       dict(self._meta("ppo"), ppo_iter=done))

    def _restore_ppo(self, step: int, generator: torch.Generator) -> dict:
        """Rebuild stage-3 state from checkpoint ``step``.  The restore
        target is structure only (:func:`checkpoint.like`: shapes, dtypes
        and the engine's device, no memory); the step counters come back
        as host tensors."""
        dev = self.e.device
        actor = _like_train_state(checkpoint.like(self.e.actor_params, dev))
        critic = _like_train_state(checkpoint.like(self.e.critic_params,
                                                   dev))
        ema = self.ppo.use_ema
        like = {"trainer": {"actor": actor, "critic": critic,
                            "ema": actor.opt.m if ema else None},
                "ref": actor.params, "reward": critic.params,
                "rng": generator.get_state()}
        lay, sh = self._layouts(), None
        if lay is not None:
            sh = {"trainer": {"actor": lay["actor"], "critic": lay["critic"],
                              "ema": lay["actor"].params if ema else None},
                  "ref": lay["params"]["ref"],
                  "reward": lay["params"]["reward"], "rng": None}
        tree, meta = self.ckpt.restore(like, step=step, shardings=sh)
        self.e.ref_params = tree["ref"]
        self.e.reward_params = tree["reward"]
        self.e.actor_params = tree["trainer"]["actor"].params
        self.e.critic_params = tree["trainer"]["critic"].params
        self.log = meta["log"]
        self.rm_acc = meta["rm_acc"]
        self.timings = meta["timings"]
        return {"trainer": tree["trainer"], "rng": tree["rng"],
                "ppo_iter": int(meta["ppo_iter"])}

    def _restore_boundary(self, step: int, meta: dict) -> None:
        """Adopt a stage-boundary checkpoint (skip re-running the
        completed stages)."""
        dev = self.e.device
        actor = checkpoint.like(self.e.actor_params, dev)
        like = {"actor": actor, "ref": actor}
        if meta["stage"] == "rm_done":
            critic = checkpoint.like(self.e.critic_params, dev)
            like["critic"] = critic
            like["reward"] = critic
        lay = self._layouts()
        tree, meta = self.ckpt.restore(
            like, step=step, shardings=None if lay is None
            else {k: lay["params"][k] for k in like})
        self.e.actor_params = tree["actor"]
        self.e.ref_params = tree["ref"]
        if "critic" in tree:
            self.e.critic_params = tree["critic"]
            self.e.reward_params = tree["reward"]
        self.log = meta["log"]
        self.rm_acc = meta["rm_acc"]
        self.timings = meta["timings"]

    def maybe_restore(self):
        """(stage, step) of the latest valid checkpoint, or None."""
        if self.ckpt is None:
            return None
        step = self.ckpt.latest_step()
        if step is None:
            return None
        return self.ckpt.restore_metadata(step).get("stage"), step

    # ----------------------------- run ----------------------------- #
    def run(self, generator: Optional[torch.Generator] = None):
        """End-to-end 3-stage run; with a checkpointer, a rerun after a
        crash skips the completed stages and resumes stage 3 mid-stream
        from the latest valid checkpoint.  On the disaggregated split the
        bridge is open for the whole run, and a rollout rank goes straight
        to its half of stage 3."""
        with self._split():
            if self.e.role == "rollout":
                return {"sft_loss": [], "rm_acc": [],
                        "ppo_scores": self.run_ppo(generator),
                        "timings": self.timings}
            return self._run(generator)

    def _run(self, generator):
        resume = self.maybe_restore()
        stage = resume[0] if resume else None
        if stage in ("sft_done", "rm_done"):
            self._restore_boundary(resume[1], {"stage": stage})
        if stage is None:
            self.run_sft()
        if stage in (None, "sft_done"):
            self.run_reward()
        scores = self.run_ppo(generator)
        return {"sft_loss": self.log["stage1"], "rm_acc": self.rm_acc,
                "ppo_scores": scores, "timings": self.timings}
