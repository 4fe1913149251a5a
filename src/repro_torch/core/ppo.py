"""PPO trainer — the ``DeepSpeedPPOTrainer`` analogue (counterpart of
``repro/core/ppo.py``, single device).

    trainer = PPOTrainer(actor_cfg=..., critic_cfg=..., actor_params=...,
                         critic_params=..., ref_params=...,
                         reward_params=..., ppo=PPOConfig(...))
    for batch in prompt_loader:
        exp, gm = trainer.generate_experience(batch, generator)  # inference
        metrics = trainer.train_rlhf(exp)                         # training

Losses follow DeepSpeed-Chat / InstructGPT: clipped surrogate for the actor
(+ optional pretrain-mixture term), clipped value loss for the critic, EMA
collection of actor weights.  Experience is generated by the port's
:class:`~repro_torch.serving.engine.GenerationEngine` (early-exit decode on
the dense KV arena for a fixed-shape batch; the request path runs on
``PPOConfig.kv_layout``, paged with ``kv_block_size`` and the prefix cache
if asked; int8 with ``PPOConfig.kv_quant``) and scored by
:func:`make_experience` under ``torch.no_grad()``: the same forward (the
same kernels, the same logit chunks) as the actor step's, so the first
step's importance ratio is 1.

Where the reference jits pure functions over immutable arrays, the port's
optimizer updates the actor's and critic's params in place: the trainer
owns the params it is given (``TrainState.create`` keeps them), and the
frozen reference and reward params must not share storage with them
(:class:`~repro_torch.core.pipeline.RLHFPipeline` clones both; the trainer
refuses aliases).

With ``engine=`` (a :class:`~repro_torch.core.hybrid_engine.HybridEngine`)
each rollout enters the inference layout through one
``engine.to_inference`` and the metrics carry its measured ``reshard_bytes``
and ``reshard_s``.  On a mesh of more than one rank (``dp x tp``) the actor
and critic states live in the training layout (ZeRO-sharded, and cut over
``model``, ``DTensor``s), the frozen models in the ``tp`` layout, the
engine decodes each data rank's rows tensor-parallel, and scoring and
both steps run tensor-parallel on the compute views
(:func:`repro_torch.training.steps.mesh_view`) over the data rank's rows,
with every batch-wide mean (advantage whitening, the losses and their
metrics, ``reward_score``) taken over the global batch: the single-device
result, up to the order of the sums.  The experience is then a tree of
``DTensor``s sharded over ``data``.  :meth:`PPOTrainer.load_state_tree`
places a restored state in this mesh's training layout, whatever layout
it was saved in.  At one rank the trainer runs as with ``engine=None``.

With ``rollout_mesh=`` (disaggregated: generation on a mesh of its own,
disjoint from the engine's training mesh, both from
:func:`repro_torch.launch.mesh.make_disaggregated_meshes`) the trainer
takes this rank's role.  On a training rank it holds the states as above
and no generation engine; :meth:`PPOTrainer.publish_shardings` is the
rollout mesh's ``tp`` layout, and the synchronous
:meth:`PPOTrainer.generate_rollout` pushes the actor there through the
bridge (``cross_mesh_put``, never ``to_inference``) and takes the batch
the rollout ranks send back.  On a rollout rank it holds only the
generation engine, bound to the rollout mesh (a plain engine on this
rank's device when that mesh has one rank), and generates with the
params published to it.  The bridge's ends (:class:`~repro_torch.core.
replay.SplitEnds`) come from :class:`~repro_torch.core.pipeline.
RLHFPipeline`, which runs each role's half of stage 3.

The asynchronous seam (:mod:`repro_torch.core.replay`: one device, a
shared mesh of any size and the disaggregated split):
:meth:`PPOTrainer.generate_rollout` takes ``gen_params`` already published
(no ``to_inference``, no reshard metrics), decodes them on ``gen_engine``
when given (on a shared mesh the producer's, from
:meth:`PPOTrainer.generation_engine` on its twin of the mesh) and tags the
rollout with their ``version``; :meth:`PPOTrainer.score_rollout` scores
with the behavior policy's retained params and reports ``policy_lag``,
``is_ratio_mean`` and ``is_ratio_max`` (the guard forward runs only when
the lag is above 0; on a training mesh of more than one rank on the
compute views, its mean and max reduced over the data group).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import stream_event
from repro_torch.core import ema as EMA
from repro_torch.core import experience as X
from repro_torch.core.replay import RolloutBatch
from repro_torch.models import reward as R
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.serving.engine import GenerationEngine
from repro_torch.sharding import runtime
from repro_torch.sharding import strategy as S
from repro_torch.training.steps import (lm_loss_fn, mesh_value_and_grad,
                                        mesh_view)
from repro_torch.training.train_state import TrainState


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None   # enables early-exit decode when set
    decode_chunk: int = 32         # decode dispatch granularity (engine)
    # best-of-n experience generation: each prompt is sampled n times
    # (fixed-shape prompt batches are row-tiled; request lists are
    # expanded with per-copy seeds); with the paged engine's prefix cache
    # on, the request path reuses each prompt's prefilled KV blocks, so
    # the prompt prefill is paid once, not n times
    n_samples_per_prompt: int = 1
    kv_layout: str = "dense"       # generation engine KV layout
    kv_block_size: int = 16        # paged: tokens per KV block
    prefix_cache: bool = False     # paged: prefix-aware block reuse
    # int8 KV cache for experience generation: only the generation
    # engine's cfg flips, training forwards are untouched
    kv_quant: bool = False
    kl_coef: float = 0.1
    clip_eps: float = 0.2
    value_clip: float = 0.2
    clip_reward: float = 5.0
    gamma: float = 1.0
    lam: float = 0.95
    lr_actor: float = 1e-5
    lr_critic: float = 5e-6
    ptx_coef: float = 0.0          # mixture training weight (0 = off)
    ema_decay: float = 0.992
    use_ema: bool = True
    # off-policy staleness guard: clamp the per-token importance ratio
    # into [1/is_clip, is_clip]; None leaves the on-policy loss untouched
    is_clip: Optional[float] = None


# ===================================================================== #
# Loss / step functions
# ===================================================================== #
def actor_logprobs(cfg: ModelConfig, params, sequences, tp=None):
    hidden, _, _ = T.forward(cfg, params, tokens=sequences, mode="full",
                             tp=tp)
    return T.per_token_logprobs(cfg, params, hidden[:, :-1],
                                sequences[:, 1:], tp)


def _count(mask, group):
    """The mask's sum over the global batch (this batch's without a data
    group), at least 1."""
    n = mask.sum()
    if group is not None:
        n = runtime.all_sum([n], group)[0]
    return torch.clamp(n, min=1.0)


def actor_loss_fn(cfg: ModelConfig, ppo: PPOConfig, params, exp: X.Experience,
                  ptx_batch=None, group=None, ptx_group=None, tp=None):
    """The actor loss and metrics.  With a data ``group`` the experience is
    this rank's rows of a batch sharded over it, and the loss and metrics
    are this rank's parts of the global batch's (they sum over the group
    to them); ``ptx_group`` is the mixture batch's group (``None``:
    replicated, whose term every rank then carries a ``1 / dp`` share
    of).  ``tp``: the tensor-parallel context of a compute view
    ``params``."""
    logp = actor_logprobs(cfg, params, exp.sequences, tp)
    ratio = torch.exp(logp - exp.logprobs)
    if ppo.is_clip is not None:
        ratio = torch.clamp(ratio, 1.0 / ppo.is_clip, ppo.is_clip)
    a = exp.advantages
    l1 = -a * ratio
    l2 = -a * torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps)
    n = _count(exp.mask, group)
    pg_loss = (torch.maximum(l1, l2) * exp.mask).sum() / n
    loss = pg_loss
    metrics = {"pg_loss": pg_loss,
               "ratio_mean": (ratio * exp.mask).sum() / n,
               "approx_kl": ((exp.logprobs - logp) * exp.mask).sum() / n}
    if ptx_batch is not None and ppo.ptx_coef > 0:
        ptx_tp = None if tp is None else tp.with_rows(ptx_group)
        if group is None:
            ptx, _ = lm_loss_fn(cfg, params, ptx_batch, tp=ptx_tp)
        else:
            ptx, _ = lm_loss_fn(cfg, params, ptx_batch, count=_count(
                ptx_batch["mask"].float(), ptx_group), tp=ptx_tp)
            if ptx_group is None:
                ptx = ptx / group.size()
        loss = loss + ppo.ptx_coef * ptx
        metrics["ptx_loss"] = ptx
    return loss, metrics


def critic_loss_fn(cfg: ModelConfig, ppo: PPOConfig, params,
                   exp: X.Experience, group=None, tp=None):
    """The critic loss and metrics (``group``, ``tp``: as
    :func:`actor_loss_fn`)."""
    v = R.values(cfg, params, exp.sequences, tp=tp)[:, :-1]
    v_clip = exp.values + torch.clamp(v - exp.values, -ppo.value_clip,
                                      ppo.value_clip)
    n = _count(exp.mask, group)
    l = torch.maximum((v - exp.returns) ** 2, (v_clip - exp.returns) ** 2)
    loss = 0.5 * (l * exp.mask).sum() / n
    return loss, {"v_loss": loss,
                  "v_mean": (v * exp.mask).sum() / n}


def actor_step(cfg: ModelConfig, ppo: PPOConfig, state: TrainState,
               exp: X.Experience, ptx_batch=None):
    """One actor update; the params and moments change in place.  A state
    in a mesh layout takes an experience (and mixture batch) from
    ``shard_batch``."""
    ptx_group = (runtime.batch_local(ptx_batch)[1]
                 if ptx_batch is not None else None)
    (loss, metrics), grads = mesh_value_and_grad(
        cfg, "actor_step",
        lambda p, b, g, tp: actor_loss_fn(cfg, ppo, p, b[0], b[1], group=g,
                                          ptx_group=ptx_group, tp=tp),
        state, (exp, ptx_batch))
    state, gnorm = state.apply_gradients(grads, lr=ppo.lr_actor)
    return state, dict(metrics, actor_loss=loss, actor_gnorm=gnorm)


def critic_step(cfg: ModelConfig, ppo: PPOConfig, state: TrainState,
                exp: X.Experience):
    """One critic update; the params and moments change in place."""
    (loss, metrics), grads = mesh_value_and_grad(
        cfg, "critic_step",
        lambda p, b, g, tp: critic_loss_fn(cfg, ppo, p, b, group=g, tp=tp),
        state, exp)
    state, gnorm = state.apply_gradients(grads, lr=ppo.lr_critic)
    return state, dict(metrics, critic_gnorm=gnorm)


@torch.no_grad()
def make_experience(actor_cfg: ModelConfig, critic_cfg: ModelConfig,
                    ppo: PPOConfig, actor_params, ref_params, critic_params,
                    reward_params, sequences, response_mask,
                    attn_mask=None, group=None, tps=(None,) * 4):
    """Score a generated batch: logprobs, ref logprobs, values, rewards,
    GAE.  Returns ``(Experience, score)``.  ``attn_mask`` marks the real
    (prompt + generated) tokens of each row so the reward model scores the
    last real token; ``None`` means the batch has no padding tail (the
    fixed-shape path).  With a data ``group`` the rows are this rank's
    part of a batch sharded over it (the advantages are whitened over the
    global batch).  ``tps``: the tensor-parallel contexts of the actor,
    ref, critic and reward params when they are compute views."""
    tp_a, tp_ref, tp_c, tp_rm = tps
    logp = actor_logprobs(actor_cfg, actor_params, sequences, tp_a)
    ref_logp = actor_logprobs(actor_cfg, ref_params, sequences, tp_ref)
    values = R.values(critic_cfg, critic_params, sequences, tp=tp_c)[:, :-1]
    if attn_mask is None:
        attn_mask = torch.ones(sequences.shape, dtype=torch.float32,
                               device=sequences.device)
    score = R.end_scores(critic_cfg, reward_params, sequences, attn_mask,
                         tp_rm)
    mask = response_mask[:, 1:].float()
    rewards = X.kl_rewards(logp, ref_logp, mask, score,
                           kl_coef=ppo.kl_coef,
                           clip_reward=ppo.clip_reward)
    adv, ret = X.gae(rewards, values, mask, gamma=ppo.gamma, lam=ppo.lam,
                     group=group)
    return X.Experience(sequences=sequences, logprobs=logp,
                        ref_logprobs=ref_logp, values=values,
                        rewards=rewards, advantages=adv, returns=ret,
                        mask=mask), score


@torch.no_grad()
def staleness_guard_stats(cfg: ModelConfig, params, sequences,
                          behavior_logp, mask, group=None, tp=None):
    """Per-token importance ratio of the current policy against the
    behavior policy that sampled the rollout (off-policy telemetry).  With
    a data ``group`` the rows are this rank's part of a batch sharded over
    it, and the mean and max are the global batch's; ``tp``: the
    tensor-parallel context of a compute view ``params``."""
    logp = actor_logprobs(cfg, params, sequences, tp)
    ratio = torch.exp(logp - behavior_logp)
    n = _count(mask, group)
    total = (ratio * mask).sum()
    top = torch.max(torch.where(mask > 0, ratio, 1.0))
    if group is not None:
        total = runtime.all_sum([total], group)[0]
        top = runtime.all_max(top, group)
    return {"is_ratio_mean": total / n, "is_ratio_max": top}


def _shares_storage(a, b) -> bool:
    def ptr(t):
        return runtime.local(t).untyped_storage().data_ptr()
    ptrs = {ptr(t) for t in tree_leaves(a)}
    return any(ptr(t) in ptrs for t in tree_leaves(b))


# ===================================================================== #
# Trainer
# ===================================================================== #
class PPOTrainer:
    """PPO over four models.  ``actor_params`` and ``critic_params`` become
    the trainer's train states and are updated in place; ``ref_params``
    and ``reward_params`` stay frozen and must not share storage with
    them.  Generation and training run on the device of ``actor_params``.
    ``engine`` (a :class:`~repro_torch.core.hybrid_engine.HybridEngine`)
    adds the phase reshard and, on a mesh of more than one rank, the
    data-parallel layouts (see the module's docstring)."""

    def __init__(self, *, actor_cfg: ModelConfig, critic_cfg: ModelConfig,
                 actor_params, critic_params, ref_params, reward_params,
                 ppo: PPOConfig, engine=None, rollout_mesh=None, ends=None):
        self.rollout_mesh, self.ends, self.role = rollout_mesh, ends, None
        if rollout_mesh is not None:
            from repro_torch.launch.mesh import bridge_of
            if engine is None:
                raise ValueError("PPOTrainer(rollout_mesh=) needs engine=: "
                                 "a HybridEngine on the training mesh, "
                                 "disjoint from the rollout mesh")
            self.role = bridge_of(rollout_mesh, engine.mesh).role
            if self.role is None:
                raise ValueError("PPOTrainer(rollout_mesh=): this rank is "
                                 "on neither mesh")
        if self.role == "rollout":
            self._init_rollout(actor_cfg, critic_cfg, ppo, rollout_mesh)
            return
        if engine is not None:
            for c in (actor_cfg, critic_cfg):
                runtime.check_compute_mesh(engine.mesh, "PPOTrainer(engine=)",
                                           c)
        if _shares_storage(actor_params, ref_params):
            raise ValueError("ref_params share storage with actor_params: "
                             "the actor's in-place updates would move the "
                             "reference policy; pass a clone")
        if _shares_storage(critic_params, reward_params):
            raise ValueError("reward_params share storage with "
                             "critic_params: the critic's in-place updates "
                             "would move the reward model; pass a clone")
        self.actor_cfg, self.critic_cfg, self.ppo = actor_cfg, critic_cfg, ppo
        self.device = tree_leaves(actor_params)[0].device
        self.engine = engine
        self.mesh = engine.mesh if engine is not None else None
        self._multi = (self.mesh is not None
                       and runtime.mesh_size(self.mesh) > 1)
        if self._multi:
            # training layout: `train_strategy` params, ZeRO-`zero` fp32
            # moments born sharded; the frozen scoring models in the `tp`
            # layout (only ever read); the critic / reward trees resolve
            # from reward.param_specs (value head)
            crit_specs = R.param_specs(critic_cfg)
            self.actor = TrainState.create(
                actor_params, shardings=engine.train_state_shardings(
                    actor_cfg))
            self.critic = TrainState.create(
                critic_params, shardings=engine.train_state_shardings(
                    critic_cfg, specs=crit_specs))
            self.ref_params = runtime.place_tree(
                ref_params, S.param_shardings(actor_cfg, self.mesh, "tp"))
            self.reward_params = runtime.place_tree(
                reward_params, S.shardings_for_tree(crit_specs, self.mesh,
                                                    "tp"))
        else:
            self.actor = TrainState.create(actor_params)
            self.critic = TrainState.create(critic_params)
            self.ref_params = ref_params
            self.reward_params = reward_params
        self.ema = EMA.init(self.actor.params) if ppo.use_ema else None
        # int8-KV experience generation: only the engine's view of the
        # model flips (cache dtypes + scale planes); the actor params it
        # consumes and every training-side forward are unchanged
        gen_cfg, gen_opts = self._gen_options(actor_cfg, ppo)
        self.gen_engine = (
            None if self.role == "train"     # generation is the rollout's
            else engine.generation_engine(cfg=gen_cfg, **gen_opts)
            if engine is not None else GenerationEngine(gen_cfg, **gen_opts))

    def _gen_options(self, actor_cfg: ModelConfig, ppo: PPOConfig):
        gen_cfg = (actor_cfg.replace(kv_quant=True) if ppo.kv_quant
                   else actor_cfg)
        return gen_cfg, dict(
            max_new_tokens=ppo.max_new_tokens, temperature=ppo.temperature,
            top_k=ppo.top_k, top_p=ppo.top_p, eos_id=ppo.eos_id,
            chunk=ppo.decode_chunk, kv_layout=ppo.kv_layout,
            block_size=ppo.kv_block_size, prefix_cache=ppo.prefix_cache,
            device=self.device)

    def generation_engine(self, mesh):
        """A generation engine like the trainer's own, bound to ``mesh``, a
        twin of the engine's mesh (:func:`repro_torch.launch.mesh.
        twin_mesh`), at any size: the asynchronous producer's on a shared
        mesh, whose every collective runs on ``mesh``'s groups."""
        gen_cfg, gen_opts = self._gen_options(self.actor_cfg, self.ppo)
        return self.engine.generation_engine(cfg=gen_cfg, mesh=mesh,
                                             **gen_opts)

    def _init_rollout(self, actor_cfg, critic_cfg, ppo, mesh) -> None:
        """A rollout rank's trainer: the generation engine on the rollout
        mesh (plain on this rank's device at one rank), no states."""
        self.actor_cfg, self.critic_cfg, self.ppo = actor_cfg, critic_cfg, ppo
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device("cpu"))
        self.engine, self.mesh, self._multi = None, mesh, False
        self.actor = self.critic = self.ema = None
        self.ref_params = self.reward_params = None
        gen_cfg, gen_opts = self._gen_options(actor_cfg, ppo)
        self.gen_engine = GenerationEngine(
            gen_cfg, mesh=mesh if runtime.mesh_size(mesh) > 1 else None,
            **gen_opts)

    def _shard_batch(self, tree):
        """A batch tree committed to the data axis (replicated when it does
        not divide it) on a mesh of more than one rank; the tree itself
        otherwise."""
        if not self._multi or tree is None:
            return tree
        return S.shard_batch(tree, self.mesh)

    # -------------------------------------------------------------- #
    def generate_experience(self, prompts, generator: torch.Generator):
        """Inference phase.  ``prompts`` is either a fixed-shape ``(B, Lp)``
        token batch (early-exit decode) or a list of
        :class:`~repro_torch.serving.engine.Request` with ragged prompts
        and per-request sampling params (the request-level core, scored at
        each sequence's true length).  Draws advance ``generator``.
        Returns ``(Experience, metrics)``."""
        if isinstance(prompts, (list, tuple)):
            return self._experience_from_requests(list(prompts), generator)
        rollout, gm = self.generate_rollout(prompts, generator)
        exp, sm = self.score_rollout(rollout)
        return exp, {**gm, **sm}

    # ---------------- rollout / scoring split ---------------------- #
    def generate_rollout(self, prompts, generator: torch.Generator, *,
                         gen_params=None, version: int = 0,
                         gen_engine=None):
        """Generation phase only: decode a fixed-shape prompt batch into a
        version-tagged :class:`~repro_torch.core.replay.RolloutBatch`.
        ``gen_params`` are params already published for generation (the
        asynchronous :class:`~repro_torch.core.replay.WeightPublisher`'s);
        with ``None`` the actor's current params go through the engine's
        ``to_inference`` (one reshard per phase) and the metrics carry its
        ``reshard_bytes`` and ``reshard_s``.  ``gen_engine`` decodes them
        (default the trainer's own).  ``gen_s`` waits for the calling
        thread's stream only."""
        if self.role == "train":
            return self._rollout_across(generator)
        if self.role == "rollout" and gen_params is None:
            raise ValueError("a rollout rank generates with the params "
                             "published to it (gen_params=)")
        t0 = time.perf_counter()
        if not isinstance(prompts, torch.Tensor):
            prompts = torch.as_tensor(np.asarray(prompts))
        prompts = prompts.to(device=self.device, dtype=torch.long)
        if self.ppo.n_samples_per_prompt > 1:
            # best-of-n: tile each prompt row n times (rows sample
            # independently, so stochastic copies diverge); the tiled
            # batch is what a mesh splits
            prompts = prompts.repeat_interleave(
                self.ppo.n_samples_per_prompt, dim=0)
        params = gen_params
        if params is None:
            params = self.actor.params
            if self.engine is not None:    # one reshard per phase
                params = self.engine.to_inference(params)
        engine = gen_engine if gen_engine is not None else self.gen_engine
        out = engine.generate(params, prompts, generator)
        del params
        done = stream_event(self.device)
        if done is not None:
            done.synchronize()
        gen_s = time.perf_counter() - t0
        n_gen = float(out["response_mask"].sum())
        gm = {"gen_len": float(out["response_mask"].sum(1).float().mean()),
              "gen_tok_s": n_gen / max(gen_s, 1e-9), "gen_s": gen_s,
              "decode_steps": float(engine.last_stats["decode_steps"])}
        if gen_params is None:
            self._add_reshard_metrics(gm)
        return RolloutBatch(sequences=out["sequences"],
                            response_mask=out["response_mask"],
                            attn_mask=None, version=version), gm

    def _rollout_across(self, generator: torch.Generator):
        """The synchronous generation phase of a training rank: the actor
        pushed to the rollout mesh (``cross_mesh_put`` over the bridge,
        waited for), then the batch the rollout ranks generated with it;
        ``generator`` takes the state the rollout ranks' generator had
        after it (what the synchronous loop checkpoints).

        The metrics are the reference's: ``gen_s`` runs from before the
        push until the batch is back, ``gen_tok_s`` is the batch's
        response tokens over it, and ``reshard_bytes`` / ``reshard_s`` are
        the training mesh's engine's (which never reshards here: 0, as the
        reference reports).  The port's extras beside them: ``gen_s``,
        and the push's ``publish_s`` and ``publish_bytes``."""
        if self.ends is None:
            raise ValueError("a training rank of the disaggregated split "
                             "generates through the bridge's ends "
                             "(PPOTrainer(ends=), as RLHFPipeline opens "
                             "them)")
        t0 = time.perf_counter()
        pushed = self.ends.push_now(self.actor.params)
        item = self.ends.queue.get(timeout=self.ends.get_timeout_s)
        gen_s = time.perf_counter() - t0
        generator.set_state(item.generator_state)
        n_gen = float(torch.as_tensor(item.rollout.response_mask).sum())
        gm = {**item.gen_metrics, "gen_tok_s": n_gen / max(gen_s, 1e-9),
              "gen_s": gen_s, "publish_s": pushed["seconds"],
              "publish_bytes": float(pushed["bytes"])}
        self._add_reshard_metrics(gm)
        return item.rollout, gm

    def score_rollout(self, rollout: RolloutBatch, *, behavior_params=None,
                      policy_lag: Optional[int] = None):
        """Scoring phase: behavior logprobs, ref logprobs, values, reward,
        KL-shaped rewards, GAE.

        ``behavior_params`` is the policy that sampled the rollout (the
        publisher's retained params for its version tag); ``None`` is the
        current actor, the on-policy case.  Scoring with the behavior
        weights makes ``exp.logprobs`` the exact sampling-time logprobs, so
        the PPO importance ratio is exact.  ``policy_lag`` (consumer version
        minus rollout version), when given, adds ``policy_lag``,
        ``is_ratio_mean`` and ``is_ratio_max`` to the metrics: 1.0 at lag 0
        (on-policy by construction), and from one more forward of the
        current actor (:func:`staleness_guard_stats`) above it."""
        t0 = time.perf_counter()
        dev = self.device
        behavior = (behavior_params if behavior_params is not None
                    else self.actor.params)
        seqs = torch.as_tensor(rollout.sequences, device=dev).long()
        mask = torch.as_tensor(rollout.response_mask, device=dev)
        attn = (None if rollout.attn_mask is None
                else torch.as_tensor(rollout.attn_mask, device=dev).float())
        if not self._multi:
            exp, score = make_experience(
                self.actor_cfg, self.critic_cfg, self.ppo, behavior,
                self.ref_params, self.critic.params, self.reward_params,
                seqs, mask, attn)
            sm = {"reward_score": float(score.mean())}   # synchronizes
            if policy_lag is not None:
                sm.update(self._guard(exp, policy_lag))
            sm["score_ms"] = (time.perf_counter() - t0) * 1e3
            return exp, sm
        # this rank's rows, scored tensor-parallel on the compute views
        batch = self._shard_batch((seqs, mask, attn))
        (lseqs, lmask, lattn), group = runtime.batch_local(batch)
        views = [mesh_view(c, p, group)[::2] for c, p in (
            (self.actor_cfg, behavior),
            (self.actor_cfg, self.ref_params),
            (self.critic_cfg, self.critic.params),
            (self.critic_cfg, self.reward_params))]
        exp, score = make_experience(
            self.actor_cfg, self.critic_cfg, self.ppo,
            *(v for v, _ in views), lseqs, lmask, lattn, group=group,
            tps=tuple(tp for _, tp in views))
        total = (runtime.all_sum([score.sum()], group)[0] if group
                 is not None else score.sum())
        sm = {"reward_score": float(total) / seqs.shape[0]}
        if policy_lag is not None:
            sm.update(self._guard(exp, policy_lag, group))
        sm["score_ms"] = (time.perf_counter() - t0) * 1e3
        return X.Experience(*runtime.wrap_rows(tuple(exp), batch[0])), sm

    def _guard(self, exp: X.Experience, policy_lag: int,
               group=None) -> dict:
        """The staleness-guard metrics of a rollout scored at
        ``policy_lag`` (on a mesh of more than one rank ``exp`` holds this
        rank's rows of a batch sharded over ``group``)."""
        sm = {"policy_lag": float(policy_lag)}
        if policy_lag > 0:
            params, tp = self.actor.params, None
            if self._multi:
                params, _, tp = mesh_view(self.actor_cfg, params, group)
            g = staleness_guard_stats(self.actor_cfg, params,
                                      exp.sequences, exp.logprobs, exp.mask,
                                      group=group, tp=tp)
            sm["is_ratio_mean"] = float(g["is_ratio_mean"])
            sm["is_ratio_max"] = float(g["is_ratio_max"])
        else:
            sm["is_ratio_mean"] = 1.0
            sm["is_ratio_max"] = 1.0
        return sm

    def publish_shardings(self):
        """Target layout for asynchronous weight publication, as the
        reference's: the rollout mesh's ``tp`` layout when there is one
        (disaggregated), the Hybrid Engine's inference layout on a shared
        mesh of several ranks, else ``None`` (one device and 1 x 1)."""
        if self.rollout_mesh is not None:
            return S.param_shardings(self.actor_cfg, self.rollout_mesh, "tp")
        if self._multi:
            return self.engine.infer_shardings
        return None

    def _expand_samples(self, requests):
        """Best-of-n expansion: each request ``n_samples_per_prompt`` times
        under fresh uids, copies of one prompt adjacent; seeded requests
        get per-copy seeds."""
        n = self.ppo.n_samples_per_prompt
        if n <= 1:
            return list(requests)
        out = []
        for i, r in enumerate(requests):
            for j in range(n):
                p = r.params
                if p is not None and p.seed is not None and j > 0:
                    p = dataclasses.replace(p, seed=p.seed + j)
                out.append(dataclasses.replace(r, uid=i * n + j, params=p))
        return out

    def _experience_from_requests(self, requests, generator, *,
                                  slots: int = 8):
        """Ragged experience generation through the stepwise engine core,
        then ``prompt | generated | pad`` rows right-padded to one width
        for scoring; padding is excluded from the response mask and from
        the reward model's end-score position via the attention mask."""
        t0 = time.perf_counter()
        eng = self.gen_engine
        requests = self._expand_samples(requests)
        params = self.actor.params
        if self.engine is not None:        # one reshard per phase
            params = self.engine.to_inference(params)
        outs = {c.uid: c for c in eng.serve(
            params, requests, generator, slots=min(slots, len(requests)))}
        del params
        gen_s = time.perf_counter() - t0
        W = max(len(r.tokens) + eng.resolve(r)[3] for r in requests)
        B = len(requests)
        pad_tok = eng.eos_id if eng.eos_id is not None else 0
        seqs = np.full((B, W), pad_tok, np.int64)
        resp = np.zeros((B, W), bool)
        attn = np.zeros((B, W), np.float32)
        for i, r in enumerate(requests):
            c = outs[r.uid]
            Lp, n = len(c.prompt), int(c.tokens.size)
            seqs[i, :Lp] = c.prompt
            seqs[i, Lp:Lp + n] = c.tokens
            resp[i, Lp:Lp + n] = True
            attn[i, :Lp + n] = 1.0
        rollout = RolloutBatch(sequences=seqs, response_mask=resp,
                               attn_mask=attn)
        exp, sm = self.score_rollout(rollout)
        n_gen = float(resp.sum())
        gm = {**sm,
              "gen_len": float(resp.sum(1).mean()),
              "gen_tok_s": n_gen / max(gen_s, 1e-9), "gen_s": gen_s,
              "decode_steps": float(eng.last_stats["decode_steps"])}
        if "prefill_hit_rate" in eng.last_stats:     # paged engine
            gm["prefill_hit_rate"] = float(
                eng.last_stats["prefill_hit_rate"])
        self._add_reshard_metrics(gm)
        return exp, gm

    def _add_reshard_metrics(self, gm: dict) -> None:
        """The measured Hybrid-Engine phase transition (bytes gathered over
        the mesh, seconds between two device synchronizations)."""
        if self.engine is None:
            return
        rs = self.engine.last_reshard_stats
        gm["reshard_bytes"] = float(rs.get("gathered_bytes", 0))
        gm["reshard_s"] = float(rs.get("seconds", 0.0))

    # ---------------------- state tree ---------------------------- #
    def state_tree(self):
        """The trainer's durable state: actor and critic TrainStates
        (params, fp32 Adam moments, step counters) and the EMA shadow."""
        return {"actor": self.actor, "critic": self.critic, "ema": self.ema}

    def state_shardings(self):
        """Layouts matching :meth:`state_tree`: the training layout on a
        mesh of more than one rank, ``None`` otherwise."""
        if not self._multi:
            return None
        a_sh = self.engine.train_state_shardings(self.actor_cfg)
        c_sh = self.engine.train_state_shardings(
            self.critic_cfg, specs=R.param_specs(self.critic_cfg))
        return {"actor": a_sh, "critic": c_sh,
                "ema": a_sh.params if self.ema is not None else None}

    def load_state_tree(self, tree):
        """Adopt a state tree (as :meth:`state_tree` returns it).  On a mesh
        of more than one rank its leaves are placed in the training layout
        of :meth:`state_shardings`: full tensors (every rank holds the same
        whole tree) are sliced locally, ``DTensor``\\ s (a tree that
        ``CheckpointManager.restore(shardings=)`` placed) are kept, or moved
        when they are laid out otherwise; the step counters stay host
        tensors."""
        sh = self.state_shardings()
        if sh is not None:
            tree = tree_map(
                lambda s, x: x if x is None or x.dim() == 0
                else runtime.move(x, s), sh, tree,
                is_leaf=runtime.is_sharding)
        self.actor = tree["actor"]
        self.critic = tree["critic"]
        self.ema = tree["ema"]

    def train_rlhf(self, exp: X.Experience, ptx_batch=None):
        """Training phase: one actor step (with the mixture term when
        ``ptx_coef > 0``), one critic step, then the EMA.  Returns the
        metrics as floats, with each step's time (``actor_ms``,
        ``critic_ms``, host clock around a synchronized step)."""
        if self._multi:
            if not runtime.is_dtensor(exp.sequences):
                exp = self._shard_batch(exp)
            if runtime.batch_local(exp)[1] is not None:
                ptx_batch = self._shard_batch(ptx_batch)
        t0 = time.perf_counter()
        self.actor, am = actor_step(self.actor_cfg, self.ppo, self.actor,
                                    exp, ptx_batch)
        am = {k: float(v) for k, v in am.items()}          # synchronizes
        t1 = time.perf_counter()
        self.critic, cm = critic_step(self.critic_cfg, self.ppo,
                                      self.critic, exp)
        cm = {k: float(v) for k, v in cm.items()}
        t2 = time.perf_counter()
        if self.ema is not None:
            EMA.update(self.ema, self.actor.params, self.ppo.ema_decay)
        return {**am, **cm, "actor_ms": (t1 - t0) * 1e3,
                "critic_ms": (t2 - t1) * 1e3}

    def ema_params(self):
        return EMA.to_params(self.ema, self.actor.params)
