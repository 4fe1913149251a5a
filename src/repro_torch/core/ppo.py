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
refuses aliases).  The reference's Hybrid Engine (``engine=``) and rollout
mesh belong to later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ema as EMA
from repro_torch.core import experience as X
from repro_torch.core.replay import RolloutBatch
from repro_torch.models import reward as R
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import tree_leaves
from repro_torch.serving.engine import GenerationEngine
from repro_torch.training.steps import lm_loss_fn, value_and_grad
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
def actor_logprobs(cfg: ModelConfig, params, sequences):
    hidden, _, _ = T.forward(cfg, params, tokens=sequences, mode="full")
    return T.per_token_logprobs(cfg, params, hidden[:, :-1],
                                sequences[:, 1:])


def actor_loss_fn(cfg: ModelConfig, ppo: PPOConfig, params, exp: X.Experience,
                  ptx_batch=None):
    logp = actor_logprobs(cfg, params, exp.sequences)
    ratio = torch.exp(logp - exp.logprobs)
    if ppo.is_clip is not None:
        ratio = torch.clamp(ratio, 1.0 / ppo.is_clip, ppo.is_clip)
    a = exp.advantages
    l1 = -a * ratio
    l2 = -a * torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps)
    n = torch.clamp(exp.mask.sum(), min=1.0)
    pg_loss = (torch.maximum(l1, l2) * exp.mask).sum() / n
    loss = pg_loss
    metrics = {"pg_loss": pg_loss,
               "ratio_mean": (ratio * exp.mask).sum() / n,
               "approx_kl": ((exp.logprobs - logp) * exp.mask).sum() / n}
    if ptx_batch is not None and ppo.ptx_coef > 0:
        ptx, _ = lm_loss_fn(cfg, params, ptx_batch)
        loss = loss + ppo.ptx_coef * ptx
        metrics["ptx_loss"] = ptx
    return loss, metrics


def critic_loss_fn(cfg: ModelConfig, ppo: PPOConfig, params,
                   exp: X.Experience):
    v = R.values(cfg, params, exp.sequences)[:, :-1]
    v_clip = exp.values + torch.clamp(v - exp.values, -ppo.value_clip,
                                      ppo.value_clip)
    n = torch.clamp(exp.mask.sum(), min=1.0)
    l = torch.maximum((v - exp.returns) ** 2, (v_clip - exp.returns) ** 2)
    loss = 0.5 * (l * exp.mask).sum() / n
    return loss, {"v_loss": loss,
                  "v_mean": (v * exp.mask).sum() / n}


def actor_step(cfg: ModelConfig, ppo: PPOConfig, state: TrainState,
               exp: X.Experience, ptx_batch=None):
    """One actor update; the params and moments change in place."""
    (loss, metrics), grads = value_and_grad(
        lambda p: actor_loss_fn(cfg, ppo, p, exp, ptx_batch), state.params)
    state, gnorm = state.apply_gradients(grads, lr=ppo.lr_actor)
    return state, dict(metrics, actor_loss=loss, actor_gnorm=gnorm)


def critic_step(cfg: ModelConfig, ppo: PPOConfig, state: TrainState,
                exp: X.Experience):
    """One critic update; the params and moments change in place."""
    (loss, metrics), grads = value_and_grad(
        lambda p: critic_loss_fn(cfg, ppo, p, exp), state.params)
    state, gnorm = state.apply_gradients(grads, lr=ppo.lr_critic)
    return state, dict(metrics, critic_gnorm=gnorm)


@torch.no_grad()
def make_experience(actor_cfg: ModelConfig, critic_cfg: ModelConfig,
                    ppo: PPOConfig, actor_params, ref_params, critic_params,
                    reward_params, sequences, response_mask,
                    attn_mask=None):
    """Score a generated batch: logprobs, ref logprobs, values, rewards,
    GAE.  Returns ``(Experience, score)``.  ``attn_mask`` marks the real
    (prompt + generated) tokens of each row so the reward model scores the
    last real token; ``None`` means the batch has no padding tail (the
    fixed-shape path)."""
    logp = actor_logprobs(actor_cfg, actor_params, sequences)
    ref_logp = actor_logprobs(actor_cfg, ref_params, sequences)
    values = R.values(critic_cfg, critic_params, sequences)[:, :-1]
    if attn_mask is None:
        attn_mask = torch.ones(sequences.shape, dtype=torch.float32,
                               device=sequences.device)
    score = R.end_scores(critic_cfg, reward_params, sequences, attn_mask)
    mask = response_mask[:, 1:].float()
    rewards = X.kl_rewards(logp, ref_logp, mask, score,
                           kl_coef=ppo.kl_coef,
                           clip_reward=ppo.clip_reward)
    adv, ret = X.gae(rewards, values, mask, gamma=ppo.gamma, lam=ppo.lam)
    return X.Experience(sequences=sequences, logprobs=logp,
                        ref_logprobs=ref_logp, values=values,
                        rewards=rewards, advantages=adv, returns=ret,
                        mask=mask), score


@torch.no_grad()
def staleness_guard_stats(cfg: ModelConfig, params, sequences,
                          behavior_logp, mask):
    """Per-token importance ratio of the current policy against the
    behavior policy that sampled the rollout (off-policy telemetry)."""
    logp = actor_logprobs(cfg, params, sequences)
    ratio = torch.exp(logp - behavior_logp)
    n = torch.clamp(mask.sum(), min=1.0)
    return {"is_ratio_mean": (ratio * mask).sum() / n,
            "is_ratio_max": torch.max(torch.where(mask > 0, ratio, 1.0))}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _shares_storage(a, b) -> bool:
    ptrs = {t.untyped_storage().data_ptr() for t in tree_leaves(a)}
    return any(t.untyped_storage().data_ptr() in ptrs
               for t in tree_leaves(b))


# ===================================================================== #
# Trainer
# ===================================================================== #
class PPOTrainer:
    """Single-device PPO over four models.  ``actor_params`` and
    ``critic_params`` become the trainer's train states and are updated in
    place; ``ref_params`` and ``reward_params`` stay frozen and must not
    share storage with them.  Generation and training run on the device
    of ``actor_params``."""

    def __init__(self, *, actor_cfg: ModelConfig, critic_cfg: ModelConfig,
                 actor_params, critic_params, ref_params, reward_params,
                 ppo: PPOConfig, engine=None, rollout_mesh=None):
        if engine is not None:
            raise NotImplementedError("PPOTrainer(engine=HybridEngine): "
                                      "not yet ported")
        if rollout_mesh is not None:
            raise NotImplementedError("PPOTrainer(rollout_mesh=): "
                                      "not yet ported")
        if _shares_storage(actor_params, ref_params):
            raise ValueError("ref_params share storage with actor_params: "
                             "the actor's in-place updates would move the "
                             "reference policy; pass a clone")
        if _shares_storage(critic_params, reward_params):
            raise ValueError("reward_params share storage with "
                             "critic_params: the critic's in-place updates "
                             "would move the reward model; pass a clone")
        self.actor_cfg, self.critic_cfg, self.ppo = actor_cfg, critic_cfg, ppo
        self.actor = TrainState.create(actor_params)
        self.critic = TrainState.create(critic_params)
        self.ref_params = ref_params
        self.reward_params = reward_params
        self.device = tree_leaves(actor_params)[0].device
        self.ema = EMA.init(self.actor.params) if ppo.use_ema else None
        # int8-KV experience generation: only the engine's view of the
        # model flips (cache dtypes + scale planes); the actor params it
        # consumes and every training-side forward are unchanged
        gen_cfg = (actor_cfg.replace(kv_quant=True) if ppo.kv_quant
                   else actor_cfg)
        self.gen_engine = GenerationEngine(
            gen_cfg, max_new_tokens=ppo.max_new_tokens,
            temperature=ppo.temperature, top_k=ppo.top_k, top_p=ppo.top_p,
            eos_id=ppo.eos_id, chunk=ppo.decode_chunk,
            kv_layout=ppo.kv_layout, block_size=ppo.kv_block_size,
            prefix_cache=ppo.prefix_cache, device=self.device)

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
    def generate_rollout(self, prompts, generator: torch.Generator):
        """Generation phase only: decode a fixed-shape prompt batch with the
        actor's current params into a
        :class:`~repro_torch.core.replay.RolloutBatch`."""
        t0 = time.perf_counter()
        if not isinstance(prompts, torch.Tensor):
            prompts = torch.as_tensor(np.asarray(prompts))
        prompts = prompts.to(device=self.device, dtype=torch.long)
        if self.ppo.n_samples_per_prompt > 1:
            # best-of-n: tile each prompt row n times (rows sample
            # independently, so stochastic copies diverge)
            prompts = prompts.repeat_interleave(
                self.ppo.n_samples_per_prompt, dim=0)
        out = self.gen_engine.generate(self.actor.params, prompts, generator)
        _sync(self.device)
        gen_s = time.perf_counter() - t0
        n_gen = float(out["response_mask"].sum())
        gm = {"gen_len": float(out["response_mask"].sum(1).float().mean()),
              "gen_tok_s": n_gen / max(gen_s, 1e-9), "gen_s": gen_s,
              "decode_steps": float(
                  self.gen_engine.last_stats["decode_steps"])}
        return RolloutBatch(sequences=out["sequences"],
                            response_mask=out["response_mask"],
                            attn_mask=None), gm

    def score_rollout(self, rollout: RolloutBatch):
        """Scoring phase with the current actor (the on-policy case):
        behavior logprobs, ref logprobs, values, reward, KL-shaped
        rewards, GAE."""
        t0 = time.perf_counter()
        dev = self.device
        seqs = torch.as_tensor(rollout.sequences, device=dev).long()
        mask = torch.as_tensor(rollout.response_mask, device=dev)
        attn = (None if rollout.attn_mask is None
                else torch.as_tensor(rollout.attn_mask, device=dev).float())
        exp, score = make_experience(
            self.actor_cfg, self.critic_cfg, self.ppo, self.actor.params,
            self.ref_params, self.critic.params, self.reward_params, seqs,
            mask, attn)
        sm = {"reward_score": float(score.mean())}       # synchronizes
        sm["score_ms"] = (time.perf_counter() - t0) * 1e3
        return exp, sm

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
        outs = {c.uid: c for c in eng.serve(
            self.actor.params, requests, generator,
            slots=min(slots, len(requests)))}
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
        return exp, gm

    # ---------------------- state tree ---------------------------- #
    def state_tree(self):
        """The trainer's durable state: actor and critic TrainStates
        (params, fp32 Adam moments, step counters) and the EMA shadow."""
        return {"actor": self.actor, "critic": self.critic, "ema": self.ema}

    def state_shardings(self):
        """Layouts matching :meth:`state_tree`: ``None`` on one device."""
        return None

    def load_state_tree(self, tree):
        """Adopt a state tree (as :meth:`state_tree` returns it)."""
        self.actor = tree["actor"]
        self.critic = tree["critic"]
        self.ema = tree["ema"]

    def train_rlhf(self, exp: X.Experience, ptx_batch=None):
        """Training phase: one actor step (with the mixture term when
        ``ptx_coef > 0``), one critic step, then the EMA.  Returns the
        metrics as floats, with each step's time (``actor_ms``,
        ``critic_ms``, host clock around a synchronized step)."""
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
