"""The port's SSM / hybrid training slice against the reference, on the CPU
(part 2 of 3, beside ``test_torch_ssm_training.py``): ``reward_train_step``
with the reward and critic heads on an SSM or hybrid backbone (the reduced
Mamba2-370M, Zamba2-1.2B and a two-segment hybrid; plain and kernel path)
against the reference's jnp path, and the PPO actor and critic steps of an
SSM or hybrid actor against ``reference_core()``'s.  Same weights (carried
across through numpy), same numpy-seeded inputs, fp32.

Tolerances: the reward step at ``STEP_TOL`` (``test_torch_training.py``'s);
the PPO step metrics at rtol/atol 1e-4 (an SSM layer amplifies a rounding
~10x, see ``test_torch_ssm.py``), grads to 1e-4 of each leaf's max |grad|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import CopyTaskDataset as JCopy, DataBlender as JBlender
from repro.data import SortTaskDataset as JSort
from repro.models import reward as JR
from repro.models import transformer as JT
from repro.training import steps as jsteps
from repro.training.train_state import TrainState as JTrainState
from repro_torch.core import experience as TX
from repro_torch.core import ppo as tppo
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.training import steps as tsteps
from repro_torch.training.train_state import TrainState

from _torch_parity import (SSM_ARCHS, SSM_TRAIN_ARCHS, STEP_TOL,
                           assert_grads_close, assert_params_moved_alike,
                           reference_core, ssm_pair, state_pair)

LR = 1e-3


def _batch_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _batch_t(batch):
    return tlaunch.to_device(batch, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_apply_fn():
    return jax.jit(lambda s, g: s.apply_gradients(g, lr=LR))


# ------------------------------------------------------------------ #
# reward steps
# ------------------------------------------------------------------ #
def _reward_batch():
    ds = [JCopy(100, 20, 20, 256, seed=1), JSort(100, 20, 20, 256, seed=2)]
    batch = next(JBlender(ds, seed=0).reward_batches(2, 1))
    batch["chosen_mask"][1, 29:] = 0.0         # a ragged row: score at 28
    return batch


@functools.lru_cache(maxsize=None)
def _jax_reward_step(arch):
    jcfg, _ = ssm_pair(arch)
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(3))
    batch = _reward_batch()
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.reward_loss_fn(jcfg, p, b), has_aux=True))(
        jparams, _batch_j(batch))
    jstate2, jgn = _jax_apply_fn()(JTrainState.create(jparams), jg)
    return jparams, batch, float(jl), float(jmet["rm_acc"]), jg, \
        float(jgn), jstate2


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", SSM_TRAIN_ARCHS)
def test_reward_train_step_matches_reference(arch, use_kernels):
    """The reward model on an SSM or hybrid backbone (``end_scores`` at
    each row's last real token, one row ragged)."""
    jparams, batch, jl, jacc, jg, jgn, jstate2 = _jax_reward_step(arch)
    _, tcfg = ssm_pair(arch, use_kernels=use_kernels)
    _, tstate = state_pair(jparams)
    (tl, tmet), tg = tsteps.value_and_grad(
        lambda p: tsteps.reward_loss_fn(tcfg, p, _batch_t(batch)),
        tstate.params)
    np.testing.assert_allclose(float(tl), jl, **STEP_TOL)
    assert float(tmet["rm_acc"]) == jacc
    assert_grads_close(tg, jg)
    tstate2, tm = tsteps.reward_train_step(tcfg, tstate, _batch_t(batch), LR)
    np.testing.assert_allclose(float(tm["grad_norm"]), jgn, **STEP_TOL)
    assert_params_moved_alike(tstate2.params, jstate2.params, jg, LR)


# ------------------------------------------------------------------ #
# PPO steps
# ------------------------------------------------------------------ #
def _random_exp(rng, B=2, T=14, Lp=6, V=512):
    seqs = rng.integers(0, V, (B, T)).astype(np.int32)
    resp = np.zeros((B, T), bool)
    resp[:, Lp:] = True
    resp[1, Lp + 5:] = False            # an early stop
    mask = resp[:, 1:].astype(np.float32)
    f = lambda: rng.standard_normal((B, T - 1)).astype(np.float32)
    return dict(sequences=seqs, logprobs=-np.abs(f()) - 4.0,
                ref_logprobs=-np.abs(f()) - 4.0, values=f(), rewards=f(),
                advantages=f(), returns=f(), mask=mask)


def _t(x):
    t = torch.from_numpy(np.array(x, copy=True))
    return t if torch.is_floating_point(t) or t.dtype == torch.bool \
        else t.long()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_actor_and_critic_steps_match_reference(arch):
    """One actor step (with the mixture term) and one critic step on a
    fixed experience batch, the critic on the actor's config as the
    launcher builds it; the port's kernel path against the bodies of the
    reference's ``actor_step`` / ``critic_step``: its loss functions'
    values and grads, then ``apply_gradients``."""
    rc = reference_core()
    jcfg, tcfg = ssm_pair(arch, use_kernels=True)
    jcfg = jcfg.replace(use_pallas=False)     # the reference's jnp path
    ks = jax.random.split(jax.random.PRNGKey(8), 2)
    jactor, jcritic = JT.init_params(jcfg, ks[0]), JR.init_params(jcfg, ks[1])
    kw = dict(max_new_tokens=6, temperature=0.0, ptx_coef=0.05,
              lr_actor=1e-4, lr_critic=1e-4)
    jppo, tppo_cfg = rc.ppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    d = _random_exp(np.random.default_rng(8))
    jexp = rc.experience.Experience(**{k: jnp.asarray(v)
                                       for k, v in d.items()})
    texp = TX.Experience(**{k: _t(v) for k, v in d.items()})
    ptx = next(JBlender([JCopy(100, 6, 6, 256, seed=1)], seed=0)
               .pretrain_batches(2, 1))
    jptx = jax.tree.map(jnp.asarray, ptx)
    # the reference's actor_step / critic_step bodies: value_and_grad of
    # its loss functions, then apply_gradients (one compile of each model)
    (jal, jam), jag = jax.jit(jax.value_and_grad(
        lambda p, e, b: rc.ppo.actor_loss_fn(jcfg, jppo, p, e, b),
        has_aux=True))(jactor, jexp, jptx)
    (jcl, jcm), jcg = jax.jit(jax.value_and_grad(
        lambda p, e: rc.ppo.critic_loss_fn(jcfg, jppo, p, e),
        has_aux=True))(jcritic, jexp)
    apply = jax.jit(lambda s, g, lr: s.apply_gradients(g, lr=lr))
    ja, jagn = apply(JTrainState.create(jactor), jag, jppo.lr_actor)
    jc, jcgn = apply(JTrainState.create(jcritic), jcg, jppo.lr_critic)
    jam = dict(jam, actor_loss=jal, actor_gnorm=jagn)
    jcm = dict(jcm, critic_gnorm=jcgn)
    to_t = lambda tree: convert.params_from_numpy(
        jax.tree.map(np.asarray, tree), "cpu")
    ta, tam = tppo.actor_step(tcfg, tppo_cfg, TrainState.create(to_t(jactor)),
                              texp, {k: _t(v) for k, v in ptx.items()})
    tc, tcm = tppo.critic_step(tcfg, tppo_cfg,
                               TrainState.create(to_t(jcritic)), texp)
    for got, want in ((tam, jam), (tcm, jcm)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       err_msg=k, **STEP_TOL)
    assert_params_moved_alike(ta.params, ja.params, jag, jppo.lr_actor)
    assert_params_moved_alike(tc.params, jc.params, jcg, jppo.lr_critic)
