"""The port's stage-3 PPO (``repro_torch/core``) against the reference's
``repro/core/{experience,ema,ppo}.py`` (loaded by file path:
``_torch_parity.reference_core``) on the same weights (carried across
through numpy) and the same inputs (numpy, seeded), at the reduced
OPT-1.3B actor and smollm-135m critic configs in fp32.  The reference
runs its jnp path; the port runs its plain path and its kernel path (the
kernels' plain versions on the CPU).

Tolerances: ``kl_rewards``, ``gae``, the EMA, the losses, ``make_experience``
and the step metrics at rtol/atol 1e-5 (the same fp32 math summed in
another order); gradients to 1e-5 of each leaf's max |grad|; the params
after one actor / critic step to 1e-5 of each leaf's max |param| where
|grad| is well above the noise, and within one Adam step elsewhere (Adam's
first step is about ``lr * sign(g)``, and a gradient at the noise level
may flip sign between frameworks); greedy tokens identical.
"""
import dataclasses
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import CopyTaskDataset as JCopy, DataBlender as JBlender
from repro.data import SortTaskDataset as JSort
from repro.models import reward as JR
from repro.models import transformer as JT
from repro.training.train_state import TrainState as JTrainState
from repro_torch.core import ema as TEMA
from repro_torch.core import experience as TX
from repro_torch.core import ppo as tppo
from repro_torch.core.pipeline import (RLHFEngine, RLHFPipeline, StageConfig,
                                       clone_params)
from repro_torch.core.replay import AsyncConfig
from repro_torch.data import CopyTaskDataset, DataBlender
from repro_torch.models import convert
from repro_torch.models.modules import tree_map
from repro_torch.serving.engine import Request
from repro_torch.training.steps import value_and_grad
from repro_torch.training.train_state import TrainState

from _torch_parity import config_pair, jax_greedy, reference_core, to_np

TOL = dict(rtol=1e-5, atol=1e-5)
_JITTED = {}


def _jit(fn, *static):
    """``jax.jit(partial(fn, *static))``, compiled once per (fn, static
    args) for the whole module (the configs are hashable)."""
    key = (fn, *static)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(partial(fn, *static))
    return _JITTED[key]


def _actor_grads(cfg, ppo, params, exp, ptx):
    return jax.grad(lambda p, e, b: reference_core().ppo.actor_loss_fn(
        cfg, ppo, p, e, b)[0])(params, exp, ptx)


def _actor_value_and_grad(cfg, ppo, params, exp, ptx):
    return jax.value_and_grad(
        lambda p: reference_core().ppo.actor_loss_fn(cfg, ppo, p, exp, ptx),
        has_aux=True)(params)


def _critic_value_and_grad(cfg, ppo, params, exp):
    return jax.value_and_grad(
        lambda p: reference_core().ppo.critic_loss_fn(cfg, ppo, p, exp),
        has_aux=True)(params)


def _critic_grads(cfg, ppo, params, exp):
    return jax.grad(lambda p, e: reference_core().ppo.critic_loss_fn(
        cfg, ppo, p, e)[0])(params, exp)


@pytest.fixture(scope="module")
def ref():
    return reference_core()


def _t(x):
    t = torch.from_numpy(np.array(x, copy=True))
    return t if torch.is_floating_point(t) or t.dtype == torch.bool \
        else t.long()


def _pairs(got, want):
    out = []
    tree_map(lambda a, b: out.append((a, b)), got, want)
    assert len(out) == len(jax.tree.leaves(want))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tensors(jtree):
    return convert.params_from_numpy(_np(jtree), "cpu")


def _configs(use_kernels=False, **kw):
    """(actor jcfg, actor tcfg, critic jcfg, critic tcfg): the reference on
    its jnp path, the port on its plain or kernel path."""
    ajcfg, atcfg = config_pair("opt-1.3b", use_kernels=use_kernels, **kw)
    cjcfg, ctcfg = config_pair("smollm-135m", use_kernels=use_kernels, **kw)
    return (ajcfg.replace(use_pallas=False), atcfg,
            cjcfg.replace(use_pallas=False), ctcfg)


def _models(ajcfg, cjcfg, seed=0):
    """JAX actor, reference policy (other weights, so the KL is not 0),
    critic and reward params."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    return (JT.init_params(ajcfg, ks[0]), JT.init_params(ajcfg, ks[1]),
            JR.init_params(cjcfg, ks[2]), JR.init_params(cjcfg, ks[3]))


def _ppo_pair(ref, **kw):
    return ref.ppo.PPOConfig(**kw), tppo.PPOConfig(**kw)


def _random_exp(rng, B=3, T=14, Lp=6, V=512):
    seqs = rng.integers(0, V, (B, T)).astype(np.int32)
    resp = np.zeros((B, T), bool)
    resp[:, Lp:] = True
    resp[1, Lp + 5:] = False            # an early stop
    resp[2] = False                     # an empty response
    mask = resp[:, 1:].astype(np.float32)
    f = lambda: rng.standard_normal((B, T - 1)).astype(np.float32)
    return dict(sequences=seqs, logprobs=-np.abs(f()) - 4.0,
                ref_logprobs=-np.abs(f()) - 4.0, values=f(), rewards=f(),
                advantages=f(), returns=f(), mask=mask)


def _exp_pair(ref, d):
    jexp = ref.experience.Experience(**{k: jnp.asarray(v)
                                        for k, v in d.items()})
    texp = TX.Experience(**{k: _t(v) for k, v in d.items()})
    return jexp, texp


def _ptx_batch(V=512, B=3, half=6):
    ds = [JCopy(100, half, half, min(V, 256), seed=1),
          JSort(100, half, half, min(V, 256), seed=2)]
    return next(JBlender(ds, seed=0).pretrain_batches(B, 1))


def _assert_exp_close(texp, jexp):
    for name in jexp._fields:
        np.testing.assert_allclose(to_np(getattr(texp, name)),
                                   np.asarray(getattr(jexp, name)),
                                   err_msg=name, **TOL)


def _assert_grads_close(got, want, rel=1e-5):
    for a, b in _pairs(got, want):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-12)
        assert float(np.abs(to_np(a) - b).max()) <= rel * scale


def _assert_params_moved_alike(got, want, grads, lr, rel=1e-5):
    """New params to ``rel`` of each leaf's max |param| where |grad| is
    well above the noise; everywhere within one Adam step (``lr``)."""
    for (a, b), (_, g) in zip(_pairs(got, want), _pairs(got, grads)):
        a, b, g = to_np(a), np.asarray(b), np.abs(np.asarray(g))
        big = g > 1e-3 * max(float(g.max()), 1e-12)
        scale = max(float(np.abs(b).max()), 1e-12)
        assert float(np.abs(a[big] - b[big]).max(initial=0.0)) \
            <= rel * scale
        assert float(np.abs(a - b).max()) <= 2.5 * lr


# --------------------------------------------------------------------- #
# experience: KL-shaped rewards and GAE
# --------------------------------------------------------------------- #
def _masks(rng, B, T, case):
    m = np.zeros((B, T), np.float32)
    if case == "zeros":
        return m
    for b in range(B):
        start = int(rng.integers(0, T))
        n = int(rng.integers(0, T - start + 1))
        m[b, start:start + n] = 1.0
    m[0] = 0.0                                    # one all-zero row
    return m


@pytest.mark.parametrize("case", ["ragged", "zeros"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kl_rewards_matches_reference(ref, seed, case):
    rng = np.random.default_rng(seed)
    B, T = 4, 11
    lp, rlp = (rng.standard_normal((B, T)).astype(np.float32)
               for _ in range(2))
    mask = _masks(rng, B, T, case)
    score = (rng.standard_normal(B) * 6).astype(np.float32)   # some clip
    want = ref.experience.kl_rewards(*map(jnp.asarray, (lp, rlp, mask,
                                                         score)),
                                     kl_coef=0.1, clip_reward=5.0)
    got = TX.kl_rewards(*map(_t, (lp, rlp, mask, score)), kl_coef=0.1,
                        clip_reward=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["ragged", "zeros"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gae_matches_reference(ref, seed, case):
    rng = np.random.default_rng(10 + seed)
    B, T = 4, 13
    r, v = (rng.standard_normal((B, T)).astype(np.float32) for _ in range(2))
    mask = _masks(rng, B, T, case)
    ja, jr = ref.experience.gae(*map(jnp.asarray, (r, v, mask)), gamma=0.99,
                                lam=0.95)
    ta, tr = TX.gae(*map(_t, (r, v, mask)), gamma=0.99, lam=0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)


# --------------------------------------------------------------------- #
# EMA
# --------------------------------------------------------------------- #
def test_ema_matches_reference(ref):
    ajcfg, _, _, _ = _configs()
    p0, p1 = (JT.init_params(ajcfg, jax.random.PRNGKey(s)) for s in (0, 1))
    jema = ref.ema.update(ref.ema.init(p0), p1, 0.9)
    tema = TEMA.update(TEMA.init(_tensors(p0)), _tensors(p1), 0.9)
    for a, b in _pairs(tema, jema):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    like = _tensors(p0)
    out = TEMA.to_params(tema, like)
    for a, e in zip(jax.tree.leaves(_np(jema)), jax.tree.leaves(_np(out))):
        np.testing.assert_allclose(e, a, **TOL)
    assert all(o.data_ptr() != e.data_ptr() for o, e in zip(
        jax.tree.leaves(out), jax.tree.leaves(tema)))


def test_ema_does_not_alias_the_actor():
    """The actor's optimizer updates its params in place: the EMA shadow
    must not move with them (``Tensor.float()`` of fp32 would alias)."""
    params = {"w": torch.ones(3), "b": (torch.zeros(2),)}
    state = TrainState.create(params)
    ema = TEMA.init(state.params)
    state.apply_gradients({"w": torch.ones(3), "b": (torch.ones(2),)},
                          lr=0.1)
    assert torch.equal(ema["w"], torch.ones(3))
    assert torch.equal(ema["b"][0], torch.zeros(2))
    assert not torch.equal(state.params["w"], torch.ones(3))
    TEMA.update(ema, state.params, 0.5)          # in place on the shadow
    assert torch.allclose(ema["w"], 0.5 + 0.5 * state.params["w"])


# --------------------------------------------------------------------- #
# losses and their gradients
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("ptx", [False, True], ids=["pg", "pg+ptx"])
def test_actor_loss_and_grads_match_reference(ref, ptx, use_kernels):
    ajcfg, atcfg, _, _ = _configs(use_kernels)
    jparams = JT.init_params(ajcfg, jax.random.PRNGKey(4))
    jppo, tppo_cfg = _ppo_pair(ref, ptx_coef=0.05 if ptx else 0.0,
                               clip_eps=0.1)
    rng = np.random.default_rng(4)
    jexp, texp = _exp_pair(ref, _random_exp(rng))
    batch = _ptx_batch() if ptx else None
    (jl, jm), jg = _jit(_actor_value_and_grad, ajcfg, jppo)(
        jparams, jexp,
        None if batch is None else jax.tree.map(jnp.asarray, batch))
    (tl, tm), tg = value_and_grad(
        lambda p: tppo.actor_loss_fn(
            atcfg, tppo_cfg, p, texp,
            None if batch is None else {k: _t(v) for k, v in batch.items()}),
        _tensors(jparams))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    _assert_grads_close(tg, jg)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_critic_loss_and_grads_match_reference(ref, use_kernels):
    _, _, cjcfg, ctcfg = _configs(use_kernels)
    jparams = JR.init_params(cjcfg, jax.random.PRNGKey(5))
    jppo, tppo_cfg = _ppo_pair(ref, value_clip=0.05)
    jexp, texp = _exp_pair(ref, _random_exp(np.random.default_rng(5)))
    (jl, jm), jg = _jit(_critic_value_and_grad, cjcfg, jppo)(jparams,
                                                              jexp)
    (tl, tm), tg = value_and_grad(
        lambda p: tppo.critic_loss_fn(ctcfg, tppo_cfg, p, texp),
        _tensors(jparams))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    _assert_grads_close(tg, jg)


# --------------------------------------------------------------------- #
# scoring and one step
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("ragged", [False, True],
                         ids=["fixed", "attn_mask"])
def test_make_experience_matches_reference(ref, ragged, use_kernels):
    ajcfg, atcfg, cjcfg, ctcfg = _configs(use_kernels)
    jm = _models(ajcfg, cjcfg, seed=6)
    jppo, tppo_cfg = _ppo_pair(ref)
    d = _random_exp(np.random.default_rng(6))
    seqs, resp = d["sequences"], np.zeros(d["sequences"].shape, bool)
    resp[:, 1:] = d["mask"] > 0
    extra_j, extra_t = (), ()
    if ragged:
        attn = np.ones(seqs.shape, np.float32)
        attn[1, 11:] = 0.0                      # a padding tail
        attn[2, 6:] = 0.0                       # an empty response
        extra_j, extra_t = (jnp.asarray(attn),), (_t(attn),)
    jexp, jscore = _jit(ref.ppo.make_experience, ajcfg, cjcfg, jppo)(
        *jm, jnp.asarray(seqs), jnp.asarray(resp), *extra_j)
    texp, tscore = tppo.make_experience(atcfg, ctcfg, tppo_cfg,
                                        *map(_tensors, jm), _t(seqs),
                                        _t(resp), *extra_t)
    _assert_exp_close(texp, jexp)
    np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore), **TOL)
    assert not texp.logprobs.requires_grad


def test_staleness_guard_matches_reference(ref):
    ajcfg, atcfg, _, _ = _configs()
    jparams = JT.init_params(ajcfg, jax.random.PRNGKey(7))
    d = _random_exp(np.random.default_rng(7))
    args = (d["sequences"], d["logprobs"], d["mask"])
    want = ref.ppo.staleness_guard_stats(ajcfg, jparams,
                                         *map(jnp.asarray, args))
    got = tppo.staleness_guard_stats(atcfg, _tensors(jparams),
                                     *map(_t, args))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_actor_and_critic_step_match_reference(ref, use_kernels):
    ajcfg, atcfg, cjcfg, ctcfg = _configs(use_kernels)
    jactor, _, jcritic, _ = _models(ajcfg, cjcfg, seed=8)
    jppo, tppo_cfg = _ppo_pair(ref, max_new_tokens=6, temperature=0.0,
                               ptx_coef=0.05, lr_actor=1e-4, lr_critic=1e-4,
                               ema_decay=0.9)
    jexp, texp = _exp_pair(ref, _random_exp(np.random.default_rng(8)))
    batch = _ptx_batch()
    jptx = jax.tree.map(jnp.asarray, batch)
    tptx = {k: _t(v) for k, v in batch.items()}
    jag = _jit(_actor_grads, ajcfg, jppo)(jactor, jexp, jptx)
    jcg = _jit(_critic_grads, cjcfg, jppo)(jcritic, jexp)
    ja, jam = _jit(ref.ppo.actor_step, ajcfg, jppo)(
        JTrainState.create(jactor), jexp, jptx)
    jc, jcm = _jit(ref.ppo.critic_step, cjcfg, jppo)(
        JTrainState.create(jcritic), jexp)
    ta, tam = tppo.actor_step(atcfg, tppo_cfg,
                              TrainState.create(_tensors(jactor)), texp,
                              tptx)
    tc, tcm = tppo.critic_step(ctcfg, tppo_cfg,
                               TrainState.create(_tensors(jcritic)), texp)
    for got, want in ((tam, jam), (tcm, jcm)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       err_msg=k, **TOL)
    assert int(ta.step) == int(ja.step) == 1
    _assert_params_moved_alike(ta.params, ja.params, jag, jppo.lr_actor)
    _assert_params_moved_alike(tc.params, jc.params, jcg, jppo.lr_critic)


# --------------------------------------------------------------------- #
# the trainer: one whole greedy iteration
# --------------------------------------------------------------------- #
def _greedy_rollout(jcfg, jactor, prompts, budgets):
    """The reference's generation for each prompt: its own greedy decode
    (``jax_greedy``) at its budget."""
    return [np.asarray(jax_greedy(jcfg, jactor, p, n), np.int32)
            for p, n in zip(prompts, budgets)]


def _reference_iteration(ref, cfgs, jm, jppo, seqs, resp, attn=None,
                         ptx=None):
    ajcfg, cjcfg = cfgs
    jactor, jrefp, jcritic, jreward = jm
    extra = () if attn is None else (jnp.asarray(attn),)
    jexp, score = _jit(ref.ppo.make_experience, ajcfg, cjcfg, jppo)(
        jactor, jrefp, jcritic, jreward, jnp.asarray(seqs),
        jnp.asarray(resp), *extra)
    ptx_j = None if ptx is None else jax.tree.map(jnp.asarray, ptx)
    jag = _jit(_actor_grads, ajcfg, jppo)(jactor, jexp, ptx_j)
    ja, jam = _jit(ref.ppo.actor_step, ajcfg, jppo)(
        JTrainState.create(jactor), jexp, ptx_j)
    jc, jcm = _jit(ref.ppo.critic_step, cjcfg, jppo)(
        JTrainState.create(jcritic), jexp)
    jema = ref.ema.update(ref.ema.init(jactor), ja.params, jppo.ema_decay)
    return jexp, score, ja, jam, jc, jcm, jema, jag


def _trainer(atcfg, ctcfg, tppo_cfg, jm):
    jactor, jrefp, jcritic, jreward = jm
    return tppo.PPOTrainer(actor_cfg=atcfg, critic_cfg=ctcfg,
                           actor_params=_tensors(jactor),
                           critic_params=_tensors(jcritic),
                           ref_params=_tensors(jrefp),
                           reward_params=_tensors(jreward), ppo=tppo_cfg)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16kv", "int8kv"])
def test_greedy_ppo_iteration_matches_reference(ref, kv_quant):
    """Generate (greedy, so the random streams do not matter), score,
    train the actor (with the mixture term) and the critic, update the
    EMA: the port's trainer against the reference's own functions."""
    ajcfg, atcfg, cjcfg, ctcfg = _configs(use_kernels=True)
    jm = _models(ajcfg, cjcfg, seed=9)
    kw = dict(max_new_tokens=6, temperature=0.0, ptx_coef=0.05,
              lr_actor=1e-4, lr_critic=1e-4, ema_decay=0.9)
    # the reference reads kv_quant only where it builds its generation
    # engine (replaced here by ``jax_greedy`` on an int8 cache config)
    jppo = ref.ppo.PPOConfig(**kw)
    tppo_cfg = tppo.PPOConfig(kv_quant=kv_quant, **kw)
    prompts = np.random.default_rng(9).integers(0, 512, (3, 6)).astype(
        np.int32)
    ptx = _ptx_batch()
    trainer = _trainer(atcfg, ctcfg, tppo_cfg, jm)
    texp, gm = trainer.generate_experience(
        prompts, torch.Generator().manual_seed(0))
    tm = trainer.train_rlhf(texp, {k: _t(v) for k, v in ptx.items()})

    gen = _greedy_rollout(ajcfg.replace(kv_quant=kv_quant), jm[0], prompts,
                          [6] * 3)
    seqs = np.concatenate([prompts, np.stack(gen)], axis=1)
    resp = np.zeros(seqs.shape, bool)
    resp[:, 6:] = True
    jexp, score, ja, jam, jc, jcm, jema, jag = _reference_iteration(
        ref, (ajcfg, cjcfg), jm, jppo, seqs, resp, ptx=ptx)

    np.testing.assert_array_equal(texp.sequences.numpy(), seqs)
    _assert_exp_close(texp, jexp)
    np.testing.assert_allclose(gm["reward_score"], float(score.mean()),
                               **TOL)
    assert gm["decode_steps"] == 6 and gm["gen_len"] == 6.0
    for k, v in {**jam, **jcm}.items():
        np.testing.assert_allclose(tm[k], float(v), err_msg=k, **TOL)
    assert tm["ratio_mean"] == pytest.approx(1.0, abs=1e-6)
    _assert_params_moved_alike(trainer.actor.params, ja.params, jag,
                               jppo.lr_actor)
    for a, b in _pairs(trainer.ema, jema):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # the frozen models did not move
    for a, b in _pairs(trainer.ref_params, jm[1]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in _pairs(trainer.reward_params, jm[3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_request_path_matches_reference(ref):
    """Ragged requests through the engine core: scored at each row's true
    length, against the reference's scoring of its own greedy tokens."""
    _check_request_path(ref)


@pytest.mark.parametrize("what", ["paged", "prefix_cache"])
def test_request_path_on_the_paged_pool_matches_reference(ref, what):
    """The paged generation engine (refused before the paged layout was
    ported) and its prefix cache: the request path's experience equals the
    reference's scoring of its own greedy tokens, and the iteration reports
    the prefill hit rate."""
    gm = _check_request_path(ref, kv_layout="paged", kv_block_size=4,
                             prefix_cache=what == "prefix_cache")
    assert gm["prefill_hit_rate"] == 0.0      # three distinct prompts


def _check_request_path(ref, **paged):
    ajcfg, atcfg, cjcfg, ctcfg = _configs()
    jm = _models(ajcfg, cjcfg, seed=10)
    jppo, tppo_cfg = _ppo_pair(ref, max_new_tokens=5, temperature=0.0)
    tppo_cfg = dataclasses.replace(tppo_cfg, **paged)
    rng = np.random.default_rng(10)
    lens, budgets = [4, 9, 6], [5, 3, 4]
    reqs = [Request(uid=i, tokens=rng.integers(0, 512, lp).astype(np.int32),
                    max_new_tokens=mn)
            for i, (lp, mn) in enumerate(zip(lens, budgets))]
    trainer = _trainer(atcfg, ctcfg, tppo_cfg, jm)
    texp, gm = trainer.generate_experience(reqs,
                                           torch.Generator().manual_seed(0))
    gen = _greedy_rollout(ajcfg, jm[0], [r.tokens for r in reqs], budgets)
    W = max(lp + mn for lp, mn in zip(lens, budgets))
    seqs = np.zeros((3, W), np.int32)
    resp = np.zeros((3, W), bool)
    attn = np.zeros((3, W), np.float32)
    for i, (r, g) in enumerate(zip(reqs, gen)):
        lp = len(r.tokens)
        seqs[i, :lp], seqs[i, lp:lp + len(g)] = r.tokens, g
        resp[i, lp:lp + len(g)] = True
        attn[i, :lp + len(g)] = 1.0
    jexp, score = _jit(ref.ppo.make_experience, ajcfg, cjcfg, jppo)(
        *jm, jnp.asarray(seqs), jnp.asarray(resp), jnp.asarray(attn))
    np.testing.assert_array_equal(texp.sequences.numpy(), seqs)
    _assert_exp_close(texp, jexp)
    np.testing.assert_allclose(gm["reward_score"], float(score.mean()),
                               **TOL)
    assert gm["gen_len"] == pytest.approx(np.mean(budgets))
    return gm


def test_n_samples_per_prompt():
    """Best-of-n: fixed-shape prompts are row-tiled (greedy copies agree),
    requests are expanded under fresh uids with per-copy seeds."""
    _, atcfg, _, ctcfg = _configs()
    ajcfg, _, cjcfg, _ = _configs()
    jm = _models(ajcfg, cjcfg, seed=11)
    cfg = tppo.PPOConfig(max_new_tokens=4, temperature=0.0,
                         n_samples_per_prompt=2)
    trainer = _trainer(atcfg, ctcfg, cfg, jm)
    prompts = np.random.default_rng(11).integers(0, 512, (2, 5))
    exp, _ = trainer.generate_experience(prompts,
                                         torch.Generator().manual_seed(0))
    seqs = exp.sequences.numpy()
    assert seqs.shape == (4, 9)
    np.testing.assert_array_equal(seqs[0], seqs[1])
    np.testing.assert_array_equal(seqs[2], seqs[3])
    np.testing.assert_array_equal(seqs[::2, :5], prompts)
    from repro_torch.serving.engine import SamplingParams
    reqs = [Request(uid=7, tokens=prompts[0].astype(np.int32),
                    params=SamplingParams(seed=3)),
            Request(uid=8, tokens=prompts[1, :3].astype(np.int32))]
    out = trainer._expand_samples(reqs)
    assert [r.uid for r in out] == [0, 1, 2, 3]
    assert [r.params.seed for r in out] == [3, 4, None, None]
    exp, gm = trainer.generate_experience(reqs,
                                          torch.Generator().manual_seed(0))
    seqs = exp.sequences.numpy()
    assert seqs.shape == (4, 9)
    np.testing.assert_array_equal(seqs[0], seqs[1])
    np.testing.assert_array_equal(seqs[2, :7], seqs[3, :7])
    assert gm["gen_len"] == 4.0


def test_state_tree_round_trip():
    ajcfg, atcfg, cjcfg, ctcfg = _configs()
    jm = _models(ajcfg, cjcfg, seed=12)
    trainer = _trainer(atcfg, ctcfg, tppo.PPOConfig(), jm)
    tree = trainer.state_tree()
    assert set(tree) == {"actor", "critic", "ema"}
    assert trainer.state_shardings() is None
    other = _trainer(atcfg, ctcfg, tppo.PPOConfig(), jm)
    other.load_state_tree(tree)
    assert other.actor is trainer.actor and other.ema is trainer.ema
    ema = trainer.ema_params()
    for a, b in zip(jax.tree.leaves(ema), jax.tree.leaves(trainer.ema)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


# --------------------------------------------------------------------- #
# refusals
# --------------------------------------------------------------------- #
class _TPMesh:
    """A mesh shape with a model axis of 3, which does not divide a Mamba2
    mixer of 2 groups."""
    shape = {"data": 1, "model": 3}
    axis_names = ("data", "model")


@pytest.mark.parametrize("what", ["engine", "rollout_mesh"])
def test_trainer_refuses_what_is_not_ported(what):
    """An engine whose mesh's model axis does not divide an actor's Mamba2
    groups is not yet ported; a rollout mesh (disaggregated generation)
    without the training mesh's engine is refused (the split itself:
    ``tests/test_torch_disaggregated.py``).  Both checks come before the
    params are read."""
    ajcfg, atcfg, cjcfg, ctcfg = _configs()
    jm = _models(ajcfg, cjcfg, seed=13)
    arg = (types.SimpleNamespace(mesh=_TPMesh()) if what == "engine"
           else object())
    if what == "engine":
        atcfg = config_pair("mamba2-370m")[1].replace(ssm_ngroups=2)
    kw, cfg = {what: arg}, tppo.PPOConfig()
    err, match = ((NotImplementedError, "not yet ported") if what == "engine"
                  else (ValueError, "needs engine="))
    with pytest.raises(err, match=match):
        tppo.PPOTrainer(actor_cfg=atcfg, critic_cfg=ctcfg,
                        actor_params=_tensors(jm[0]),
                        critic_params=_tensors(jm[2]),
                        ref_params=_tensors(jm[1]),
                        reward_params=_tensors(jm[3]), ppo=cfg, **kw)


@pytest.mark.parametrize("frozen", ["ref", "reward"])
def test_trainer_refuses_aliased_frozen_models(frozen):
    """In-place updates would move a frozen model that shares storage
    with the model being trained; a clone is accepted."""
    ajcfg, atcfg, cjcfg, ctcfg = _configs()
    actor, refp, critic, reward = map(_tensors,
                                      _models(ajcfg, cjcfg, seed=14))
    if frozen == "ref":
        refp = actor
    else:
        reward = critic
    make = lambda r, w: tppo.PPOTrainer(
        actor_cfg=atcfg, critic_cfg=ctcfg, actor_params=actor,
        critic_params=critic, ref_params=r, reward_params=w,
        ppo=tppo.PPOConfig())
    with pytest.raises(ValueError, match="share storage"):
        make(refp, reward)
    make(clone_params(refp), clone_params(reward))


def test_pipeline_refuses_what_is_not_ported():
    _, atcfg, _, ctcfg = _configs()
    gen = torch.Generator().manual_seed(0)
    # a rollout mesh goes with the training mesh (the disaggregated split,
    # tests/test_torch_disaggregated.py)
    with pytest.raises(ValueError, match="needs mesh=, the training mesh"):
        RLHFEngine(atcfg, ctcfg, gen, rollout_mesh=object())
    eng = RLHFEngine(atcfg, ctcfg, gen)
    bl = DataBlender([CopyTaskDataset(50, 4, 4, 64, seed=1)])
    # asynchronous stage 3 runs on one device and at 1 x 1; on a mesh of
    # more than one rank it is refused (a stand-in engine whose Hybrid
    # Engine spans 2 ranks: the check reads the mesh's shape only)
    RLHFPipeline(eng, bl, StageConfig(), tppo.PPOConfig(),
                 async_cfg=AsyncConfig.lockstep())
    two = types.SimpleNamespace(hybrid=types.SimpleNamespace(
        mesh=types.SimpleNamespace(shape={"data": 2, "model": 1})))
    with pytest.raises(NotImplementedError,
                       match="not yet ported; run it disaggregated"):
        RLHFPipeline(two, bl, StageConfig(), tppo.PPOConfig(),
                     async_cfg=AsyncConfig.lockstep())
