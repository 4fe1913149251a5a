"""The port's prefix cache (prefix-aware block reuse on the paged pool) on
the CPU, with the contracts of the reference's ``tests/test_prefix_cache.py``
(which cannot run here, ROADMAP R1):

- cache on/off token identity, greedy (and equal to the reference's greedy
  decode on the same weights) and seeded, under preemption (with eviction
  running underneath) and under mid-flight cancellation;
- harvest-then-match across turns on one core, eviction before preemption,
  shared blocks outliving their first sharer;
- the int8 pool: the suffix attends the dequantized history, with the
  streams of the cache-off run on this suite;
- PPO best-of-n on the paged int8 pool: the copies of a prompt reuse its
  prefill (``prefill_hit_rate > 0``) and the experience equals the run
  with the cache off.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ppo import PPOConfig, PPOTrainer
from repro_torch.core.pipeline import clone_params
from repro_torch.models import reward as TR
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import (GenerationEngine, Request,
                                        SamplingParams)

from _torch_parity import config_pair, jax_greedy, params_pair


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = config_pair("smollm-135m", use_kernels=True)
    jparams, tparams = params_pair(jcfg, seed=31)
    return jcfg, tcfg, jparams, tparams


def _engine(cfg, prefix_cache, **kw):
    kw.setdefault("max_new_tokens", 8)
    kw.setdefault("temperature", 0.0)
    kw.setdefault("chunk", 4)
    return GenerationEngine(cfg, kv_layout="paged", block_size=4,
                            prefix_cache=prefix_cache, device="cpu", **kw)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _shared_prefix_requests(V, n=6, prefix_len=13, seed=7, max_new=8):
    """Chat traffic with a shared system prompt: one long common prefix,
    short distinct tails."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, V, size=prefix_len).astype(np.int32)
    return [Request(uid=i, tokens=np.concatenate(
        [sys_prompt, rng.integers(0, V, size=int(rng.integers(2, 6)))
         .astype(np.int32)]), max_new_tokens=max_new) for i in range(n)]


def _distinct_requests(V, lengths, budgets, seed=11):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(0, V, size=lp)
                    .astype(np.int32), max_new_tokens=mn)
            for i, (lp, mn) in enumerate(zip(lengths, budgets))]


def _serve(eng, params, reqs, seed, **kw):
    outs = {c.uid: c for c in eng.serve(params, reqs, _gen(seed), **kw)}
    assert sorted(outs) == list(range(len(reqs)))
    return outs


def _drain(core):
    events = []
    while core.has_work():
        events.extend(core.step())
    return events


def test_cache_on_off_identity_greedy_and_vs_reference(model):
    """Shared-prefix greedy streams are identical with the cache on and
    off, the cache hits, and both equal the reference's greedy decode."""
    jcfg, tcfg, jparams, tparams = model
    reqs = _shared_prefix_requests(tcfg.vocab_size)
    kw = dict(slots=3, max_seq_len=32)
    off_eng, on_eng = _engine(tcfg, False), _engine(tcfg, True)
    off = _serve(off_eng, tparams, reqs, 3, **kw)
    on = _serve(on_eng, tparams, reqs, 3, **kw)
    for uid in off:
        assert off[uid].tokens.tolist() == on[uid].tokens.tolist()
        assert off[uid].finish_reason == on[uid].finish_reason
    st_on, st_off = on_eng.last_stats, off_eng.last_stats
    assert st_on["prefill_hit_rate"] > 0
    assert st_off["cached_prefill_tokens"] == 0
    assert (st_on["computed_prefill_tokens"]
            < st_off["computed_prefill_tokens"])
    for uid in (0, 4):
        r = reqs[uid]
        assert on[uid].tokens.tolist() == jax_greedy(
            jcfg, jparams, r.tokens, r.max_new_tokens)


def test_cache_on_off_identity_seeded_sampling(model):
    """Same admission order, same draws: identical streams whether a
    prompt prefilled fully or from the cache (shared-generator and seeded
    requests mixed)."""
    _, tcfg, _, tparams = model
    V = tcfg.vocab_size
    reqs = [Request(uid=r.uid, tokens=r.tokens,
                    max_new_tokens=r.max_new_tokens,
                    params=SamplingParams(seed=100 + r.uid)
                    if r.uid % 2 else SamplingParams())
            for r in _shared_prefix_requests(V, n=5)]
    mk = lambda pc: _engine(tcfg, pc, temperature=1.0, top_k=8,
                            eos_id=V - 1)
    off = _serve(mk(False), tparams, reqs, 5, slots=2, max_seq_len=32)
    on_eng = mk(True)
    on = _serve(on_eng, tparams, reqs, 5, slots=2, max_seq_len=32)
    assert on_eng.last_stats["prefill_hit_rate"] > 0
    for uid in off:
        assert off[uid].tokens.tolist() == on[uid].tokens.tolist()
        assert off[uid].finish_reason == on[uid].finish_reason


def test_cache_on_off_identity_under_preemption(model):
    """A pool sized for about one request preempts; with distinct prompts
    the cache is transparent (same streams, same preemptions) while its
    harvest and eviction paths run underneath."""
    jcfg, tcfg, jparams, tparams = model
    reqs = _distinct_requests(tcfg.vocab_size, [3, 9, 4, 7, 5, 6],
                              [5, 6, 7, 3, 6, 4])
    kw = dict(slots=3, max_seq_len=20, num_blocks=6, watermark=0)
    off_eng, on_eng = _engine(tcfg, False, chunk=2), _engine(tcfg, True,
                                                             chunk=2)
    off = _serve(off_eng, tparams, reqs, 5, **kw)
    on = _serve(on_eng, tparams, reqs, 5, **kw)
    st_on, st_off = on_eng.last_stats, off_eng.last_stats
    assert st_off["preemptions"] > 0
    assert st_on["preemptions"] == st_off["preemptions"]
    assert st_on["cache_evictions"] > 0
    for uid in off:
        assert off[uid].tokens.tolist() == on[uid].tokens.tolist()
    r = reqs[1]
    assert on[1].tokens.tolist() == jax_greedy(jcfg, jparams, r.tokens,
                                               r.max_new_tokens)


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_cache_identity_under_cancellation(model, prefix_cache):
    """A mid-flight cancel: the cancelled stream is a prefix of the solo
    run, its blocks are reclaimed (no reference left), and the queued
    requests complete with their own greedy streams."""
    _, tcfg, _, tparams = model
    reqs = _shared_prefix_requests(tcfg.vocab_size, n=3, max_new=12)
    solo = {c.uid: c.tokens.tolist() for c in _engine(
        tcfg, False, max_new_tokens=12).serve(tparams, reqs, _gen(0),
                                              slots=1, max_seq_len=32)}
    eng = _engine(tcfg, prefix_cache, max_new_tokens=12)
    core = eng.core(tparams, _gen(0), slots=1, max_seq_len=32)
    for r in reqs:
        core.add_request(r)
    got = core.step()                          # uid 0 admitted, one chunk
    assert [ev.uid for ev in got] == [0] and not got[0].finished
    partial = got[0].new_tokens.tolist()
    assert core.cancel(0)
    events = _drain(core)
    assert [ev.uid for ev in events
            if ev.finish_reason == "cancelled"] == [0]
    assert {ev.uid for ev in events if ev.finished} == {0, 1, 2}
    assert partial == solo[0][:len(partial)]
    for uid in (1, 2):
        assert np.concatenate([ev.new_tokens for ev in events
                               if ev.uid == uid]).tolist() == solo[uid]
    alloc = core.backend.alloc
    assert alloc.num_live == 0
    assert alloc.num_free + alloc.num_cached == alloc.capacity
    if prefix_cache:
        assert alloc.num_cached > 0            # harvested, not freed


def test_harvest_then_match_multi_turn(model):
    """Turn 2's prompt extends turn 1's whole stream, on one core: its
    prefill is served mostly from turn 1's harvested blocks, and its
    tokens equal the reference's greedy decode (harvested KV intact)."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(2)
    eng = _engine(tcfg, True, max_new_tokens=6)
    core = eng.core(tparams, _gen(0), slots=2, max_seq_len=48)
    t1 = rng.integers(0, tcfg.vocab_size, size=11).astype(np.int32)
    core.add_request(Request(uid=0, tokens=t1))
    gen1 = np.concatenate([ev.new_tokens for ev in _drain(core)
                           if ev.uid == 0]).astype(np.int32)
    turn2 = np.concatenate([t1, gen1, rng.integers(
        0, tcfg.vocab_size, size=5).astype(np.int32)])
    before = core.backend.cached_prefill_tokens
    core.add_request(Request(uid=1, tokens=turn2))
    gen2 = np.concatenate([ev.new_tokens for ev in _drain(core)
                           if ev.uid == 1])
    hit = core.backend.cached_prefill_tokens - before
    bs = eng.block_size
    assert hit > 0
    assert hit >= (len(t1) + len(gen1)) // bs * bs - bs
    assert gen2.tolist() == jax_greedy(jcfg, jparams, turn2, 6)


def test_eviction_before_preemption_sequential(model):
    """One slot over many distinct prompts on a small pool: the cache
    fills with harvested blocks, later admissions evict them, and nothing
    is ever preempted; streams are the cache-off ones."""
    _, tcfg, _, tparams = model
    reqs = _distinct_requests(tcfg.vocab_size, [6, 7, 5, 8, 6, 7], [4] * 6)
    kw = dict(slots=1, max_seq_len=16, num_blocks=9)
    eng = _engine(tcfg, True)
    on = _serve(eng, tparams, reqs, 1, **kw)
    off = _serve(_engine(tcfg, False), tparams, reqs, 1, **kw)
    assert eng.last_stats["preemptions"] == 0
    assert eng.last_stats["cache_evictions"] > 0
    for uid in off:
        assert on[uid].tokens.tolist() == off[uid].tokens.tolist()


def test_shared_blocks_survive_first_finisher(model):
    """When the first sharer finishes, the blocks it shares stay live for
    the others (refcount, not ownership)."""
    _, tcfg, _, tparams = model
    reqs = [Request(uid=r.uid, tokens=r.tokens,
                    max_new_tokens=3 if r.uid == 0 else 10)
            for r in _shared_prefix_requests(tcfg.vocab_size, n=3,
                                             prefix_len=12)]
    eng = _engine(tcfg, True, max_new_tokens=10, chunk=2)
    on = _serve(eng, tparams, reqs, 0, slots=3, max_seq_len=32)
    off = _serve(_engine(tcfg, False, max_new_tokens=10, chunk=2), tparams,
                 reqs, 0, slots=3, max_seq_len=32)
    assert eng.last_stats["prefill_hit_rate"] > 0
    for uid in off:
        assert on[uid].tokens.tolist() == off[uid].tokens.tolist()


def test_prefix_cache_rejects_dense_layout(model):
    _, tcfg, _, _ = model
    with pytest.raises(ValueError):
        GenerationEngine(tcfg, max_new_tokens=4, prefix_cache=True,
                         device="cpu")


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_int8_prefix_cache_on_off(model, use_kernels):
    """Over an int8 pool the suffix attends the dequantized history (a
    cold prefill attends the original keys), so the two runs agree within
    the quantization budget: here, identical greedy streams; the scale
    planes travel with the shared blocks (hit rate > 0.3)."""
    _, tcfg, _, tparams = model
    qcfg = tcfg.replace(kv_quant=True, use_kernels=use_kernels)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, qcfg.vocab_size, size=8).astype(np.int32)
    reqs = [Request(uid=i, tokens=np.concatenate(
        [shared, rng.integers(0, qcfg.vocab_size, size=4)]).astype(np.int32),
        max_new_tokens=6) for i in range(5)]
    e_on = _engine(qcfg, True)
    on = _serve(e_on, tparams, reqs, 2, slots=2, max_seq_len=24)
    off = _serve(_engine(qcfg, False), tparams, reqs, 2, slots=2,
                 max_seq_len=24)
    assert e_on.last_stats["prefill_hit_rate"] > 0.3
    for uid in off:
        assert on[uid].tokens.tolist() == off[uid].tokens.tolist()


def test_ppo_best_of_n_on_the_paged_int8_pool_reuses_prompt_prefill():
    """PPO's best-of-n recipe on the request path (paged int8 pool, the
    prefix cache on, n = 3): the later copies of each prompt prefill only
    its last chunk, the experience equals the cache-off run's, and the
    iteration trains to finite metrics."""
    _, cfg = config_pair("smollm-135m", use_kernels=True)
    gen = torch.Generator().manual_seed(4)
    actor = TT.init_params(cfg, gen)
    critic = TR.init_params(cfg, gen)
    rng = np.random.default_rng(4)
    reqs = [Request(uid=0, tokens=rng.integers(0, cfg.vocab_size, size=9)
                    .astype(np.int32), max_new_tokens=5,
                    params=SamplingParams(temperature=0.0)),
            Request(uid=1, tokens=rng.integers(0, cfg.vocab_size, size=13)
                    .astype(np.int32), max_new_tokens=5,
                    params=SamplingParams(seed=21))]
    runs = {}
    for pc in (False, True):
        trainer = PPOTrainer(
            actor_cfg=cfg, critic_cfg=cfg, actor_params=clone_params(actor),
            critic_params=clone_params(critic),
            ref_params=clone_params(actor),
            reward_params=clone_params(critic),
            ppo=PPOConfig(max_new_tokens=5, eos_id=3, use_ema=False,
                          decode_chunk=4, n_samples_per_prompt=3,
                          kv_layout="paged", kv_block_size=4,
                          kv_quant=True, prefix_cache=pc))
        runs[pc] = (trainer,) + trainer.generate_experience(
            reqs, torch.Generator().manual_seed(8))
    (_, exp_off, gm_off), (trainer, exp, gm) = runs[False], runs[True]
    assert exp.sequences.shape[0] == 6             # 2 prompts x 3 samples
    assert gm["prefill_hit_rate"] > 0 and gm_off["prefill_hit_rate"] == 0
    seqs = exp.sequences.numpy()
    np.testing.assert_array_equal(seqs[0], seqs[1])   # greedy copies
    np.testing.assert_array_equal(seqs[1], seqs[2])
    assert not ((seqs[3] == seqs[4]).all() and (seqs[4] == seqs[5]).all())
    for name in ("sequences", "mask", "logprobs", "ref_logprobs", "values",
                 "rewards", "advantages", "returns"):
        assert torch.equal(getattr(exp, name), getattr(exp_off, name)), name
    m = trainer.train_rlhf(exp)
    assert all(np.isfinite(v) for v in m.values())
