"""The port's serving stack on the CPU: greedy ``GenerationEngine.generate``
and ``EngineCore`` continuous batching are token-identical to a greedy JAX
reference built from ``repro.models.transformer`` on the same weights;
slot refill, early exit and per-request budgets behave as in
``tests/test_engine*.py``; the sampler's filtered logits equal the
reference's, and its draws follow the filtered softmax."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.serving.engine import (GenerationEngine, Request,
                                        SamplingParams, StepEvent)
from repro_torch.serving.sampling import filter_rows, sample, sample_rows

from _torch_parity import config_pair, jax_greedy, params_pair

_REF_SAMPLING = (Path(__file__).resolve().parents[1]
                 / "src" / "repro" / "serving" / "sampling.py")


def _reference_sampling():
    """The reference's sampling module, loaded by path (its package does
    not import on Python 3.12)."""
    spec = importlib.util.spec_from_file_location("_ref_sampling",
                                                  _REF_SAMPLING)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = config_pair("smollm-135m", use_kernels=True)
    jparams, tparams = params_pair(jcfg, seed=21)
    return jcfg, tcfg, jparams, tparams


def _requests(vocab, lengths, budgets, seed=7):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(0, vocab, size=lp)
                    .astype(np.int32), max_new_tokens=mn)
            for i, (lp, mn) in enumerate(zip(lengths, budgets))]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------ #
# fixed-batch path
# ------------------------------------------------------------------ #
def test_generate_greedy_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (3, 6))
    eng = GenerationEngine(tcfg, max_new_tokens=8, temperature=0.0,
                           device="cpu")
    out = eng.generate(tparams, prompts, _gen())
    seqs = out["sequences"].numpy()
    np.testing.assert_array_equal(seqs[:, :6], prompts)
    for b in range(3):
        assert seqs[b, 6:].tolist() == jax_greedy(jcfg, jparams, prompts[b],
                                                  8)
    assert out["response_mask"][:, 6:].all()
    assert not out["response_mask"][:, :6].any()


def test_generate_early_exit(model):
    """All rows share a prompt, so greedy decode finishes them together:
    decode stops early and the sequences still equal the full reference
    (forced EOS padding, mask False after the EOS)."""
    jcfg, tcfg, jparams, tparams = model
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size, 6)
    probe = jax_greedy(jcfg, jparams, prompt, 16)
    eos = probe[2]
    want = jax_greedy(jcfg, jparams, prompt, 16, eos_id=eos)
    eng = GenerationEngine(tcfg, max_new_tokens=16, temperature=0.0,
                           eos_id=eos, chunk=4, device="cpu")
    out = eng.generate(tparams, np.tile(prompt, (4, 1)), _gen())
    assert eng.last_stats["decode_steps"] < 16
    for row, mask in zip(out["sequences"].numpy(),
                         out["response_mask"].numpy()):
        assert row[6:].tolist() == want
        n = int(mask[6:].sum())
        assert row[6 + n - 1] == eos and not mask[6 + n:].any()


# ------------------------------------------------------------------ #
# continuous batching
# ------------------------------------------------------------------ #
def test_core_greedy_matches_jax_per_request(model):
    """Slot packing, bucketed ragged prefill into the arena rows in place,
    and refills leak nothing between sequences."""
    jcfg, tcfg, jparams, tparams = model
    reqs = _requests(jcfg.vocab_size, [3, 7, 5, 4, 6, 3], [5, 8, 4, 6, 3, 7])
    eng = GenerationEngine(tcfg, max_new_tokens=8, temperature=0.0, chunk=4,
                           device="cpu")
    outs = eng.serve(tparams, reqs, _gen(9), slots=3)
    assert sorted(c.uid for c in outs) == list(range(6))
    for c in outs:
        r = reqs[c.uid]
        assert c.finish_reason == "length"
        assert c.tokens.tolist() == jax_greedy(jcfg, jparams, r.tokens,
                                               r.max_new_tokens)


def test_core_eos_stops_per_slot(model):
    jcfg, tcfg, jparams, tparams = model
    reqs = _requests(jcfg.vocab_size, [4, 6, 5], [12, 12, 12])
    eos = jax_greedy(jcfg, jparams, reqs[0].tokens, 12)[1]
    eng = GenerationEngine(tcfg, max_new_tokens=12, temperature=0.0,
                           eos_id=eos, chunk=4, device="cpu")
    outs = {c.uid: c for c in eng.serve(tparams, reqs, _gen(), slots=2)}
    for uid, c in outs.items():
        want = jax_greedy(jcfg, jparams, reqs[uid].tokens, 12, eos_id=eos)
        n = want.index(eos) + 1 if eos in want else 12
        assert c.tokens.tolist() == want[:n]
    assert outs[0].finish_reason == "eos" and outs[0].tokens[-1] == eos


def test_slot_refill_bookkeeping(model):
    """More requests than slots: every request completes exactly once,
    with its own budget, and the counters add up."""
    _, tcfg, _, tparams = model
    lengths = [3, 9, 4, 7, 5, 6, 8, 3, 4]
    budgets = [2, 5, 7, 3, 6, 4, 2, 5, 3]
    reqs = _requests(tcfg.vocab_size, lengths, budgets)
    eng = GenerationEngine(tcfg, max_new_tokens=8, temperature=0.0, chunk=2,
                           device="cpu")
    outs = eng.serve(tparams, reqs, _gen(5), slots=2)
    assert sorted(c.uid for c in outs) == list(range(len(reqs)))
    for c in outs:
        assert c.tokens.size == reqs[c.uid].max_new_tokens
    st = eng.last_stats
    assert st["admitted"] == st["requests"] == len(reqs)
    assert st["generated_tokens"] == sum(budgets)
    assert st["scheduled_tokens"] == st["decode_steps"] * 2


def test_per_request_budget_zero_and_too_long(model):
    _, tcfg, _, tparams = model
    reqs = _requests(tcfg.vocab_size, [4, 6], [0, 3])
    eng = GenerationEngine(tcfg, max_new_tokens=8, temperature=0.0, chunk=2,
                           device="cpu")
    outs = {c.uid: c for c in eng.serve(tparams, reqs, _gen(), slots=1)}
    assert outs[0].tokens.size == 0 and outs[0].finish_reason == "length"
    assert outs[1].tokens.size == 3
    with pytest.raises(ValueError):
        eng.serve(tparams, _requests(tcfg.vocab_size, [6], [8]), _gen(),
                  slots=1, max_seq_len=10)


def test_cancel_in_flight_and_queued(model):
    _, tcfg, _, tparams = model
    reqs = _requests(tcfg.vocab_size, [4, 5, 6], [8, 8, 8])
    eng = GenerationEngine(tcfg, max_new_tokens=8, temperature=0.0, chunk=2,
                           device="cpu")
    core = eng.core(tparams, _gen(), slots=1, max_seq_len=16)
    for r in reqs:
        core.add_request(r)
    first = core.step()                         # request 0 admitted
    assert [e.uid for e in first] == [0] and first[0].new_tokens.size == 2
    assert core.cancel(0) and core.cancel(2) and not core.cancel(99)
    events = core.step()
    cancelled = {e.uid for e in events if e.finish_reason == "cancelled"}
    assert cancelled == {0, 2}
    while core.has_work():
        events += core.step()
    done = [e for e in events if e.finished and e.uid == 1]
    assert len(done) == 1 and done[0].finish_reason == "length"


def test_seeded_request_is_independent_of_the_batch(model):
    """A seeded request draws from its own generator: its sampled stream
    is the same alone and next to other requests."""
    _, tcfg, _, tparams = model
    base = _requests(tcfg.vocab_size, [5, 4, 6], [6, 6, 6], seed=3)
    seeded = Request(uid=0, tokens=base[0].tokens, max_new_tokens=6,
                     params=SamplingParams(temperature=1.0, seed=1234))
    eng = GenerationEngine(tcfg, max_new_tokens=6, temperature=1.0, chunk=3,
                           device="cpu")
    alone = eng.serve(tparams, [seeded], _gen(0), slots=2)
    mixed = eng.serve(tparams, [base[1], seeded.__class__(
        uid=7, tokens=seeded.tokens, max_new_tokens=6, params=seeded.params),
        base[2]], _gen(99), slots=2)
    got = {c.uid: c.tokens.tolist() for c in mixed}
    assert got[7] == alone[0].tokens.tolist()


def test_step_event_default_tokens_are_fresh():
    a, b = StepEvent(uid=1), StepEvent(uid=2)
    assert a.new_tokens.size == 0 and a.new_tokens is not b.new_tokens


def test_engine_refuses_unported_layouts(model):
    _, tcfg, _, _ = model
    with pytest.raises(NotImplementedError):
        GenerationEngine(tcfg, max_new_tokens=4, mesh=object(), device="cpu")


def test_engine_paged_layout_matches_jax_per_request(model):
    """``kv_layout="paged"`` (refused before the paged layout was ported):
    continuous batching over the block pool, each request's tokens equal
    to its own greedy decode by the reference."""
    jcfg, tcfg, jparams, tparams = model
    reqs = _requests(jcfg.vocab_size, [3, 7, 5, 4, 6, 3], [5, 8, 4, 6, 3, 7])
    eng = GenerationEngine(tcfg, max_new_tokens=8, temperature=0.0, chunk=4,
                           kv_layout="paged", block_size=4, device="cpu")
    outs = eng.serve(tparams, reqs, _gen(9), slots=3)
    assert eng.last_stats["num_blocks"] == 3 * 4 + 1   # S = 15 -> 16 rows
    for c in outs:
        r = reqs[c.uid]
        assert c.tokens.tolist() == jax_greedy(jcfg, jparams, r.tokens,
                                               r.max_new_tokens)


# ------------------------------------------------------------------ #
# sampling
# ------------------------------------------------------------------ #
B, V = 6, 41
TEMPS = [0.7, 1.0, 0.0, 1.3, 0.5, 2.0]
TOPKS = [0, 5, 0, 3, 40, 1]
TOPPS = [1.0, 1.0, 0.9, 0.5, 0.8, 1.0]


def test_filtered_logits_match_reference(monkeypatch):
    """Temperature, top-k and top-p masks per row equal the reference's:
    its ``sample_rows`` hands ``jax.random.categorical`` exactly these
    logits, so the test captures them there."""
    ref = _reference_sampling()
    logits = (np.random.default_rng(0).standard_normal((B, V)) * 3.0
              ).astype(np.float32)
    seen = {}

    def capture(key, x, axis=-1):
        seen["logits"] = np.asarray(x)
        return jnp.argmax(x, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    ref.sample_rows(jnp.asarray(logits), jax.random.PRNGKey(0),
                    temperature=jnp.asarray(TEMPS, jnp.float32),
                    top_k=jnp.asarray(TOPKS, jnp.int32),
                    top_p=jnp.asarray(TOPPS, jnp.float32))
    got = filter_rows(torch.from_numpy(logits),
                      temperature=torch.tensor(TEMPS),
                      top_k=torch.tensor(TOPKS),
                      top_p=torch.tensor(TOPPS)).numpy()
    np.testing.assert_array_equal(got <= -1e29, seen["logits"] <= -1e29)
    np.testing.assert_allclose(got, seen["logits"], rtol=1e-6, atol=1e-6)


def test_sample_rows_greedy_rows_and_support(model):
    logits = torch.from_numpy(
        (np.random.default_rng(1).standard_normal((B, V)) * 3.0)
        .astype(np.float32))
    t, k, p = (torch.tensor(TEMPS), torch.tensor(TOPKS), torch.tensor(TOPPS))
    filt = filter_rows(logits, temperature=t, top_k=k, top_p=p)
    for s in range(20):
        tok = sample_rows(logits, _gen(s), temperature=t, top_k=k, top_p=p)
        assert tok[2] == torch.argmax(logits[2])          # greedy row
        assert (filt.gather(1, tok[:, None]) > -1e29).all()
    assert (sample(logits, _gen(), temperature=0.0)
            == torch.argmax(logits, -1)).all()


# chi-square critical values at p = 0.001 by degrees of freedom
_CHI2_999 = {1: 10.83, 2: 13.82, 3: 16.27, 4: 18.47, 5: 20.52, 6: 22.46,
             7: 24.32}


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, 0, 1.0), (0.8, 5, 1.0),
                                               (1.2, 0, 0.85)])
def test_sample_rows_draws_follow_filtered_softmax(temp, top_k, top_p):
    """20000 draws from one row's filtered distribution: no token outside
    the support, and a chi-square statistic under the p = 0.001 critical
    value for its degrees of freedom."""
    n, v = 20000, 8
    row = torch.tensor([2.0, 1.5, 1.0, 0.6, 0.2, -0.3, -0.8, -1.5])
    logits = row.expand(n, v)
    full = lambda x: torch.full((n,), x)                  # noqa: E731
    kw = dict(temperature=full(temp), top_k=full(top_k), top_p=full(top_p))
    probs = torch.softmax(filter_rows(logits[:1], temperature=full(temp)[:1],
                                      top_k=full(top_k)[:1],
                                      top_p=full(top_p)[:1])[0], -1).numpy()
    draws = sample_rows(logits, _gen(123), **kw).numpy()
    counts = np.bincount(draws, minlength=v)
    support = probs > 1e-12
    assert counts[~support].sum() == 0
    expected = probs[support] * n
    chi2 = float(((counts[support] - expected) ** 2 / expected).sum())
    assert chi2 < _CHI2_999[int(support.sum()) - 1], (chi2, counts, probs)
