"""Split-KV of the decode kernels (``csrc/decode_core.cuh``), fp and int8,
on the CPU.

* The wrappers' host-side split choice (``decode_attention.split_plan``,
  ``paged_attention.paged_split_plan``): the ranges cover every row once,
  none empty, aligned to 64 rows and to the block size; no split once
  ``B * KV`` fills the SMs (unless a dense split's mask bytes would pass
  ``MAX_CHUNK``); otherwise enough splits for about two waves.
* A plain torch model of the kernels' split-then-combine rule, kept here
  and nowhere on the main path: each split's base-2 online-softmax partial
  (m, l, acc) over its valid rows only, a state (empty, full, bad), and the
  combine in split order.  At random split counts it is held to the port's
  plain versions (``ref.decode_attention_ref``,
  ``ref.paged_decode_attention_ref``) and to the reference's Pallas kernels
  in interpret mode, fp32 at rtol = atol = 1e-5: empty splits, a fully
  masked dense sequence (the mean of V over all rows), paged ``lens = 0``
  (the Pallas kernel's zeros) and a bad table entry (NaN for that sequence
  only).
* The same model over int8 rows with their fp32 scales (k_scale on the
  score, v_scale on the probability, ``l`` the probability alone), held to
  ``ref.decode_attention_quant_ref`` / ``ref.paged_decode_attention_quant_ref``
  and the reference's int8 Pallas kernels in interpret mode on the same
  cases, the fully masked answer being the mean of the dequantized V.  The
  int8 values and scales come from the reference's quantizer."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_fwd as j_decode
from repro.kernels.decode_attention import \
    decode_attention_quant_fwd as j_decode_q
from repro.kernels.paged_attention import paged_decode_attention_fwd as j_paged
from repro.kernels.paged_attention import \
    paged_decode_attention_quant_fwd as j_paged_q
from repro.models.modules import _kv_quant as j_kv_quant
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (MAX_CHUNK, MAX_SPLITS,
                                                  TILE, WAVES, split_plan)
from repro_torch.kernels.paged_attention import paged_split_plan

TOL = dict(rtol=1e-5, atol=1e-5)
SMS = 132                              # the H100's streaming multiprocessors


def _ranges(n_rows, plan):
    splits, chunk = plan
    return [(s * chunk, min((s + 1) * chunk, n_rows)) for s in range(splits)]


@pytest.mark.parametrize("bs", [None, 1, 7, 16, 19])
def test_split_ranges_cover_every_row_once(bs):
    """Dense (``bs`` None) or paged with block size ``bs``, over a grid of
    row counts and ``B * KV`` head counts on both sides of the SM count."""
    for n_rows in (1, 63, 65, 511, 513, 2048, 4097, 100_000):
        for heads in (1, 3, 32, 48, 131, 132, 512):
            _check_split_ranges(n_rows, heads, bs)


def _check_split_ranges(n_rows, heads, bs):
    what = (n_rows, heads, bs)
    if bs is None:                     # dense
        plan = split_plan(n_rows, heads, sms=SMS, max_chunk=MAX_CHUNK)
        align = TILE
    else:                              # paged: nb * bs rows
        nb = -(-n_rows // bs)
        n_rows = nb * bs
        plan = paged_split_plan(nb, bs, heads, SMS)
        align = math.lcm(TILE, bs)
    splits, chunk = plan
    assert chunk % TILE == 0 and chunk % align == 0, what
    assert 1 <= splits <= MAX_SPLITS or (bs is None
                                         and chunk == MAX_CHUNK), what
    rows = _ranges(n_rows, plan)
    assert all(lo < hi for lo, hi in rows), what           # none empty
    assert rows[0][0] == 0 and rows[-1][1] == n_rows, what
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:])), what
    if heads >= SMS:                   # the SMs are full: no combine, but
        assert splits == 1 or (bs is None and chunk == MAX_CHUNK), what
    else:                              # enough blocks, or all the rows allow
        units = -(-n_rows // align)
        assert (heads * splits >= WAVES * SMS or splits == units
                or splits > MAX_SPLITS // 2), what


@pytest.mark.parametrize("B,KV,S,bs,splits", [
    (16, 32, 512, 16, 1),              # OPT-1.3B serve
    (8, 32, 512, 16, 1),               # OPT-1.3B PPO generation
    (16, 3, 512, 16, 8),               # smollm-135m at 16 slots
    (1, 32, 2048, 16, 11)])            # one sequence over a long cache
def test_split_plan_fills_about_two_waves(B, KV, S, bs, splits):
    """The main paths' shapes give at least ~1.9 waves of 132 SMs, one
    block per SM a wave: serve 512 and PPO 256 blocks without a split,
    smollm-135m 48 heads x 8 splits = 384."""
    for plan in (split_plan(S, B * KV, sms=SMS, max_chunk=MAX_CHUNK),
                 paged_split_plan(S // bs, bs, B * KV, SMS)):
        assert plan[0] == splits
        assert B * KV * plan[0] >= 1.9 * SMS


# --------------------------------------------------------------------- #
# the split-then-combine rule, as plain torch
# --------------------------------------------------------------------- #
EMPTY, FULL, BAD = 0, 1, 2
LOG2E = 1.4426950408889634


def _partial(q, k, v, ok, bad=False, scales=None):
    """One split of one (b, kv head): q (G, D), k/v (n, D), ok (n,) bool.
    Only rows with ``ok`` enter; scores in base 2.  ``scales`` (int8 rows):
    the rows' (k_scale, v_scale), each (n,): k_scale multiplies the score,
    v_scale the probability that meets V; l sums the probability alone."""
    if bad:
        return BAD, None
    if not bool(ok.any()):
        return EMPTY, None
    s = (q * (LOG2E / math.sqrt(q.shape[-1]))) @ k[ok].float().T  # (G, n_ok)
    if scales is not None:
        s = s * scales[0][ok]
    m = s.max(dim=-1).values
    p = torch.exp2(s - m[:, None])
    pv = p if scales is None else p * scales[1][ok]
    return FULL, (m, p.sum(-1), pv @ v[ok].float())


def _combine(parts, empty_answer):
    """Merge the partials in split order: a bad split makes the output NaN,
    no full split gives ``empty_answer``, an empty split contributes
    nothing (its m never meets an exp)."""
    states = [st for st, _ in parts]
    if BAD in states:
        return torch.full_like(empty_answer, float("nan"))
    full = [x for st, x in parts if st == FULL]
    if not full:
        return empty_answer
    M = torch.stack([m for m, _, _ in full]).max(dim=0).values
    w = [torch.exp2(m - M) for m, _, _ in full]
    L = sum(wi * l for wi, (_, l, _) in zip(w, full))
    A = sum(wi[:, None] * a for wi, (_, _, a) in zip(w, full))
    return A / L.clamp(min=1e-20)[:, None]


def model_dense(q, k, v, valid, plan, scales=None):
    """q (B, KV, G, D); k/v (B, KV, S, D); valid (B, S) bool; ``scales``
    (int8 k/v): (k_scale, v_scale), each (B, KV, S).  A fully masked
    sequence gets the mean of (the dequantized) V over all S rows."""
    B, KV, G, D = q.shape
    S = k.shape[2]
    out = torch.empty_like(q)
    for b in range(B):
        for h in range(KV):
            parts = [_partial(q[b, h], k[b, h, lo:hi], v[b, h, lo:hi],
                              valid[b, lo:hi], scales=None if scales is None
                              else [t[b, h, lo:hi] for t in scales])
                     for lo, hi in _ranges(S, plan)]
            vd = v[b, h].float()
            if scales is not None:
                vd = vd * scales[1][b, h][:, None]
            out[b, h] = _combine(parts, vd.mean(0).expand(G, D))
    return out


def model_paged(q, k_pool, v_pool, tables, lens, plan, nblocks=None,
                scales=None):
    """q (B, KV, G, D); pools (nblocks, bs, KV, D); tables (B, nb); lens (B,);
    ``scales`` (int8 pools): (k_scale, v_scale) planes, each (nblocks, bs,
    KV).  A split whose valid rows use a table entry outside the pool is
    bad."""
    B, KV, G, D = q.shape
    bs = k_pool.shape[1]
    nb = tables.shape[1]
    nblocks = k_pool.shape[0] if nblocks is None else nblocks
    out = torch.empty_like(q)
    for b in range(B):
        n_valid = max(0, min(int(lens[b]), nb * bs))
        for h in range(KV):
            parts = []
            for lo, hi in _ranges(nb * bs, plan):
                hi = max(lo, min(hi, n_valid))
                ents = tables[b, lo // bs:-(-hi // bs)]
                bad = bool(((ents < 0) | (ents >= nblocks)).any())
                r = torch.arange(lo, hi)
                blk = tables[b, r // bs].clamp(0, k_pool.shape[0] - 1).long()
                parts.append(_partial(
                    q[b, h], k_pool[blk, r % bs, h], v_pool[blk, r % bs, h],
                    torch.ones(hi - lo, dtype=torch.bool), bad,
                    None if scales is None
                    else [t[blk, r % bs, h] for t in scales]))
            out[b, h] = _combine(parts, torch.zeros(G, D))
    return out


def _rng_plans(rng, n_rows, align, count=4):
    """Random split plans: chunks of random multiples of ``align``, and
    the wrappers' own plans at 1, 3 and 48 heads."""
    plans = {(1, -(-n_rows // align) * align)}
    for _ in range(count):
        chunk = align * int(rng.integers(1, -(-n_rows // align) + 1))
        plans.add((-(-n_rows // chunk), chunk))
    return sorted(plans)


def _quantize(x):
    """The reference's int8 quantizer over the last axis: (int8, fp32
    scales), as numpy."""
    xi, sc = j_kv_quant(jnp.asarray(x))
    return np.array(xi), np.array(sc)


DENSE_CASES = [(3, 2, 1, 200), (3, 1, 3, 333), (2, 2, 2, 130), (2, 1, 3, 129)]


def _check_dense(B, KV, G, S, quant):
    rng = np.random.default_rng(B * 1000 + S)
    D = 32
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    valid = rng.random((B, S)) < 0.4                 # holes
    valid[0] = False                                 # no valid row at all
    valid[1, :] = np.arange(S) < max(1, S // 3)      # a prefix: empty tails
    valid[-1, 64:128] = False                        # an all-masked split
    sc = ()
    if quant:                                        # int8 rows, fp32 scales
        (k, ks), (v, vs) = _quantize(k), _quantize(v)
        sc = (ks, vs)
    tq, tk, tv, tvalid, *tsc = map(torch.from_numpy, (q, k, v, valid, *sc))
    if quant:
        plain = ref.decode_attention_quant_ref(tq, tk, tv, *tsc, tvalid)
        pallas = j_decode_q(*map(jnp.asarray, (q, k, v, *sc, valid)),
                            s_block=S, interpret=True)
    else:
        plain = ref.decode_attention_ref(tq, tk, tv, tvalid)
        pallas = j_decode(*map(jnp.asarray, (q, k, v, valid)), s_block=S,
                          interpret=True)
    plain, pallas = plain.numpy(), np.asarray(pallas)
    plans = _rng_plans(rng, S, TILE) + [split_plan(S, n, max_chunk=MAX_CHUNK)
                                        for n in (1, 3, 48)]
    assert max(p[0] for p in plans) > 1
    for plan in plans:
        got = model_dense(tq, tk, tv, tvalid, plan,
                          scales=tsc or None).numpy()
        np.testing.assert_allclose(got, plain, **TOL)
        np.testing.assert_allclose(got, pallas, **TOL)
    # the fully masked sequence: the mean of (the dequantized) V over all S
    # rows
    v0 = v[0].astype(np.float32) * (sc[1][0][..., None] if quant else 1)
    np.testing.assert_allclose(got[0], np.broadcast_to(
        v0.mean(axis=1)[:, None], (KV, G, D)), **TOL)


@pytest.mark.parametrize("B,KV,G,S", DENSE_CASES)
def test_split_model_matches_dense_plain_and_pallas(B, KV, G, S):
    _check_dense(B, KV, G, S, quant=False)


@pytest.mark.parametrize("B,KV,G,S", DENSE_CASES)
def test_split_model_matches_dense_int8_plain_and_pallas(B, KV, G, S):
    _check_dense(B, KV, G, S, quant=True)


def _paged_inputs(rng, B, KV, G, D, bs, nb, lens, quant=False):
    """q, pools, tables, lens and (int8 pools) the scale planes, as numpy."""
    nblocks = B * nb + 1
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    k = rng.standard_normal((nblocks, bs, KV, D)).astype(np.float32)
    v = rng.standard_normal((nblocks, bs, KV, D)).astype(np.float32)
    perm = rng.permutation(nblocks - 1) + 1
    tables = np.zeros((B, nb), np.int32)
    for b in range(B):
        n = -(-lens[b] // bs)
        tables[b, :n] = perm[b * nb:b * nb + n]
    sc = ()
    if quant:
        (k, ks), (v, vs) = _quantize(k), _quantize(v)
        sc = (ks, vs)
    return q, k, v, tables, np.asarray(lens, np.int32), sc


PAGED_CASES = [(1, 16, 12), (3, 4, 40), (2, 7, 30), (1, 1, 70)]


def _check_paged(G, bs, nb, quant):
    rng = np.random.default_rng(G * 100 + bs)
    B, KV, D = 4, 2, 32
    n_rows = nb * bs
    align = math.lcm(TILE, bs)
    lens = [0, 1, min(align + 1, n_rows), n_rows]   # 0, one row, past a split
    q, k, v, tables, lens, sc = _paged_inputs(rng, B, KV, G, D, bs, nb, lens,
                                              quant)
    t = [torch.from_numpy(x) for x in (q, k, v, tables, lens)]
    tsc = [torch.from_numpy(x) for x in sc]
    if quant:
        plain = ref.paged_decode_attention_quant_ref(*t[:3], *tsc, *t[3:])
        pallas = j_paged_q(*map(jnp.asarray, (q, k, v, *sc, tables, lens)),
                           interpret=True)
    else:
        plain = ref.paged_decode_attention_ref(*t)
        pallas = j_paged(*map(jnp.asarray, (q, k, v, tables, lens)),
                         interpret=True)
    plain, pallas = plain.numpy(), np.asarray(pallas)
    plans = _rng_plans(rng, n_rows, align) + [
        paged_split_plan(nb, bs, n) for n in (1, 3, 48)]
    for plan in plans:
        got = model_paged(*t, plan, scales=tsc or None).numpy()
        np.testing.assert_allclose(got[1:], plain[1:], **TOL)
        np.testing.assert_allclose(got, pallas, **TOL)
        assert not got[0].any()            # lens = 0: the Pallas kernel's 0


@pytest.mark.parametrize("G,bs,nb", PAGED_CASES)
def test_split_model_matches_paged_plain_and_pallas(G, bs, nb):
    _check_paged(G, bs, nb, quant=False)


@pytest.mark.parametrize("G,bs,nb", PAGED_CASES)
def test_split_model_matches_paged_int8_plain_and_pallas(G, bs, nb):
    _check_paged(G, bs, nb, quant=True)


def _check_bad_entry(quant):
    rng = np.random.default_rng(5)
    B, KV, G, D, bs, nb = 3, 2, 2, 32, 8, 40
    q, k, v, tables, lens, sc = _paged_inputs(
        rng, B, KV, G, D, bs, nb, [nb * bs, 77, nb * bs], quant)
    t = [torch.from_numpy(x) for x in (q, k, v, tables, lens)]
    scales = [torch.from_numpy(x) for x in sc] or None

    def run(tables):
        return model_paged(t[0], t[1], t[2], tables, t[4], plan,
                           scales=scales)

    for plan in [(1, 320), (3, 128), (5, 64)]:
        good = run(t[3])
        bad = t[3].clone()
        bad[2, (plan[0] - 1) * plan[1] // bs] = k.shape[0]
        got = run(bad)
        assert torch.isnan(got[2]).all()
        assert torch.equal(got[:2], good[:2])
        # an entry past lens is never looked at
        past = t[3].clone()
        past[1, -1] = k.shape[0]
        assert torch.equal(run(past), good)


def test_split_model_bad_entry_poisons_only_its_sequence():
    """A table entry outside the pool in the last split of one sequence:
    that sequence's output is NaN (an explicit state: a max that drops NaN
    would hide it), the others' are unchanged, at every split count."""
    _check_bad_entry(quant=False)


def test_split_model_int8_bad_entry_poisons_only_its_sequence():
    """:func:`test_split_model_bad_entry_poisons_only_its_sequence` over an
    int8 pool and its scale planes."""
    _check_bad_entry(quant=True)
