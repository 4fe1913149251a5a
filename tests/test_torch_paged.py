"""The port's paged KV layout on the CPU against the reference's.

- The block pool (``repro_torch/serving/block_pool.py``, a copy of the
  reference's): the same ids, matches and chain keys as the reference's
  allocator (loaded by file path: ``repro.serving`` does not import here,
  ROADMAP R1) over random admit / grow / harvest / release sequences, and
  the reference's own property suite (``tests/test_block_pool_properties.py``)
  run on the port's allocator.
- The plain paged decode (fp32, bf16 and int8 pools; the plain versions the
  CUDA kernels sit behind, through the wrappers and the model-layout
  adapters) against the reference's oracle and its Pallas kernels in
  interpret mode: fp32 ``rtol = atol = 1e-5`` (the same math summed in
  another order), bf16 one rounding of the output (2e-2), ``lens >= 1``;
  ``lens = 0`` against each reference's own answer (ROADMAP R8).
- ``attn_apply`` and ``transformer.forward`` in paged decode against the
  reference's on the same pool contents: the clamped wrap of a fully
  allocated table, int8 rows and scales written in place.
- The engine contracts of the reference's ``tests/test_paged.py`` (which
  cannot run here, R1): paged streams equal to dense (greedy and seeded)
  and to the reference's greedy decode, block reuse after harvest,
  backpressure without deadlock on an exhausted pool, the watermark, and
  paged int8 equal to dense int8.
"""
import contextlib
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import (
    paged_decode_attention_fwd as j_paged,
    paged_decode_attention_quant_fwd as j_paged_quant)
from repro.models import modules as JM
from repro.models import transformer as JT
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpaged
from repro_torch.models import modules as TM
from repro_torch.models import transformer as TT
from repro_torch.serving import block_pool as BP
from repro_torch.serving.engine import GenerationEngine, Request

from _torch_parity import config_pair, jax_greedy, params_pair, to_np

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _port_pool_as_reference():
    """``repro.serving.block_pool`` resolves to the port's module while the
    block runs (the reference's package does not import here); then
    ``sys.modules`` is as it was."""
    name = "repro.serving.block_pool"
    saved = sys.modules.get(name)
    sys.modules[name] = BP
    try:
        yield
    finally:
        if saved is None:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = saved


# --------------------------------------------------------------------- #
# the block pool
# --------------------------------------------------------------------- #
def _pool_state(a):
    return (a.num_free, a.num_cached, a.num_live, a.available,
            a.high_water, list(a._free), list(a._lru), a.cache_stats(),
            a._ref.tolist())


@pytest.mark.parametrize("seed", range(4))
def test_allocator_makes_the_reference_decisions(seed):
    """The engine's call sequences (admit = match + alloc + insert, grow,
    harvest = insert + free in reverse, release) on both allocators: every
    returned id list, match and chain key, and the whole pool state after
    each call, are equal."""
    R = _load(ROOT / "src" / "repro" / "serving" / "block_pool.py",
              "_ref_block_pool")
    rng = np.random.default_rng(seed)
    bs = 2 + seed % 3
    ra, ta = R.BlockAllocator(19, bs), BP.BlockAllocator(19, bs)
    live = []
    for _ in range(300):
        op = rng.random()
        if op < 0.4 or not live:
            toks = rng.integers(0, 3, size=int(rng.integers(1, 5 * bs)))
            keys = ra.chunk_keys(toks)
            assert keys == ta.chunk_keys(toks)
            m = ra.match(toks, keys=keys)
            assert m == ta.match(toks, keys=keys)
            need = BP.blocks_for(len(toks), bs) - len(m)
            got = ra.alloc(need)
            assert got == ta.alloc(need)
            if got is None:
                ra.free(m)
                ta.free(m)
            else:
                assert (ra.insert(toks, m + got, keys=keys)
                        == ta.insert(toks, m + got, keys=keys))
                live.append((toks, m + got))
        elif op < 0.6:
            i = int(rng.integers(len(live)))
            n = int(rng.integers(1, 3))
            got = ra.alloc(n)
            assert got == ta.alloc(n)
            if got is not None:
                live[i] = (live[i][0], live[i][1] + got)
        else:
            toks, ids = live.pop(int(rng.integers(len(live))))
            if op < 0.85:                      # harvest, then release
                seq = np.concatenate([toks, rng.integers(
                    0, 3, size=int(rng.integers(0, 2 * bs)))])
                n = len(seq) // bs
                assert (ra.insert(seq, ids[:n]) == ta.insert(seq, ids[:n]))
            ra.free(reversed(ids))
            ta.free(reversed(ids))
        assert _pool_state(ra) == _pool_state(ta)
        ta.check_invariants()


_PROPERTY_TESTS = ("test_pool_invariants_random_cycles",
                   "test_pool_invariants_varied_geometry",
                   "test_sharing_refcounts_and_lru_revival",
                   "test_eviction_consumes_chains_leaf_first",
                   "test_double_free_detected_through_cache",
                   "test_match_never_covers_whole_prompt",
                   "test_available_counts_cached_blocks_for_admission")


@pytest.mark.parametrize("name", _PROPERTY_TESTS)
def test_reference_pool_properties_hold_on_the_port(name):
    """The reference's property suite, unchanged, on the port's allocator
    (refcounts balance, no double free, free + cached + live = capacity,
    disjoint free list / LRU / live set, eviction before preemption,
    chains evicted leaf-first, a match never covers the whole prompt)."""
    with _port_pool_as_reference():
        mod = _load(ROOT / "tests" / "test_block_pool_properties.py",
                    "_ref_pool_properties")
        assert mod.BlockAllocator is BP.BlockAllocator
        getattr(mod, name)()


def test_block_tables_pad_with_the_trash_block():
    a = BP.BlockAllocator(9, 4)
    t = BP.BlockTables(a, slots=2, nbmax=3)
    t.assign(1, a.alloc(2))
    assert t.table[0].tolist() == [BP.TRASH_BLOCK] * 3
    assert t.table[1, 2] == BP.TRASH_BLOCK and BP.TRASH_BLOCK == 0
    assert t.grow(1, 3) and BP.TRASH_BLOCK not in t.table[1]
    assert not t.grow(0, 7)                     # all-or-nothing
    t.release(1)
    assert a.num_free == a.capacity and not t.table.any()


# --------------------------------------------------------------------- #
# the plain paged decode
# --------------------------------------------------------------------- #
def _paged_case(rng, B, KV, G, D, bs, nb, lens, quant):
    """Shuffled, non-contiguous tables over a pool whose unused and trash
    blocks hold finite garbage."""
    nblocks = B * nb + 3
    perm = rng.permutation(np.arange(1, nblocks))
    tables = np.zeros((B, nb), np.int32)
    for b, n in enumerate(lens):
        used = min(-(-n // bs), nb)
        tables[b, :used] = perm[b * nb:b * nb + used]
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, (nblocks, bs, KV, D)).astype(np.int8)
        v = rng.integers(-127, 128, (nblocks, bs, KV, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (nblocks, bs, KV)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (nblocks, bs, KV)).astype(np.float32)
        scales = (ks, vs)
    else:
        k = rng.standard_normal((nblocks, bs, KV, D)).astype(np.float32)
        v = rng.standard_normal((nblocks, bs, KV, D)).astype(np.float32)
        scales = ()
    return q, k, v, scales, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("G", [1, 3])
def test_plain_paged_decode_matches_reference(kind, G):
    """Ragged lens (one row, a partial last block, a full table): the
    wrapper (kernel layout) and the adapter (model layout) against the
    reference's oracle and its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(G)
    B, KV, D, bs, nb = 3, 2, 32, 4, 4
    q, k, v, scales, tables, lens = _paged_case(
        rng, B, KV, G, D, bs, nb, [1, 7, 16], kind == "int8")
    dt = torch.bfloat16 if kind == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if kind == "bfloat16" else jnp.float32
    tq = torch.from_numpy(q).to(dt)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if kind != "int8":
        tk, tv = tk.to(dt), tv.to(dt)
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lens)
    jq = jnp.asarray(q).astype(jdt)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if kind != "int8":
        jk, jv = jk.astype(jdt), jv.astype(jdt)
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    if kind == "int8":
        tks, tvs = (torch.from_numpy(s) for s in scales)
        jks, jvs = (jnp.asarray(s) for s in scales)
        got = tpaged.paged_decode_attention_quant_fwd(tq, tk, tv, tks, tvs,
                                                      tt, tl)
        adapter = tops.paged_decode_attention_quant(
            tq.flatten(1, 2), tk, tv, tks, tvs, tt, tl)
        oracle = jref.paged_decode_attention_quant_ref(jq, jk, jv, jks, jvs,
                                                       jt, jl)
        pallas = j_paged_quant(jq, jk, jv, jks, jvs, jt, jl, interpret=True)
    else:
        got = tpaged.paged_decode_attention_fwd(tq, tk, tv, tt, tl)
        adapter = tops.paged_decode_attention(tq.flatten(1, 2), tk, tv, tt,
                                              tl)
        oracle = jref.paged_decode_attention_ref(jq, jk, jv, jt, jl)
        pallas = j_paged(jq, jk, jv, jt, jl, interpret=True)
    # bf16: one rounding of the output apart at most
    tol = dict(rtol=2e-2, atol=2e-2) if kind == "bfloat16" else TOL
    for want in (oracle, pallas):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(to_np(got.float()), want, **tol)
        np.testing.assert_allclose(
            to_np(adapter.float()).reshape(want.shape), want, **tol)
    assert got.dtype == dt


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_lens_zero_follows_each_reference(quant):
    """ROADMAP R8: with ``lens = 0`` the reference's Pallas kernel skips
    every block and returns 0, its oracle returns the mean of V.  The
    port's plain version gives the oracle's answer (the CUDA kernels give
    the Pallas kernel's, checked on the card)."""
    rng = np.random.default_rng(8)
    q, k, v, scales, tables, lens = _paged_case(rng, 2, 2, 2, 32, 4, 3,
                                                [0, 5], quant)
    j_args = [jnp.asarray(x) for x in (q, k, v, *scales, tables, lens)]
    t_args = [torch.from_numpy(x) for x in (q, k, v, *scales, tables, lens)]
    if quant:
        got = tpaged.paged_decode_attention_quant_fwd(*t_args)
        oracle = jref.paged_decode_attention_quant_ref(*j_args)
        pallas = j_paged_quant(*j_args, interpret=True)
        vrows = v[tables[0]].astype(np.float32) * scales[1][tables[0]][
            ..., None]
    else:
        got = tpaged.paged_decode_attention_fwd(*t_args)
        oracle = jref.paged_decode_attention_ref(*j_args)
        pallas = j_paged(*j_args, interpret=True)
        vrows = v[tables[0]]
    np.testing.assert_allclose(to_np(got), np.asarray(oracle), **TOL)
    assert not np.asarray(pallas)[0].any()          # the kernel: zeros
    mean_v = vrows.reshape(-1, 2, 32).mean(0)       # the oracle: mean of V
    np.testing.assert_allclose(to_np(got)[0], np.broadcast_to(
        mean_v[:, None], (2, 2, 32)), **TOL)


@pytest.mark.parametrize("bad", ["head_dim", "group", "dtype", "table_dtype",
                                 "out_of_pool", "scale_shape", "misaligned"])
def test_paged_wrappers_reject_what_the_kernels_do_not_take(bad):
    B, KV, G, D, bs, nb, nblocks = 2, 2, 1, 32, 4, 3, 8
    q = torch.randn(B, KV, G, D)
    k = torch.randn(nblocks, bs, KV, D)
    v = torch.randn(nblocks, bs, KV, D)
    tables = torch.ones(B, nb, dtype=torch.int32)
    lens = torch.full((B,), 5, dtype=torch.int32)
    quant = bad == "scale_shape"
    if quant:
        k, v = k.to(torch.int8), v.to(torch.int8)
    ks = torch.ones(nblocks, bs, KV + (1 if quant else 0))
    vs = torch.ones(nblocks, bs, KV)
    if bad == "head_dim":
        q, k, v = q[..., :16], k[..., :16], v[..., :16]
    elif bad == "group":
        q = torch.randn(B, KV, 9, D)
    elif bad == "dtype":
        k = k.double()
    elif bad == "table_dtype":
        tables = tables.long()
    elif bad == "out_of_pool":
        tables[1, 0] = nblocks
    elif bad == "misaligned":              # rows off 16-byte boundaries
        k = torch.randn(nblocks, bs, KV, D + 1)[..., 1:]
    with pytest.raises((ValueError, TypeError)):
        if quant:
            tpaged.paged_decode_attention_quant_fwd(q, k, v, ks, vs, tables,
                                                    lens)
        else:
            tpaged.paged_decode_attention_fwd(q, k, v, tables, lens)


# --------------------------------------------------------------------- #
# the attention layer and the model over the pool
# --------------------------------------------------------------------- #
def _layer0(tree):
    return {k: (v[0] if not isinstance(v, dict) else _layer0(v))
            for k, v in tree.items()}


def _pool(rng, cfg, n_units, nblocks, bs):
    """Random pool contents, per layer (n_units leading) or one layer."""
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    lead = () if n_units is None else (n_units,)
    if not cfg.kv_quant:
        return {n: rng.standard_normal(lead + (nblocks, bs, KV, hd))
                .astype(np.float32) for n in ("k", "v")}
    out = {}
    for n in ("k", "v"):
        out[n] = rng.integers(-127, 128, lead + (nblocks, bs, KV, hd)
                              ).astype(np.int8)
        out[n + "_scale"] = rng.uniform(0.001, 0.05, lead + (
            nblocks, bs, KV)).astype(np.float32)
    return out


def _assert_pool_close(got, want):
    for name, g in got.items():
        g, w = to_np(g), np.asarray(want[name])
        if g.dtype == np.int8:                 # one step on a rounding edge
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, name
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def _decode_case(rng, nb, bs):
    """Three sequences: a short one, one mid-table, and one past a fully
    allocated table (its write wraps into its own last block)."""
    tables = np.zeros((3, nb), np.int32)
    tables[0, :1] = [5]
    tables[1, :3] = [2, 9, 4]
    tables[2, :] = [7, 1, 8, 3][:nb]
    pos = np.asarray([[2], [9], [nb * bs + 5]], np.int32)
    return tables, pos


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32", "int8"])
def test_attn_apply_paged_decode_matches_reference(kv_quant, use_kernels):
    """Paged decode in the attention layer: the new row lands at
    ``(table[min(pos // bs, nb - 1)], pos % bs)`` in place (quantized per
    row under int8), and the token attends ``min(pos + 1, nb * bs)`` rows
    through its table; the reference runs its jnp path, or its Pallas
    kernel in interpret mode where the port runs its kernel path."""
    jcfg, tcfg = config_pair("smollm-135m", use_kernels=use_kernels,
                             kv_quant=kv_quant)
    jparams, tparams = params_pair(jcfg, seed=3)
    jp = _layer0(jparams["segments"][0][0])["attn"]
    tp = _layer0(tparams["segments"][0][0])["attn"]
    rng = np.random.default_rng(4)
    nb, bs, nblocks = 4, 4, 10
    tables, pos = _decode_case(rng, nb, bs)
    pool = _pool(rng, jcfg, None, nblocks, bs)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    jout, jc = JM.attn_apply(
        jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos), mode="decode",
        cache={k: jnp.asarray(v) for k, v in pool.items()},
        block_tables=jnp.asarray(tables))
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    tout, tc = TM.attn_apply(
        tcfg, tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
        mode="decode", cache=tpool, block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    assert all(tc[n] is tpool[n] for n in tpool)      # written in place
    _assert_pool_close(tc, jc)
    # the wrapped write went to the last block of the full table
    assert not np.array_equal(to_np(tc["k"][3]), pool["k"][3])


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32", "int8"])
def test_forward_paged_decode_matches_reference(kv_quant, use_kernels):
    """``transformer.forward(mode="decode", block_tables=...)`` over a
    whole paged cache tree (every layer's pool updated in place)."""
    jcfg, tcfg = config_pair("smollm-135m", use_kernels=use_kernels,
                             kv_quant=kv_quant)
    jparams, tparams = params_pair(jcfg, seed=6)
    rng = np.random.default_rng(6)
    nb, bs, nblocks = 4, 4, 10
    tables, pos = _decode_case(rng, nb, bs)
    struct = TT.paged_cache_struct(tcfg, nblocks, bs)
    jstruct = JT.paged_cache_struct(jcfg, nblocks, bs)
    layer = _pool(rng, jcfg, jcfg.n_layers, nblocks, bs)
    for name, (shape, dtype) in struct[0][0].items():
        assert tuple(jstruct[0][0][name].shape) == shape
        assert str(jstruct[0][0][name].dtype) == str(dtype).split(".")[1]
        assert layer[name].shape == shape
    toks = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
    jh, jc, _ = JT.forward(jcfg, jparams, tokens=jnp.asarray(toks),
                           mode="decode",
                           cache=(({k: jnp.asarray(v)
                                    for k, v in layer.items()},),),
                           positions=jnp.asarray(pos),
                           block_tables=jnp.asarray(tables))
    tcache = (({k: torch.from_numpy(v.copy()) for k, v in layer.items()},),)
    th, tc, _ = TT.forward(tcfg, tparams, tokens=torch.from_numpy(toks),
                           mode="decode", cache=tcache,
                           positions=torch.from_numpy(pos),
                           block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(to_np(th), np.asarray(jh), **TOL)
    _assert_pool_close(tc[0][0], jc[0][0])


def test_paged_cache_refuses_what_the_reference_refuses():
    _, tcfg = config_pair("smollm-135m")
    with pytest.raises(NotImplementedError):
        TT.paged_cache_struct(tcfg.replace(sliding_window=8), 4, 4)
    with pytest.raises(NotImplementedError):
        GenerationEngine(tcfg.replace(sliding_window=8), max_new_tokens=4,
                         kv_layout="paged", device="cpu")
    with pytest.raises(ValueError):
        GenerationEngine(tcfg, max_new_tokens=4, kv_layout="banana",
                         device="cpu")
    pool = TT.init_paged_cache(tcfg.replace(kv_quant=True), 6, 4)
    leaf = pool[0][0]
    assert leaf["k"].dtype == torch.int8 and leaf["v"].dtype == torch.int8
    assert tuple(leaf["k_scale"].shape) == (tcfg.n_layers, 6, 4,
                                            tcfg.n_kv_heads)
    assert leaf["k_scale"].dtype == torch.float32


# --------------------------------------------------------------------- #
# the engine over the pool (tests/test_paged.py's contracts)
# --------------------------------------------------------------------- #
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


def _engine(cfg, layout, **kw):
    kw.setdefault("max_new_tokens", 8)
    kw.setdefault("temperature", 0.0)
    kw.setdefault("chunk", 4)
    return GenerationEngine(cfg, kv_layout=layout, block_size=4,
                            device="cpu", **kw)


def _serve(eng, params, reqs, seed=9, **kw):
    outs = eng.serve(params, reqs, torch.Generator().manual_seed(seed), **kw)
    assert sorted(c.uid for c in outs) == list(range(len(reqs)))
    return {c.uid: c for c in outs}


def _streams(outs):
    return {u: c.tokens.tolist() for u, c in outs.items()}


@pytest.fixture(scope="module")
def dense_greedy(model):
    """Dense greedy streams of the request sets used below (the dense
    layout is held to the reference's greedy decode in
    ``test_torch_serving.py``)."""
    _, tcfg, _, tparams = model
    V = tcfg.vocab_size
    sets = {"a": _requests(V, [3, 7, 5, 4, 6, 3], [5, 8, 4, 6, 3, 7]),
            "b": _requests(V, [3, 9, 4, 7, 5, 6], [8, 5, 7, 3, 6, 4]),
            "c": _requests(V, [3, 9, 4, 7, 5, 6, 8, 3, 4],
                           [2, 5, 7, 3, 6, 4, 2, 5, 3])}
    out = {}
    for name, reqs in sets.items():
        out[name] = (reqs, _streams(_serve(_engine(tcfg, "dense"), tparams,
                                           reqs, slots=3, max_seq_len=20)))
    return out


def test_paged_matches_dense_greedy(model, dense_greedy):
    _, tcfg, _, tparams = model
    reqs, want = dense_greedy["a"]
    got = _serve(_engine(tcfg, "paged"), tparams, reqs, slots=3,
                 max_seq_len=16)
    assert _streams(got) == want


def test_paged_matches_dense_seeded_sampling(model):
    """Same admission order, same generator draws: identical streams
    across the KV layouts under stochastic sampling with an EOS."""
    _, tcfg, _, tparams = model
    V = tcfg.vocab_size
    reqs = _requests(V, [4, 6, 3, 5, 7], [6, 8, 5, 7, 4])
    mk = lambda layout: _engine(tcfg, layout, temperature=1.0, top_k=8,
                                eos_id=V - 1)
    d = _serve(mk("dense"), tparams, reqs, seed=3, slots=2, max_seq_len=16)
    p = _serve(mk("paged"), tparams, reqs, seed=3, slots=2, max_seq_len=16)
    for uid in d:
        assert d[uid].tokens.tolist() == p[uid].tokens.tolist()
        assert d[uid].finish_reason == p[uid].finish_reason


def test_paged_block_reuse_after_harvest(model, dense_greedy):
    """A pool barely larger than one request: every admission reuses
    just-freed blocks, and the streams stay those of the dense layout
    (stale KV fully dead)."""
    _, tcfg, _, tparams = model
    reqs, want = dense_greedy["b"]
    eng = _engine(tcfg, "paged")
    got = _serve(eng, tparams, reqs, seed=5, slots=2, max_seq_len=20,
                 num_blocks=11, watermark=0)
    assert eng.last_stats["block_high_water"] <= 10
    assert _streams(got) == want


def test_exhaustion_backpressure_and_preemption_no_deadlock(model,
                                                            dense_greedy):
    """A pool that holds about one request: admission waits for blocks,
    top-ups preempt the newest slot, and every request still completes
    with the dense layout's greedy tokens, the reference's greedy decode
    for a preempted one."""
    jcfg, tcfg, jparams, tparams = model
    reqs, want = dense_greedy["c"]
    eng = _engine(tcfg, "paged", chunk=2)
    got = _serve(eng, tparams, reqs, seed=5, slots=3, max_seq_len=20,
                 num_blocks=6, watermark=0)
    st = eng.last_stats
    assert st["max_concurrency"] <= 2               # pool-bound, not slots
    assert st["block_high_water"] <= 5
    assert st["preemptions"] > 0
    assert _streams(got) == want
    r = reqs[1]
    assert got[1].tokens.tolist() == jax_greedy(jcfg, jparams, r.tokens,
                                                r.max_new_tokens)


def test_watermark_reserves_headroom(model):
    """A watermark that covers each admitted sequence's appends admits
    fewer at once and never preempts; the same pool without it preempts
    and still completes everything."""
    _, tcfg, _, tparams = model
    reqs = _requests(tcfg.vocab_size, [6, 6, 6, 6], [8, 8, 8, 8])
    eng = _engine(tcfg, "paged", chunk=2)
    _serve(eng, tparams, reqs, seed=1, slots=4, max_seq_len=16,
           num_blocks=9, watermark=4)
    assert eng.last_stats["preemptions"] == 0
    assert eng.last_stats["max_concurrency"] <= 2
    eng0 = _engine(tcfg, "paged", chunk=2)
    _serve(eng0, tparams, reqs, seed=1, slots=4, max_seq_len=16,
           num_blocks=9, watermark=0)
    assert eng0.last_stats["preemptions"] > 0


def test_zero_budget_and_too_long_requests_paged(model):
    _, tcfg, _, tparams = model
    V = tcfg.vocab_size
    eng = _engine(tcfg, "paged")
    outs = _serve(eng, tparams, _requests(V, [4, 6], [0, 3]), slots=1)
    assert outs[0].tokens.size == 0 and outs[1].tokens.size == 3
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError):                 # exceeds the pool
        eng.serve(tparams, _requests(V, [8], [8]), gen, slots=1,
                  num_blocks=3)
    with pytest.raises(ValueError):                 # exceeds max_seq_len
        eng.serve(tparams, _requests(V, [8], [8]), gen, slots=1,
                  max_seq_len=10)
    with pytest.raises(ValueError):                 # pool knobs: paged only
        _engine(tcfg, "dense").serve(tparams, _requests(V, [4], [2]), gen,
                                     slots=1, num_blocks=8)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_paged_int8_matches_dense_int8_bitwise(model, use_kernels):
    """Two layouts over the same quantization stream identical greedy
    tokens (same quantized rows, same score algebra, the gathered virtual
    cache equal to the arena); preemption included."""
    _, tcfg, _, tparams = model
    qcfg = tcfg.replace(kv_quant=True, use_kernels=use_kernels)
    reqs = _requests(qcfg.vocab_size, [3, 9, 4, 7, 5, 6], [8, 5, 7, 3, 6, 4])
    d = _serve(_engine(qcfg, "dense"), tparams, reqs, slots=3,
               max_seq_len=20)
    p = _serve(_engine(qcfg, "paged"), tparams, reqs, slots=3,
               max_seq_len=20)
    eng = _engine(qcfg, "paged", chunk=2)
    pre = _serve(eng, tparams, reqs, slots=3, max_seq_len=20, num_blocks=6,
                 watermark=0)
    assert eng.last_stats["preemptions"] > 0
    assert _streams(d) == _streams(p) == _streams(pre)
