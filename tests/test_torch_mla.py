"""MLA (DeepSeek-V2 multi-head latent attention) in the port, held to the
reference at reduced ``deepseek-v2-lite-16b`` size (r 64, dn 32, dr 16,
dv 32; the query/key head dim is dn + dr = 48, V is padded to it) on
carried-across weights, fp32: ``mla_apply`` in its three modes, the
absorbed decode against the expanded form on the same cache, the plain
flash (and the kernel wrappers' CPU route) at D 192 with V padded and
non-causal with Lq > Lk, forward and gradients, against the reference's
``_flash``; greedy generation (the fixed batch and the request core on
the dense arena) against ``jax_greedy``; the paged refusals; and the
reference behaviour the tests meet (ROADMAP Queue 3, R15 and R16).

Tolerances: module outputs at 1e-5 (``LAYER_TOL`` of
``test_torch_model.py``), gradients at 1e-4 of each leaf's max
(``assert_grads_close``), streams exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (close_rel, config_pair, jax_greedy, params_pair,
                           to_np)
from repro.models import modules as JM
from repro.models import transformer as JT
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_fwd
from repro_torch.models import modules as TM
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import GenerationEngine, Request

ARCH = "deepseek-v2-lite-16b"
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _layer0_attn(tree):
    """Layer 0's MLA params out of a stacked (JAX or port) tree."""
    attn = tree["segments"][0][0]["attn"]
    return {k: v[0] for k, v in attn.items()}


def _pair(use_kernels=False, **kw):
    jcfg, tcfg = config_pair(ARCH, use_kernels=use_kernels, **kw)
    jcfg = jcfg.replace(use_pallas=False)           # the reference's jnp path
    jparams, tparams = params_pair(jcfg, seed=11)
    return jcfg, tcfg, _layer0_attn(jparams), _layer0_attn(tparams)


def _x(cfg, B, L, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, L, cfg.d_model)).astype(np.float32)


def _positions(B, L):
    return np.broadcast_to(np.arange(L)[None], (B, L)).astype(np.int32)


def _caches(jcfg, tcfg, B, S):
    shp = JM.mla_cache_shape(jcfg, B, S)
    assert shp == TM.mla_cache_shape(tcfg, B, S)
    return ({k: jnp.zeros(v, jnp.float32) for k, v in shp.items()},
            {k: torch.zeros(v) for k, v in shp.items()})


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("mode", ["full", "prefill", "decode"])
def test_mla_apply_matches_reference(mode, use_kernels):
    """'full' and 'prefill' (9 tokens, 2 rows; the prefill's latents in a
    12-row cache) and 'decode' (one step on that cache at positions 9 and
    6: rows at different lengths) against the reference's ``mla_apply``,
    output and cache.  The kernel route runs at dn 48 (query/key head dim
    64, a width the flash kernels are built for, V padded from 32), so the
    kernel wrappers' CPU versions serve it; the reduced config's 48 runs
    the plain flash on the CPU."""
    jcfg, tcfg, jp, tp = _pair(use_kernels, **(
        dict(qk_nope_head_dim=48) if use_kernels else {}))
    B, L, S = 2, 9, 12
    x = _x(jcfg, B, L, 1)
    pos = _positions(B, L)
    jc, tc = _caches(jcfg, tcfg, B, S) if mode != "full" else (None, None)
    pm = "prefill" if mode == "decode" else mode
    jo, jc2 = JM.mla_apply(jcfg, jp, jnp.asarray(x),
                           positions=jnp.asarray(pos), mode=pm, cache=jc)
    to, tc2 = TM.mla_apply(tcfg, tp, torch.from_numpy(x),
                           positions=torch.from_numpy(pos).long(), mode=pm,
                           cache=tc)
    if mode == "decode":
        xd = _x(jcfg, B, 1, 2)
        dpos = np.array([[9], [6]], np.int32)
        jo, jc2 = JM.mla_apply(jcfg, jp, jnp.asarray(xd),
                               positions=jnp.asarray(dpos), mode="decode",
                               cache=jc2)
        to, tc2 = TM.mla_apply(tcfg, tp, torch.from_numpy(xd),
                               positions=torch.from_numpy(dpos).long(),
                               mode="decode", cache=tc2)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **LAYER_TOL)
    if mode == "full":
        assert jc2 is None and tc2 is None
        return
    assert tc2 is tc                                # updated in place
    for k in ("ckv", "krope"):
        np.testing.assert_allclose(to_np(tc2[k]), np.asarray(jc2[k]),
                                   **LAYER_TOL)


def _absorbed_and_expanded(M, cfg, p, x, B, L, S, torch_side):
    """The decode output at position L - 1 after a prefill of L - 1 tokens
    (the absorbed form over the cache) and the expanded form's output at
    that position (a prefill of all L tokens), in one package."""
    pos = _positions(B, L)
    if torch_side:
        xt, pt = torch.from_numpy(x), torch.from_numpy(pos).long()
        cache = {k: torch.zeros(v, dtype=cfg.cdtype)
                 for k, v in TM.mla_cache_shape(cfg, B, S).items()}
        xt = xt.to(cfg.cdtype)
        p = {k: v.to(cfg.cdtype) for k, v in p.items()}
        _, cache = M.mla_apply(cfg, p, xt[:, :-1], positions=pt[:, :-1],
                               mode="prefill", cache=cache)
        dec, _ = M.mla_apply(cfg, p, xt[:, -1:], positions=pt[:, -1:],
                             mode="decode", cache=cache)
        full, _ = M.mla_apply(cfg, p, xt, positions=pt, mode="full")
        return to_np(dec.float())[:, 0], to_np(full.float())[:, -1]
    xj, pj = jnp.asarray(x, cfg.cdtype), jnp.asarray(pos)
    p = {k: v.astype(cfg.cdtype) for k, v in p.items()}
    cache = {k: jnp.zeros(v, cfg.cdtype)
             for k, v in JM.mla_cache_shape(cfg, B, S).items()}
    _, cache = M.mla_apply(cfg, p, xj[:, :-1], positions=pj[:, :-1],
                           mode="prefill", cache=cache)
    dec, _ = M.mla_apply(cfg, p, xj[:, -1:], positions=pj[:, -1:],
                         mode="decode", cache=cache)
    full, _ = M.mla_apply(cfg, p, xj, positions=pj, mode="full")
    return (np.asarray(dec.astype(jnp.float32))[:, 0],
            np.asarray(full.astype(jnp.float32))[:, -1])


def test_absorbed_decode_equals_the_expanded_form_in_fp32():
    """On the same cache, the absorbed decode step (W_UK folded into the
    query, W_UV after) computes the expanded attention's last row: in fp32
    they agree to rounding (1e-5)."""
    jcfg, tcfg, jp, tp = _pair()
    x = _x(jcfg, 2, 10, 3)
    dec, full = _absorbed_and_expanded(TM, tcfg, tp, x, 2, 10, 16, True)
    np.testing.assert_allclose(dec, full, **LAYER_TOL)


def test_r16_absorbed_decode_rounds_otherwise_than_expanded_in_bf16():
    """R16: in bf16 the absorbed decode rounds differently from the
    expanded prefill (the absorbed query ``q_nope W_UK`` is rounded to
    bf16, the expanded keys ``ckv W_UK`` are), in the reference and in the
    port alike: the two forms of one position differ by more than fp32
    rounding and stay within bf16's (5e-2 of the output's max)."""
    jcfg, tcfg, jp, tp = _pair(compute_dtype="bfloat16")
    x = _x(jcfg, 2, 10, 3)
    for torch_side, M, cfg, p in ((False, JM, jcfg, jp),
                                  (True, TM, tcfg, tp)):
        dec, full = _absorbed_and_expanded(M, cfg, p, x, 2, 10, 16,
                                           torch_side)
        gap = float(np.abs(dec - full).max()) / float(np.abs(full).max())
        assert 1e-4 < gap < 5e-2, (torch_side, gap)


def test_r15_kv_quant_leaves_the_latent_cache_in_the_compute_dtype():
    """R15: ``kv_quant`` makes only the ``k``/``v`` leaves int8
    (``transformer.py::_cache_dtype``), so MLA's ``ckv``/``krope`` stay in
    the compute dtype, in the reference and in the port."""
    jcfg, tcfg = config_pair(ARCH, kv_quant=True, compute_dtype="bfloat16")
    jleaves = jax.tree_util.tree_leaves_with_path(JT.cache_struct(jcfg, 2, 8))
    tstruct = TT.cache_struct(tcfg, 2, 8)
    got = {k: v[1] for unit in tstruct[0] for k, v in unit.items()}
    assert got == {"ckv": torch.bfloat16, "krope": torch.bfloat16}
    want = {p[-1].key: leaf.dtype for p, leaf in jleaves}
    assert set(want) == {"ckv", "krope"}
    assert all(d == jnp.bfloat16 for d in want.values())
    cache = TT.init_cache(tcfg, 2, 8)
    assert cache[0][0]["ckv"].dtype == torch.bfloat16


def _flash_inputs(B, Lq, Lk, H, KV, D, seed, pad_v_from=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Lk, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Lk, KV, D)).astype(np.float32)
    if pad_v_from is not None:                      # MLA: V zero-padded
        v[..., pad_v_from:] = 0.0
    g = rng.standard_normal((B, Lq, H, D)).astype(np.float32)
    return q, k, v, g


def _port_attention(impl, q, k, v, causal):
    if impl == "plain":
        return TM.flash_attention(q, k, v, causal=causal, q_block=8,
                                  k_block=8)
    return ops.FlashAttention.apply(q, k, v, causal, None)


@pytest.mark.parametrize("impl", ["plain", "ops"])
@pytest.mark.parametrize("case", [
    dict(B=2, Lq=13, Lk=13, H=4, KV=4, D=192, causal=True, pad=128),
    dict(B=1, Lq=9, Lk=9, H=2, KV=2, D=48, causal=True, pad=32),
    dict(B=2, Lq=20, Lk=7, H=4, KV=2, D=32, causal=False, pad=None),
    dict(B=1, Lq=1, Lk=17, H=4, KV=2, D=192, causal=False, pad=None)],
    ids=["d192-padded-v", "d48-reduced", "noncausal-lq-gt-lk",
         "noncausal-one-query"])
def test_flash_forward_and_grads_match_the_reference(case, impl):
    """The plain flash (small blocks, so several tiles and ragged edges)
    and ``ops.FlashAttention`` (the kernels' plain versions on the CPU)
    at MLA's head dim 192 with V padded from 128, at the reduced config's
    48 with V padded from 32 (the plain flash only: the wrappers refuse a
    head dim no kernel is built for), and non-causal over fewer keys than
    queries (cross-attention): output and dq, dk, dv against the
    reference's ``flash_attention`` and ``jax.grad`` of it."""
    q, k, v, g = _flash_inputs(case["B"], case["Lq"], case["Lk"], case["H"],
                               case["KV"], case["D"], 5, case["pad"])
    causal = case["causal"]
    if impl == "ops" and case["D"] not in HEAD_DIMS:
        # no kernel is built for it: the wrappers refuse it on any device
        with pytest.raises(ValueError, match="head_dim 48"):
            _port_attention(impl, *(torch.from_numpy(a) for a in (q, k, v)),
                            causal)
        return
    jf = lambda q, k, v: JM.flash_attention(q, k, v, causal=causal,
                                            q_block=8, k_block=8)
    jo, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = _port_attention(impl, tq, tk, tv, causal)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **LAYER_TOL)
    for a, b in zip(tgrads, jgrads):
        close_rel(a, np.asarray(b), 1e-4)
    if case["pad"] is not None:     # padded V columns give zero output
        assert float(to.detach()[..., case["pad"]:].abs().max()) == 0.0


def test_kernel_wrappers_refuse_causal_lq_gt_lk_only():
    """The wrappers take Lq > Lk without a causal mask (cross-attention)
    and refuse it with one (a query would precede every key)."""
    q5 = torch.randn(1, 2, 2, 6, 32)
    k4 = torch.randn(1, 2, 4, 32)
    out = flash_attention_fwd(q5, k4, k4, causal=False)
    assert out.shape == q5.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="causal with Lq=6 > Lk=4"):
        flash_attention_fwd(q5, k4, k4, causal=True)


def _deepseek(seed=13):
    jcfg, tcfg = config_pair(ARCH, use_kernels=True)
    jparams, tparams = params_pair(jcfg, seed=seed)
    return jcfg, tcfg, jparams, tparams


def test_fixed_batch_generate_matches_jax_greedy():
    """``GenerationEngine.generate`` (one row, a 16-token prompt: MoE rows
    as the reference routes them, R13) on the latent arena, greedy."""
    jcfg, tcfg, jparams, tparams = _deepseek()
    prompt = np.random.default_rng(14).integers(0, jcfg.vocab_size, 16)
    eng = GenerationEngine(tcfg, max_new_tokens=6, temperature=0.0,
                           device="cpu")
    out = eng.generate(tparams, prompt[None], torch.Generator())
    got = out["sequences"][0, 16:].tolist()
    assert got == jax_greedy(jcfg, jparams, prompt, 6)


def test_request_core_streams_match_jax_greedy():
    """The request core on the dense arena (one slot, prompts of 8 and 16
    tokens: their own bucket widths, R13) against ``jax_greedy``."""
    jcfg, tcfg, jparams, tparams = _deepseek(seed=15)
    rng = np.random.default_rng(16)
    reqs = [Request(uid=i, tokens=rng.integers(0, jcfg.vocab_size, L)
                    .astype(np.int32), max_new_tokens=5)
            for i, L in enumerate((8, 16))]
    eng = GenerationEngine(tcfg, max_new_tokens=5, temperature=0.0, chunk=4,
                           device="cpu")
    got = {c.uid: c.tokens.tolist() for c in
           eng.serve(tparams, reqs, torch.Generator(), slots=1)}
    for r in reqs:
        assert got[r.uid] == jax_greedy(jcfg, jparams, r.tokens, 5)


def test_paged_kv_refuses_mla():
    """As in the reference: MLA caches latents, dense geometry only."""
    _, tcfg = config_pair(ARCH)
    with pytest.raises(NotImplementedError, match="no MLA / VLM"):
        GenerationEngine(tcfg, max_new_tokens=4, kv_layout="paged",
                         device="cpu")
    with pytest.raises(NotImplementedError, match="MLA caches latents"):
        TT.paged_cache_struct(tcfg, 4, 8)
    _, _, _, tp = _pair()
    x = torch.zeros(1, 1, tcfg.d_model)
    with pytest.raises(NotImplementedError, match="MLA caches latents"):
        TM.mla_apply(tcfg, tp, x, positions=torch.zeros(1, 1).long(),
                     mode="decode", cache={},
                     block_tables=torch.zeros(1, 1, dtype=torch.int32))
