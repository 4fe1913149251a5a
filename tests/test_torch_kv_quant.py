"""The port's int8 KV cache on the CPU against the reference's.

- ``_kv_quant``: bitwise (the absmax floor of 1e-8, zero rows, round half
  to even).
- The plain int8 decode (kernel layout, model layout, and through the
  wrapper / adapter the CUDA kernel sits behind) against the reference's
  jnp oracle and its Pallas ``decode_attention_quant_fwd`` in interpret
  mode: fp32, rtol = atol = 1e-5 (the same math summed in another order),
  GQA groups of 1 and 3, ragged masks with a fully masked row.
- The attention layer's int8 prefill (also over an int8 prefix-cache
  history) and decode against the reference's: outputs at 1e-5, cache
  scales at 1e-5, int8 rows equal (one step apart at most where a value
  sits on a rounding edge).
- Greedy generation on the int8 arena through ``GenerationEngine.generate``
  and ``EngineCore`` (``serve``): tokens identical to the reference's
  greedy decode on the same weights; teacher-forced logits within 1e-5 of
  the reference's max |logit|.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import (
    decode_attention_quant_fwd as j_decode_quant)
from repro.models import modules as JM
from repro.models import transformer as JT
from repro_torch.kernels import ops as tops
from repro_torch.kernels.decode_attention import decode_attention_quant_fwd
from repro_torch.models import modules as TM
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import GenerationEngine, Request
from repro_torch.serving.generate import decode_step, prefill

from _torch_parity import config_pair, jax_greedy, params_pair, to_np

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------- #
# quantization
# --------------------------------------------------------------------- #
def _quant_input(rng, shape):
    x = _normal(rng, shape) * np.exp(rng.uniform(-4, 4, shape[:-1] + (1,)))
    x = x.astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0                                  # all-zero row: scale 1e-8
    flat[1] *= 1e-8                                # below the floor
    flat[2] = np.linspace(-127, 127, shape[-1])    # scale exactly 1
    flat[2, :4] = (2.5, -3.5, 0.5, -0.5)           # ties round to even
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 32), (2, 7, 3, 64)])
def test_kv_quant_matches_reference_bitwise(shape, dtype):
    x = _quant_input(np.random.default_rng(len(shape)), shape)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ji, js = JM._kv_quant(jx)
    ti, ts = TM._kv_quant(tx)
    assert ti.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    flat_s = ts.reshape(-1)
    assert float(flat_s[0]) == pytest.approx(1e-8)   # the floor, no NaN
    if dtype == "float32":
        assert ti.reshape(-1, shape[-1])[2, :4].tolist() == [2, -4, 0, 0]


# --------------------------------------------------------------------- #
# the int8 decode's plain versions
# --------------------------------------------------------------------- #
DECODE_CASES = [(2, 2, 1, 24), (3, 1, 3, 40), (4, 3, 3, 17)]


def _ragged_valid(rng, B, S):
    nv = rng.integers(1, S + 1, size=B)
    nv[0] = 0                            # fully masked: mean of dequant V
    nv[-1] = S
    return np.arange(S)[None] < nv[:, None]


def _quant_cache(rng, shape):
    """int8 rows and their fp32 scales, from random fp rows."""
    xi, xs = JM._kv_quant(jnp.asarray(_normal(rng, shape)))
    return np.array(xi), np.array(xs)


@pytest.mark.parametrize("B,KV,G,S", DECODE_CASES)
def test_decode_quant_plain_matches_pallas_and_ref(B, KV, G, S):
    rng = np.random.default_rng(B * 100 + S)
    D = 32
    q = _normal(rng, (B, KV, G, D))
    k, ks = _quant_cache(rng, (B, KV, S, D))
    v, vs = _quant_cache(rng, (B, KV, S, D))
    valid = _ragged_valid(rng, B, S)
    got = decode_attention_quant_fwd(*map(torch.from_numpy,
                                          (q, k, v, ks, vs, valid))).numpy()
    jargs = tuple(map(jnp.asarray, (q, k, v, ks, vs, valid)))
    pallas = j_decode_quant(*jargs, s_block=S, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.decode_attention_quant_ref(*jargs)), **TOL)
    # the fully masked row averages the dequantized V
    mean_v = (v[0].astype(np.float32) * vs[0][..., None]).mean(axis=1)
    np.testing.assert_allclose(got[0], np.broadcast_to(
        mean_v[:, None], (KV, G, D)), **TOL)


@pytest.mark.parametrize("B,KV,G,S", DECODE_CASES)
def test_decode_quant_adapter_reads_arena_in_place(B, KV, G, S):
    """q (B, H, D), the (B, S, KV, D) int8 arena and its (B, S, KV) scale
    planes through the port's adapter (strided views, no copy) vs the
    reference's adapter (Pallas, interpret mode) and vs the model's plain
    code against the reference's jnp path."""
    rng = np.random.default_rng(11 + S)
    D = 32
    q = _normal(rng, (B, KV * G, D))
    k, ks = _quant_cache(rng, (B, S, KV, D))
    v, vs = _quant_cache(rng, (B, S, KV, D))
    valid = _ragged_valid(rng, B, S)
    targs = tuple(map(torch.from_numpy, (q, k, v, ks, vs, valid)))
    jargs = tuple(map(jnp.asarray, (q, k, v, ks, vs, valid)))
    got = tops.decode_attention_quant(*targs).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.decode_attention_quant(*jargs)), **TOL)
    plain = TM.decode_attention_quant(*targs).numpy()
    np.testing.assert_allclose(
        plain, np.asarray(JM.decode_attention_quant(*jargs)), **TOL)
    tk, tks = targs[1], targs[3]
    assert tk.transpose(1, 2).data_ptr() == tk.data_ptr()
    assert tks.transpose(1, 2).data_ptr() == tks.data_ptr()


@pytest.mark.parametrize("bad", ["kv_dtype", "scale_dtype", "scale_shape",
                                 "misaligned"])
def test_quant_wrapper_rejects_what_the_kernel_does_not_take(bad):
    B, KV, G, S, D = 2, 2, 1, 16, 32
    q = torch.randn(B, KV, G, D)
    k = torch.zeros(B, KV, S, D, dtype=torch.int8)
    v = torch.zeros(B, KV, S, D, dtype=torch.int8)
    ks, vs = torch.ones(B, KV, S), torch.ones(B, KV, S)
    valid = torch.ones(B, S, dtype=torch.bool)
    if bad == "kv_dtype":
        k = k.float()
    elif bad == "scale_dtype":
        ks = ks.half()
    elif bad == "scale_shape":
        vs = torch.ones(B, KV, S + 1)
    elif bad == "misaligned":                  # rows off 16-byte boundaries
        k = torch.zeros(B, KV, S, D + 1, dtype=torch.int8)[..., 1:]
    with pytest.raises((ValueError, TypeError)):
        decode_attention_quant_fwd(q, k, v, ks, vs, valid)


# --------------------------------------------------------------------- #
# the attention layer and the cache
# --------------------------------------------------------------------- #
def test_int8_cache_layout():
    _, tcfg = config_pair("smollm-135m", kv_quant=True)
    struct = TT.cache_struct(tcfg, 3, 10)
    layer = struct[0][0]
    n, KV, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    assert layer["k"] == ((n, 3, 10, KV, hd), torch.int8)
    assert layer["v"] == ((n, 3, 10, KV, hd), torch.int8)
    assert layer["k_scale"] == ((n, 3, 10, KV), torch.float32)
    assert layer["v_scale"] == ((n, 3, 10, KV), torch.float32)
    jstruct = JT.cache_struct(config_pair("smollm-135m", kv_quant=True)[0],
                              3, 10)[0][0]
    for name, (shape, dtype) in layer.items():
        assert tuple(jstruct[name].shape) == shape
        assert str(jstruct[name].dtype) == str(dtype).split(".")[1]


def _layer0(tree):
    return {k: (v[0] if not isinstance(v, dict) else _layer0(v))
            for k, v in tree.items()}


def _int8_cache(jcfg, B, S, rng):
    KV, hd = jcfg.n_kv_heads, jcfg.head_dim
    k, ks = _quant_cache(rng, (B, S, KV, hd))
    v, vs = _quant_cache(rng, (B, S, KV, hd))
    return dict(k=k, v=v, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("case", ["prefill", "decode", "ring"])
def test_attn_apply_int8_matches_reference(case, use_kernels):
    """The int8 branches of ``attn_apply``: prefill writes quantized rows
    and scales (a prompt longer than a windowed arena keeps the last S at
    slot pos % S); decode quantizes the new row, writes it in place and
    attends over the int8 arena."""
    kw = dict(sliding_window=8) if case == "ring" else {}
    jcfg, tcfg = config_pair("smollm-135m", use_kernels=use_kernels,
                             kv_quant=True, **kw)
    jcfg = jcfg.replace(use_pallas=False)
    jparams, tparams = params_pair(jcfg, seed=3)
    jp = _layer0(jparams["segments"][0][0])["attn"]
    tp = _layer0(tparams["segments"][0][0])["attn"]
    rng = np.random.default_rng(4)
    B, S = 3, (8 if case == "ring" else 24)
    L = {"prefill": 10, "decode": 1, "ring": 13}[case]
    x = _normal(rng, (B, L, jcfg.d_model))
    cache = _int8_cache(jcfg, B, S, rng)
    if case == "decode":
        pos = np.asarray([[3], [17], [S + 5]], np.int32)
    else:
        pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    mode = "decode" if case == "decode" else "prefill"
    window = 8 if case == "ring" else None
    jout, jc = JM.attn_apply(jcfg, jp, jnp.asarray(x), positions=jnp.asarray(
        pos), mode=mode, cache={k: jnp.asarray(v) for k, v in cache.items()},
        window=window)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tout, tc = TM.attn_apply(tcfg, tp, torch.from_numpy(x),
                             positions=torch.from_numpy(pos), mode=mode,
                             cache=tcache, window=window)
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    for name in ("k", "v"):
        assert tc[name] is tcache[name]          # written in place
        d = np.abs(tc[name].numpy().astype(np.int32)
                   - np.asarray(jc[name]).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    for name in ("k_scale", "v_scale"):
        assert tc[name] is tcache[name]
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_int8_prefix_history_matches_reference(use_kernels):
    """A prefix-cache suffix prefill over an int8 pool: the read-only
    history ``hk``/``hv`` is int8 with ``hk_scale``/``hv_scale``, is
    dequantized before the concat, and the suffix attends [history;
    suffix] rectangularly at positions P .. P + L - 1; the suffix's own
    rows are quantized into the arena."""
    jcfg, tcfg = config_pair("smollm-135m", use_kernels=use_kernels,
                             kv_quant=True)
    jcfg = jcfg.replace(use_pallas=False)
    jparams, tparams = params_pair(jcfg, seed=5)
    jp = _layer0(jparams["segments"][0][0])["attn"]
    tp = _layer0(tparams["segments"][0][0])["attn"]
    rng = np.random.default_rng(5)
    B, L, P, S = 1, 5, 8, 8
    x = _normal(rng, (B, L, jcfg.d_model))
    cache = _int8_cache(jcfg, B, S, rng)
    hist = _int8_cache(jcfg, B, P, rng)
    cache.update(hk=hist["k"], hv=hist["v"], hk_scale=hist["k_scale"],
                 hv_scale=hist["v_scale"])
    pos = (P + np.arange(L, dtype=np.int32))[None]
    jout, jc = JM.attn_apply(jcfg, jp, jnp.asarray(x),
                             positions=jnp.asarray(pos), mode="prefill",
                             cache={k: jnp.asarray(v)
                                    for k, v in cache.items()})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tout, tc = TM.attn_apply(tcfg, tp, torch.from_numpy(x),
                             positions=torch.from_numpy(pos),
                             mode="prefill", cache=tcache)
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    for name in ("k", "v"):
        d = np.abs(tc[name].numpy().astype(np.int32)
                   - np.asarray(jc[name]).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


# --------------------------------------------------------------------- #
# generation on the int8 arena
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", ["opt-1.3b", "smollm-135m"])
def test_int8_teacher_forced_logits_match_reference(arch, use_kernels):
    """Prefill + decode steps over the int8 arena, teacher-forced on one
    token stream: the port's logits at every step against the
    reference's (jnp path) to 1e-5 of its max |logit|."""
    jcfg, tcfg = config_pair(arch, use_kernels=use_kernels, kv_quant=True)
    jcfg = jcfg.replace(use_pallas=False)
    jparams, tparams = params_pair(jcfg, seed=6)
    B, Lp, n = 2, 7, 6
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size,
                                             (B, Lp + n)).astype(np.int32)
    cache = JT.init_cache(jcfg, B, Lp + n)
    h, cache, _ = JT.forward(jcfg, jparams, tokens=jnp.asarray(toks[:, :Lp]),
                             mode="prefill", cache=cache)
    want = [JT.logits_fn(jcfg, jparams, h[:, -1:])[:, 0]]
    for t in range(n):
        h, cache, _ = JT.forward(
            jcfg, jparams, tokens=jnp.asarray(toks[:, Lp + t:Lp + t + 1]),
            mode="decode", cache=cache,
            positions=jnp.full((B, 1), Lp + t, jnp.int32))
        want.append(JT.logits_fn(jcfg, jparams, h)[:, 0])
    want = np.stack([np.asarray(w) for w in want], 1)

    tt = torch.from_numpy(toks).long()
    params = TT.cast_params(tcfg, tparams)
    tcache = TT.init_cache(tcfg, B, Lp + n)
    logits, tcache = prefill(tcfg, params, tt[:, :Lp], tcache)
    got = [logits]
    for t in range(n):
        logits, tcache = decode_step(tcfg, params, tt[:, Lp + t], tcache,
                                     torch.full((B,), Lp + t))
        got.append(logits)
    got = torch.stack(got, 1).numpy()
    assert tcache[0][0]["k"].dtype == torch.int8
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = config_pair("smollm-135m", use_kernels=True, kv_quant=True)
    jcfg = jcfg.replace(use_pallas=False)
    jparams, tparams = params_pair(jcfg, seed=21)
    return jcfg, tcfg, jparams, tparams


def test_generate_int8_greedy_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (3, 6))
    eng = GenerationEngine(tcfg, max_new_tokens=8, temperature=0.0,
                           device="cpu")
    out = eng.generate(tparams, prompts, torch.Generator().manual_seed(0))
    seqs = out["sequences"].numpy()
    np.testing.assert_array_equal(seqs[:, :6], prompts)
    for b in range(3):
        assert seqs[b, 6:].tolist() == jax_greedy(jcfg, jparams, prompts[b],
                                                  8)


def test_core_int8_greedy_matches_jax_per_request(model):
    """Continuous batching over the int8 arena: ragged requests, slots
    refilled mid-run; each request's tokens equal its own greedy decode
    (admission prefills the slot's int8 rows and scale rows in place)."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(7)
    lens, budgets = [5, 11, 3, 9, 6], [6, 4, 8, 5, 7]
    reqs = [Request(uid=i, tokens=rng.integers(0, jcfg.vocab_size, lp)
                    .astype(np.int32), max_new_tokens=mn)
            for i, (lp, mn) in enumerate(zip(lens, budgets))]
    eng = GenerationEngine(tcfg, max_new_tokens=8, temperature=0.0, chunk=3,
                           device="cpu")
    outs = {c.uid: c.tokens.tolist() for c in eng.serve(
        tparams, reqs, torch.Generator().manual_seed(0), slots=2)}
    for r in reqs:
        assert outs[r.uid] == jax_greedy(jcfg, jparams, r.tokens,
                                         r.max_new_tokens)


def test_serve_cli_kv_quant_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "smollm-135m", "--reduced", "--requests", "4",
         "--max-new", "8", "--kv-quant"], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert re.search(r"kv=dense-int8  requests=4  generated 32 tokens in .* "
                     r"tok/s, slot utilization 100\.0%", res.stdout), \
        res.stdout
