"""The port's model against the reference's, on the same weights (carried
across through numpy) and the same inputs (numpy, seeded), at the reduced
OPT-1.3B and smollm-135m configs in fp32.  Layers at 1e-5; forward logits
at atol 1e-4 (two decoder layers of fp32 arithmetic summed in another
order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import modules as JM
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import modules as TM
from repro_torch.models import transformer as TT
from repro_torch.serving.generate import decode_step, prefill

from _torch_parity import ARCHS, config_pair, params_pair, to_np

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)


def _layer0(tree):
    """Layer 0's parameters out of the stacked segment tree."""
    return jax.tree.map(lambda a: a[0], tree["segments"][0][0])


def _tlayer0(tree):
    return TM.tree_map(lambda t: t[0], tree["segments"][0][0])


@pytest.mark.parametrize("arch", ["opt-125m", "opt-1.3b", "opt-13b",
                                  "smollm-135m"])
def test_configs_match_reference(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for cj, ct in ((j, t), (jconfigs.reduced(j), tconfigs.reduced(t))):
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "rope_theta",
                  "rms_eps", "compute_dtype", "param_dtype",
                  "tie_embeddings", "qk_norm", "sliding_window"):
            assert getattr(cj, f) == getattr(ct, f), f
        assert cj.n_params() == ct.n_params()


def test_unported_arch_raises():
    with pytest.raises(NotImplementedError):
        tconfigs.get_config("mamba2-370m")


def test_params_round_trip_is_bitwise():
    jcfg, _ = config_pair("opt-1.3b")
    jparams, tparams = params_pair(jcfg, seed=3)
    back = convert.params_to_numpy(tparams)
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    tl = jax.tree.leaves(back)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    # and the trees have the same paths
    assert (jax.tree_util.tree_structure(jax.tree.map(np.asarray, jparams))
            == jax.tree_util.tree_structure(back))


@pytest.mark.parametrize("heads", [True, False])
def test_apply_rope_matches_reference(heads):
    rng = np.random.default_rng(1)
    shape = (2, 11, 3, 32) if heads else (2, 11, 32)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 11)).astype(np.int32)
    got = TM.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    want = JM.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_mlp_apply_matches_reference(arch):
    jcfg, _ = config_pair(arch)
    jparams, tparams = params_pair(jcfg, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32)
    got = TM.mlp_apply(_tlayer0(tparams)["mlp"], torch.from_numpy(x))
    want = JM.mlp_apply(_layer0(jparams)["mlp"], jnp.asarray(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LAYER_TOL)


def _attn_inputs(jcfg, B, L, S, seed, window=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, jcfg.d_model)).astype(np.float32)
    shape = (B, S, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32)}
    return x, cache


def _run_attn(jcfg, tcfg, jp, tp, x, cache, **kw):
    jout, jc = JM.attn_apply(jcfg, jp, jnp.asarray(x),
                             cache=None if cache is None else
                             {k: jnp.asarray(v) for k, v in cache.items()},
                             **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                    else v) for k, v in kw.items()})
    tcache = None if cache is None else {
        k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tout, tc = TM.attn_apply(tcfg, tp, torch.from_numpy(x), cache=tcache,
                             **{k: (torch.from_numpy(v)
                                    if isinstance(v, np.ndarray) else v)
                                for k, v in kw.items()})
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **LAYER_TOL)
    if jc is not None:
        for k in ("k", "v"):
            np.testing.assert_allclose(to_np(tc[k]), np.asarray(jc[k]),
                                       **LAYER_TOL)
            # the port wrote the rows into the cache it was given
            assert tc[k] is tcache[k]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["full", "prefill", "decode"])
def test_attn_apply_matches_reference(arch, mode, use_kernels):
    """Port (plain code or the kernels' plain versions) vs the reference
    (jnp path or the Pallas kernels in interpret mode)."""
    jcfg, tcfg = config_pair(arch, use_kernels=use_kernels)
    jparams, tparams = params_pair(jcfg, seed=2)
    jp, tp = _layer0(jparams)["attn"], _tlayer0(tparams)["attn"]
    B, S = 3, 24
    L = 1 if mode == "decode" else 10
    x, cache = _attn_inputs(jcfg, B, L, S, seed=4)
    if mode == "decode":
        # ragged absolute positions, one past the arena (ring wrap)
        pos = np.asarray([[3], [17], [S + 5]], np.int32)
    else:
        pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    _run_attn(jcfg, tcfg, jp, tp, x, None if mode == "full" else cache,
              positions=pos, mode=mode)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_attn_prefill_with_history_is_rectangular_causal(use_kernels):
    """Suffix prefill over a read-only history (hk/hv): queries are the
    last Lq of the Lk positions."""
    jcfg, tcfg = config_pair("smollm-135m", use_kernels=use_kernels)
    jparams, tparams = params_pair(jcfg, seed=5)
    B, L, P, S = 2, 6, 9, 16
    x, cache = _attn_inputs(jcfg, B, L, S, seed=6)
    rng = np.random.default_rng(7)
    hshape = (B, P, jcfg.n_kv_heads, jcfg.head_dim)
    cache["hk"] = rng.standard_normal(hshape).astype(np.float32)
    cache["hv"] = rng.standard_normal(hshape).astype(np.float32)
    pos = np.broadcast_to(P + np.arange(L, dtype=np.int32), (B, L)).copy()
    _run_attn(jcfg, tcfg, _layer0(jparams)["attn"],
              _tlayer0(tparams)["attn"], x, cache, positions=pos,
              mode="prefill")


def test_attn_prefill_longer_than_window_rolls_the_ring():
    """A prompt longer than a sliding-window arena keeps the last S rows,
    each at slot pos % S."""
    jcfg, tcfg = config_pair("smollm-135m", sliding_window=8)
    jparams, tparams = params_pair(jcfg, seed=8)
    B, L, S = 2, 13, 8
    x, cache = _attn_inputs(jcfg, B, L, S, seed=9)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    _run_attn(jcfg, tcfg, _layer0(jparams)["attn"],
              _tlayer0(tparams)["attn"], x, cache, positions=pos,
              mode="prefill", window=8)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_logits_match_reference(arch, use_kernels):
    jcfg, tcfg = config_pair(arch, use_kernels=use_kernels)
    jparams, tparams = params_pair(jcfg, seed=10)
    B, L = 2, 24 if not use_kernels else 16
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (B, L))
    jh, _, _ = JT.forward(jcfg, jparams, tokens=jnp.asarray(toks, jnp.int32),
                          mode="full")
    jl = JT.logits_fn(jcfg, jparams, jh)
    th, _, _ = TT.forward(tcfg, tparams, tokens=torch.from_numpy(toks),
                          mode="full")
    tl = TT.logits_fn(tcfg, tparams, th)
    np.testing.assert_allclose(to_np(th), np.asarray(jh), **LOGIT_TOL)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_then_decode_equals_full_forward(arch, use_kernels):
    """Prefill + N decode steps through the in-place cache give the full
    forward's logits at every position (the port's analogue of
    test_system.py::test_generation_matches_score_forward), and both
    match the reference's full forward."""
    jcfg, tcfg = config_pair(arch, use_kernels=use_kernels)
    jparams, tparams = params_pair(jcfg, seed=12)
    B, Lp, n = 2, 7, 5
    toks = np.random.default_rng(13).integers(0, jcfg.vocab_size,
                                              (B, Lp + n))
    tt = torch.from_numpy(toks)
    params = TT.cast_params(tcfg, tparams)
    cache = TT.init_cache(tcfg, B, Lp + n)
    logits, cache = prefill(tcfg, params, tt[:, :Lp], cache)
    steps = [logits]
    for t in range(n - 1):
        logits, cache = decode_step(tcfg, params, tt[:, Lp + t], cache,
                                    torch.full((B,), Lp + t))
        steps.append(logits)
    got = torch.stack(steps, 1)                       # (B, n, V)
    th, _, _ = TT.forward(tcfg, tparams, tokens=tt, mode="full")
    full = TT.logits_fn(tcfg, tparams, th)[:, Lp - 1:-1]
    np.testing.assert_allclose(to_np(got), to_np(full), **LOGIT_TOL)
    jh, _, _ = JT.forward(jcfg, jparams, tokens=jnp.asarray(toks, jnp.int32),
                          mode="full")
    jfull = JT.logits_fn(jcfg, jparams, jh)[:, Lp - 1:-1]
    np.testing.assert_allclose(to_np(got), np.asarray(jfull), **LOGIT_TOL)


def test_cast_params_is_free_when_already_cast():
    _, tcfg = config_pair("opt-1.3b", compute_dtype="bfloat16")
    _, tparams = params_pair(config_pair("opt-1.3b")[0], seed=0)
    once = TT.cast_params(tcfg, tparams)
    twice = TT.cast_params(tcfg, once)
    for a, b in zip(TM.tree_leaves(once), TM.tree_leaves(twice)):
        assert a.dtype == torch.bfloat16 and a is b
