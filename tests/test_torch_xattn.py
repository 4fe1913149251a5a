"""Cross-attention and embedding inputs in the port, and the three configs
that brought MLA, cross-attention and embedding inputs in
(``deepseek-v2-lite-16b``, ``llama-3.2-vision-11b``, ``musicgen-medium``),
held to the reference at reduced size on carried-across weights, fp32:
``cross_attn_apply`` in its three modes; the transformer's forward and
one ``lm_train_step`` of each config (the port's counterpart of
``tests/test_smoke_archs.py``, plus parity); the audio decoder's prefill
and decode steps on frame embeddings; greedy ``generate`` of the VLM with
``encoder_embeds`` against ``jax_greedy``; the reference's refusals;
``reduced()``, ``param_specs`` and the new leaves' pspecs against the
reference's for every architecture id; the weights of each new tree
across both ways, bit for bit.

The cross-attention gate is ``tanh(gate)`` with ``gate`` initialised to
0, which would take cross-attention out of every output: the tests set
it to 0.7 in both trees.  Tolerances: module outputs and hidden states at
1e-5 (``LAYER_TOL`` of ``test_torch_model.py``), logits at 1e-4
(``LOGIT_TOL``), the train step at ``STEP_TOL`` with gradients at 1e-4
of each leaf's max, streams exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (STEP_TOL, assert_grads_close,
                           assert_params_moved_alike, config_pair,
                           jax_greedy, state_pair, to_np)
from repro import configs as jconfigs
from repro.models import modules as JM
from repro.models import transformer as JT
from repro.sharding import strategy as JS
from repro.training import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.configs import registry
from repro_torch.models import convert
from repro_torch.models import modules as TM
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.generate import decode_step, prefill
from repro_torch.sharding import strategy as TS
from repro_torch.training import steps as tsteps

VLM, AUDIO, MLA = ("llama-3.2-vision-11b", "musicgen-medium",
                   "deepseek-v2-lite-16b")
NEW = (MLA, VLM, AUDIO)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GATE = 0.7


def _gated(jparams):
    """The reference tree with every cross-attention gate at ``GATE``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.full_like(x, GATE)
        if getattr(path[-1], "key", None) == "gate" else x, jparams)


def _params(jcfg, seed):
    jparams = _gated(JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jparams, convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _pair(arch, use_kernels=False, seed=21, **kw):
    jcfg, tcfg = config_pair(arch, use_kernels=use_kernels, **kw)
    jcfg = jcfg.replace(use_pallas=False)           # the reference's jnp path
    return (jcfg, tcfg) + _params(jcfg, seed)


def _inputs(cfg, B, L, seed):
    """(reference kwargs, port kwargs) of a forward: tokens or frame
    embeddings, and a VLM's encoder embeddings."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, L))
    else:
        out["embeds"] = rng.standard_normal((B, L, cfg.d_model)).astype(
            np.float32)
    if cfg.arch_type == "vlm":
        out["encoder_embeds"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.encoder_dim)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


# --------------------------------------------------------------------- #
# cross_attn_apply
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("mode", ["full", "prefill", "decode"])
def test_cross_attn_apply_matches_reference(mode, use_kernels):
    """'full' and 'prefill' (7 query tokens over the 16 encoder states;
    'prefill' fills the ``xk``/``xv`` arena) and 'decode' (one query token
    over that cache, no encoder states) against the reference's
    ``cross_attn_apply``: output and cache."""
    jcfg, tcfg, jparams, tparams = _pair(VLM, use_kernels)
    jp = {k: v[0] for k, v in jparams["segments"][0][4]["xattn"].items()}
    tp = {k: v[0] for k, v in tparams["segments"][0][4]["xattn"].items()}
    rng = np.random.default_rng(3)
    B, L, Le = 2, 7, jcfg.encoder_len
    x = rng.standard_normal((B, L, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, Le, jcfg.d_model)).astype(np.float32)
    shp = (B, Le, jcfg.n_kv_heads, jcfg.head_dim)
    jc = tc = None
    if mode != "full":
        jc = {k: jnp.zeros(shp) for k in ("xk", "xv")}
        tc = {k: torch.zeros(shp) for k in ("xk", "xv")}
    pm = "prefill" if mode == "decode" else mode
    jo, jc = JM.cross_attn_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(enc),
                                 mode=pm, cache=jc)
    to, tc = TM.cross_attn_apply(tcfg, tp, torch.from_numpy(x),
                                 torch.from_numpy(enc), mode=pm, cache=tc)
    if mode == "decode":
        xd = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jo, jc = JM.cross_attn_apply(jcfg, jp, jnp.asarray(xd), None,
                                     mode="decode", cache=jc)
        to, tc = TM.cross_attn_apply(tcfg, tp, torch.from_numpy(xd), None,
                                     mode="decode", cache=tc)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **LAYER_TOL)
    assert float(to.abs().max()) > 0              # the gate lets it through
    for k in ("xk", "xv"):
        np.testing.assert_allclose(to_np(tc[k]), np.asarray(jc[k]),
                                   **LAYER_TOL)


def test_cross_attention_cache_must_hold_the_encoder_length():
    """The port fills the arena in place, so the encoder must give
    ``encoder_len`` states (the reference rebuilds its cache instead)."""
    _, tcfg, _, tparams = _pair(VLM)
    tp = {k: v[0] for k, v in tparams["segments"][0][4]["xattn"].items()}
    cache = {k: torch.zeros(1, tcfg.encoder_len, tcfg.n_kv_heads,
                            tcfg.head_dim) for k in ("xk", "xv")}
    with pytest.raises(ValueError, match="encoder_len"):
        TM.cross_attn_apply(tcfg, tp, torch.zeros(1, 2, tcfg.d_model),
                            torch.zeros(1, 3, tcfg.d_model), mode="prefill",
                            cache=cache)


# --------------------------------------------------------------------- #
# the three configs: forward and one train step
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", NEW)
def test_forward_hidden_and_aux_match_reference(arch, use_kernels):
    jcfg, tcfg, jparams, tparams = _pair(arch, use_kernels)
    jin, tin = _inputs(jcfg, 2, 12, 4)
    jh, _, jaux = JT.forward(jcfg, jparams, mode="full", **jin)
    th, _, taux = TT.forward(tcfg, tparams, mode="full", **tin)
    assert th.shape == (2, 12, tcfg.d_model)
    np.testing.assert_allclose(to_np(th), np.asarray(jh), **LAYER_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    assert (float(taux) > 0) == tcfg.moe


def _lm_batch(cfg, seed, B=4, L=12):
    _, tin = _inputs(cfg, B, L, seed)
    rng = np.random.default_rng(seed + 1)
    batch = {k: v.numpy() for k, v in tin.items()}
    batch["labels"] = rng.integers(0, cfg.vocab_size, (B, L)).astype(
        np.int32)
    batch["mask"] = (rng.random((B, L)) < 0.8).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", NEW)
def test_lm_train_step_matches_reference(arch):
    """One ``lm_train_step`` (kernel route, remat) on tokens, frame
    embeddings or tokens with encoder embeddings: loss, aux, every grad
    (the projector's and the gates' too) and the moved params."""
    jcfg, tcfg, jparams, _ = _pair(arch, use_kernels=True, seed=23)
    tcfg = tcfg.replace(remat=True)
    jstate, tstate = state_pair(jparams)
    batch = _lm_batch(jcfg, 5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    lr = 1e-3
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jsteps.lm_loss_fn(jcfg, p, jb), has_aux=True))(jparams)
    (tl, tm), tg = tsteps.lm_value_and_grad(tcfg, tstate.params, tb)
    np.testing.assert_allclose(float(tl), float(jl), **STEP_TOL)
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                               rtol=1e-5, atol=1e-7)
    assert_grads_close(tg, jg)
    jstate2, _ = jax.jit(lambda s, b: jsteps.lm_train_step(
        jcfg, s, b, lr))(jstate, jb)
    tstate2, _ = tsteps.lm_train_step(tcfg, tstate, tb, lr)
    assert_params_moved_alike(tstate2.params, jstate2.params, jg, lr)


# --------------------------------------------------------------------- #
# serving: prefill / decode with embeds, the VLM's generate
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", (AUDIO, VLM))
def test_prefill_then_decode_matches_reference(arch, use_kernels):
    """Prefill 6 positions of 2 rows, then 3 decode steps, each fed the next
    frame embedding (audio) or token (the VLM, whose decode reads the
    cross K/V its prefill cached): every step's logits against the
    reference's prefill and decode."""
    jcfg, tcfg, jparams, tparams = _pair(arch, use_kernels, seed=25)
    B, Lp, n = 2, 6, 3
    jin, tin = _inputs(jcfg, B, Lp + n, 6)
    key = "embeds" if arch == AUDIO else "tokens"
    enc_j, enc_t = jin.get("encoder_embeds"), tin.get("encoder_embeds")
    params = TT.cast_params(tcfg, tparams)
    cache = TT.init_cache(tcfg, B, Lp + n)
    jcache = JT.init_cache(jcfg, B, Lp + n)
    head = {key: tin[key][:, :Lp]}
    if arch == AUDIO:
        logits, cache = prefill(tcfg, params, None, cache, embeds=head[key],
                                encoder_embeds=enc_t)
    else:
        logits, cache = prefill(tcfg, params, head[key], cache,
                                encoder_embeds=enc_t)
    jh, jcache, _ = JT.forward(jcfg, jparams, mode="prefill", cache=jcache,
                               encoder_embeds=enc_j,
                               **{key: jin[key][:, :Lp]})
    got, want = [logits], [JT.logits_fn(jcfg, jparams, jh[:, -1:])[:, 0]]
    for t in range(n):
        pos = torch.full((B,), Lp + t, dtype=torch.long)
        if arch == AUDIO:
            lg, cache = decode_step(tcfg, params, None, cache, pos,
                                    embeds=tin[key][:, Lp + t:Lp + t + 1])
        else:
            lg, cache = decode_step(tcfg, params, tin[key][:, Lp + t], cache,
                                    pos)
        got.append(lg)
        jh, jcache, _ = JT.forward(
            jcfg, jparams, mode="decode", cache=jcache,
            positions=jnp.full((B, 1), Lp + t, jnp.int32),
            encoder_embeds=enc_j, **{key: jin[key][:, Lp + t:Lp + t + 1]})
        want.append(JT.logits_fn(jcfg, jparams, jh)[:, 0])
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_np(a), np.asarray(b), **LOGIT_TOL)


def test_vlm_generate_with_encoder_embeds_matches_jax_greedy():
    """``GenerationEngine.generate(..., encoder_embeds=)`` greedy on two
    rows, each row's stream against ``jax_greedy`` of that row alone; a
    different image changes the stream, so cross-attention reaches it."""
    jcfg, tcfg, jparams, tparams = _pair(VLM, use_kernels=True, seed=27)
    jcfg = jcfg.replace(use_pallas=True)
    rng = np.random.default_rng(28)
    prompts = rng.integers(0, jcfg.vocab_size, (2, 9))
    enc = rng.standard_normal((2, jcfg.encoder_len, jcfg.encoder_dim)
                              ).astype(np.float32) * 3
    eng = GenerationEngine(tcfg, max_new_tokens=6, temperature=0.0,
                           device="cpu")
    out = eng.generate(tparams, prompts, torch.Generator(),
                       encoder_embeds=torch.from_numpy(enc))
    got = out["sequences"][:, 9:].tolist()
    for b in range(2):
        assert got[b] == jax_greedy(jcfg, jparams, prompts[b], 6,
                                    encoder_embeds=enc[b])
    other = eng.generate(tparams, prompts, torch.Generator(),
                         encoder_embeds=torch.from_numpy(enc[::-1].copy()))
    assert other["sequences"][:, 9:].tolist() != got


def test_reference_refusals():
    """The request core takes token-input decoder LMs only, and the paged
    layout refuses VLMs (the reference's messages)."""
    for arch in (VLM, AUDIO):
        _, tcfg, _, tparams = _pair(arch)
        eng = GenerationEngine(tcfg, max_new_tokens=4, device="cpu")
        with pytest.raises(NotImplementedError,
                           match="continuous batching supports token-input "
                                 "decoder LMs"):
            eng.core(tparams, torch.Generator(), slots=2, max_seq_len=16)
    _, tcfg = config_pair(VLM)
    with pytest.raises(NotImplementedError, match="no MLA / VLM"):
        GenerationEngine(tcfg, max_new_tokens=4, kv_layout="paged",
                         device="cpu")


# --------------------------------------------------------------------- #
# configs, specs, pspecs, weights
# --------------------------------------------------------------------- #
IDS = tuple(jconfigs.list_archs()) + ("opt-1.3b",)


def _spec_rows(specs, M):
    leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, M.ParamSpec))
    return [(tuple(s.shape), tuple(s.axes), s.init, s.scale) for s in leaves]


def _port_spec_rows(tree):
    out = []
    for _, s in TM.flatten_with_path(tree):
        out.append((tuple(s.shape), tuple(s.axes), s.init, s.scale))
    return out


@pytest.mark.parametrize("arch", IDS)
def test_configs_reduced_and_param_specs_match_reference(arch):
    """Every architecture id resolves (nothing is left unported), its config
    and ``reduced()`` equal the reference's field for field (all but the
    reference's ``use_pallas`` and sharding knobs, whose place the port's
    ``use_kernels`` takes), and ``param_specs`` give the same leaves
    (shape, axes, init, scale) in the reference's order."""
    assert registry._NOT_PORTED == []
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    skip = {"use_pallas", "weight_gather", "tp_size", "use_kernels"}
    for cj, ct in ((j, t), (jconfigs.reduced(j), tconfigs.reduced(t))):
        for f in ct.__dataclass_fields__:
            if f not in skip:
                assert getattr(cj, f) == getattr(ct, f), (arch, f)
        assert _port_spec_rows(TT.param_specs(ct)) == _spec_rows(
            JT.param_specs(cj), JM)
        assert cj.n_params() == ct.n_params()


def test_input_shapes_match_reference():
    """``InputShape`` / ``INPUT_SHAPES`` (the assigned benchmark shapes)
    are the reference's, field for field."""
    from repro.models.config import INPUT_SHAPES as J
    from repro_torch.models.config import INPUT_SHAPES as T_
    assert list(T_) == list(J)
    for k in J:
        assert (T_[k].name, T_[k].seq_len, T_[k].global_batch,
                T_[k].phase) == (J[k].name, J[k].seq_len, J[k].global_batch,
                                 J[k].phase)


class _Mesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _pspec_paths(tree, path=()):
    """``[(path, pspec)]`` of a port pspec tree, dict keys sorted."""
    if TS.is_pspec(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _pspec_paths(tree[k], path + (k,))]
    return [kv for i, t in enumerate(tree)
            for kv in _pspec_paths(t, path + (i,))]


NEW_LEAVES = {MLA: ("w_dkv", "kv_norm", "w_uk", "w_uv"),
              VLM: ("projector", "xattn"), AUDIO: ()}


@pytest.mark.parametrize("strategy", ("ddp", "zero1", "zero3", "tp"))
@pytest.mark.parametrize("arch", NEW)
def test_new_leaves_pspecs_match_reference(arch, strategy):
    """The pspecs of the new leaves (MLA's latent projections and norm, the
    projector and the cross-attention block; no ``embed`` for the audio
    decoder) under each strategy at the production mesh, path by path."""
    mesh = _Mesh({"data": 16, "model": 16})
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
            tuple(v) for p, v in jax.tree_util.tree_leaves_with_path(
                JS.param_pspecs(jcfg, mesh, strategy),
                is_leaf=lambda x: isinstance(x, JS.P))}
    got = dict(_pspec_paths(TS.param_pspecs(tcfg, mesh, strategy)))
    assert got == want
    paths = [p for p in got if any(n in p for n in NEW_LEAVES[arch])]
    assert len(paths) >= len(NEW_LEAVES[arch])
    assert (("embed",) in got) == tcfg.embed_inputs


@pytest.mark.parametrize("arch", NEW)
def test_weights_cross_both_ways_bitwise(arch):
    """The reference's tree (with ``projector``, MLA's leaves, the gates;
    without ``embed`` for the audio decoder) into the port and back, and
    the port's own tree out and in, bit for bit, in fp32 and bf16."""
    jcfg, tcfg = config_pair(arch)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(29))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert ("embed" in tparams) == tcfg.embed_inputs
    assert ("projector" in tparams) == (tcfg.arch_type == "vlm")
    back = convert.params_to_numpy(tparams)
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    tl = [leaf for _, leaf in TM.flatten_with_path(back)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    own = TT.init_params(tcfg, torch.Generator().manual_seed(0),
                         torch.bfloat16)
    again = convert.params_from_numpy(convert.params_to_numpy(own))
    for (pa, a), (pb, b) in zip(TM.flatten_with_path(own),
                                TM.flatten_with_path(again)):
        assert pa == pb
        assert torch.equal(a, b.to(a.dtype))
